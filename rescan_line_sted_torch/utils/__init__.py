"""Utilities: image rotation, and tracing, timing, metrics and debugging
(``observability``)."""

from rescan_line_sted_torch.utils.observability import (
    enable_compilation_cache,
)
from rescan_line_sted_torch.utils.rotate import rotate_image

__all__ = ["enable_compilation_cache", "rotate_image"]

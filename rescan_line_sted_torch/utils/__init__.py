"""Utilities: image rotation.

Not ported yet: ``enable_compilation_cache`` (ROADMAP.md queue 1, slice K).
"""

from rescan_line_sted_torch.utils.rotate import rotate_image

__all__ = ["rotate_image"]

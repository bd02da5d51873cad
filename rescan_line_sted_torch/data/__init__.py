"""Procedural samples."""

from rescan_line_sted_torch.data.samples import siemens_star

__all__ = ["siemens_star"]

"""Imaging engines (rescanned line-STED so far)."""

from rescan_line_sted_torch.imaging.rescan import rescanned_line_sted_image

__all__ = ["rescanned_line_sted_image"]

"""Imaging engines: descanned point- and line-STED, rescanned line-STED and
rescanned point-STED (ISM)."""

from rescan_line_sted_torch.imaging.line_sted import line_sted_image
from rescan_line_sted_torch.imaging.point_sted import point_sted_image
from rescan_line_sted_torch.imaging.rescan import rescanned_line_sted_image
from rescan_line_sted_torch.imaging.rescan_point import (
    rescanned_point_sted_image,
)

__all__ = ["line_sted_image", "point_sted_image", "rescanned_line_sted_image",
           "rescanned_point_sted_image"]

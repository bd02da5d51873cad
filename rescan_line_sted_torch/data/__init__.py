"""Procedural samples."""

from rescan_line_sted_torch.data.samples import (
    line_pairs,
    rings,
    siemens_star,
    sparse_points,
)

__all__ = ["line_pairs", "rings", "siemens_star", "sparse_points"]

"""Procedural samples.

Not ported yet: ``rings``, ``line_pairs`` and ``sparse_points``
(ROADMAP.md queue 1, slice H).
"""

from rescan_line_sted_torch.data.samples import siemens_star

__all__ = ["siemens_star"]

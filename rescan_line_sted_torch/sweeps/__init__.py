"""Parameter sweeps: the dose-matched comparison.

Not ported yet: ``resolution_fov_sweep`` (ROADMAP.md queue 1, slice H),
which needs rotation and Richardson-Lucy (slices D and E).
"""

from rescan_line_sted_torch.sweeps.dose import (
    DoseMatchedComparison,
    ModalitySweep,
    dose_matched_sweep,
)

__all__ = ["DoseMatchedComparison", "ModalitySweep", "dose_matched_sweep"]

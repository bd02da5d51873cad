"""Parameter sweeps: the dose-matched comparison and the resolution / FOV
sweep."""

from rescan_line_sted_torch.sweeps.dose import (
    DoseMatchedComparison,
    ModalitySweep,
    dose_matched_sweep,
)
from rescan_line_sted_torch.sweeps.fov import resolution_fov_sweep

__all__ = ["DoseMatchedComparison", "ModalitySweep", "dose_matched_sweep",
           "resolution_fov_sweep"]

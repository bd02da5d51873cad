"""Host I/O: TIFF images and stacks, and checkpoints of sweep results."""

from rescan_line_sted_torch.io.tiff import array_to_tif, tif_to_array
from rescan_line_sted_torch.io.checkpoint import (
    SweepCheckpoint,
    load_state,
    save_state,
)

__all__ = ["SweepCheckpoint", "array_to_tif", "load_state", "save_state",
           "tif_to_array"]

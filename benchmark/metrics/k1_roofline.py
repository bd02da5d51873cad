"""``k1_roofline``: K1's least time over its device time per image (%).

The least time (``work.k1_least_s``) is counted from the cell's shapes,
from the work K1's function needs and not from K1's padded windows: each
scan position's lit columns times the detection taps in every row, plus
the NUFFT spreading taps at an irrational R, as three TF32 passes at
495 TFLOP/s, or the sample read once and the canvas written once at
3.35 TB/s, whichever is longer. It leaves out K1's draws and placement,
which make K1 slower and never the bound larger. K1 is every kernel whose
name holds ``KERNELS``'s name."""

from benchmark import readers, work

KERNELS = ("rescan_banded_fused",)


def read(run):
    return readers.roofline(run, work.k1_least_s, KERNELS)

"""``k2c_roofline``: K2c's least time over its device time per image (%).

The least time (``work.k2c_least_s``): the canvas's rates read once and
its counts written once, 4 bytes each, at 3.35 TB/s. K2c is every kernel
whose name holds ``KERNELS``'s name (both of its layouts)."""

from benchmark import readers, work

KERNELS = ("poisson_flat",)


def read(run):
    return readers.roofline(run, work.k2c_least_s, KERNELS)

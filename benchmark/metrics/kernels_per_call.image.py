"""``kernels_per_call.image``: device kernels per image call."""

from benchmark.readers import kernels_per_call as read  # noqa: F401

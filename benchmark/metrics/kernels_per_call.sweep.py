"""``kernels_per_call.sweep``: device kernels per sweep."""

from benchmark.readers import kernels_per_call as read  # noqa: F401

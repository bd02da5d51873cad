"""``device_idle.sweep``: share of the traced sweeps with the card idle."""

from benchmark.readers import device_idle as read  # noqa: F401

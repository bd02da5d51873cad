"""``device_idle.image``: share of the traced image calls with the card
idle."""

from benchmark.readers import device_idle as read  # noqa: F401

"""``syncs_per_call.sweep``: device-to-host reads and waits per sweep."""

from benchmark.readers import syncs_per_call as read  # noqa: F401

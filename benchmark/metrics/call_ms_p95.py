"""``call_ms_p95``: the 95th percentile (nearest rank) of every call in
the window, each timed on the host from its start to the synchronise
that ends it."""

import math


def read(run):
    times = sorted(run.call_s)
    return 1e3 * times[math.ceil(0.95 * len(times)) - 1]

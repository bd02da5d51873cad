"""``ledgers_idle.sweep``: share (%) of the traced sweeps in which the
card is idle while the port's ``rls.sweep.ledgers`` span is open."""

from benchmark import spans


def read(run):
    return spans.idle_share(run, "rls.sweep.ledgers")

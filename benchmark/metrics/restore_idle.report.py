"""``restore_idle.report``: share (%) of the traced sweeps in which the
card is idle while one of the port's RL loops (``rls.fusion.rl``,
``rls.fusion.operator``) is open."""

from benchmark import spans


def read(run):
    return spans.idle_share(run, "rls.fusion.rl", "rls.fusion.operator")

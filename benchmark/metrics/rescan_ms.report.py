"""``rescan_ms.report``: host time (ms) per sweep inside
``rls.sweep.rescan``: each power's rotated canvases, their draws,
operator-RL fusions and FRC."""

from benchmark import spans


def read(run):
    return spans.span_ms(run, "rls.sweep.rescan")

"""``ledgers_ms.sweep``: host time (ms) per sweep inside
``rls.sweep.ledgers``, the CPU dose ledgers: the models' profiles before
the loop, and each power's dose reports, exposures and brightnesses."""

from benchmark import spans


def read(run):
    return spans.span_ms(run, "rls.sweep.ledgers")

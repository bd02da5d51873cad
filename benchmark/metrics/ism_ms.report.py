"""``ism_ms.report``: host time (ms) per sweep inside ``rls.sweep.ism``:
each power's ISM canvas, its draws, deconvolutions and FRC."""

from benchmark import spans


def read(run):
    return spans.span_ms(run, "rls.sweep.ism")

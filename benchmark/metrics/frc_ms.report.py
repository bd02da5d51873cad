"""``frc_ms.report``: host time (ms) per sweep inside ``rls.frc``, one
span for each resolution the FRC entries return."""

from benchmark import spans


def read(run):
    return spans.span_ms(run, "rls.frc")

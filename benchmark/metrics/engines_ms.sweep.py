"""``engines_ms.sweep``: host time (ms) per sweep inside
``rls.sweep.point`` or ``rls.sweep.line``: each power's system kernel
and engine calls, arm by arm."""

from benchmark import spans


def read(run):
    return spans.span_ms(run, "rls.sweep.point", "rls.sweep.line")

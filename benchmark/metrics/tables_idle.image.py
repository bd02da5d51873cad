"""``tables_idle.image``: share (%) of the traced image calls in which the
card is idle while the port's ``rls.image.tables`` span is open."""

from benchmark import spans


def read(run):
    return spans.idle_share(run, "rls.image.tables")

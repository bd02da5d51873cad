"""``k1_issue_ms.image``: host time (ms) per image call inside ``rls.k1``,
K1's wrapper on the card: its tables, key words and launch."""

from benchmark import spans


def read(run):
    return spans.span_ms(run, "rls.k1")

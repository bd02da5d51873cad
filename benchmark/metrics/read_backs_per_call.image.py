"""``read_backs_per_call.image``: the port's deliberate reads from the
card per image call (``rls.read_back``: one ``device.read_back`` each,
which waits for the card)."""

from benchmark import spans


def read(run):
    return spans.per_call(run, "rls.read_back", "rls.image")

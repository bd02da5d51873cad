"""``host_tables_per_call.image``: host-built tables copied to the card
per image call (``rls.host_table``: one ``device.host_table`` each,
through a freshly pinned buffer)."""

from benchmark import spans


def read(run):
    return spans.per_call(run, "rls.host_table", "rls.image")

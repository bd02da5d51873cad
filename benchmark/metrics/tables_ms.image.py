"""``tables_ms.image``: host time (ms) per image call inside
``rls.image.tables``, the port's span over what a call rebuilds that
depends only on the parameters, geometry and device (profiles, OTF,
offsets and classes, NUFFT tables, the closed form's constants, the dose
ledger)."""

from benchmark import spans


def read(run):
    return spans.span_ms(run, "rls.image.tables")

"""Pytest hooks of the benchmark's own tests (``python -m pytest
benchmark/tests``): the small CPU field of each configuration added after
``benchmark/tests/conftest.py``'s table ``SMALL``, entered into that table
as it loads, so that the table stays as the first cells left it."""

# a field at which every fault of the cell reads above a limit and the
# sound run stays under each
SMALL = {"report_sweep_192": [64, 64]}


def pytest_plugin_registered(plugin):
    table = getattr(plugin, "SMALL", None)
    if isinstance(table, dict) and table is not SMALL:
        for name, field in SMALL.items():
            table.setdefault(name, field)

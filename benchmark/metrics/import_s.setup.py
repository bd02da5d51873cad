"""``import_s.setup``: seconds of the port's own import, torch already
imported (``SETUP["import_s"]``), a part of ``setup_s``."""

from benchmark import spans


def read(run):
    return spans.setup("import_s")

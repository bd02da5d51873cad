"""``library_s.setup``: seconds of the port's first load of its kernel
library in this process (``SETUP["library_s"]``: the sources' hash, nvcc
where the checkout has not built the library, the load and its
signatures), a part of ``setup_s``."""

from benchmark import spans


def read(run):
    return spans.setup("library_s")

"""``setup_s``: from the start of the process to the first timed call:
imports, inputs, the kernels' build where it has not been made, and the
warm-up calls of the cell's shapes."""


def read(run):
    return run.setup_s

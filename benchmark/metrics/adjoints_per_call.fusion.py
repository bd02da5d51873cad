"""``adjoints_per_call.fusion``: applications of the fusion operator's
adjoint per call (``rls.fusion.adjoint``: each autograd pull of a
``LinearOperator``, the normaliser's included); None where the program
records no such span (a program that does not count them)."""

from benchmark import spans


def read(run):
    return spans.per_call(run, "rls.fusion.adjoint", "rls.fusion.adjoint")

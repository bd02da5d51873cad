"""``operator_builds_per_call.report``: builds per sweep of a fusion
operator's rotation constants, the gather's indices and weights
(``rls.fusion.build``); None where the program records no operator RL
(``rls.fusion.operator``)."""

from benchmark import spans


def read(run):
    return spans.per_call(run, "rls.fusion.build", "rls.fusion.operator")

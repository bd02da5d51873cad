"""``restore_ms.report``: host time (ms) per sweep inside the port's RL
loops, ``rls.fusion.rl`` (multi-view RL: the point arm's restoration,
the line arm's fusion, ISM's deconvolution, the point responses) or
``rls.fusion.operator`` (operator RL: the rescan arm's fusion)."""

from benchmark import spans


def read(run):
    return spans.span_ms(run, "rls.fusion.rl", "rls.fusion.operator")

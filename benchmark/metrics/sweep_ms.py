"""``sweep_ms``: the window over the sweeps it completed."""


def read(run):
    if "sweeps" not in run.work:
        return None
    return 1e3 * run.window_s / (run.calls * run.work["sweeps"])

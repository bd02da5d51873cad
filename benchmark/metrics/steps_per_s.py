"""``steps_per_s``: scan positions simulated over the whole window, the
calls completed times the positions of one call, over the window."""


def read(run):
    if "steps" not in run.work:
        return None
    return run.calls * run.work["steps"] / run.window_s

"""``issue_ms.image``: mean host time from a call's start to the entry's
return, before the synchronise, over the window's calls (host clock,
outside the profiler)."""


def read(run):
    return 1e3 * sum(run.issue_s) / len(run.issue_s)

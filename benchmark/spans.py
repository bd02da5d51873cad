"""Readers of the port's own spans and counters in the traced stretch.

The port marks its stages with ``utils.observability.span``:
``torch.profiler.record_function`` spans named ``rls.<layer>.<stage>``,
recorded only while the profiler runs, so they lie in the same Chrome
trace as the card's kernels and copies and on the same clock
(``cat: "user_annotation"``, held by ``trace.Trace._host``). A counter
is a span around the work it counts (``rls.host_table``,
``rls.read_back``): its occurrences are the count. Every reader keeps to
the traced stretch (``Trace._t``: the first call's start to the last
call's end) and returns None without a trace, or where the program
records no such span (a program without the spans reads as nothing).
"""

from __future__ import annotations

import sys

from benchmark.trace import _union

SETUP_MODULE = "rescan_line_sted_torch.utils.observability"


def intervals(trace, *names) -> list:
    """The union of the intervals (us) of the port's spans named
    ``names`` in the stretch, clipped to it."""
    t0, t1 = trace._t
    return _union([(max(e["ts"], t0), min(e["ts"] + e["dur"], t1))
                   for e in trace._host
                   if e.get("cat") == "user_annotation"
                   and e["name"] in names
                   and e["ts"] < t1 and e["ts"] + e["dur"] > t0])


def occurrences(trace, *names) -> int:
    """How many spans named ``names`` start in the stretch."""
    t0, t1 = trace._t
    return sum(1 for e in trace._host
               if e.get("cat") == "user_annotation" and e["name"] in names
               and t0 <= e["ts"] < t1)


def length(ivs) -> float:
    return sum(b - a for a, b in ivs)


def intersect(xs, ys) -> list:
    """The intersection of two sorted unions of intervals."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def idle(trace) -> list:
    """The stretch's intervals with nothing on the card."""
    t0, t1 = trace._t
    edges = [t0] + [x for iv in trace.busy for x in iv] + [t1]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def span_ms(run, *names):
    """Host time (ms) a call with any of the spans ``names`` open: the
    union of their intervals over the stretch's calls."""
    t = run.trace
    if t is None:
        return None
    ivs = intervals(t, *names)
    if not ivs:
        return None
    return 1e-3 * length(ivs) / t.calls


def per_call(run, name, root):
    """Occurrences of span ``name`` per call; None unless the program
    records its ``root`` span there (a counter that reads 0 is a count
    only where the program counts)."""
    t = run.trace
    if t is None or not occurrences(t, root):
        return None
    return occurrences(t, name) / t.calls


def idle_share(run, *names):
    """Share (%) of the stretch in which the card is idle while one of the
    spans ``names`` is open; None where nothing ran on a card."""
    t = run.trace
    if t is None or not t.busy:
        return None
    ivs = intervals(t, *names)
    if not ivs:
        return None
    t0, t1 = t._t
    return 100.0 * length(intersect(ivs, idle(t))) / (t1 - t0)


def setup(key):
    """The port's own set-up reading ``key`` (seconds), from its
    ``observability.SETUP`` in this process; None where the program keeps
    no such reading."""
    module = sys.modules.get(SETUP_MODULE)
    value = getattr(module, "SETUP", {}).get(key)
    return None if value is None else float(value)

#!/usr/bin/env python3
"""Where a benchmark cell's call spends its host time, by the port's spans.

    python scripts/torch_trace_split.py --workload <cell> --seed <n>

Runs one cell of ``BENCHMARK.json`` as ``benchmark/run.py`` does (one
process, one CPU thread for torch), on the card, and prints one JSON line:

- ``setup``: the set-up split: the torch import, the driver's import (the
  port's import within it, ``SETUP["import_s"]``), CUDA's start, the
  cell's inputs, the warm-up calls (the kernel library's first load within
  them, ``SETUP["library_s"]``, ``built`` where it ran nvcc), and their
  sum, the set-up as ``run.py`` counts it;
- ``window``: ``SECONDS`` of the closed loop, untraced: calls, the mean
  call and the mean issue (ms);
- ``clocked``: ``SECONDS`` more of the closed loop, untraced, with each
  port span timed on the host clock instead of the profiler's (this
  script stands a timer in for ``record_function`` and reports the
  profiler as on to the spans alone): the mean call, and the host time
  (ms) per call inside each span name, its own nesting counted once;
- ``traced``: the cell's ``trace_calls`` under ``torch.profiler``
  (``benchmark/trace.py``), as ``--trace 1`` profiles them: per call, the host time (ms) inside each of
  the port's stages (``benchmark/spans.py``: the union of the stage's
  spans), the root's self time, the share of the root the stages cover,
  the traced ``bench.issue``, the card's idle time inside ``bench.issue``
  and the share of it that falls under a stage, and each counter; and
  every idle gap longer than ``GAP_US`` by the innermost port span open
  at its middle (and the outermost operator), counted and summed;
- ``span_cost_us``: one span's host cost, profiler off (as a context
  manager and as a decorator) and on.

The line holds the card's name and power limit.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()   # as benchmark/run.py counts set-up

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

ROOTS = ("rls.image", "rls.sweep")
COUNTERS = ("rls.host_table", "rls.read_back", "rls.plan_build")
STAGES = ("rls.image.tables", "rls.image.yconv", "rls.k1",
          "rls.image.finish", "rls.image.products", "rls.k2c",
          "rls.sweep.generators", "rls.sweep.ledgers", "rls.sweep.point",
          "rls.sweep.line", "rls.sweep.columns")
GAP_US = 100.0      # the idle gaps placed one by one
SECONDS = 10.0      # each closed loop


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def span_cost_us(n: int = 100_000) -> dict:
    """One span's host cost in us: off as a context manager, off as a
    decorator (over the bare call), and on under the CPU profiler."""
    from torch.profiler import ProfilerActivity, profile

    from rescan_line_sted_torch.utils.observability import span

    def bare():
        return None

    spanned = span("rls.cost")(bare)

    def per(fn, count):
        t = time.perf_counter()
        fn(count)
        return 1e6 * (time.perf_counter() - t) / count

    def ctx(count):
        for _ in range(count):
            with span("rls.cost"):
                pass

    def loop(f):
        def run(count):
            for _ in range(count):
                f()
        return run

    out = {"off_context": per(ctx, n),
           "off_decorator": per(loop(spanned), n) - per(loop(bare), n)}
    with profile(activities=[ProfilerActivity.CPU]):
        out["on_context"] = per(ctx, n // 10)
    return out


class Clock:
    """Host-clock time inside each span name, standing in for
    ``record_function`` (``clocked``)."""

    total: dict = {}
    depth: dict = {}

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        d = Clock.depth.get(self.name, 0)
        Clock.depth[self.name] = d + 1
        if d == 0:
            self.t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        Clock.depth[self.name] -= 1
        if not Clock.depth[self.name]:
            Clock.total[self.name] = Clock.total.get(self.name, 0.0) + (
                time.perf_counter() - self.t)
        return False


def closed_loop(cell, dev, seconds: float) -> dict:
    call_s, issue_s = [], []
    start = end = time.perf_counter()
    while end - start < seconds:
        t = time.perf_counter()
        out = cell.call()
        issued = time.perf_counter()
        dev.sync()
        end = time.perf_counter()
        call_s.append(end - t)
        issue_s.append(issued - t)
        del out
    n = len(call_s)
    return {"calls": n, "call_ms": 1e3 * (end - start) / n,
            "issue_ms": 1e3 * sum(issue_s) / n}


def clocked(cell, dev, seconds: float) -> dict:
    """The closed loop with the port's spans on the host clock: the
    spans see the profiler as on and enter ``Clock`` in place of
    ``record_function``; nothing else here reads that flag."""
    import torch

    saved = torch.autograd._profiler_enabled, torch.profiler.record_function
    torch.autograd._profiler_enabled = lambda: True
    torch.profiler.record_function = Clock
    Clock.total.clear()
    try:
        out = closed_loop(cell, dev, seconds)
    finally:
        torch.autograd._profiler_enabled, torch.profiler.record_function = \
            saved
    out["span_ms"] = {k: 1e3 * v / out["calls"]
                      for k, v in sorted(Clock.total.items())}
    return out


def stage_split(tr) -> dict:
    from benchmark import spans

    calls = tr.calls
    root = spans.intervals(tr, *ROOTS)
    stages = spans.intervals(tr, *STAGES, *COUNTERS)
    issue = spans.intervals(tr, "bench.issue")
    idle = spans.idle(tr)
    idle_issue = spans.intersect(idle, issue)
    per_call = {name: 1e-3 * spans.length(spans.intervals(tr, name)) / calls
                for name in STAGES + ROOTS}
    port = [e for e in tr._host if e.get("cat") == "user_annotation"
            and e["name"].startswith("rls.")]
    gaps: dict = {}
    for a, b in idle:
        if b - a < GAP_US:
            continue
        mid = (a + b) / 2
        open_at = sorted((e for e in port
                          if e["ts"] <= mid < e["ts"] + e["dur"]),
                         key=lambda e: e["ts"])
        where = tr._label(mid)
        label = "/".join(e["name"] for e in open_at) or "(no port span)"
        g = gaps.setdefault(f"{label} | {where}", [0, 0.0, 0.0])
        g[0] += 1
        g[1] += 1e-3 * (b - a) / calls
        g[2] = max(g[2], 1e-3 * (b - a))
    issue_ms = [1e-3 * e["dur"] for e in tr._host
                if e.get("cat") == "user_annotation"
                and e["name"] == "bench.issue"]
    return {
        "calls": calls,
        "stage_ms": {k: v for k, v in per_call.items() if v},
        "root_self_ms": 1e-3 * (spans.length(root) - spans.length(
            spans.intersect(root, stages))) / calls,
        "stage_cover": (spans.length(spans.intersect(root, stages))
                        / spans.length(root)) if root else None,
        "traced_issue_ms": sum(issue_ms) / len(issue_ms),
        "idle_in_issue_ms": 1e-3 * spans.length(idle_issue) / calls,
        "idle_in_issue_placed": (spans.length(spans.intersect(
            idle_issue, stages)) / spans.length(idle_issue)
            if idle_issue else None),
        "idle_share": 100.0 * (1.0 - tr.busy_s / tr.window_s),
        "counts": {k: spans.occurrences(tr, k) / calls
                   for k in COUNTERS + ROOTS},
        "gaps": {k: {"n": v[0], "ms_per_call": v[1], "max_ms": v[2]}
                 for k, v in sorted(gaps.items(), key=lambda kv: -kv[1][1])},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)

    t = time.perf_counter()
    import torch
    setup = {"torch_import_s": time.perf_counter() - t}
    from benchmark import core, trace

    if not torch.cuda.is_available():
        print("torch_trace_split: needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    manifest = core.read_json(REPO / "BENCHMARK.json")
    spec = core.load_spec(args.workload, manifest)
    t = time.perf_counter()
    driver = core.load_module(spec.driver_path(core.BENCH), "split_driver")
    setup["driver_import_s"] = time.perf_counter() - t
    t = time.perf_counter()
    dev = core.Device("cuda:0")
    setup["cuda_start_s"] = time.perf_counter() - t
    t = time.perf_counter()
    cell = driver.Cell(spec.config, spec.workload, args.seed, dev.device)
    setup["inputs_s"] = time.perf_counter() - t
    t = time.perf_counter()
    cell.warm()
    dev.sync()
    setup["warm_s"] = time.perf_counter() - t
    setup["setup_s"] = time.perf_counter() - T0
    from rescan_line_sted_torch.utils import observability

    setup.update(getattr(observability, "SETUP", {}))   # none before it

    window = closed_loop(cell, dev, SECONDS)
    clock = clocked(cell, dev, SECONDS)
    tr = trace.profile(cell.call, dev.sync, spec.workload["trace_calls"])
    line = {"workload": args.workload, "seed": args.seed, "card": card(),
            "setup": setup, "window": window, "clocked": clock,
            "traced": stage_split(tr), "span_cost_us": span_cost_us()}
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())

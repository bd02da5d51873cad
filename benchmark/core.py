"""The harness: one run of one cell, driven by data.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``. Its files are
found by name, and no list in the code names them:

* ``benchmark/workloads/<cell>.json``: its driver, its traffic parameters,
  the outputs it keeps for the check, the calls it traces and the limit
  of each number compared;
* ``benchmark/configs/<config>.json``: the sizes, as run;
* ``benchmark/drivers/<driver>.py``: ``Cell(config, workload, seed,
  device)`` with ``warm()``, ``call()``, ``clean()``, ``check(kept, clean,
  reference)`` and ``work`` (what one call completes);
* ``benchmark/reference/<driver>.py``: the plain reference ``check``
  compares with;
* ``benchmark/metrics/<metric>.py``: ``read(run) -> float | None`` for each
  metric the cell reports (``Run`` below); None leaves it out.

A run warms the cell's shapes (set-up), then calls the entry in a closed
loop for ``seconds``, each call ended by a synchronise, and keeps a
sample of its outputs drawn from the seed. A traced run then profiles a
few more calls (``trace.py``). After that the noise-free call, the
memory peak, the reference and the comparison.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import random
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
REPO = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "rescan_line_sted_tpu")


def load_module(path: Path, name: str):
    """A module from a file of the benchmark, by path."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Spec:
    """One cell's manifest entry and files."""

    name: str
    entry: dict
    workload: dict
    config: dict
    end_to_end: list
    per_layer: list

    def driver_path(self, bench: Path) -> Path:
        return bench / "drivers" / f"{self.workload['driver']}.py"

    def reference_path(self, bench: Path) -> Path:
        return bench / "reference" / f"{self.workload['driver']}.py"


def reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """Whether ``cell`` reports per-layer ``metric``: the cell is in the
    metric's ``workloads``, or the metric has none and the cell reports
    the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def load_spec(name: str, manifest: dict, bench: Path = BENCH) -> Spec:
    entry = next((w for w in manifest["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    workload = read_json(bench / "workloads" / f"{name}.json")
    config = read_json(bench.parent / conf["file"])
    e2e = [m for m in manifest["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"] if reports(m, name, names)]
    return Spec(name, entry, workload, config, e2e, per_layer)


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""

    spec: Spec
    setup_s: float
    window_s: float
    calls: int
    call_s: list
    issue_s: list
    work: dict
    trace: object = None


class Device:
    """The device the run drives: its synchronise and its readings."""

    def __init__(self, name: str):
        import torch

        self.torch = torch
        self.device = torch.device(name)
        self.cuda = self.device.type == "cuda"
        if self.cuda:       # the allocator exists once the card is in use
            torch.empty(1, device=self.device)
            torch.cuda.reset_peak_memory_stats(self.device)

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize(self.device)

    def info(self, chips: int) -> dict:
        if not self.cuda:
            return {"platform": "cpu", "kind": "cpu", "count": 1,
                    "memory_peak_bytes": 0}
        return {"platform": "gpu",
                "kind": self.torch.cuda.get_device_name(self.device),
                "count": chips,
                "memory_peak_bytes": int(
                    self.torch.cuda.max_memory_allocated(self.device))}


def run(name: str, seed: int, seconds: float, trace: bool, device: str,
        t0: float, manifest: dict | None = None, bench: Path = BENCH,
        patch=None) -> dict:
    """One run of cell ``name``; returns the result's fields, ``checks``
    last. ``patch(cell)``, where given, may replace parts of the cell
    before set-up (the harness's own tests plant faults with it)."""
    manifest = manifest or read_json(bench.parent / "BENCHMARK.json")
    spec = load_spec(name, manifest, bench)
    dev = Device(device)
    driver = load_module(spec.driver_path(bench),
                         f"bench_driver_{spec.workload['driver']}")
    cell = driver.Cell(spec.config, spec.workload, seed, dev.device)
    if patch is not None:
        patch(cell)
    cell.warm()
    dev.sync()
    setup_s = time.perf_counter() - t0

    keep = spec.workload["keep"]
    rng = random.Random(seed)
    kept, call_s, issue_s = [], [], []
    start = time.perf_counter()
    end = start
    while end - start < seconds:
        t_call = time.perf_counter()
        out = cell.call()
        t_issued = time.perf_counter()
        dev.sync()
        end = time.perf_counter()
        call_s.append(end - t_call)
        issue_s.append(t_issued - t_call)
        n = len(call_s)                       # a sample drawn from the seed
        if n <= keep:
            kept.append(out)
        elif rng.random() < keep / n:
            kept[rng.randrange(keep)] = out
        del out
    r = Run(spec, setup_s, end - start, len(call_s), call_s, issue_s,
            dict(cell.work))
    if trace:
        from benchmark import trace as tracing

        r.trace = tracing.profile(cell.call, dev.sync,
                                  spec.workload["trace_calls"])
    clean = cell.clean()
    dev.sync()
    device_info = dev.info(spec.entry["chips"])
    if r.trace is not None:
        device_info["busy_s"] = r.trace.busy_s
        device_info["window_s"] = r.trace.window_s

    reference = load_module(spec.reference_path(bench),
                            f"bench_reference_{spec.workload['driver']}")
    rows = cell.check(kept, clean, reference)
    limits = spec.workload["limits"]
    checks = {k: {"value": v, "limit": limits[k]}
              for k, v in worst(rows).items()}
    failed = sum(any(not float(v) <= limits[k] for k, v in row.items())
                 for row in rows)                     # NaN fails
    correct = failed == 0 and set(limits) <= set(checks)

    metrics = {}
    for m in (spec.per_layer if trace else spec.end_to_end):
        reader = load_module(bench / "metrics" / f"{m['name']}.py",
                             "bench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(r)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": r.calls, "failed": failed,
              "metrics": metrics, "device": device_info}
    if r.trace is not None:
        result["breakdown"] = r.trace.breakdown()
    result["checks"] = checks
    return result


def worst(rows: list[dict]) -> dict:
    """Each compared number's worst reading over the rows (NaN, once
    read, stays)."""
    out: dict = {}
    for row in rows:
        for k, v in row.items():
            v, w = float(v), out.get(k, -math.inf)
            out[k] = v if math.isnan(v) or v > w else w
    return out


def forbidden_modules() -> list[str]:
    """Modules of JAX or of the JAX package loaded in this process, by
    whole top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})

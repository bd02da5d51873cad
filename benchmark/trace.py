"""The traced stretch of a run: ``torch.profiler`` over a few steady calls
after the measured window, read from its Chrome trace.

Each call runs inside the benchmark's own host spans, ``bench.call``
around ``bench.issue`` (the entry, up to its return) and ``bench.sync``
(the synchronise that ends it). From the trace:

* the device's operations (kernels, copies, fills), their busy time as
  the union of their intervals, and the stretch from the first call's
  start to the last call's end;
* the kernels by name (``kernel_s``, ``kernel_count``);
* the host's reads from the device and synchronisations outside
  ``bench.sync`` (``syncs``): device-to-host copies, and CUDA runtime
  calls that wait (``cuda*Synchronize``, blocking ``cudaMemcpy``);
* ``breakdown``: the device operations that took most time (seconds per
  call), and the longest idle gaps, each labelled by the benchmark's span
  open in the gap's middle and the outermost operator the host was in.
"""

from __future__ import annotations

import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WAITS = ("cudaDeviceSynchronize", "cudaStreamSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")
SPANS = ("bench.issue", "bench.sync")


def profile(call, sync, calls: int) -> "Trace":
    """``calls`` calls of ``call`` under the profiler, after one traced
    call that is thrown away (the profiler's own start-up)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from torch.profiler import record_function

    def stretch(n):
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                with record_function("bench.call"):
                    with record_function("bench.issue"):
                        out = call()
                    with record_function("bench.sync"):
                        sync()
                del out
        return prof

    stretch(1)
    prof = stretch(calls)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return Trace(events, calls)


class Trace:
    def __init__(self, events: list, calls: int):
        self.calls = calls
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        spans = [e for e in xs if e.get("name") == "bench.call"
                 and e.get("cat") == "user_annotation"]
        t0 = min(e["ts"] for e in spans)
        t1 = max(e["ts"] + e["dur"] for e in spans)
        self.window_s = (t1 - t0) * 1e-6
        dev = [e for e in xs
               if e.get("cat") in DEVICE_CATS and t0 <= e["ts"] < t1]
        self.device_ops = [(e["name"], e["ts"], e["dur"]) for e in dev]
        self.kernels = [(e["name"], e["ts"], e["dur"]) for e in dev
                        if e["cat"] == "kernel"]
        self._host = [e for e in xs if e.get("cat") in (
            "cpu_op", "user_annotation")]
        self.busy = _union([(ts, min(ts + d, t1)) for _, ts, d
                            in self.device_ops])
        self.busy_s = sum(b - a for a, b in self.busy) * 1e-6
        self._t = (t0, t1)
        waits = [e for e in xs if e.get("cat") == "cuda_runtime"
                 and e.get("name") in WAITS and t0 <= e["ts"] < t1]
        in_sync = [(e["ts"], e["ts"] + e["dur"]) for e in self._host
                   if e["name"] == "bench.sync"]
        self.syncs = sum(1 for e in waits
                         if not any(a <= e["ts"] <= b for a, b in in_sync))
        self.syncs += sum(1 for name, _, _ in self.device_ops
                          if "DtoH" in name)

    def kernel_s(self, *names) -> float:
        """Device seconds of the kernels whose name holds any of ``names``
        (every kernel without ``names``)."""
        return 1e-6 * sum(d for n, _, d in self.kernels
                          if not names or any(k in n for k in names))

    def kernel_count(self, *names) -> int:
        return sum(1 for n, _, _ in self.kernels
                   if not names or any(k in n for k in names))

    def breakdown(self) -> dict:
        by_name: dict = {}
        for n, _, d in self.device_ops:
            by_name[n] = by_name.get(n, 0.0) + d * 1e-6 / self.calls
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        t0, t1 = self._t
        edges = [t0] + [x for iv in self.busy for x in iv] + [t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        return {"device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": [[self._label((a + b) / 2), (b - a) * 1e-6]
                              for a, b in gaps]}

    def _label(self, t: float) -> str:
        """The benchmark's span open at ``t`` (a gap's middle) and the
        outermost operator the host was in then."""
        open_at = [e for e in self._host if e["ts"] <= t < e["ts"] + e["dur"]]
        span = next((e["name"] for e in open_at if e["name"] in SPANS),
                    "bench.loop")
        ops = [e for e in open_at if e.get("cat") == "cpu_op"]
        if not ops:
            return span
        return f"{span}/{min(ops, key=lambda e: e['ts'])['name']}"[:120]


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out

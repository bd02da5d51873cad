"""The reader of ``fft_placements_per_call.fusion`` on synthetic traces:
the closed form's FFT placements (``rls.image.fft_placement``) per fused
call, None without a trace or where the program records no such span."""

import json
from pathlib import Path

from benchmark import core, trace

REPO = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = "fft_placements_per_call.fusion"


def _x(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _read(events, calls):
    reader = core.load_module(core.BENCH / "metrics" / f"{NAME}.py",
                              "bench_metric_fft_placements")
    spec = core.load_spec("fusion_rescan_2048", MANIFEST)
    run = core.Run(spec, 1.0, 1.0, calls, [], [], {"sweeps": 1},
                   trace=None if events is None else trace.Trace(events,
                                                                 calls))
    return reader.read(run)


def test_none_without_a_trace():
    assert _read(None, 1) is None


def test_none_on_a_trace_without_the_span():
    """A fused call whose placement is the phase-table product: the
    operator RL's span and the card's work, no FFT placement."""
    events = [_x("bench.call", 0, 100), _x("rls.fusion.operator", 10, 80),
              _x("rls.image.products", 20, 10), _x("k", 20, 50, "kernel")]
    assert _read(events, 1) is None


def test_placements_on_two_fused_calls():
    """Two calls: the acquisition's placement, then the normaliser's and
    two iterations' inside the operator RL, four a call."""
    events = []
    for t in (0, 1000):
        events += [_x("bench.call", t, 1000),
                   _x("rls.fusion.acquire", t, 50),
                   _x("rls.image.fft_placement", t + 10, 5),
                   _x("rls.fusion.operator", t + 100, 800)]
        events += [_x("rls.image.fft_placement", t + 150 + 200 * k, 20)
                   for k in range(3)]
    events += [_x("k", 10, 600, "kernel"), _x("k", 1100, 300, "kernel")]
    assert _read(events, 2) == 4.0

"""The yardstick's arithmetic: the frozen band windows against the rescan
engine's routing today, the work counts against their known values, and
the trace's reduction on a synthetic Chrome trace."""

import json
import math
from pathlib import Path

import pytest

from benchmark import core, readers, work
from benchmark.trace import Trace

REPO = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
RESCAN = [w["name"] for w in MANIFEST["workloads"]
          if json.loads((REPO / "benchmark" / "workloads"
                         / f"{w['name']}.json").read_text())["driver"]
          == "rescan_image"]


def _port_windows(config, traffic):
    from rescan_line_sted_torch import Grid, LineSTEDParams, RescanGeometry
    from rescan_line_sted_torch.imaging.rescan import _k1_windows

    params = LineSTEDParams.create(sigma_exc=config["sigma_exc"],
                                   sigma_det=config["sigma_det"])
    geom = RescanGeometry(Grid(*config["field"]),
                          rescan_factor=float(traffic["rescan_factor"]),
                          binning=config["binning"], chunk=config["chunk"])
    return _k1_windows(params, geom, traffic["reassignment"])


@pytest.mark.parametrize("cell", RESCAN)
def test_frozen_windows_match_the_routing_on_each_cell(cell):
    spec = core.load_spec(cell, MANIFEST)
    traffic = spec.workload["traffic"]
    port = _port_windows(spec.config, traffic)
    mine = work.k1_windows(spec.config, traffic)
    assert port is not None and mine is not None
    d_in, d_out, pq = port
    assert mine[:2] == (d_in, d_out)
    assert mine[2] == ("nufft" if pq is None else "class")
    assert mine[3] == (2 if pq is None else pq[1])


@pytest.mark.parametrize("size, r, b, sigma_exc, reassignment", [
    (2048, 2.0, 1, 3.0, "auto"), (512, 3.0, 2, 3.0, "auto"),
    (2048, 1.0 + math.pi / 16, 1, 8.0, "auto"), (512, 1.0 + math.pi / 8, 2, 3.0,
                                                 "auto"),
    (2048, 1.5, 1, 3.0, "rounded"), (1024, 1.25, 1, 5.0, "subpixel")])
def test_frozen_windows_match_the_routing_elsewhere(size, r, b, sigma_exc,
                                                    reassignment):
    config = dict(field=[size, size], chunk=32, binning=b, sigma_exc=sigma_exc,
                  sigma_det=3.0)
    traffic = dict(rescan_factor=r, reassignment=reassignment)
    port, mine = _port_windows(config, traffic), work.k1_windows(config,
                                                                 traffic)
    assert (port is None) == (mine is None)
    if port is not None:
        assert mine[:2] == port[:2]
        assert mine[2:] == (("nufft", 2) if port[2] is None
                            else ("class", port[2][1]))


def test_flagship_bound():
    spec = core.load_spec("rescan_2048_per_step", MANIFEST)
    n = work.k1_work(spec.config, spec.workload["traffic"])
    # 2048 positions x 49 lit columns x 49 detection taps x 2048 rows
    assert n["conv"] == 2048 * 49 * 49 * 2048        # 10.07 G
    assert n["taps"] == 0
    assert n["bytes"] == 4 * (2048 * 2048 + 2048 * 3072)
    least = work.k1_least_s(spec.config, spec.workload["traffic"])
    assert least == pytest.approx(6 * 10.07e9 / 495e12, rel=1e-3)  # 0.122 ms
    nufft = core.load_spec("rescan_2048_irrational", MANIFEST)
    m = work.k1_work(nufft.config, nufft.workload["traffic"])
    assert m["taps"] == 2048 * 97 * 2048 * 8          # 97 columns lit
    t = work.k1_least_s(nufft.config, nufft.workload["traffic"])
    assert t == pytest.approx(6 * (10.07e9 + 3.255e9) / 495e12, rel=1e-3)


def test_k1_bound_counts_the_function_not_the_windows():
    """Widening the Gaussians widens the count; the band windows' padding
    to 128 columns does not enter it."""
    spec = core.load_spec("rescan_2048_per_step", MANIFEST)
    traffic = spec.workload["traffic"]
    wide = dict(spec.config, sigma_exc=8.0)
    lit = 2 * work.support(8.0) + 1
    assert work.k1_windows(wide, traffic)[:2] != work.k1_windows(
        spec.config, traffic)[:2]
    assert work.k1_work(wide, traffic)["conv"] == 2048 * lit * 49 * 2048


def test_k2c_bound_is_bytes():
    spec = core.load_spec("rescan_2048_analytic", MANIFEST)
    assert work.k2c_least_s(spec.config, spec.workload["traffic"]) == \
        pytest.approx(8 * 2048 * 3072 / 3.35e12)


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _synthetic():
    """Two calls of 100 us each, the card busy 30 + 20 us in the first
    and 40 in the second, with one read-back inside the entry."""
    ev = []
    for t in (1000.0, 1100.0):
        ev += [_ev("bench.call", "user_annotation", t, 100),
               _ev("bench.issue", "user_annotation", t, 60),
               _ev("aten::mm", "cpu_op", t + 5, 50),
               _ev("bench.sync", "user_annotation", t + 60, 40),
               _ev("cudaDeviceSynchronize", "cuda_runtime", t + 61, 38)]
    ev += [_ev("void rescan_banded_fused_kernel<1>(K1Args)", "kernel", 1010, 30),
           _ev("poisson_flat_kernel", "kernel", 1050, 20),
           _ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 1060, 1),
           _ev("cudaStreamSynchronize", "cuda_runtime", 1020, 30),
           _ev("void rescan_banded_fused_kernel<1>(K1Args)", "kernel", 1130, 40),
           _ev("outside", "kernel", 5000, 10)]
    return Trace(ev, calls=2)


def test_trace_reduction():
    t = _synthetic()
    assert t.window_s == pytest.approx(200e-6)
    assert t.busy_s == pytest.approx(90e-6)      # the copy lies in the fill
    assert t.kernel_count() == 3
    assert t.kernel_s("rescan_banded_fused") == pytest.approx(70e-6)
    assert t.syncs == 2                           # one wait, one read-back
    b = t.breakdown()
    assert b["device_ops"][0] == ["void rescan_banded_fused_kernel<1>(K1Args)",
                                  pytest.approx(35e-6)]
    gaps = [(round(s * 1e6), label) for label, s in b["idle_gaps"]]
    assert gaps[:2] == [(60, "bench.issue"), (30, "bench.sync")]
    assert gaps[2:] == [(10, "bench.issue/aten::mm")] * 2
    assert len(b["idle_gaps"]) <= 10 and len(b["device_ops"]) <= 10


def test_readers_on_a_trace():
    spec = core.load_spec("rescan_2048_per_step", MANIFEST)
    run = core.Run(spec, 1.0, 1.0, 2, [0.1, 0.1], [0.05, 0.07], {"steps": 2048},
                   trace=_synthetic())
    assert readers.device_idle(run) == pytest.approx(55.0)
    assert readers.kernels_per_call(run) == 1.5
    assert readers.syncs_per_call(run) == 1.0
    k1 = readers.roofline(run, work.k1_least_s, ("rescan_banded_fused",))
    assert k1 == pytest.approx(100 * work.k1_least_s(
        spec.config, spec.workload["traffic"]) / 35e-6)
    assert readers.roofline(run, work.k1_least_s, ("absent",)) is None
    run.trace = None
    assert readers.device_idle(run) is None
    assert readers.kernels_per_call(run) is None

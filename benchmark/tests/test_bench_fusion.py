"""The ``fusion_rescan_2048`` cell's pieces on the CPU: the fusion's work
count from the configuration alone, its faults, its TF32 control, and the
readers of its per-layer metrics on synthetic traces. (Each fault's run at
the small field is in ``test_bench_faults.py``, the readings in
``test_bench_card.py``: both take every cell.)"""

import json
from pathlib import Path

import pytest

from benchmark import core, fusion_work, trace

REPO = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
CELL = "fusion_rescan_2048"
READERS = ("fusion_roofline", "adjoints_per_call.fusion")


def _spec():
    return core.load_spec(CELL, MANIFEST)


def test_flagship_work_by_hand():
    """Four views at 2048^2, R = 2, 50 iterations: per sample pixel, view
    and application 4 rotation taps, 49 detection taps and 49 + 48 canvas
    taps; 2 x 50 + 2 applications: ~257 G FMA, three TF32 passes 3.11 ms
    against 2.50 ms of bytes (the canvases read and the estimate read and
    written each iteration)."""
    spec = _spec()
    n = fusion_work.fusion_work(spec.config)
    assert n["fma"] == 102 * 4 * 2048 * 2048 * (4 + 49 + 97)
    assert n["fma"] == pytest.approx(256.7e9, rel=1e-3)
    assert n["bytes"] == 50 * 4 * (4 * 2048 * 4096 + 2 * 2048 * 2048)
    least = fusion_work.fusion_least_s(spec.config, spec.workload["traffic"])
    assert least == pytest.approx(6 * 256.7e9 / 495e12, rel=1e-3)
    assert n["bytes"] / 3.35e12 == pytest.approx(2.504e-3, rel=1e-3)


def test_work_is_the_configurations_alone():
    """A wider excitation, another R or fewer iterations change the count
    by the formula; the module reads no program code."""
    cfg = _spec().config
    base = fusion_work.fusion_work(cfg)["fma"]
    wide = dict(cfg, line=dict(cfg["line"], sigma_exc=8.0))
    taps = 4 + 49 + (49 + 2 * (52 + 5))
    assert fusion_work.fusion_work(wide)["fma"] == 102 * 4 * 2048 ** 2 * taps
    r3 = dict(cfg, rescan=dict(cfg["rescan"], rescan_factor=3.0))
    assert fusion_work.fusion_work(r3)["fma"] == \
        102 * 4 * 2048 ** 2 * (4 + 49 + 49 + 2 * 48)
    short = dict(cfg, fusion_iters=10)
    assert fusion_work.fusion_work(short)["fma"] == base * 22 / 102
    source = Path(fusion_work.__file__).read_text()
    assert "import rescan_line_sted_torch" not in source
    assert "from rescan_line_sted_torch" not in source


def test_the_faults_cover_the_new_mechanism():
    spec = _spec()
    driver = core.load_module(spec.driver_path(core.BENCH),
                              "bench_driver_fusion_image")
    assert set(driver.FAULTS) == {"unchanged", "half_batch", "altered",
                                  "no_draws", "rl_short", "adjoint_rotated"}


def test_control_fails_the_noise_free_checks(small_tree):
    """The reference one step below the configuration's precision (TF32
    products) in the program's place, at the small field: its canvases and
    its fused image read above their limits."""
    manifest, bench = small_tree
    spec = core.load_spec(CELL, manifest, bench)
    driver = core.load_module(spec.driver_path(bench), "bench_fusion_drv")
    reference = core.load_module(spec.reference_path(bench),
                                 "bench_fusion_ref")
    cell = driver.Cell(spec.config, spec.workload, 7, "cpu")
    got = core.worst(cell.control(reference))
    limits = spec.workload["limits"]
    assert got["canvas_err"] > 3 * limits["canvas_err"]
    assert got["image_err"] > 3 * limits["image_err"]


def _x(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _read(name, events, calls):
    reader = core.load_module(core.BENCH / "metrics" / f"{name}.py",
                              "bench_metric_" + name.replace(".", "_"))
    run = core.Run(_spec(), 1.0, 1.0, calls, [], [], {"sweeps": 1},
                   trace=None if events is None else trace.Trace(events,
                                                                 calls))
    return reader.read(run)


@pytest.mark.parametrize("name", READERS)
def test_reader_is_none_without_a_trace(name):
    assert _read(name, None, 1) is None


def test_adjoints_are_none_on_a_parents_trace():
    """A parent's fused call: the operator RL's span and the card's work,
    no adjoint counter."""
    events = [_x("bench.call", 0, 100), _x("rls.fusion.operator", 10, 80),
              _x("k", 20, 50, "kernel")]
    assert _read("adjoints_per_call.fusion", events, 1) is None


def test_readers_on_two_fused_calls():
    """Two calls of 1000 us: the card busy 600 + 300 us, each call with
    its operator RL and three adjoint applications."""
    events = []
    for t in (0, 1000):
        events += [_x("bench.call", t, 1000), _x("rls.fusion.acquire", t, 50),
                   _x("rls.fusion.operator", t + 100, 800)]
        events += [_x("rls.fusion.adjoint", t + 100 + 200 * k, 20)
                   for k in range(3)]
    events += [_x("k", 10, 600, "kernel"), _x("k", 1100, 300, "kernel")]
    assert _read("adjoints_per_call.fusion", events, 2) == 3.0
    least = fusion_work.fusion_least_s(_spec().config, {})
    assert _read("fusion_roofline", events, 2) == pytest.approx(
        100.0 * least / 450e-6)

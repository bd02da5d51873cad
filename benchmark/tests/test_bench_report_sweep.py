"""The ``report_sweep`` cell's pieces on the CPU: its plain reference
against the per-position oracle (``tests/oracle/oracle.py``), its faults,
its TF32 control, and the readers of its per-layer metrics on synthetic
traces. (Each fault's run at the small field is in
``test_bench_faults.py``, the readings in ``test_bench_card.py``: both
take every cell.)"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import compare, core, trace
from benchmark.reference import plain, report_sweep

REPO = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
CELL = "report_sweep_192"
F64 = plain.Precision("float64")
READERS = ("restore_ms.report", "restore_idle.report", "ism_ms.report",
           "rescan_ms.report", "frc_ms.report",
           "operator_builds_per_call.report")


def _oracle():
    spec = importlib.util.spec_from_file_location(
        "bench_oracle", REPO / "tests" / "oracle" / "oracle.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _interior(n=32):
    """A sample zero within ~PSF support of every edge."""
    s = np.zeros((n, n))
    s[12:20, 13:21] = np.random.default_rng(0).uniform(0.2, 1.0, (8, 8))
    return s


def test_rl_is_the_oracles():
    """Multi-view RL on positive data, where the guard never acts: the
    oracle's update from the data's mean."""
    gen = torch.Generator().manual_seed(5)
    psfs = torch.stack([
        plain.gaussian(plain.coords(24, "cpu"), s)[:, None]
        * plain.gaussian(plain.coords(24, "cpu"), 2.0)[None, :]
        for s in (1.0, 2.5)])
    data = 1.0 + torch.rand(2, 24, 24, generator=gen, dtype=torch.float64)
    got = report_sweep.richardson_lucy(data, psfs, 7, F64)
    want = _oracle().richardson_lucy(data.numpy(), psfs.numpy(), 7)
    assert compare.rel_err(got, torch.from_numpy(want)) < 1e-12


def test_rescan_canvas_is_the_oracles_scan():
    """The canvas map at R = 2 against the per-position scan with rounded
    reassignment, on a sample and widths whose tails reach round neither
    ring."""
    cfg = dict(sigma_exc=1.5, sigma_det=1.0, stripe_period=12.0)
    sample = _interior()
    cmap = report_sweep.CanvasMap(32, 32, cfg, 4.0, 3.0, 2.0, "cpu", F64)
    want = _oracle().rescanned_line_sted_image(
        sample, depletion=4.0, brightness=3.0, rescan_factor=2.0,
        reassignment="rounded", **cfg)
    assert compare.rel_err(cmap(torch.from_numpy(sample)),
                           torch.from_numpy(want)) < 1e-12


def test_ism_canvas_is_the_oracles_scan():
    widths = dict(sigma_exc=1.5, sigma_det=1.0, sigma_dep=1.5)
    sample = _interior()
    want = _oracle().rescanned_point_sted_image(
        sample, depletion=4.0, brightness=2.0, rescan_factor=2.0,
        reassignment="rounded", **widths)
    got = report_sweep.ism_canvas(torch.from_numpy(sample), widths, 4.0,
                                  2.0, 2.0, F64)
    assert compare.rel_err(got, torch.from_numpy(want)) < 1e-12


def test_the_faults_cover_the_new_mechanism():
    spec = core.load_spec(CELL, MANIFEST)
    driver = core.load_module(spec.driver_path(core.BENCH),
                              "bench_driver_report_sweep")
    assert set(driver.FAULTS) == {"unchanged", "half_batch", "altered",
                                  "no_draws", "rl_short", "frc_one_draw",
                                  "frc_unscaled", "frc_rings"}


def test_frc_gap_reads_a_scale_and_not_the_scatter():
    """``frc_gap``'s test on two sets of log resolutions: sets drawn alike
    (10% scatter) read under 3 standard errors, one of them scaled by 2
    (ISM's division by R left out) above 20; resolutions that never cross
    read as Nyquist, alike on both sides: 0."""
    spec = core.load_spec(CELL, MANIFEST)
    driver = core.load_module(spec.driver_path(core.BENCH),
                              "bench_driver_report_sweep")
    rng = np.random.default_rng(3)
    got = 10.0 * np.exp(rng.normal(0.0, 0.1, (6, 6)))
    want = 10.0 * np.exp(rng.normal(0.0, 0.1, (8, 6)))
    assert driver._log_gap_z(got, want, 2.0) < 3.0
    assert driver._log_gap_z(2.0 * got, want, 2.0) > 20.0
    never = np.full((6, 6), np.nan)
    assert driver._log_gap_z(never, np.full((8, 6), 2.0), 2.0) == 0.0


def test_control_fails_by_a_limit_its_ledgers_do_not(small_tree):
    """The reference one step below the configuration's precision (TF32
    products) in the program's place, at the small field: its restored
    images and point responses read above their limits; its ledgers, which
    TF32 does not reach, under theirs."""
    manifest, bench = small_tree
    spec = core.load_spec(CELL, manifest, bench)
    driver = core.load_module(spec.driver_path(bench), "bench_report_drv")
    reference = core.load_module(spec.reference_path(bench),
                                 "bench_report_ref")
    cell = driver.Cell(spec.config, spec.workload, 7, "cpu")
    got = core.worst(cell.control(reference))
    limits = spec.workload["limits"]
    assert got["image_err"] > limits["image_err"]
    assert got["fwhm_err"] > limits["fwhm_err"]
    assert got["ledger_err"] < limits["ledger_err"]


def _x(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _read(name, events, calls):
    reader = core.load_module(core.BENCH / "metrics" / f"{name}.py",
                              "bench_metric_" + name.replace(".", "_"))
    run = type("Run", (), {"trace": trace.Trace(events, calls=calls)})()
    return reader.read(run)


@pytest.mark.parametrize("name", READERS)
def test_reader_is_none_without_its_span(name):
    """A parent's trace: the sweep's spans and kernels, none of the new."""
    events = [_x("bench.call", 0, 100), _x("rls.sweep", 0, 90),
              _x("rls.sweep.point", 5, 40), _x("k", 10, 20, "kernel")]
    assert _read(name, events, 1) is None


def test_readers_on_a_sweep_with_the_spans():
    """One sweep, 0-200 us: RL at 10-50 and operator RL at 110-150 (inside
    ``rls.sweep.rescan`` 100-180, with two builds), ISM at 60-90, two FRCs
    of 5 us; kernels at 20-30 and 120-160."""
    events = [_x("bench.call", 0, 200), _x("rls.sweep", 0, 190),
              _x("rls.fusion.rl", 10, 40), _x("rls.sweep.ism", 60, 30),
              _x("rls.frc", 80, 5), _x("rls.sweep.rescan", 100, 80),
              _x("rls.fusion.build", 102, 3), _x("rls.fusion.build", 106, 3),
              _x("rls.fusion.operator", 110, 40), _x("rls.frc", 160, 5),
              _x("k", 20, 10, "kernel"), _x("k", 120, 40, "kernel")]
    assert _read("restore_ms.report", events, 1) == pytest.approx(0.08)
    # idle under RL: 10-20, 30-50 and 110-120: 40 of 200 us
    assert _read("restore_idle.report", events, 1) == pytest.approx(20.0)
    assert _read("ism_ms.report", events, 1) == pytest.approx(0.03)
    assert _read("rescan_ms.report", events, 1) == pytest.approx(0.08)
    assert _read("frc_ms.report", events, 1) == pytest.approx(0.01)
    assert _read("operator_builds_per_call.report", events, 1) == 2.0

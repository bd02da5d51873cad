"""The plain references against the per-position float64 oracle
(``tests/oracle/oracle.py``) and against the port's ``device="cpu"`` path
at small sizes; their TF32 controls read far above each limit there."""

import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import compare, core, samples
from benchmark.reference import dose_sweep, rescan_image

REPO = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
IRRATIONAL = 1.0 + math.pi / 16


def _oracle():
    spec = importlib.util.spec_from_file_location(
        "bench_oracle", REPO / "tests" / "oracle" / "oracle.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _limit(cell, name):
    return core.load_spec(cell, MANIFEST).workload["limits"][name]


def _line_config(size):
    cfg = dict(core.load_spec("rescan_2048_per_step", MANIFEST).config)
    cfg["field"] = [size, size]
    return cfg


@pytest.mark.parametrize("r, reassignment", [(1.5, "subpixel"),
                                             (2.0, "rounded"),
                                             (IRRATIONAL, "subpixel")])
def test_scan_reference_is_the_oracles_per_position_scan(r, reassignment):
    cfg = _line_config(64)
    sample = samples.siemens_star((64, 64), "cpu")
    want = _oracle().rescanned_line_sted_image(
        sample.double().numpy(), sigma_exc=cfg["sigma_exc"],
        sigma_det=cfg["sigma_det"], stripe_period=cfg["stripe_period"],
        depletion=cfg["depletion"], brightness=cfg["brightness"],
        rescan_factor=r, reassignment=reassignment)
    got = rescan_image.canvas_mean(sample, cfg, dict(
        method="scan", rescan_factor=r, reassignment=reassignment))
    assert compare.rel_err(got, torch.from_numpy(want)) < 1e-12


def _port_canvas(cfg, traffic, sample):
    from rescan_line_sted_torch import (Grid, LineSTEDParams,
                                        RescanGeometry,
                                        rescanned_line_sted_image)

    params = LineSTEDParams.create(**{k: cfg[k] for k in (
        "sigma_exc", "sigma_det", "stripe_period", "depletion",
        "slit_halfwidth", "brightness")})
    geom = RescanGeometry(Grid(*cfg["field"]),
                          rescan_factor=traffic["rescan_factor"], chunk=32)
    return rescanned_line_sted_image(
        sample, params, geom, method=traffic["method"],
        noise_mode=traffic["noise_mode"], device="cpu").image


@pytest.mark.parametrize("method, r", [("scan", 1.5), ("scan", IRRATIONAL),
                                       ("scan", 2.0), ("analytic", 1.5),
                                       ("analytic", IRRATIONAL)])
def test_rescan_reference_against_the_port_on_the_cpu(method, r):
    cfg = _line_config(256)
    traffic = dict(method=method, noise_mode="per_step", rescan_factor=r,
                   reassignment="auto")
    sample = samples.siemens_star((256, 256), "cpu")
    want = rescan_image.canvas_mean(sample, cfg, traffic)
    limit = _limit("rescan_2048_per_step", "mean_err")
    assert compare.rel_err(_port_canvas(cfg, traffic, sample), want) < limit
    control = rescan_image.canvas_mean(sample, cfg, traffic, "tf32")
    assert compare.rel_err(control, want) > limit


def test_sweep_reference_is_the_oracles_descanned_scans():
    cfg = core.load_spec("dose_sweep_256", MANIFEST).config
    oracle = _oracle()
    sample = samples.siemens_star((32, 32), "cpu")
    s = float(np.float32(16 / 7))
    ref = dose_sweep.sweep(sample, dict(cfg, field=[32, 32]), [s])
    for arm, run in (("point", oracle.point_sted_image),
                     ("line", oracle.line_sted_image)):
        kw = {k: v for k, v in cfg[arm].items() if k != "brightness"}
        bright = cfg[arm]["brightness"] * float(ref[arm]["exposure"][0])
        want = run(sample.double().numpy(), depletion=s, brightness=bright,
                   **kw)
        assert compare.rel_err(ref[arm]["image"][0],
                               torch.from_numpy(want)) < 1e-12


def test_sweep_reference_against_the_port_on_the_cpu():
    from rescan_line_sted_torch import (Grid, LineSTEDGeometry,
                                        LineSTEDParams, PointSTEDGeometry,
                                        PointSTEDParams)
    from rescan_line_sted_torch.sweeps import dose_matched_sweep

    cfg = dict(core.load_spec("dose_sweep_256", MANIFEST).config,
               field=[64, 64])
    limits = core.load_spec("dose_sweep_256", MANIFEST).workload["limits"]
    sample = samples.siemens_star((64, 64), "cpu")
    powers = np.linspace(0, 16, 8).astype(np.float32).tolist()
    grid = Grid(64, 64)
    got = dose_matched_sweep(
        sample, PointSTEDParams.create(**cfg["point"]),
        LineSTEDParams.create(**cfg["line"]), PointSTEDGeometry(grid),
        LineSTEDGeometry(grid), powers, cfg["dose_budget"], device="cpu")
    ref = dose_sweep.sweep(sample, cfg, powers)
    control = dose_sweep.sweep(sample, cfg, powers, "tf32")
    for arm in ("point", "line"):
        g, w = getattr(got, arm), ref[arm]
        for i in range(len(powers)):
            assert compare.rel_err(g.image[i], w["image"][i]) < \
                limits["image_err"]
        assert max(compare.rel_err(control[arm]["image"][i], w["image"][i])
                   for i in range(len(powers))) > limits["image_err"]
        for col in ("exposure", "emitted_signal", "num_steps"):
            assert compare.rel_err(getattr(g, col), w[col]) < \
                limits["ledger_err"]
        for col in ("fwhm_x", "fwhm_y"):
            gap = (getattr(g, col).double() - w[col]).abs().max()
            assert float(gap) < limits["fwhm_err"]


def test_poisson_numbers_separate_draws_from_their_absence():
    gen = torch.Generator().manual_seed(2**31 + 3)
    mean = torch.rand((128, 128), generator=gen, dtype=torch.float64) * 20 + 1
    counts = torch.poisson(mean, generator=gen)
    assert compare.total_z(counts, mean) < 5
    assert compare.dispersion_z(counts, mean) < 5
    assert compare.dispersion_z(mean, mean) > 50         # no draws
    assert compare.total_z(0 * mean, mean) > 100         # nothing placed
    assert compare.dispersion_z(compare.block_sums(counts, 4),
                                compare.block_sums(mean, 4)) < 5

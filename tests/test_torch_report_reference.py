"""The report's four-arm fused dose sweep on the port against the float64
plain reference of the benchmark (``benchmark/reference/report_sweep.py``),
and the reference's pieces against their definitions: the rotation's and
the canvas map's transposes, FRC, and the ISM canvas against the
per-position oracle (``tests/oracle/oracle.py``)."""

import functools
import math

import numpy as np
import pytest
import torch

from benchmark import compare, samples
from benchmark.reference import plain, report_sweep
from rescan_line_sted_torch import (
    Grid,
    LineSTEDGeometry,
    LineSTEDParams,
    PointSTEDGeometry,
    PointSTEDParams,
    RescanGeometry,
)
from rescan_line_sted_torch.algorithms.frc import frc_resolution
from rescan_line_sted_torch.config import RescanPointGeometry
from rescan_line_sted_torch.imaging import rescan_point
from rescan_line_sted_torch.imaging.rescan_point import (
    rescan_point_canvas_mean,
)
from rescan_line_sted_torch.sweeps import dose_matched_sweep
from tests.oracle import oracle

torch.set_num_threads(1)

F64 = plain.Precision("float64")
POINT = dict(sigma_exc=3.0, sigma_det=3.0, sigma_dep=3.0,
             pinhole_radius=4.0, brightness=1.0)
LINE = dict(sigma_exc=3.0, sigma_det=3.0, stripe_period=12.0,
            slit_halfwidth=4.0, brightness=1.0)
# the configuration's protocol at a CPU test's size: 48^2, two powers, a
# few RL iterations
CONFIG = dict(field=[48, 48], point=POINT, line=LINE, dose_budget=100.0,
              orientations=2, rescan=dict(rescan_factor=2.0, binning=1),
              ism=dict(rescan_factor=2.0, binning=1), fusion_iters=5)
POWERS = np.linspace(0.0, 16.0, 2).astype(np.float32).tolist()


@functools.lru_cache(maxsize=1)
def _sweeps():
    """The port's noise-free fused sweep and the reference's, once."""
    grid = Grid(*CONFIG["field"])
    sample = samples.siemens_star(tuple(CONFIG["field"]), "cpu")
    got = dose_matched_sweep(
        sample, PointSTEDParams.create(**POINT),
        LineSTEDParams.create(**LINE), PointSTEDGeometry(grid),
        LineSTEDGeometry(grid), POWERS, CONFIG["dose_budget"],
        orientations=CONFIG["orientations"],
        rescan_geom=RescanGeometry(grid, **CONFIG["rescan"]),
        ism_geom=RescanPointGeometry(grid, **CONFIG["ism"]),
        fuse_orientations=True, fusion_iters=CONFIG["fusion_iters"],
        device="cpu")
    return got, report_sweep.sweep(sample.double(), CONFIG, POWERS)


@pytest.mark.parametrize("arm", report_sweep.ARMS)
def test_fused_sweep_is_the_reference(arm):
    """Every column of each arm within 1e-5: the restored images (largest
    gap over the largest value), the ledgers (relative), the FWHMs of the
    restored point responses (px)."""
    got, want = _sweeps()
    got, want = getattr(got, arm), want[arm]
    for img, ref in zip(got.image, want["image"]):
        assert compare.rel_err(img, ref) < 1e-5
    for col in ("exposure", "emitted_signal", "num_steps"):
        assert compare.rel_err(getattr(got, col), want[col]) < 1e-5
    for col in ("fwhm_x", "fwhm_y"):
        gap = (getattr(got, col).double() - want[col]).abs().max()
        assert float(gap) < 1e-5


@pytest.mark.parametrize("theta", [0.0, math.pi / 2, math.pi / 3, -0.7])
def test_rotation_transpose_is_exact(theta):
    """``<R x, y> = <x, R^T y>`` to 1e-12, zero fill included (a 20 x 24
    field, where corners leave the grid)."""
    gen = torch.Generator().manual_seed(11)
    x = torch.rand(20, 24, generator=gen, dtype=torch.float64)
    y = torch.rand(20, 24, generator=gen, dtype=torch.float64)
    rot = report_sweep.Rotation(20, 24, theta, "cpu", F64)
    lhs, rhs = float((rot(x) * y).sum()), float((x * rot.T(y)).sum())
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


@pytest.mark.parametrize("r", [2.0, 1.5])
def test_canvas_map_transpose_is_exact(r):
    gen = torch.Generator().manual_seed(12)
    x = torch.rand(2, 16, 20, generator=gen, dtype=torch.float64)
    cmap = report_sweep.CanvasMap(16, 20, LINE, 4.0, 3.0, r, "cpu", F64)
    y = torch.rand(2, 16, cmap.wc, generator=gen, dtype=torch.float64)
    lhs, rhs = float((cmap(x) * y).sum()), float((x * cmap.T(y)).sum())
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


def _pair(seed, shape):
    """Two independent noisy acquisitions of one smooth random field."""
    gen = torch.Generator().manual_seed(seed)
    field = torch.rand(shape, generator=gen, dtype=torch.float64)
    kernel = plain.gaussian(plain.coords(shape[0], "cpu"), 1.5)[:, None] \
        * plain.gaussian(plain.coords(shape[1], "cpu"), 1.5)[None, :]
    mean = 200.0 * plain.convolve2(field, kernel / kernel.sum(), F64)
    return [torch.poisson(mean, generator=gen).float() for _ in range(2)]


@pytest.mark.parametrize("seed, shape", [(1, (48, 48)), (2, (64, 64)),
                                         (3, (64, 80))])
def test_frc_is_the_references(seed, shape):
    a, b = _pair(seed, shape)
    want = report_sweep.frc_resolution(a, b)
    assert 2.0 < want < math.inf
    assert float(frc_resolution(a, b)) == pytest.approx(want, rel=1e-5)


def test_frc_ends_are_the_references():
    """Identical images never fall below 1/7: NaN; anticorrelated ones
    start below: 2 px."""
    a, _ = _pair(4, (48, 48))
    assert math.isnan(report_sweep.frc_resolution(a, a))
    assert math.isnan(float(frc_resolution(a, a)))
    assert report_sweep.frc_resolution(a, -a) == 2.0
    assert float(frc_resolution(a, -a)) == 2.0


@pytest.mark.parametrize("who", ["reference", "port"])
def test_ism_canvas_is_the_oracles(who):
    """The ISM canvas at 32^2, R = 2, against the per-position scan with
    rounded reassignment (exact at R = 2), the reference to 1e-12 and the
    port to 1e-5: the scan wraps on the sample grid and the closed form on
    the canvas, so the sample is zero near every edge and the widths
    narrow enough that no tail reaches around either."""
    n, s = 32, 4.0
    widths = dict(sigma_exc=1.5, sigma_det=1.0, sigma_dep=1.5)
    sample = np.zeros((n, n))
    sample[12:20, 13:21] = np.random.default_rng(0).uniform(0.2, 1.0, (8, 8))
    want = torch.from_numpy(oracle.rescanned_point_sted_image(
        sample, depletion=s, brightness=2.0, rescan_factor=2.0,
        reassignment="rounded", **widths))
    if who == "reference":
        got = report_sweep.ism_canvas(torch.from_numpy(sample), widths, s,
                                      2.0, 2.0, F64)
        assert compare.rel_err(got, want) < 1e-12
    else:
        params = PointSTEDParams.create(depletion=s, brightness=2.0,
                                        **widths)
        got = rescan_point_canvas_mean(
            torch.from_numpy(sample).float(), params,
            RescanPointGeometry(Grid(n, n), rescan_factor=2.0))
        assert compare.rel_err(got, want) < 1e-5


@pytest.mark.parametrize("n, r", [(96, 2.0), (96, 1.5), (60, 1.25),
                                  (50, 1.33)])
def test_ism_placed_spectrum_is_its_definition(n, r):
    """``S_R(k) = sum_a sample[a] exp(-2i pi k R a / Nc)`` against its
    complex128 sum: read from the sample's FFT where the canvas is exactly
    R times the field (2, 1.5, 1.25 here), to 1e-7 of its largest value,
    where the products against the phase tables carry ~1.4e-7 at 96^2 and
    ~4e-7 at 192^2; by those products elsewhere (R = 1.33: a 66.5 px
    canvas rounds to 66)."""
    geom = RescanPointGeometry(Grid(n, n), rescan_factor=r)
    hc, wc = geom.canvas_shape
    sample = torch.rand(n, n, generator=torch.Generator().manual_seed(9))
    m = np.arange(n)
    py = np.exp(-2j * np.pi * np.arange(hc)[None, :] * r * m[:, None] / hc)
    px = np.exp(-2j * np.pi * np.arange(wc // 2 + 1)[None, :] * r
                * m[:, None] / wc)
    want = torch.from_numpy(py.T @ sample.double().numpy() @ px)
    tables = rescan_point._tables(geom, "cpu")
    got = rescan_point._placed_spectrum(sample, geom, *tables[:2])
    err = (got.to(torch.complex128) - want).abs().max() / want.abs().max()
    assert float(err) < (1e-7 if r * n == hc else 1e-6)

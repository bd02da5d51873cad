"""Port parity of rescanned point-STED (ISM, ``imaging/rescan_point.py``)
against the JAX package, on the same numpy inputs at the JAX suite's sizes
(32^2, 48^2).

Noise-free agreement: max|port - jax| / max|jax| <= 1e-5 (analytic at
b = 1 and 2 for several rescan factors, the scan with rounded and subpixel
placement, the system kernel, the rescan factors, the padded and apodized
boundaries). The per-step route draws every frame with K2b (its plain
version here): it runs with the sampler replaced by the identity against
the JAX collapsed scan; noise is checked statistically on the port alone.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rescan_line_sted_torch as T
import rescan_line_sted_tpu as J
from rescan_line_sted_torch.convert import geometry_from_jax, params_from_jax
from rescan_line_sted_torch.imaging import boundary as tboundary
from rescan_line_sted_torch.imaging import rescan_point as tpoint
from rescan_line_sted_torch.kernels import _build
from rescan_line_sted_tpu.imaging import boundary as jboundary
from rescan_line_sted_tpu.imaging import rescan_point as jpoint

torch.set_num_threads(1)
# the JAX suite's physics (tests/test_rescan_point.py)
KW = dict(sigma_exc=2.0, sigma_det=2.5, sigma_dep=2.0, depletion=4.0,
          brightness=1.0)
FACTORS = [1.5, 2.0, 1.0 + math.pi / 8]


def _both(n=32, rf=2.0, b=1, chunk=32, **kw):
    params = {**KW, **kw}
    return ((J.PointSTEDParams.create(**params),
             J.RescanPointGeometry(J.Grid(n, n), rescan_factor=rf, binning=b,
                                   chunk=chunk)),
            (T.PointSTEDParams.create(**params),
             T.RescanPointGeometry(T.Grid(n, n), rescan_factor=rf, binning=b,
                                   chunk=chunk)))


def _interior(n=32, seed=0):
    """Content zero within ~PSF support of every edge (both axes
    reassign), an asymmetric patch."""
    s = np.zeros((n, n), np.float32)
    c = n // 2
    rng = np.random.default_rng(seed)
    s[c - 4:c + 4, c - 3:c + 5] = rng.uniform(0.2, 1.0, (8, 8))
    return s


def _sample(n=32, seed=0):
    """Random content up to the edges, ramped along x."""
    rng = np.random.default_rng(seed)
    ramp = np.linspace(0.2, 2.0, n, dtype=np.float32)[None, :]
    return (rng.random((n, n), np.float32) * ramp).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _port(s, tp, tg, **kw):
    return T.rescanned_point_sted_image(s, tp, tg, device="cpu", **kw)


def _jax(s, jp, jg, **kw):
    return J.imaging.rescanned_point_sted_image(jnp.asarray(s), jp, jg, **kw)


@pytest.mark.parametrize("rf", FACTORS)
@pytest.mark.parametrize("b", [1, 2])
def test_analytic_matches_jax(rf, b):
    (jp, jg), (tp, tg) = _both(32, rf, b)
    s = _sample(32, 1)
    got = _port(s, tp, tg).image
    assert got.shape == tg.canvas_shape == tuple(jg.canvas_shape)
    assert _rel(got, _jax(s, jp, jg).image) <= 1e-5


@pytest.mark.parametrize("rf,b,reassignment", [
    (2.0, 1, "rounded"), (1.5, 1, "subpixel"), (1.5, 1, "rounded"),
    (2.0, 2, "auto"), (3.0, 2, "rounded"), (1.0 + math.pi / 8, 2, "auto")])
def test_scan_matches_jax(rf, b, reassignment):
    """The noise-free scan, rounded and subpixel placement, b = 1 and 2
    (at (R - 1) / b = 1/2, "auto" places subpixel)."""
    (jp, jg), (tp, tg) = _both(32, rf, b)
    s = _sample(32, 2)
    got = _port(s, tp, tg, method="scan", reassignment=reassignment).image
    want = _jax(s, jp, jg, method="scan", reassignment=reassignment).image
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("rf,b", [(2.0, 1), (1.5, 1), (2.0, 2), (3.0, 2)])
def test_scan_matches_analytic_on_interior_sample(rf, b):
    """Scan and closed form agree for content away from every edge (the
    JAX suite's ``test_analytic_matches_scan``)."""
    _, (tp, tg) = _both(32, rf, b)
    s = _interior()
    ana = _port(s, tp, tg).image
    scan = _port(s, tp, tg, method="scan", reassignment="subpixel").image
    assert _rel(scan, ana) <= 1e-5


@pytest.mark.parametrize("rf", [2.0, 1.5])
def test_system_kernel_matches_jax(rf):
    (jp, jg), (tp, tg) = _both(32, rf)
    got = tpoint.rescan_point_system_kernel(tg, tp)
    assert _rel(got, jpoint.rescan_point_system_kernel(jg, jp)) <= 1e-5
    with pytest.raises(ValueError, match="binning"):
        tpoint.rescan_point_system_kernel(_both(32, rf, 2)[1][1], tp)


def test_system_kernel_predicts_canvas():
    """canvas == brightness * conv(place_2d(sample, R), H) at R = 2."""
    from rescan_line_sted_torch.kernels import fftconv

    _, (tp, tg) = _both(32, 2.0)
    s = torch.from_numpy(_interior())
    placed = torch.zeros(tg.canvas_shape)
    placed[::2, ::2] = s
    via_kernel = tp.brightness * fftconv.fft_convolve(
        placed, tpoint.rescan_point_system_kernel(tg, tp))
    assert _rel(via_kernel, _port(s, tp, tg).image) <= 1e-5


@pytest.mark.parametrize("depletion", [0.0, 8.0])
def test_rescan_factors_match_jax(depletion):
    jp = J.PointSTEDParams.create(depletion=depletion)
    tp = T.PointSTEDParams.create(depletion=depletion)
    assert _rel(tpoint.optimal_rescan_factor_point(tp, 64),
                jpoint.optimal_rescan_factor_point(jp, 64)) <= 1e-5
    for kw in ({}, {"cap": 2.0}, {"snap": None}, {"tolerance": 0.1}):
        assert _rel(tpoint.practical_rescan_factor_point(tp, 64, **kw),
                    jpoint.practical_rescan_factor_point(jp, 64, **kw)) \
            <= 1e-5, kw
    if depletion == 0.0:
        assert 1.9 < float(tpoint.optimal_rescan_factor_point(tp, 64)) < 2.1


@pytest.mark.parametrize("method", ["analytic", "scan"])
@pytest.mark.parametrize("boundary", ["padded", "apodized"])
def test_boundaries_match_jax(method, boundary):
    """Padded crops both rescanned axes (an irrational R: the crop shifts
    by a fraction of a pixel); apodized tapers the sample."""
    (jp, jg), (tp, tg) = _both(32, 1.0 + math.pi / 8, 1)
    s = _sample(32, 3)
    got = _port(s, tp, tg, method=method, boundary=boundary)
    want = _jax(s, jp, jg, method=method, boundary=boundary)
    assert got.image.shape == tg.canvas_shape
    assert _rel(got.image, want.image) <= 1e-5
    assert float(got.dose.num_steps) == 32 * 32


def test_padded_crop_keeps_both_axes():
    """An emitter near the y edge lands at R * position after the padded
    crop, and its tail no longer wraps to the canvas bottom (the JAX
    suite's ``test_padded_boundary_2d_crop``); binned, against JAX."""
    (jp, jg), (tp, tg) = _both(32, 2.0)
    s = np.zeros((32, 32), np.float32)
    s[4, 16] = 1.0
    canvas = _port(s, tp, tg, boundary="padded", margin=16).image.numpy()
    peak = np.unravel_index(canvas.argmax(), canvas.shape)
    assert abs(peak[0] - 8) <= 1 and abs(peak[1] - 32) <= 1
    circ = _port(s, tp, tg).image.numpy()
    assert circ[-2:].sum() > 1e3 * max(canvas[-2:].sum(), 1e-12)
    (jp, jg), (tp, tg) = _both(48, 3.0, 2, chunk=64)
    s = _sample(48, 4)
    for method in ("analytic", "scan"):
        got = _port(s, tp, tg, method=method, boundary="padded", margin=8)
        want = _jax(s, jp, jg, method=method, boundary="padded", margin=8)
        assert _rel(got.image, want.image) <= 1e-5


@pytest.mark.parametrize("margin", [5, 8, 12])
def test_padded_geometry_counts_every_pixel(margin):
    """The padded ISM geometry lowers its chunk until it divides the padded
    H * W (a point scan's steps); the margin matches the JAX package's."""
    (jp, jg), (tp, tg) = _both(40, 1.5, 1, chunk=64)
    assert tboundary.default_margin(tg) == jboundary.default_margin(jg)
    pg = tboundary.padded_geometry(tg, margin)
    n = 40 + 2 * margin
    assert pg.grid.shape == (n, n) and type(pg) is type(tg)
    assert pg.num_steps == n * n and pg.num_steps % pg.chunk == 0
    assert pg.chunk == max(c for c in range(1, 65) if (n * n) % c == 0)


# route: (n, R, b, reassignment, chunk)
ROUTES = {"rounded": (32, 2.0, 1, "rounded", 32),
          "subpixel": (32, 1.5, 1, "subpixel", 64),
          "binned": (48, 2.0, 2, "auto", 48),
          "binned_rounded": (48, 3.0, 2, "rounded", 96)}


@pytest.mark.parametrize("route", list(ROUTES))
def test_per_step_route_matches_jax_collapsed(route, monkeypatch):
    """Per-step noise draws every (binned) frame with K2b, once per chunk
    of raster positions; with the draw replaced by the identity the canvas
    is the JAX collapsed scan's."""
    n, rf, b, reassignment, chunk = ROUTES[route]
    (jp, jg), (tp, tg) = _both(n, rf, b, chunk=chunk)
    s = _sample(n, 5)
    shapes = []

    def identity(lam, generator):
        shapes.append(tuple(lam.shape))
        return lam.clamp_min(0.0)

    monkeypatch.setattr(tpoint, "poisson_rows_tiered", identity)
    got = _port(s, tp, tg, generator=torch.Generator().manual_seed(0),
                method="scan", noise_mode="per_step",
                reassignment=reassignment).image
    want = _jax(s, jp, jg, method="scan", reassignment=reassignment).image
    assert _rel(got, want) <= 1e-5
    assert shapes == [(chunk, n // b, n // b)] * (n * n // chunk)


@pytest.mark.parametrize("noise_mode", ["per_step", "collapsed"])
@pytest.mark.parametrize("rf,b", [(2.0, 1), (1.5, 2)])
def test_noise_statistics_and_determinism(noise_mode, rf, b):
    """Noisy canvases: totals within 5 sigma of the noise-free total over
    seeds, the seed-mean near the mean, and one generator seed gives one
    canvas. Rounded per-step and collapsed canvases hold integer counts.
    Collapsed noise draws the clamped canvas (subpixel canvases ring below
    zero), so its mean is the clamped canvas."""
    _, (tp, tg) = _both(32, rf, b)
    s = torch.from_numpy(_interior()) * 50.0
    mean = _port(s, tp, tg, method="scan").image.double()
    if noise_mode == "collapsed":
        mean = mean.clamp_min(0)
    total = float(mean.sum())

    def draw(seed):
        return _port(s, tp, tg, generator=torch.Generator().manual_seed(seed),
                     method="scan", noise_mode=noise_mode).image

    draws = torch.stack([draw(k) for k in range(6)]).double()
    for img in draws:
        assert abs(float(img.sum()) - total) <= 5 * math.sqrt(total)
    assert abs(float(draws.mean(0).sum()) - total) <= \
        5 * math.sqrt(total / 6)
    sel = mean > 0.3 * float(mean.max())
    rel = float((draws.mean(0)[sel] - mean[sel]).abs().mean()
                / mean[sel].mean())
    assert rel < 0.1
    assert torch.equal(draw(0), draws[0].float())
    assert not torch.equal(draws[0], draws[1])
    if noise_mode == "collapsed" or (rf - 1) / b % 1 == 0:
        assert (draws - draws.round()).abs().max() < 1e-2


def test_analytic_noise_and_dose():
    (jp, jg), (tp, tg) = _both(32, 2.0)
    s = torch.from_numpy(_interior()) * 50.0
    clean = _port(s, tp, tg)
    noisy = _port(s, tp, tg, generator=torch.Generator().manual_seed(1))
    total = float(clean.image.double().sum())
    assert torch.equal(noisy.image, noisy.image.round())
    assert abs(float(noisy.image.double().sum()) - total) <= \
        5 * math.sqrt(total)
    want = J.imaging.rescanned_point_sted_image(jnp.asarray(s.numpy()), jp,
                                                jg).dose
    for f in ("excitation_dose", "depletion_dose",
              "emission_per_unit_sample", "num_steps"):
        assert _rel(getattr(clean.dose, f), getattr(want, f)) <= 1e-5, f


def test_arguments_devices_and_convert(monkeypatch):
    (jp, jg), (tp, tg) = _both(32, 2.0)
    assert params_from_jax(jp) == tp and geometry_from_jax(jg) == tg
    s = _sample(32)
    for kw in (dict(method="nope"), dict(boundary="mirror"),
               dict(method="scan", noise_mode="nope"),
               dict(method="scan", reassignment="nope")):
        with pytest.raises(ValueError):
            _port(s, tp, tg, **kw)
    with pytest.raises(ValueError, match="grid"):
        _port(s[:16], tp, tg)
    with pytest.raises(ValueError, match="chunk"):
        _port(s, tp, T.RescanPointGeometry(T.Grid(32, 32), chunk=48),
              method="scan")
    with pytest.raises(ValueError, match="binning"):
        T.RescanPointGeometry(T.Grid(32, 30), binning=4)
    with pytest.raises(ValueError, match="rescan_factor"):
        T.RescanPointGeometry(T.Grid(32, 32), rescan_factor=0.5)
    _build.reset_launches()
    _port(s, tp, tg, generator=torch.Generator().manual_seed(0),
          method="scan", noise_mode="per_step")
    _port(s, tp, tg, generator=torch.Generator().manual_seed(0))
    assert all(v == 0 for v in _build.LAUNCHES.values())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        T.rescanned_point_sted_image(s, tp, tg)

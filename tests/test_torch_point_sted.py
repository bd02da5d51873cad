"""Port parity of descanned point-STED (``imaging/point_sted.py``) and the
2D physics under it (psf, ``effective_point_psf``, dose, fftconv,
``shifted_images``, ``point_system_kernel``) against the JAX package, on
the same numpy inputs at small sizes.

Noise-free agreement: max|port - jax| / max|jax| <= 1e-5. The per-step
routes sample with K2b (its plain version here): each runs with the
sampler replaced by the identity and is held to the JAX collapsed scan,
and the banded route's noise-free pipeline to the JAX one; noise is
checked statistically on the port alone.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rescan_line_sted_torch as T
import rescan_line_sted_tpu as J
from rescan_line_sted_torch.imaging import point_sted as tpoint
from rescan_line_sted_torch.imaging import shifts as tshifts
from rescan_line_sted_torch.kernels import fftconv as tfft
from rescan_line_sted_torch.physics import dose as tdose
from rescan_line_sted_torch.physics import models as tmodels
from rescan_line_sted_torch.physics import psf as tpsf
from rescan_line_sted_tpu.imaging import analytic as janalytic
from rescan_line_sted_tpu.imaging import point_sted as jpoint
from rescan_line_sted_tpu.imaging import shifts as jshifts
from rescan_line_sted_tpu.kernels import fftconv as jfft
from rescan_line_sted_tpu.physics import dose as jdose
from rescan_line_sted_tpu.physics import models as jmodels
from rescan_line_sted_tpu.physics import psf as jpsf

torch.set_num_threads(1)
KW = dict(sigma_exc=1.5, sigma_det=1.5, sigma_dep=1.5, depletion=4.0,
          pinhole_radius=2.5, brightness=50.0)
BOUNDARIES = ["circular", "padded", "apodized"]


def _both(h, w, chunk=16, **kw):
    params = {**KW, **kw}
    return ((J.PointSTEDParams.create(**params),
             J.PointSTEDGeometry(J.Grid(h, w), chunk=chunk)),
            (T.PointSTEDParams.create(**params),
             T.PointSTEDGeometry(T.Grid(h, w), chunk=chunk)))


def _sample(h, w, seed=0):
    """An asymmetric sample (a ramp along x under random values)."""
    rng = np.random.default_rng(seed)
    ramp = np.linspace(0.2, 2.0, w, dtype=np.float32)[None, :]
    return (rng.random((h, w), np.float32) * ramp).astype(np.float32)


def _rel(got, want):
    got = np.asarray(got, np.complex128)
    want = np.asarray(want, np.complex128)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("name,shape,arg", [
    ("radius_sq", (32, 33), None), ("gaussian_psf", (32, 40), 2.5),
    ("donut_psf", (31, 32), 1.7), ("detection_psf", (32, 32), 3.0),
    ("pinhole_mask", (33, 32), 4.0), ("pinhole_mask", (32, 32), 2.5)])
def test_psf_2d_matches_jax(name, shape, arg):
    args = () if arg is None else (np.float32(arg),)
    got = getattr(tpsf, name)(shape, *args)
    want = getattr(jpsf, name)(shape, *(jnp.float32(a) for a in args))
    assert got.dtype == torch.float32 and _rel(got, want) <= 1e-5


@pytest.mark.parametrize("shape,depletion", [((32, 40), 4.0),
                                             ((33, 32), 0.0)])
def test_effective_psf_and_system_kernel_match_jax(shape, depletion):
    (jp, _), (tp, _) = _both(*shape, depletion=depletion)
    assert _rel(tmodels.effective_point_psf(shape, tp),
                jmodels.effective_point_psf(shape, jp)) <= 1e-5
    assert _rel(T.imaging.analytic.point_system_kernel(shape, tp),
                janalytic.point_system_kernel(shape, jp)) <= 1e-5


@pytest.mark.parametrize("depletion", [0.0, 8.0])
def test_point_dose_matches_jax(depletion):
    (jp, jg), (tp, tg) = _both(32, 48, depletion=depletion)
    want, got = jdose.point_sted_dose(jp, jg), tdose.point_sted_dose(tp, tg)
    for f in ("excitation_dose", "depletion_dose", "emission_per_unit_sample",
              "num_steps", "total_dose", "signal_per_dose"):
        assert _rel(getattr(got, f), getattr(want, f)) <= 1e-5, f


@pytest.mark.parametrize("case", [
    "otf", "convolve", "correlate", "fft_convolve", "fft_correlate",
    "at_even", "at_odd", "at_batched_otf", "at_large"])
def test_fftconv_2d_matches_jax(case):
    rng = np.random.default_rng(11)
    h, w = (40, 45) if case == "at_odd" else (256, 256) \
        if case == "at_large" else (32, 48)
    img = rng.random((5, h, w), np.float32)
    k = np.asarray(jpsf.detection_psf((h, w), jnp.float32(1.9)))
    k = (k * rng.random((h, w))).astype(np.float32)      # asymmetric kernel
    if case == "otf":
        got, want = tfft.kernel_to_otf(_t(k)), jfft.kernel_to_otf(k)
    elif case in ("convolve", "correlate"):
        otf = jfft.kernel_to_otf(k)
        got = getattr(tfft, case + "_otf")(_t(img), _t(otf))
        want = getattr(jfft, case + "_otf")(img, otf)
    elif case in ("fft_convolve", "fft_correlate"):
        got = getattr(tfft, case)(_t(img[0]), _t(k))
        want = getattr(jfft, case)(img[0], k)
    else:
        otf = np.asarray(jfft.kernel_to_otf(k))
        if case == "at_batched_otf":
            otf = np.stack([otf * (1 + i) for i in range(5)])
        pos = np.stack([rng.integers(0, h, 5), rng.integers(0, w, 5)], -1)
        pos[0] = (h - 1, w - 1)
        got = tfft.correlate_otf_at(_t(img), _t(otf), _t(pos))
        want = jfft.correlate_otf_at(img, otf, pos)
        full = jfft.correlate_otf(img, otf)
        assert _rel(want, full[np.arange(5), pos[:, 0], pos[:, 1]]) <= 1e-5
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("shape", [(31, 32), (32, 33)])
def test_shifted_images_match_jax(shape):
    rng = np.random.default_rng(shape[1])
    psf = rng.random(shape, np.float32)
    pos = np.array([[0, 0], [3, shape[1] - 1], [shape[0] - 1, 5],
                    [shape[0] // 2, shape[1] // 2]], np.int64)
    assert _rel(tshifts.shifted_images(_t(psf), _t(pos)),
                jshifts.shifted_images(psf, pos)) == 0.0


class _WideExcModel:
    """No ``gaussian_excitation``: unknown support, no band windows."""

    def excitation(self, shape, params):
        return jnp.ones(shape, jnp.float32)

    def depletion(self, shape, params):
        return jnp.zeros(shape, jnp.float32)


# the JAX suite's gating cases (tests/test_engines_parity.py), the
# point_512 / point_128 configurations, and an odd grid
@pytest.mark.parametrize("h,w,chunk,kw", [
    (512, 512, 64, dict(sigma_exc=3.0, pinhole_radius=4.0)),
    (48, 48, 16, dict(sigma_exc=3.0, pinhole_radius=4.0)),
    (512, 512, 64, dict(sigma_exc=3.0, model="pupil")),
    (512, 512, 64, dict(sigma_exc=3.0, model="wide")),
    (512, 512, 60, dict(sigma_exc=3.0, pinhole_radius=4.0)),
    (128, 128, 64, dict(sigma_exc=3.0, pinhole_radius=4.0)),
    (64, 64, 16, {}), (40, 45, 36, {})])
def test_point_band_matches_jax(h, w, chunk, kw):
    models = {"pupil": jmodels.PupilDonutModel(), "wide": _WideExcModel()}
    kw = {k: models.get(v, v) if k == "model" else v for k, v in kw.items()}
    (jp, _), (tp, _) = _both(h, w, **kw)
    assert tpoint._point_band(tp, h, w, chunk) == \
        jpoint._point_band(jp, h, w, chunk)


def test_banded_point_scan_matches_jax():
    """The banded route's noise-free windowed pipeline, port against JAX,
    both held to the collapsed closed form."""
    (jp, jg), (tp, tg) = _both(64, 64)
    s = _sample(64, 64, 1)
    band = tpoint._point_band(tp, 64, 64, 16)
    assert band is not None
    eff = jmodels.effective_point_psf((64, 64), jp)
    pin = jpsf.pinhole_mask((64, 64), jp.pinhole_radius)
    want = jpoint._banded_point_scan(jnp.asarray(s), jp, jg,
                                     jax.random.key(0), eff, pin, band,
                                     draw_noise=False)
    got = tpoint._banded_point_scan(
        _t(s), tp, tg, None, _t(eff), _t(pin), band, draw_noise=False)
    assert _rel(got, want) <= 1e-5
    collapsed = J.imaging.point_sted_image(jnp.asarray(s), jp, jg,
                                           method="scan").image
    assert _rel(got, collapsed) <= 1e-5


@pytest.mark.parametrize("method", ["analytic", "scan"])
@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_image_matches_jax(method, boundary):
    (jp, jg), (tp, tg) = _both(40, 48)
    s = _sample(40, 48, 2)
    want = J.imaging.point_sted_image(jnp.asarray(s), jp, jg, method=method,
                                      boundary=boundary)
    got = T.point_sted_image(s, tp, tg, method=method, boundary=boundary,
                             device="cpu")
    assert got.image.shape == (40, 48) and _rel(got.image, want.image) <= 1e-5
    for f in ("excitation_dose", "depletion_dose", "num_steps"):
        assert _rel(getattr(got.dose, f), getattr(want.dose, f)) <= 1e-5


# route: (grid, chunk, K2b's frame shape on the first call)
ROUTES = {"banded": ((64, 64), 16, (64, 16, 16, 24)),
          "full_frame": ((32, 32), 16, (16, 32, 32)),
          "full_frame_rows_crossed": ((40, 45), 36, (36, 40, 45))}


@pytest.mark.parametrize("route", list(ROUTES))
def test_per_step_routes_match_jax_collapsed(route, monkeypatch):
    (h, w), chunk, frames = ROUTES[route]
    (jp, jg), (tp, tg) = _both(h, w, chunk)
    s = _sample(h, w, 3)
    calls = []

    def identity(lam, generator):
        calls.append(tuple(lam.shape))
        return lam.clamp_min(0.0)

    monkeypatch.setattr(tpoint, "poisson_rows_tiered", identity)
    got = T.point_sted_image(s, tp, tg, torch.Generator().manual_seed(0),
                             method="scan", noise_mode="per_step",
                             device="cpu").image
    want = J.imaging.point_sted_image(jnp.asarray(s), jp, jg,
                                      method="scan").image
    assert _rel(got, want) <= 1e-5
    assert calls[0] == frames
    assert (tpoint._point_band(tp, h, w, chunk) is None) == \
        route.startswith("full_frame")


@pytest.mark.parametrize("grid", [(64, 64), (32, 32)],
                         ids=["banded", "full_frame"])
def test_per_step_noise_statistics(grid):
    """First moments of the per-step draws over seeds, integer counts (up
    to the spectral readout's rounding), and determinism under one
    generator seed."""
    _, (tp, tg) = _both(*grid)
    s = torch.from_numpy(_sample(*grid, 4)) * 3.0
    mean = T.point_sted_image(s, tp, tg, method="scan", device="cpu").image

    def draw(seed):
        return T.point_sted_image(s, tp, tg, torch.Generator().manual_seed(
            seed), method="scan", noise_mode="per_step", device="cpu").image

    draws = torch.stack([draw(i) for i in range(6)]).double()
    # integer counts; the full-frame route reads the pinhole spectrally
    assert (draws - draws.round()).abs().max() < 1e-2
    assert (draws > -1e-2).all()
    total = float(mean.double().sum())
    assert abs(float(draws.mean(0).sum()) - total) <= 5 * np.sqrt(total / 6)
    assert torch.equal(draw(0), draws[0].float())
    assert not torch.equal(draws[0], draws[1])


def test_arguments_and_devices(monkeypatch):
    _, (tp, tg) = _both(32, 32)
    s = _sample(32, 32)
    for kw in (dict(method="nope"), dict(boundary="mirror"),
               dict(method="scan", noise_mode="nope")):
        with pytest.raises(ValueError):
            T.point_sted_image(s, tp, tg, device="cpu", **kw)
    with pytest.raises(ValueError, match="grid"):
        T.point_sted_image(s[:16], tp, tg, device="cpu")
    with pytest.raises(ValueError, match="chunk"):
        T.point_sted_image(s, tp, T.PointSTEDGeometry(T.Grid(32, 32),
                                                      chunk=48),
                           method="scan", device="cpu")
    with pytest.raises(TypeError, match="params_from_jax"):
        T.point_sted_image(s, dataclasses.replace(
            tp, model=jmodels.PupilDonutModel()), tg, device="cpu")
    # the port's own model of that class runs, as the JAX package's does
    jp = J.PointSTEDParams.create(**KW, model=jmodels.PupilDonutModel())
    got = T.point_sted_image(s, dataclasses.replace(
        tp, model=tmodels.PupilDonutModel()), tg, device="cpu").image
    want = J.imaging.point_sted_image(
        jnp.asarray(s), jp, J.PointSTEDGeometry(J.Grid(32, 32), chunk=16))
    assert _rel(got, want.image) <= 1e-5
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        T.point_sted_image(s, tp, tg)


@pytest.mark.parametrize("kind,chunk,margin", [
    ("point", 36, 8), ("point", 64, 5), ("line", 36, 8), ("line", 16, 6)])
def test_padded_geometry_matches_jax(kind, chunk, margin):
    """The padded grid of the descanned geometries, its chunk lowered until
    it divides the padded step count (H * W for point scans, W for line
    scans), as in the JAX package."""
    from rescan_line_sted_torch.imaging import boundary as tb
    from rescan_line_sted_tpu.imaging import boundary as jb

    name = "PointSTEDGeometry" if kind == "point" else "LineSTEDGeometry"
    jg = getattr(J, name)(J.Grid(40, 45), chunk=chunk)
    tg = getattr(T, name)(T.Grid(40, 45), chunk=chunk)
    assert tb.default_margin(tg) == jb.default_margin(jg)
    jp, tp = jb.padded_geometry(jg, margin), tb.padded_geometry(tg, margin)
    assert (tp.grid.shape, tp.chunk) == (tuple(jp.grid.shape), jp.chunk)
    assert tp.num_steps % tp.chunk == 0 and type(tp) is type(tg)

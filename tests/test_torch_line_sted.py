"""Port parity of descanned line-STED (``imaging/line_sted.py``) and its
kernel K3 (``kernels/line_fused.py``) against the JAX package, on the same
numpy inputs at small sizes.

Noise-free agreement: max|port - jax| / max|jax| <= 1e-5. The plain K3 is
held to the JAX kernel in interpret mode. Off the TPU the JAX package
never routes per-step noise to K3 or K2b, so each per-step route of the
port runs with its sampler replaced by the identity (as the JAX suite's
``test_legacy_point_per_step_mean_matches_collapsed`` does) and is held to
the JAX collapsed scan; noise is checked statistically on the port alone.
The CUDA kernel is held to the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rescan_line_sted_torch as T
import rescan_line_sted_tpu as J
from rescan_line_sted_torch.imaging import line_sted as tline
from rescan_line_sted_torch.kernels import fftconv as tfft
from rescan_line_sted_torch.kernels import line_fused as tfused
from rescan_line_sted_torch.physics import models as tmodels
from rescan_line_sted_torch.physics import psf as tpsf
from rescan_line_sted_tpu.imaging import analytic as janalytic
from rescan_line_sted_tpu.imaging import line_sted as jline
from rescan_line_sted_tpu.kernels import fftconv as jfft
from rescan_line_sted_tpu.kernels.line_fused import (
    line_sted_fused as j_fused,
)
from rescan_line_sted_tpu.physics import models as jmodels
from rescan_line_sted_tpu.physics import psf as jpsf

torch.set_num_threads(1)
KW = dict(sigma_exc=2.0, sigma_det=2.5, stripe_period=9.0, depletion=4.0,
          slit_halfwidth=4.0, brightness=100.0)
BOUNDARIES = ["circular", "padded", "apodized"]


def _both(h, w, chunk=16, **kw):
    params = {**KW, **kw}
    return ((J.LineSTEDParams.create(**params),
             J.LineSTEDGeometry(J.Grid(h, w), chunk=chunk)),
            (T.LineSTEDParams.create(**params),
             T.LineSTEDGeometry(T.Grid(h, w), chunk=chunk)))


def _sample(h, w, seed=0):
    """An asymmetric sample: a mirrored image fails where a symmetric one
    would pass."""
    rng = np.random.default_rng(seed)
    ramp = np.linspace(0.2, 2.0, w, dtype=np.float32)[None, :]
    return (rng.random((h, w), np.float32) * ramp).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("w,hw", [(64, 4.0), (65, 2.5), (48, 0.0)])
def test_slit_and_profiles_match_jax(w, hw):
    assert _rel(tpsf.slit_profile(w, hw), jpsf.slit_profile(w, hw)) == 0.0
    a = np.random.default_rng(w).random(w, np.float32)
    b = np.asarray(jpsf.detection_profile(w, jnp.float32(1.7)))
    assert _rel(tfft.convolve_profiles(_t(a), _t(b)),
                jfft.convolve_profiles(a, b)) <= 1e-5


@pytest.mark.parametrize("shape,depletion", [((48, 64), 4.0),
                                             ((33, 40), 0.0)])
def test_line_system_kernel_matches_jax(shape, depletion):
    (jp, _), (tp, _) = _both(*shape, depletion=depletion)
    assert _rel(T.imaging.analytic.line_system_kernel(shape, tp),
                janalytic.line_system_kernel(shape, jp)) <= 1e-5


class _WideExcModel:
    """No ``gaussian_excitation``: unknown support, no band windows."""

    def excitation(self, width, params):
        return jnp.ones((width,), jnp.float32)

    def depletion(self, width, params):
        return jnp.zeros((width,), jnp.float32)


@pytest.mark.parametrize("w,chunk,kw", [
    (512, 32, {}), (128, 32, {}), (2048, 32, dict(sigma_exc=3.0)),
    (256, 16, dict(slit_halfwidth=60.0)), (192, 8, dict(sigma_exc=9.0)),
    (512, 32, dict(model="envelope")), (512, 32, dict(model="wide"))])
def test_line_band_matches_jax(w, chunk, kw):
    models = {"envelope": jmodels.EnvelopedStripeModel(),
              "wide": _WideExcModel()}
    kw = {k: models.get(v, v) if k == "model" else v for k, v in kw.items()}
    (jp, _), (tp, _) = _both(8, w, **kw)
    assert tline._line_band(tp, w, chunk) == jline._line_band(jp, w, chunk)


def _fused_inputs(h, w, hw, seed=1):
    p = J.LineSTEDParams.create(**dict(KW, slit_halfwidth=hw))
    eff = np.asarray(jline.effective_line_profile(w, p)) * 100.0
    gx = np.asarray(jpsf.detection_profile(w, p.sigma_det))
    slit = np.asarray(jpsf.slit_profile(w, p.slit_halfwidth))
    return _sample(h, w, seed), eff, gx, slit


@pytest.mark.parametrize("h,w,hw,slit_support", [
    (48, 64, 4.0, 18),       # the engine's default window: 9 sampled rows
    (40, 64, 4.0, 4),        # undersized: a row outside adds its mean
    (24, 96, 10.0, 12),      # most rows outside the window
    (32, 40, 3.0, 64)])      # window wider than the frame
def test_k3_plain_matches_jax_interpret(h, w, hw, slit_support):
    s, eff, gx, slit = _fused_inputs(h, w, hw)
    want = j_fused(jnp.asarray(s), jnp.asarray(eff),
                   jfft.circulant_matrix(jnp.asarray(gx)), jnp.asarray(slit),
                   None, slit_support=slit_support, interpret=True)
    got = tfused.line_sted_fused(_t(s), _t(eff), _t(gx), _t(slit),
                                 slit_support=slit_support)
    assert got.shape == (h, w) and _rel(got, want) <= 1e-5


def test_k3_rows():
    """The rows K3 computes: the slit's span, split at the window."""
    slit = tpsf.slit_profile(64, 4.0)
    i0, ws, wm = tfused._rows(slit, 64, 4)           # window rows [28, 36)
    assert i0 == 28 and ws.tolist() == [1.0] * 8 + [0.0]
    assert wm.tolist() == [0.0] * 8 + [1.0]
    i0, ws, wm = tfused._rows(slit, 64, 18)
    assert i0 == 28 and ws.tolist() == [1.0] * 9 and not wm.any()
    assert tfused._rows(torch.zeros(64), 64, 18)[1].size == 0


def _shortest_run(mask):
    """Brute force: the shortest circular run (start, length) holding
    every True of ``mask``."""
    w = mask.size
    if not mask.any():
        return 0, 0
    for n in range(1, w + 1):
        for j0 in range(w):
            if mask[(j0 + np.arange(n)) % w].sum() == mask.sum():
                return j0, n


@pytest.mark.parametrize("nz", [[], [5], [0, 9], [2, 3, 7], list(range(10)),
                                [0, 1, 2, 8, 9], [1, 4, 6, 8]])
def test_k3_tap_span(nz):
    """K3's tap run is the shortest circular run over the nonzero taps,
    wrapping past the last offset where that is shorter."""
    mask = np.zeros(10, bool)
    mask[nz] = True
    taps = np.stack([mask, np.zeros(10, bool)])
    got = tfused._span(taps)
    assert got[1] == _shortest_run(mask)[1]
    assert mask[(got[0] + np.arange(got[1])) % 10].sum() == mask.sum()


@pytest.mark.parametrize("w,shift,run", [(128, 0, "short"),
                                         (128, 60, "wraps"),
                                         (40, 0, "whole")])
def test_k3_tap_run_sum_matches_plain(w, shift, run):
    """K3's noise-free arithmetic in numpy (each computed row summed over
    its tap run only) equals the plain version summing every offset: the
    run is short at 128 columns, wraps past the last offset with eff and
    gx rolled off centre, and is the whole frame at 40 columns."""
    s, eff, gx, slit = _fused_inputs(24, w, 4.0)
    eff, gx = np.roll(eff, shift), np.roll(gx, shift)
    i0, ws, wm = tfused._rows(_t(slit), w, 18)
    taps = tfused._taps(_t(eff), _t(gx), i0, ws.size)
    j0, n = tfused._span(taps)
    assert {"short": 0 < n and j0 + n <= w, "wraps": n < w < j0 + n,
            "whole": n == w}[run]
    j = (j0 + np.arange(n)) % w
    c = (i0 + np.arange(ws.size) + w // 2) % w
    k = gx[(c[:, None] - j[None, :]) % w] * eff[j][None, :]      # [rows, n]
    cols = (np.arange(w)[:, None] - w // 2 + j[None, :]) % w    # [pos, n]
    got = np.einsum("ypn,kn,k->yp", s[:, cols].astype(np.float64), k,
                    ws + wm)
    want = tfused.line_sted_fused_reference(_t(s), _t(eff), _t(gx), _t(slit),
                                            slit_support=18)
    assert not taps[:, (j0 + np.arange(n, w)) % w].any()
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("method", ["analytic", "scan"])
@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_image_matches_jax(method, boundary):
    (jp, jg), (tp, tg) = _both(40, 64)
    s = _sample(40, 64, 2)
    want = J.imaging.line_sted_image(jnp.asarray(s), jp, jg, method=method,
                                     boundary=boundary).image
    got = T.line_sted_image(s, tp, tg, method=method, boundary=boundary,
                            device="cpu")
    assert got.image.shape == (40, 64) and _rel(got.image, want) <= 1e-5
    assert got.image.dtype == torch.float32


def test_dose_matches_jax():
    (jp, jg), (tp, tg) = _both(40, 64)
    s = _sample(40, 64)
    want = J.imaging.line_sted_image(jnp.asarray(s), jp, jg).dose
    got = T.line_sted_image(s, tp, tg, device="cpu").dose
    for f in ("excitation_dose", "depletion_dose",
              "emission_per_unit_sample", "num_steps"):
        assert _rel(getattr(got, f), getattr(want, f)) <= 1e-5, f


def _identity(calls):
    def sampler(lam, generator):
        calls.append(tuple(lam.shape))
        return lam.clamp_min(0.0)
    return sampler


# route: (grid, use_pallas, slit_support, the sampler that must be taken)
ROUTES = {
    "k3_default": ((32, 64), None, None, "k3"),          # no band windows
    "k3_forced": ((24, 192), True, None, "k3"),
    "k3_undersized": ((24, 64), True, 4, "k3"),
    "banded_k2b": ((24, 192), None, None, "k2b"),
    "full_frame_k2b": ((24, 64), None, None, "k2b"),     # K3 too narrow
    "full_frame_k2c": ((24, 64), False, None, "k2c"),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_per_step_routes_match_jax_collapsed(route, monkeypatch):
    (h, w), use_pallas, slit_support, sampler = ROUTES[route]
    (jp, jg), (tp, tg) = _both(h, w)
    s = _sample(h, w, 3)
    calls = {"k3": [], "k2b": [], "k2c": []}
    monkeypatch.setattr(tfused, "poisson_reference", _identity(calls["k3"]))
    monkeypatch.setattr(tline, "poisson_rows_tiered", _identity(calls["k2b"]))
    monkeypatch.setattr(tline, "maybe_poisson",
                        lambda g, m: _identity(calls["k2c"])(m, g))
    if route == "full_frame_k2b":
        monkeypatch.setattr(tfused, "MAX_WIDTH", w - 1)
    got = T.line_sted_image(s, tp, tg, torch.Generator().manual_seed(0),
                            method="scan", noise_mode="per_step",
                            use_pallas=use_pallas, slit_support=slit_support,
                            device="cpu").image
    want = J.imaging.line_sted_image(jnp.asarray(s), jp, jg,
                                     method="scan").image
    assert _rel(got, want) <= 1e-5
    assert [k for k, v in calls.items() if v] == [sampler]
    if route == "banded_k2b":          # frames [C, D_out, H], H last
        assert calls["k2b"][0] == (16, 32, h)
    if route == "full_frame_k2b":      # W-major frames [C, W, H]
        assert calls["k2b"][0] == (16, w, h)


@pytest.mark.parametrize("grid,use_pallas", [((48, 48), None),
                                             ((32, 192), None),
                                             ((48, 48), False)],
                         ids=["k3", "banded_k2b", "full_frame_k2c"])
def test_per_step_noise_statistics(grid, use_pallas):
    """First moments of the per-step draws (the JAX suite's
    ``test_per_step_cpu_fallback_statistics``), and determinism under one
    generator seed."""
    _, (tp, tg) = _both(*grid, sigma_det=2.5, slit_halfwidth=3.0)
    s = torch.full(grid, 3.0)
    mean = T.line_sted_image(s, tp, tg, method="scan", device="cpu").image

    def draw(seed):
        return T.line_sted_image(s, tp, tg, torch.Generator().manual_seed(
            seed), method="scan", noise_mode="per_step",
            use_pallas=use_pallas, device="cpu").image

    draws = torch.stack([draw(i) for i in range(8)]).double()
    sel = mean > 20
    rel = ((draws.mean(0)[sel] - mean[sel]).abs().mean()
           / mean[sel].mean())
    assert rel < 0.05
    assert torch.equal(draws, draws.round()) and (draws >= 0).all()
    assert torch.equal(draw(0), draws[0].float())
    assert not torch.equal(draws[0], draws[1])


def test_arguments_and_devices(monkeypatch):
    (_, _), (tp, tg) = _both(24, 64)
    s = _sample(24, 64)
    for kw in (dict(method="nope"), dict(boundary="mirror"),
               dict(method="scan", noise_mode="nope")):
        with pytest.raises(ValueError):
            T.line_sted_image(s, tp, tg, device="cpu", **kw)
    with pytest.raises(ValueError, match="grid"):
        T.line_sted_image(s[:, :32], tp, tg, device="cpu")
    with pytest.raises(ValueError, match="chunk"):
        T.line_sted_image(s, tp, T.LineSTEDGeometry(T.Grid(24, 64), chunk=24),
                          method="scan", device="cpu")
    with pytest.raises(TypeError, match="params_from_jax"):
        T.line_sted_image(s, dataclasses.replace(
            tp, model=jmodels.EnvelopedStripeModel()), tg, device="cpu")
    # the port's own model of that class runs, as the JAX package's does
    jp = J.LineSTEDParams.create(**KW, model=jmodels.EnvelopedStripeModel())
    got = T.line_sted_image(s, dataclasses.replace(
        tp, model=tmodels.EnvelopedStripeModel()), tg, device="cpu").image
    want = J.imaging.line_sted_image(
        jnp.asarray(s), jp, J.LineSTEDGeometry(J.Grid(24, 64), chunk=16))
    assert _rel(got, want.image) <= 1e-5
    got = T.line_sted_image(s.astype(np.float64), tp, tg, device="cpu")
    assert got.image.dtype == torch.float32 and got.image.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        T.line_sted_image(s, tp, tg)


@pytest.mark.parametrize("kw,w,support", [
    ({}, 128, 18), (dict(slit_halfwidth=3.0), 128, 16),
    (dict(sigma_det=1.5, depletion=8.0), 96, 18),
    (dict(sigma_exc=3.0, brightness=2.0), 128, 4),
    (dict(stripe_period=12.0), 200, 64)])
def test_k3_cached_plan_matches_fresh(kw, w, support):
    """The K3 plan the line engine caches (rows, weights on the profiles'
    device, tap run) equals ``_rows`` and ``_span`` worked out afresh on
    the profiles ``_scan`` hands K3; the same key hits the cache, and a
    changed param, width or window misses it."""
    params = T.LineSTEDParams.create(**{**KW, **kw})
    dev = torch.device("cpu")
    tline._k3_plan.cache_clear()
    plan = tline._k3_plan(params, w, support, dev)
    eff = params.brightness * tline.effective_line_profile(w, params, dev)
    gx = tpsf.detection_profile(w, params.sigma_det, dev)
    slit = tpsf.slit_profile(w, params.slit_halfwidth, dev)
    i0, ws, wm = tfused._rows(slit, w, support)
    j0, n = tfused._span(tfused._taps(eff, gx, i0, ws.size))
    assert (plan.i0, plan.n_rows, plan.j0, plan.n_taps) == (i0, ws.size,
                                                            j0, n)
    assert np.array_equal(plan.ws.numpy(), ws)
    assert np.array_equal(plan.wm.numpy(), wm)
    assert plan.ws.device == dev and plan.ws.dtype == torch.float32
    assert tline._k3_plan(params, w, support, dev) is plan
    assert tline._k3_plan.cache_info().misses == 1
    other = dataclasses.replace(params, sigma_det=params.sigma_det + 0.5)
    assert tline._k3_plan(other, w, support, dev) is not plan
    tline._k3_plan(params, w + 8, support, dev)
    tline._k3_plan(params, w, support + 8, dev)
    assert tline._k3_plan.cache_info().misses == 4
    # the wrapper given the plan computes what it computes without one
    s = torch.from_numpy(_sample(16, w, 3))
    assert torch.equal(
        tfused.line_sted_fused(s, eff, gx, slit, slit_support=support,
                               plan=plan),
        tfused.line_sted_fused(s, eff, gx, slit, slit_support=support))

"""Port parity of the rescan scan without band windows: K4's and K5's plain
versions, the tap-run finder, ``imaging/frames.py`` and every route of
``rescanned_line_sted_image`` that no band window serves, against the JAX
package on the same numpy inputs at small sizes.

Noise-free agreement: max|port - jax| / max|jax| <= 1e-5 (relative L2
<= 1e-5 for whole images, the engine's parity bar); JAX's interpret-mode
K4 runs one grid step per position, so its grids stay at <= 32 columns.
Per-step routes run with their sampler replaced by the identity against
the JAX collapsed scan; noisy totals lie within 5 sigma of their mean.
"""

import dataclasses
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rescan_line_sted_torch as T
import rescan_line_sted_tpu as J
from rescan_line_sted_torch.convert import params_from_jax
from rescan_line_sted_torch.imaging import frames as tframes
from rescan_line_sted_torch.imaging import rescan as trescan
from rescan_line_sted_torch.kernels import _build
from rescan_line_sted_torch.kernels import fftconv as tfft
from rescan_line_sted_torch.kernels.rescan_accumulate import (
    rescan_accumulate,
    rescan_accumulate_reference,
)
from rescan_line_sted_torch.physics import psf as tpsf
from rescan_line_sted_tpu import imaging as jimaging
from rescan_line_sted_tpu.imaging import frames as jframes
from rescan_line_sted_tpu.kernels import fftconv as jfft
from rescan_line_sted_tpu.kernels.rescan_fused import rescan_fused as jfused
from rescan_line_sted_tpu.physics import models as jmodels

# both kernels packages export the function under the module's name
jaccum = importlib.import_module(
    "rescan_line_sted_tpu.kernels.rescan_accumulate")
tfused = importlib.import_module("rescan_line_sted_torch.kernels.rescan_fused")
torch.set_num_threads(1)
KW = dict(sigma_exc=2.0, sigma_det=2.0, stripe_period=8.0, depletion=4.0,
          brightness=40.0)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _t(x):
    return torch.from_numpy(np.array(x))


# ---- K4's plain version against the JAX kernel (interpret mode) ----------

def _k4_case(h, w, seed, zeros):
    rng = np.random.default_rng(seed)
    s = rng.uniform(size=(h, w)).astype(np.float32)
    eff = rng.uniform(size=(w,)).astype(np.float32)
    g = rng.uniform(size=(w,)).astype(np.float32)
    if zeros:                      # a short eff run, a gx run that wraps
        eff[:w // 3] = 0
        eff[-3:] = 0
        g[3:w - 4] = 0
    return s, eff, g


@pytest.mark.parametrize("h,w,wc,b,zeros", [
    (16, 24, 48, 1, False), (16, 24, 48, 2, False), (16, 24, 40, 2, True),
    (8, 32, 64, 1, True), (12, 24, 30, 3, True)])
def test_k4_plain_matches_jax_interpret(h, w, wc, b, zeros):
    """``rescan_fused_reference`` against the JAX ``rescan_fused`` driven
    directly (``gx_mat`` the circulant of the profile), with offsets that
    wrap the canvas; full runs (random profiles) and short, wrapped runs.
    Tolerance 1e-5 relative (both sum float32 products)."""
    s, eff, g = _k4_case(h, w, h + w + b, zeros)
    offs = np.random.default_rng(w).integers(-50, 200, w).astype(np.int32)
    want = jfused(jnp.asarray(s), jnp.asarray(eff),
                  jfft.circulant_matrix(jnp.asarray(g)),
                  jnp.asarray(offs % wc), wc, binning=b, interpret=True)
    got = tfused.rescan_fused_reference(_t(s), _t(eff), _t(g), _t(offs), wc,
                                        b)
    assert got.shape == (h // b, wc) and _rel(got, want) <= 1e-5
    # a CPU tensor takes the plain version through the kernel's wrapper
    assert torch.equal(tfused.rescan_fused(_t(s), _t(eff), _t(g), _t(offs),
                                           wc, b), got)


@pytest.mark.parametrize("b", [1, 2])
def test_k4_wrapped_windows_match_jax_interpret(b):
    """Frame windows that wrap the camera columns (binned window start
    ``xab`` with ``xab + lb > W/b``) under the engine's monotone offsets
    (R = 2): the chunks K4 places as two strips (``chunk_paths``), the
    plain version against the JAX kernel in interpret mode at 1e-5."""
    h, w, wc = 8, 32, 64 // b
    s, eff, g = _k4_case(h, w, 40 + b, True)
    paths = tfused.chunk_paths(w, b, _t(eff), _t(g))
    assert paths["split"] > 0 and paths["split"] + paths["strip"] == 2
    offs = np.round(np.arange(w) / b).astype(np.int32)
    want = jfused(jnp.asarray(s), jnp.asarray(eff),
                  jfft.circulant_matrix(jnp.asarray(g)),
                  jnp.asarray(offs % wc), wc, binning=b, interpret=True)
    got = tfused.rescan_fused_reference(_t(s), _t(eff), _t(g), _t(offs), wc,
                                        b)
    assert got.shape == (h // b, wc) and _rel(got, want) <= 1e-5


@pytest.mark.parametrize("w,b", [(2048, 1), (512, 2), (40, 1), (96, 3)])
def test_k4_chunk_paths(w, b):
    """``chunk_paths`` against a direct count: a chunk of 16 positions is
    split when one of its frame windows (``lb`` binned columns from ``xab
    = ((p + e0 + g0) mod W) // b``) runs past the last binned column."""
    x = np.arange(w) - w // 2
    eff = np.exp(-0.5 * (x / 3.0) ** 2).astype(np.float32)
    g = np.exp(-0.5 * (x / 2.0) ** 2).astype(np.float32)
    (e0, ne), (g0, ng) = tfused._run(_t(eff)), tfused._run(_t(g))
    lb = min(w // b, -(-(ne + ng - 1 + b - 1) // b))
    split = sum(any(((p + e0 + g0) % w) // b + lb > w // b
                    for p in range(p0, min(p0 + 16, w)))
                for p0 in range(0, w, 16))
    got = tfused.chunk_paths(w, b, _t(eff), _t(g))
    assert got == {"strip": -(-w // 16) - split, "split": split}
    assert tfused.chunk_paths(w, b, torch.zeros(w), _t(g)) == \
        {"strip": 0, "split": 0}


def test_k4_plain_checks_arguments():
    s, eff, g = _k4_case(8, 16, 0, False)
    with pytest.raises(ValueError, match="canvas"):
        tfused.rescan_fused_reference(_t(s), _t(eff), _t(g),
                                      torch.arange(16), 12)
    with pytest.raises(ValueError, match="binning"):
        tfused.rescan_fused_reference(_t(s), _t(eff), _t(g),
                                      torch.arange(16), 32, binning=3)
    with pytest.raises(ValueError, match="column"):
        tfused.rescan_fused_reference(_t(s), _t(eff)[:8], _t(g),
                                      torch.arange(16), 32)
    zero = torch.zeros(16)
    assert not tfused.rescan_fused_reference(_t(s), zero, _t(g),
                                             torch.arange(16), 32).any()


def _shortest_run(nonzero):
    """Brute force: the shortest circular run (start, length) holding every
    nonzero index."""
    w = nonzero.size
    if not nonzero.any():
        return 0, 0
    best = None
    for j0 in range(w):
        for n in range(1, w + 1):
            if all(((i - j0) % w) < n for i in np.flatnonzero(nonzero)):
                if best is None or n < best[1]:
                    best = (j0, n)
                break
    return best


@pytest.mark.parametrize("nz", [[], [4], [0, 11], [2, 3, 9], list(range(12)),
                                [10, 11, 0, 1], [1, 5, 6, 7]])
def test_k4_tap_run(nz):
    """``_run`` against brute force: runs that wrap, a full-width run and
    an all-zero profile (a shortest run of its length, holding every
    nonzero value)."""
    p = torch.zeros(12)
    p[nz] = 1.0 + torch.arange(len(nz), dtype=torch.float32)
    j0, n = tfused._run(p)
    want = _shortest_run(p.numpy() != 0)
    assert n == want[1]
    assert all(((i - j0) % 12) < n for i in nz)
    if len(nz) == 12:
        assert (j0, n) == (0, 12)


def test_k4_plain_is_the_placed_camera_frames():
    """K4's plain version equals the binned camera frames of
    ``frames.line_sted_camera_frames`` added at their offsets, on the
    engine's own inputs (the frames convolve by FFT: 1e-5 relative)."""
    params = T.RescanParams.create(**KW)
    geom = T.RescanGeometry(T.Grid(24, 40), rescan_factor=2.0, binning=2,
                            chunk=8)
    s = np.random.default_rng(3).random((24, 40), np.float32)
    pos = torch.arange(40)
    cams = tframes.line_sted_camera_frames(s, params, geom, pos,
                                           device="cpu")     # [C, H, W]
    binned = cams.reshape(40, 12, 2, 20, 2).sum((2, 4))
    offs = torch.round(1.0 * pos / 2).int()
    wc = geom.canvas_shape[1]
    want = rescan_accumulate_reference(torch.zeros(12, wc), binned, offs)
    otf_y = tfft.profile_to_otf1d(tpsf.detection_profile(24, 2.0))
    got = tfused.rescan_fused_reference(
        tfft.convolve_otf1d(torch.from_numpy(s), otf_y, axis=-2, n=24),
        params.brightness * trescan.effective_line_profile(40, params),
        tpsf.detection_profile(40, params.sigma_det), offs, wc, 2)
    assert _rel(got, want) <= 1e-5


# ---- K5's plain version against the JAX scatter-add ----------------------

@pytest.mark.parametrize("n,h,w,wc", [
    (6, 8, 16, 40), (5, 8, 16, 24), (4, 8, 30, 24), (7, 4, 50, 16)])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_k5_plain_matches_jax(n, h, w, wc, use_pallas):
    """``rescan_accumulate_reference`` against the JAX ``rescan_accumulate``
    (interpret-mode Pallas or its XLA reference): duplicate offsets,
    offsets beyond the canvas, a frame wider than ``wc - 8`` (the TPU
    wrapper gives way to XLA there) and wider than the canvas. Tolerance
    1e-5 relative."""
    rng = np.random.default_rng(n * w)
    canvas = rng.random((h, wc), np.float32)
    frames = rng.random((n, h, w), np.float32)
    offs = rng.integers(-2 * wc, 3 * wc, n).astype(np.int32)
    offs[1] = offs[0]
    want = jaccum.rescan_accumulate(jnp.asarray(canvas), jnp.asarray(frames),
                                    jnp.asarray(offs), use_pallas=use_pallas)
    got = rescan_accumulate(_t(canvas), _t(frames), _t(offs))
    assert _rel(got, want) <= 1e-5
    assert _rel(got, jaccum.rescan_accumulate_reference(
        jnp.asarray(canvas), jnp.asarray(frames), jnp.asarray(offs))) <= 1e-5
    with pytest.raises(ValueError):
        rescan_accumulate(_t(canvas), _t(frames)[:, :2], _t(offs))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n,h,w,wc", [(9, 6, 16, 40), (6, 4, 40, 40),
                                      (5, 3, 70, 24)])
def test_k5_plain_route_offsets(dtype, n, h, w, wc):
    """K5's route on CPU tensors (the plain version) with int32 and int64
    offsets that are negative, at least ``wc`` and duplicated: the canvas
    plus each frame added in order at its columns mod ``wc`` (numpy,
    float64), and the JAX reference, within 1e-6 relative."""
    rng = np.random.default_rng(n + w)
    canvas = rng.random((h, wc), np.float32)
    frames = rng.random((n, h, w), np.float32)
    offs = rng.integers(-3 * wc, 4 * wc, n)
    offs[:3] = (-wc - 1, wc, 2 * wc + 5)
    offs[3] = offs[0]
    want = canvas.astype(np.float64)
    for k in range(n):
        for x in range(w):
            want[:, (offs[k] + x) % wc] += frames[k, :, x]
    offsets = torch.from_numpy(offs).to(dtype)
    got = rescan_accumulate(_t(canvas), _t(frames), offsets)
    assert got.dtype == torch.float32 and got.shape == (h, wc)
    assert _rel(got, want) <= 1e-6
    assert _rel(got, jaccum.rescan_accumulate_reference(
        jnp.asarray(canvas), jnp.asarray(frames),
        jnp.asarray(offs.astype(np.int32)))) <= 1e-6


# ---- frames.py ------------------------------------------------------------

def test_line_camera_frames_match_jax():
    jp = J.LineSTEDParams.create(**KW)
    jg = J.LineSTEDGeometry(J.Grid(24, 40), chunk=8)
    s = np.random.default_rng(4).random((24, 40), np.float32)
    pos = np.array([0, 7, 39, 20])
    want = jframes.line_sted_camera_frames(jnp.asarray(s), jp, jg,
                                           jnp.asarray(pos))
    got = tframes.line_sted_camera_frames(
        s, params_from_jax(jp), T.LineSTEDGeometry(T.Grid(24, 40), chunk=8),
        torch.from_numpy(pos), device="cpu")
    assert got.shape == (4, 24, 40) and _rel(got, want) <= 1e-5
    noisy = tframes.line_sted_camera_frames(
        s, params_from_jax(jp), T.LineSTEDGeometry(T.Grid(24, 40), chunk=8),
        torch.from_numpy(pos), torch.Generator().manual_seed(0),
        device="cpu")
    assert torch.equal(noisy, noisy.round()) and (noisy >= 0).all()


@pytest.mark.parametrize("model", [None, jmodels.PupilDonutModel()])
def test_point_camera_frames_match_jax(model):
    jp = J.PointSTEDParams.create(sigma_exc=1.5, sigma_det=1.5,
                                  sigma_dep=1.5, depletion=4.0,
                                  brightness=50.0, model=model)
    jg = J.PointSTEDGeometry(J.Grid(20, 24), chunk=8)
    s = np.random.default_rng(5).random((20, 24), np.float32)
    pos = np.array([[0, 0], [10, 3], [19, 23]])
    want = jframes.point_sted_camera_frames(jnp.asarray(s), jp, jg,
                                            jnp.asarray(pos))
    got = tframes.point_sted_camera_frames(
        s, params_from_jax(jp), T.PointSTEDGeometry(T.Grid(20, 24), chunk=8),
        torch.from_numpy(pos), device="cpu")
    assert got.shape == (3, 20, 24) and _rel(got, want) <= 1e-5


# ---- every route without band windows ------------------------------------

class JWideExcModel:
    """The JAX suite's ``WideExcModel`` (no ``gaussian_excitation``)."""

    def excitation(self, width, params):
        return jnp.ones((width,), jnp.float32)

    def depletion(self, width, params):
        return jnp.zeros((width,), jnp.float32)


class TWideExcModel:
    def excitation(self, width, params, device=None):
        return torch.ones(width, device=device)

    def depletion(self, width, params, device=None):
        return torch.zeros(width, device=device)


@dataclasses.dataclass(frozen=True)
class JStripeNoBands(jmodels.GaussianStripeModel):
    gaussian_excitation = False


@dataclasses.dataclass(frozen=True)
class TStripeNoBands(T.physics.models.GaussianStripeModel):
    gaussian_excitation = False


MODELS = {"default": (None, None), "wide": (JWideExcModel, TWideExcModel),
          "stripe": (JStripeNoBands, TStripeNoBands)}
STEPS = [(2.0, 1), (3.0, 2), (1.5, 1), (1.0 + math.pi / 16, 2)]


def _both(model, rf, b, h=32, w=32, chunk=16):
    jm, tm = MODELS[model]
    jp = J.RescanParams.create(**KW, model=jm and jm())
    tp = T.RescanParams.create(**KW, model=tm and tm())
    return ((jp, J.RescanGeometry(J.Grid(h, w), rescan_factor=rf, binning=b,
                                  chunk=chunk)),
            (tp, T.RescanGeometry(T.Grid(h, w), rescan_factor=rf, binning=b,
                                  chunk=chunk)))


def _sample(h=32, w=32, seed=0):
    rng = np.random.default_rng(seed)
    ramp = np.linspace(0.2, 2.0, w, dtype=np.float32)[None, :]
    return (rng.random((h, w), np.float32) * ramp).astype(np.float32)


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("rf,b", STEPS)
@pytest.mark.parametrize("use_pallas", [False, True])
def test_no_band_scan_matches_jax(model, rf, b, use_pallas):
    """Noise-free scan without band windows (a 32-column grid is no wider
    than the default model's 128-column window; the other two models
    decline the windows) against the JAX scan with the same
    ``use_pallas``: the JAX package runs K4 in interpret mode, the scatter
    engine or phase accumulation. Tolerance 1e-5 relative L2."""
    (jp, jg), (tp, tg) = _both(model, rf, b)
    assert trescan._illum_band(tp, 32, 16, b) is None
    s = _sample(seed=1)
    want = jimaging.rescanned_line_sted_image(
        jnp.asarray(s), jp, jg, method="scan", use_pallas=use_pallas).image
    got = T.rescanned_line_sted_image(s, tp, tg, method="scan",
                                      use_pallas=use_pallas,
                                      device="cpu").image
    assert got.shape == tg.canvas_shape and _rel_l2(got, want) <= 1e-5


def _identity(calls, name):
    def sampler(lam, generator=None):
        calls.append(name)
        return lam.clamp_min(0.0)
    return sampler


# route: (rf, b, use_pallas, the sampler it must take)
ROUTES = {"k4": (2.0, 1, None, "k4"), "k4_binned": (3.0, 2, True, "k4"),
          "scatter_k5": (2.0, 1, False, "k2c"),
          "hybrid_k2b": (1.5, 1, None, "k2b"),
          "hybrid_k2b_irrational": (1.0 + math.pi / 16, 2, True, "k2b"),
          "subpixel_k2c": (1.5, 2, False, "k2c")}


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("model", ["default", "stripe"])
def test_per_step_routes_match_jax_collapsed(route, model, monkeypatch):
    """Each per-step route without band windows, its sampler replaced by
    the identity, against the JAX collapsed scan (1e-5 relative L2); the
    route takes its own sampler only."""
    rf, b, use_pallas, sampler = ROUTES[route]
    (jp, jg), (tp, tg) = _both(model, rf, b, h=32, w=64)
    s = _sample(32, 64, 2)
    calls = []
    monkeypatch.setattr(tfused, "poisson_reference", _identity(calls, "k4"))
    monkeypatch.setattr(trescan, "poisson_rows_tiered",
                        _identity(calls, "k2b"))
    monkeypatch.setattr(trescan, "maybe_poisson",
                        lambda g, m: _identity(calls, "k2c")(m, g))
    accumulated = []
    monkeypatch.setattr(trescan, "rescan_accumulate", lambda c, f, o: (
        accumulated.append(f.shape), rescan_accumulate(c, f, o))[1])
    got = T.rescanned_line_sted_image(
        s, tp, tg, torch.Generator().manual_seed(0), method="scan",
        noise_mode="per_step", use_pallas=use_pallas, device="cpu").image
    want = jimaging.rescanned_line_sted_image(jnp.asarray(s), jp, jg,
                                              method="scan").image
    assert _rel_l2(got, want) <= 1e-5
    assert set(calls) == {sampler}
    assert bool(accumulated) == (route == "scatter_k5")


@pytest.mark.parametrize("route", list(ROUTES))
def test_no_band_noise_statistics(route):
    """Per-step and collapsed noise on each route: totals within 5 sigma of
    the noise-free total, and the same generator seed gives the same
    image."""
    rf, b, use_pallas, _ = ROUTES[route]
    _, (tp, tg) = _both("wide", rf, b, h=32, w=64)
    s = torch.from_numpy(_sample(32, 64, 3))
    clean = T.rescanned_line_sted_image(s, tp, tg, method="scan",
                                        device="cpu").image
    total = float(clean.double().sum())
    for mode in ("per_step", "collapsed"):
        imgs = [T.rescanned_line_sted_image(
            s, tp, tg, torch.Generator().manual_seed(k), method="scan",
            noise_mode=mode, use_pallas=use_pallas, device="cpu").image
            for k in (0, 0, 1)]
        assert torch.equal(imgs[0], imgs[1])
        assert not torch.equal(imgs[0], imgs[2])
        for img in imgs:
            assert abs(float(img.double().sum()) - total) <= \
                5 * math.sqrt(total)


def test_boundaries_without_band_windows():
    """Padded and apodized boundaries on the full-frame routes, against
    the JAX package (the padded grid runs the same routes)."""
    (jp, jg), (tp, tg) = _both("stripe", 2.0, 1, h=16, w=32)
    s = _sample(16, 32, 4)
    for boundary in ("padded", "apodized"):
        want = jimaging.rescanned_line_sted_image(
            jnp.asarray(s), jp, jg, method="scan", boundary=boundary,
            margin=8).image
        got = T.rescanned_line_sted_image(s, tp, tg, method="scan",
                                          boundary=boundary, margin=8,
                                          device="cpu").image
        assert _rel_l2(got, want) <= 1e-5, boundary


def test_cpu_routes_launch_no_kernel():
    _, (tp, tg) = _both("wide", 2.0, 1)
    _build.reset_launches()
    for up in (None, True, False):
        T.rescanned_line_sted_image(_sample(), tp, tg,
                                    torch.Generator().manual_seed(0),
                                    method="scan", noise_mode="per_step",
                                    use_pallas=up, device="cpu")
    assert all(v == 0 for v in _build.LAUNCHES.values())


# ---- K4's static bound: runs beyond it take the hybrid --------------------

def _k4_layout_bytes(b, ne, ng):
    """Shared memory of K4's smallest layout, one binned row per block
    (``layout`` in ``csrc/rescan_fused.cu`` at rb = 1), in bytes."""
    def up(x, m):
        return (x + m - 1) // m * m

    def bank(n):
        return up(n - 1, 32) + 1

    window = b * (up(up(ne, 16), 32) + 16)
    frames = 16 * b * bank(up(ne + ng - 1, 16))
    return 4 * (up(ne, 16) + up(ng + 64, 4) + window + frames)


@pytest.mark.parametrize("b", [1, 2, 3, 4, 8, 16, 32])
def test_k4_run_bound_fits_its_layout(b):
    """Every pair of runs ``runs_fit`` admits fits a Hopper block's 227 KB
    (232448 bytes) less 1 KB for K4's static plan at one binned row per
    block, for any split of the combined run; at b = 1 the bound admits a
    combined run of 1704."""
    budget = tfused.MAX_RUN // b - 45            # ne + ng at the bound
    assert budget >= 2
    for ne in range(1, budget):
        assert _k4_layout_bytes(b, ne, budget - ne) <= 232448 - 1024, (b, ne)
    if b == 1:
        assert budget - 1 == 1704
    for ne, fits in ((budget - 4, True), (budget - 3, False)):
        narrow = torch.zeros(ne)
        narrow[ne // 2 - 2: ne // 2 + 2] = 1.0     # a 4-tap run
        assert tfused.runs_fit(torch.ones(ne), narrow, b) == fits


def test_rounded_runs_beyond_k4_take_the_hybrid(monkeypatch):
    """A rounded per-step scan whose tap runs exceed K4's bound (a flat
    excitation 512 columns wide at b = 4, R = 5: integral steps) takes the
    W-major K2b route with rounded phase ramps, on the CPU as on the card,
    for ``use_pallas`` None and True; with its draws replaced by the
    identity it matches the JAX scan (1e-5 relative L2). Collapsed noise
    with ``use_pallas=True`` takes phase accumulation."""
    h, w, b, rf, chunk = 8, 512, 4, 5.0, 32
    (jp, jg), (tp, tg) = _both("wide", rf, b, h=h, w=w, chunk=chunk)
    eff = T.imaging.line_sted.effective_line_profile(w, tp)
    gx = tpsf.detection_profile(w, tp.sigma_det)
    assert not tfused.runs_fit(tp.brightness * eff, gx, b)
    assert tfused.runs_fit(tp.brightness * eff, gx, 1)
    s = _sample(h, w, 5)
    want = jimaging.rescanned_line_sted_image(jnp.asarray(s), jp, jg,
                                              method="scan").image

    def no_k4(*args, **kw):
        raise AssertionError("K4 must not take runs beyond its bound")

    monkeypatch.setattr(trescan, "rescan_fused", no_k4)
    for use_pallas in (None, True):
        calls = []
        monkeypatch.setattr(trescan, "poisson_rows_tiered",
                            _identity(calls, "k2b"))
        got = T.rescanned_line_sted_image(
            s, tp, tg, torch.Generator().manual_seed(0), method="scan",
            noise_mode="per_step", use_pallas=use_pallas,
            device="cpu").image
        assert calls == ["k2b"] * (w // chunk)
        assert got.shape == tg.canvas_shape and _rel_l2(got, want) <= 1e-5
    got = T.rescanned_line_sted_image(s, tp, tg, method="scan",
                                      use_pallas=True, device="cpu").image
    assert _rel_l2(got, want) <= 1e-5

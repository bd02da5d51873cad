"""Port parity: Richardson-Lucy deconvolution
(``algorithms/richardson_lucy.py``) against the JAX package and the
float64 oracle on the CPU, on the same numpy inputs.

Every case of ``tests/test_richardson_lucy.py`` runs on the port (the
oracle multiview case at its 1e-4); the multiview and accelerated loops
are held to the JAX package at max|port - jax| / max|jax| <= 1e-5 after
20 and 40 iterations (on the star's views and on the FOV sweep's
lattice views), with the default and a given ``init``; the star's
accelerated run at 40 iterations through the JAX package's float64 run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rescan_line_sted_torch.algorithms import (
    richardson_lucy,
    richardson_lucy_views,
)
from rescan_line_sted_torch.data import samples as ts
from rescan_line_sted_torch.kernels import fftconv as tfft
from rescan_line_sted_torch.physics import psf as tpsf
from rescan_line_sted_tpu.algorithms import (
    richardson_lucy_views as j_rl_views,
)
from rescan_line_sted_tpu.config import Grid, LineSTEDGeometry, LineSTEDParams
from rescan_line_sted_tpu.data import samples as js
from rescan_line_sted_tpu.imaging.orientations import (
    multi_orientation_line_sted,
)
from rescan_line_sted_tpu.kernels import fftconv as jfft
from rescan_line_sted_tpu.physics import psf as jpsf
from tests.oracle import oracle

torch.set_num_threads(1)
TOL = 1e-5
SHAPE = (48, 48)                    # tests/test_richardson_lucy.py:12


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _views():
    """Two views of a star through detection PSFs of width 2.0 and 1.2
    (``tests/test_richardson_lucy.py:40-46``), as numpy arrays."""
    true = js.siemens_star(SHAPE, spokes=6) + 0.02
    psfs = [jpsf.detection_psf(SHAPE, 2.0), jpsf.detection_psf(SHAPE, 1.2)]
    data = [jfft.fft_convolve(true, p) for p in psfs]
    return (np.stack([np.asarray(d) for d in data]),
            np.stack([np.asarray(p) for p in psfs]))


def _lattice_views():
    """The FOV sweep's noise-free views: a 64^2 point lattice through the
    JAX package's line-STED at four orientations, and their kernels."""
    params = LineSTEDParams.create(depletion=8.0, brightness=200.0)
    geom = LineSTEDGeometry(Grid(64, 64), chunk=32)
    views, kernels = multi_orientation_line_sted(
        js.sparse_points((64, 64), spacing=24), params, geom,
        jnp.arange(4) * (jnp.pi / 4))
    return np.array(views), np.array(kernels)


def test_delta_psf_fixed_point():
    """With a delta PSF, any positive image is an RL fixed point."""
    img = ts.rings(SHAPE, device="cpu") + 0.1
    delta = torch.zeros(SHAPE)
    delta[24, 24] = 1.0
    out = richardson_lucy(img, delta, num_iter=5)
    assert rel_err(out, img) < 1e-5


def test_noise_free_convergence():
    """RL on noise-free data converges toward the true sample."""
    true = ts.rings(SHAPE, period=16.0, device="cpu") + 0.05
    psf = tpsf.detection_psf(SHAPE, 1.5, "cpu")
    data = tfft.fft_convolve(true, psf)
    est0 = richardson_lucy(data, psf, num_iter=1)
    est = richardson_lucy(data, psf, num_iter=150)
    assert rel_err(est, true) < rel_err(est0, true)
    assert rel_err(est, true) < 0.05


def test_matches_oracle_multiview():
    data, psfs = _views()
    got = richardson_lucy_views(torch.from_numpy(data),
                                torch.from_numpy(psfs), num_iter=20)
    want = oracle.richardson_lucy(list(data.astype(np.float64)),
                                  list(psfs.astype(np.float64)), num_iter=20)
    assert rel_err(got, want) < 1e-4


def test_flux_roughly_conserved():
    true = ts.rings(SHAPE, device="cpu") + 0.1
    psf = tpsf.detection_psf(SHAPE, 2.0, "cpu")
    data = tfft.fft_convolve(true, psf)
    est = richardson_lucy(data, psf, num_iter=30)
    assert abs(float(est.sum()) / float(data.sum()) - 1.0) < 1e-3


def test_accelerated_rl_converges_faster():
    """Biggs-Andrews acceleration reaches lower error at equal iterations,
    and long accelerated runs stay finite, positive and close."""
    true = ts.rings(SHAPE, period=16.0, device="cpu") + 0.05
    psf = tpsf.detection_psf(SHAPE, 2.0, "cpu")
    data = tfft.fft_convolve(true, psf)
    plain = richardson_lucy_views(data[None], psf[None], num_iter=40)
    accel = richardson_lucy_views(data[None], psf[None], num_iter=40,
                                  accelerate=True)
    assert rel_err(accel, true) < rel_err(plain, true)
    long = richardson_lucy_views(data[None], psf[None], num_iter=300,
                                 accelerate=True)
    assert torch.isfinite(long).all() and (long >= 0).all()
    assert rel_err(long, true) < 0.05


# (views, iterations, accelerate). The star's accelerated run at 40
# iterations is held to the JAX package's float64 run instead
# (test_accelerated_star_at_f32_floor)
JAX_CASES = [("star", 20, False), ("star", 40, False), ("star", 20, True),
             ("lattice", 20, False), ("lattice", 40, False),
             ("lattice", 20, True), ("lattice", 40, True)]


@pytest.mark.parametrize("case,num_iter,accelerate", JAX_CASES,
                         ids=[f"{c}-{n}-{'accel' if a else 'plain'}"
                              for c, n, a in JAX_CASES])
def test_multiview_matches_jax(case, num_iter, accelerate):
    data, psfs = _views() if case == "star" else _lattice_views()
    want = j_rl_views(jnp.asarray(data), jnp.asarray(psfs), num_iter,
                      accelerate=accelerate)
    got = richardson_lucy_views(torch.from_numpy(data),
                                torch.from_numpy(psfs), num_iter,
                                accelerate=accelerate)
    assert got.shape == data.shape[-2:] and got.dtype == torch.float32
    assert rel(got, want) <= TOL


def test_accelerated_star_at_f32_floor():
    """Biggs-Andrews extrapolation amplifies float32 rounding: after 40
    accelerated iterations on the star's views the JAX package's float32
    run lies ~7.7e-6 from its own float64 run of the same iteration, the
    port's ~7.2e-6, in other directions (~1.0e-5 apart). Both are held to
    the JAX package's float64 run at 1e-5."""
    data, psfs = _views()
    with jax.enable_x64(True):
        exact = j_rl_views(jnp.asarray(data, jnp.float64),
                           jnp.asarray(psfs, jnp.float64), 40,
                           accelerate=True)
        assert exact.dtype == jnp.float64
        exact = np.asarray(exact)
    want = j_rl_views(jnp.asarray(data), jnp.asarray(psfs), 40,
                      accelerate=True)
    got = richardson_lucy_views(torch.from_numpy(data),
                                torch.from_numpy(psfs), 40, accelerate=True)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    assert rel(want, exact) <= TOL
    assert rel(got, exact) <= TOL


@pytest.mark.parametrize("accelerate", [False, True],
                         ids=["plain", "accelerate"])
def test_given_init_matches_jax(accelerate):
    data, psfs = _views()
    rng = np.random.default_rng(4)
    init = (0.5 + rng.random(SHAPE)).astype(np.float32) * data.mean()
    want = j_rl_views(jnp.asarray(data), jnp.asarray(psfs), 20,
                      init=jnp.asarray(init), accelerate=accelerate)
    got = richardson_lucy_views(torch.from_numpy(data),
                                torch.from_numpy(psfs), 20,
                                init=torch.from_numpy(init),
                                accelerate=accelerate)
    assert rel(got, want) <= TOL
    assert not torch.equal(got, richardson_lucy_views(
        torch.from_numpy(data), torch.from_numpy(psfs), 20,
        accelerate=accelerate))


def test_sparse_background_stays_zero():
    """The scale guard pins the ratio to 0 where the forward model is ~0:
    a lattice of points keeps an empty background finite, as in JAX."""
    true = np.asarray(js.sparse_points(SHAPE, spacing=24))
    psf = np.array(jpsf.detection_psf(SHAPE, 1.5))
    data = np.array(jfft.fft_convolve(jnp.asarray(true), jnp.asarray(psf)))
    want = j_rl_views(jnp.asarray(data)[None], jnp.asarray(psf)[None], 40)
    got = richardson_lucy_views(torch.from_numpy(data)[None],
                                torch.from_numpy(psf)[None], 40)
    assert torch.isfinite(got).all()
    assert rel(got, want) <= TOL

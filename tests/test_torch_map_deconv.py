"""Port parity: MAP deconvolution (``algorithms/map_deconv.py``) against
the JAX package on the CPU, on the same numpy inputs.

The cases of ``tests/test_map_deconv.py`` at its step counts: the
estimate and every step's loss within max|port - jax| / max|jax| <= 1e-5
(rings, 300 steps; two anisotropic views, 1500 steps), and the file's
properties on the port. With total variation the loss holds at 1e-5 but
the estimate does not for any float32 run: the TV gradient ``d / sqrt(d^2
+ 1e-12)`` flips sign with rounding wherever neighbouring pixels are
nearly equal (at the file's flat start, everywhere), and the JAX
package's own float32 run lies 1.7e-2 from its float64 run after the
file's 50 steps. So the TV estimate is held to the JAX package's from a
start with real gradients, over 10 steps, and its losses over 50.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rescan_line_sted_torch.algorithms import map_deconvolve_views
from rescan_line_sted_tpu.algorithms import (
    map_deconvolve_views as jax_map,
)
from rescan_line_sted_tpu.data import samples
from rescan_line_sted_tpu.kernels import fftconv
from rescan_line_sted_tpu.physics import psf as psfs

torch.set_num_threads(1)
TOL = 1e-5
SHAPE = (48, 48)                         # tests/test_map_deconv.py:13


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _rings():
    """``test_loss_decreases_and_recovers``'s view and truth."""
    true = samples.rings(SHAPE, period=14.0) + 0.05
    psf = psfs.detection_psf(SHAPE, 1.8)
    data = 50.0 * fftconv.fft_convolve(true, psf)
    return (np.array(data)[None], np.array(psf)[None], np.array(true),
            dict(num_steps=300, learning_rate=0.1))


def _anisotropic():
    """``test_multiview_anisotropic_fusion``'s two orthogonal views."""
    true = samples.sparse_points(SHAPE, spacing=24) * 100.0
    y = jnp.arange(48.0)[:, None] - 24
    x = jnp.arange(48.0)[None, :] - 24
    p1 = jnp.exp(-(y / 4.0) ** 2 / 2 - (x / 1.2) ** 2 / 2)
    p1 = p1 / p1.sum()
    data = jnp.stack([fftconv.fft_convolve(true, p1),
                      fftconv.fft_convolve(true, p1.T)])
    return (np.array(data), np.array(jnp.stack([p1, p1.T])), np.array(true),
            dict(num_steps=1500, learning_rate=0.2))


def _tv():
    """``test_jit_and_tv``'s view, ``tv_weight=0.1``."""
    true = samples.rings(SHAPE) + 0.05
    psf = psfs.detection_psf(SHAPE, 1.5)
    data = 20.0 * fftconv.fft_convolve(true, psf)
    return (np.array(data)[None], np.array(psf)[None], np.array(true),
            dict(num_steps=50, tv_weight=0.1))


CASES = {"rings": _rings, "anisotropic": _anisotropic, "tv": _tv}


@functools.lru_cache(maxsize=None)
def _run(case, init_seed=None, **changes):
    data, psf, true, kw = CASES[case]()
    kw = dict(kw, **changes)
    init = None
    if init_seed is not None:
        rng = np.random.default_rng(init_seed)
        init = (data.mean() * (0.5 + rng.random(SHAPE))).astype(np.float32)
    want = jax_map(jnp.asarray(data), jnp.asarray(psf),
                   init=None if init is None else jnp.asarray(init), **kw)
    got = map_deconvolve_views(
        torch.from_numpy(data), torch.from_numpy(psf),
        init=None if init is None else torch.from_numpy(init), **kw)
    return data, true, [np.asarray(w) for w in want], got


@pytest.mark.parametrize("case", ["rings", "anisotropic"])
def test_matches_jax(case):
    _, _, (est, losses), (got_est, got_losses) = _run(case)
    assert got_est.shape == SHAPE and got_est.dtype == torch.float32
    assert got_losses.shape == losses.shape
    assert rel(got_est, est) <= TOL
    assert rel(got_losses, losses) <= TOL


@pytest.mark.parametrize("init_seed", [4, 5])
def test_tv_matches_jax_from_a_rough_start(init_seed):
    _, _, (est, _), (got_est, _) = _run("tv", init_seed, num_steps=10)
    assert rel(got_est, est) <= TOL
    _, _, (_, losses), (_, got_losses) = _run("tv", init_seed)
    assert rel(got_losses, losses) <= TOL


def test_loss_decreases_and_recovers():
    data, true, _, (est, losses) = _run("rings")
    assert losses[-1] < losses[0]
    est = est.numpy() / 50.0
    blur_err = np.linalg.norm(data[0] / 50.0 - true)
    assert np.linalg.norm(est - true) < 0.6 * blur_err
    assert (est >= 0).all()


def test_multiview_anisotropic_fusion():
    """The restored point is tighter than either PSF's wide axis."""
    est = _run("anisotropic")[3][0].numpy()
    peak = np.unravel_index(est.argmax(), est.shape)
    row = est[peak[0], :]
    assert (row > 0.5 * row.max()).sum() <= 8


def test_tv_is_finite_and_reads_nothing_back():
    """The file's TV case is finite; the losses stay a tensor on the
    estimate's device, one per step."""
    _, _, _, (est, losses) = _run("tv")
    assert torch.isfinite(est).all() and torch.isfinite(losses).all()
    assert isinstance(losses, torch.Tensor) and losses.shape == (50,)


def test_given_init_parameterisation():
    """``init`` maps to ``theta0 = log(expm1(max(init / scale, 1e-6)))``:
    zero steps return it (up to float32 rounding of the round trip)."""
    data, psf, _, _ = _rings()
    init = np.full(SHAPE, 2.0 * data.mean(), np.float32)
    est, losses = map_deconvolve_views(
        torch.from_numpy(data), torch.from_numpy(psf), num_steps=0,
        init=torch.from_numpy(init))
    assert losses.shape == (0,)
    assert rel(est, init) <= TOL

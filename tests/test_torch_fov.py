"""Port parity: the resolution / FOV sweep (``sweeps/fov.py``) against the
JAX package's on the CPU.

Noise-free, the case of ``tests/test_fov_sweep.py`` (sizes 48 and 96, two
angles, 30 RL iterations): every record column but the two times within
max|port - jax| / max|jax| <= 1e-5. With a generator: the JAX test's
properties, and the two timed calls seeing the same draws.
"""

import functools

import numpy as np
import pytest
import torch

from rescan_line_sted_torch.convert import params_from_jax
from rescan_line_sted_torch.sweeps import resolution_fov_sweep
from rescan_line_sted_torch.sweeps import fov as tfov
from rescan_line_sted_tpu.config import LineSTEDParams
from rescan_line_sted_tpu.sweeps import resolution_fov_sweep as jax_sweep

torch.set_num_threads(1)
TOL = 1e-5
JPARAMS = LineSTEDParams.create(sigma_exc=2.5, sigma_det=2.5,   # :10-12
                                stripe_period=10.0, depletion=8.0,
                                brightness=200.0)
PARAMS = params_from_jax(JPARAMS)
ARGS = dict(num_angles=2, rl_iters=30, spacing=24)
COLUMNS = ("fov", "scan_steps", "fused_fwhm_y", "fused_fwhm_x",
           "view_kernel_fwhm_y", "view_kernel_fwhm_x")


@functools.lru_cache(maxsize=None)
def _jax_records():
    return tuple(jax_sweep((48, 96), JPARAMS, **ARGS))


@pytest.mark.parametrize("column", COLUMNS)
def test_noise_free_records_match_jax(column):
    got = resolution_fov_sweep((48, 96), PARAMS, device="cpu", **ARGS)
    want = _jax_records()
    assert [r["fov"] for r in got] == [48, 96]
    g = np.array([r[column] for r in got], np.float64)
    w = np.array([r[column] for r in want], np.float64)
    assert np.isfinite(w).all()
    assert np.abs(g - w).max() <= TOL * np.abs(w).max()
    for r in got:
        assert set(r) == set(want[0])
        assert r["wall_s"] > 0 and r["compile_s"] > 0


def test_noisy_sweep_records():
    """``tests/test_fov_sweep.py`` on the port, with a generator: the
    fused point beats the view kernel's wide axis, and the scan steps."""
    recs = resolution_fov_sweep((48, 96), PARAMS, device="cpu",
                                generator=torch.Generator().manual_seed(0),
                                **ARGS)
    assert [r["fov"] for r in recs] == [48, 96]
    for r in recs:
        assert r["fused_fwhm_y"] < r["view_kernel_fwhm_y"]
        assert r["scan_steps"] == r["fov"] * 2
        assert r["wall_s"] > 0


def test_timed_calls_see_the_same_draws():
    """The generator's state is restored before the second call, so both
    calls draw the same views (as the JAX sweep calls its program twice
    with one key); one generator state gives one record set."""
    gen = torch.Generator().manual_seed(3)
    calls = []
    real = tfov.fused_views

    def spy(*args, **kw):
        out = real(*args, **kw)
        calls.append(out[0])
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfov, "fused_views", spy)
        recs = resolution_fov_sweep((48,), PARAMS, device="cpu",
                                    generator=gen, **ARGS)
    assert len(calls) == 2 and torch.equal(calls[0], calls[1])
    again = resolution_fov_sweep((48,), PARAMS, device="cpu",
                                 generator=torch.Generator().manual_seed(3),
                                 **ARGS)
    for col in COLUMNS:
        assert recs[0][col] == again[0][col]


def test_lattice_patches_are_the_jax_slices():
    """The one gather cuts the patches ``lax.dynamic_slice`` cuts: at
    each lattice point at and next to the centre (a blob of its own
    width on each), then one NaN-mean per axis."""
    size, spacing = 96, 24
    half = spacing // 2
    c = half + spacing * ((size // 2 - half) // spacing)
    centers = [c, c - spacing, c + spacing]
    y = torch.arange(size, dtype=torch.float32)[:, None]
    x = torch.arange(size, dtype=torch.float32)[None, :]
    fused = torch.zeros(size, size)
    for i, cy in enumerate(centers):
        for j, cx in enumerate(centers):
            sy, sx = 1.0 + 0.3 * i, 1.5 + 0.2 * j
            fused += torch.exp(-(y - cy) ** 2 / (2 * sy ** 2)
                               - (x - cx) ** 2 / (2 * sx ** 2))
    want = torch.stack([
        torch.stack(tfov.fwhm_2d(fused[cy - half:cy + half,
                                       cx - half:cx + half]))
        for cy in centers for cx in centers])
    kernel = torch.exp(-(y - size // 2) ** 2 / 8 - (x - size // 2) ** 2 / 2)
    got = tfov.lattice_fwhm(fused, kernel[None], spacing)
    assert torch.isfinite(want).all()
    assert torch.equal(got[:2], want.mean(0))
    assert torch.equal(got[2:], torch.stack(tfov.fwhm_2d(kernel)))

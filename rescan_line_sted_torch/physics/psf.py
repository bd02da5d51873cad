"""PSF synthesis and the saturable-depletion nonlinearity.

Port of ``rescan_line_sted_tpu.physics.psf``. Conventions are the JAX
package's:

* a centered profile (or 2D PSF) has its peak at index ``n // 2`` (on
  every axis);
* illumination profiles are peak-normalized, detection profiles are
  sum-normalized;
* distances are in simulation pixels; everything is float32;
* a scalar parameter is a number or a 0-d float32 tensor (a tensor's
  gradient flows through every helper; the hard pinhole and slit masks
  give none, as in the JAX package).
"""

from __future__ import annotations

import math

import numpy as np
import torch

# A number's scalar arithmetic is done in numpy float32 (as the JAX package
# does it on f32 scalars), and the result enters torch as a Python scalar,
# so no host-to-device copy (and no stall) is needed for it. A 0-d tensor
# field (a calibration fit's) is computed with torch ops on its own device,
# so that autograd sees it.
from rescan_line_sted_torch.config import _f as _f32


def _scalar(x):
    """A field as torch ops take it: a tensor as it is, a number as the
    Python float of its float32 value."""
    return x if isinstance(x, torch.Tensor) else _f32(x)


def _centered_coords(n: int, device=None) -> torch.Tensor:
    """Signed pixel offsets from the grid center ``n // 2``."""
    return torch.arange(n, dtype=torch.float32, device=device) - (n // 2)


def _two_sigma_sq(sigma):
    if isinstance(sigma, torch.Tensor):
        return 2.0 * sigma.square()
    s = np.float32(sigma)
    return _f32(np.float32(2.0) * s * s)


def _gaussian(x: torch.Tensor, sigma) -> torch.Tensor:
    return torch.exp(-x.square() / _two_sigma_sq(sigma))


def radius_sq(shape: tuple[int, int], device=None) -> torch.Tensor:
    """Squared distance from the grid center, [H, W]."""
    y = _centered_coords(shape[0], device)[:, None]
    x = _centered_coords(shape[1], device)[None, :]
    return y * y + x * x


def gaussian_psf(shape: tuple[int, int], sigma, device=None) -> torch.Tensor:
    """Peak-normalized 2D Gaussian intensity PSF, centered."""
    return torch.exp(-radius_sq(shape, device) / _two_sigma_sq(sigma))


def donut_psf(shape: tuple[int, int], sigma, device=None) -> torch.Tensor:
    """Peak-normalized depletion donut ``u e^{1-u}``, ``u = r^2 / (2
    sigma^2)``: zero at the center, 1 on the ring ``r = sigma sqrt(2)``."""
    u = radius_sq(shape, device) / _two_sigma_sq(sigma)
    return u * torch.exp(1.0 - u)


def detection_psf(shape: tuple[int, int], sigma, device=None) -> torch.Tensor:
    """Sum-normalized Gaussian detection PSF, centered, [H, W]."""
    g = gaussian_psf(shape, sigma, device)
    return g / g.sum()


def pinhole_mask(shape: tuple[int, int], radius, device=None) -> torch.Tensor:
    """Centered descanned-pinhole integration mask (1 inside, 0 outside)."""
    if isinstance(radius, torch.Tensor):
        r_sq = radius.square()
    else:
        r = np.float32(radius)
        r_sq = _f32(r * r)
    return (radius_sq(shape, device) <= r_sq).to(torch.float32)


def slit_profile(width: int, halfwidth, device=None) -> torch.Tensor:
    """Centered descanned-slit integration profile along x, [W]."""
    x = _centered_coords(width, device)
    return (x.abs() <= _scalar(halfwidth)).to(torch.float32)


def line_excitation_profile(width: int, sigma, device=None) -> torch.Tensor:
    """Peak-normalized 1D Gaussian excitation line profile along x, [W]."""
    return _gaussian(_centered_coords(width, device), sigma)


def stripe_depletion_profile(width: int, period, device=None) -> torch.Tensor:
    """Peak-normalized standing-wave depletion stripe ``sin^2(pi x / P)``."""
    x = _centered_coords(width, device)
    return torch.sin(math.pi * x / _scalar(period)).square()


def detection_profile(n: int, sigma, device=None) -> torch.Tensor:
    """Sum-normalized 1D Gaussian detection profile, centered, [n].

    The 2D detection PSF is the outer product of two such profiles, which
    lets the scan engine hoist the y-convolution out of the scan loop.
    """
    g = _gaussian(_centered_coords(n, device), sigma)
    return g / g.sum()


def effective_psf(exc: torch.Tensor, dep: torch.Tensor, s) -> torch.Tensor:
    """Saturable-depletion effective illumination: ``exc * exp(-s * dep)``."""
    return exc * torch.exp(-_scalar(s) * dep)

"""PSF synthesis and the saturable-depletion nonlinearity (1D line profiles).

Port of ``rescan_line_sted_tpu.physics.psf``, restricted to what the
rescanned line-STED path builds. Conventions are the JAX package's:

* a centered profile has its peak at index ``n // 2``;
* illumination profiles are peak-normalized, detection profiles are
  sum-normalized;
* distances are in simulation pixels; everything is float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Scalar arithmetic is done in numpy float32 (as the JAX package does it on
# f32 scalars), and the result enters torch as a Python scalar, so no
# host-to-device copy (and no stall) is needed for it.
from rescan_line_sted_torch.config import _f as _f32


def _centered_coords(n: int, device=None) -> torch.Tensor:
    """Signed pixel offsets from the grid center ``n // 2``."""
    return torch.arange(n, dtype=torch.float32, device=device) - (n // 2)


def _gaussian(x: torch.Tensor, sigma) -> torch.Tensor:
    s = np.float32(sigma)
    return torch.exp(-x.square() / _f32(np.float32(2.0) * s * s))


def line_excitation_profile(width: int, sigma, device=None) -> torch.Tensor:
    """Peak-normalized 1D Gaussian excitation line profile along x, [W]."""
    return _gaussian(_centered_coords(width, device), sigma)


def stripe_depletion_profile(width: int, period, device=None) -> torch.Tensor:
    """Peak-normalized standing-wave depletion stripe ``sin^2(pi x / P)``."""
    x = _centered_coords(width, device)
    return torch.sin(math.pi * x / _f32(period)).square()


def detection_profile(n: int, sigma, device=None) -> torch.Tensor:
    """Sum-normalized 1D Gaussian detection profile, centered, [n].

    The 2D detection PSF is the outer product of two such profiles, which
    lets the scan engine hoist the y-convolution out of the scan loop.
    """
    g = _gaussian(_centered_coords(n, device), sigma)
    return g / g.sum()


def effective_psf(exc: torch.Tensor, dep: torch.Tensor, s) -> torch.Tensor:
    """Saturable-depletion effective illumination: ``exc * exp(-s * dep)``."""
    return exc * torch.exp(-_f32(s) * dep)

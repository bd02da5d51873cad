"""Procedural ground-truth samples (port of the JAX package's
``data/samples.py``). Nonnegative f32 fluorophore density with peak ~1,
made on ``device`` (None: the CUDA card; raises without one)."""

from __future__ import annotations

import math

import torch

from rescan_line_sted_torch.device import resolve


def _grid(shape: tuple[int, int], device):
    y = (torch.arange(shape[0], dtype=torch.float32, device=device)
         - shape[0] // 2)[:, None]
    x = (torch.arange(shape[1], dtype=torch.float32, device=device)
         - shape[1] // 2)[None, :]
    return y, x


def siemens_star(shape: tuple[int, int], spokes: int = 16,
                 inner: float = 2.0, device=None) -> torch.Tensor:
    """Siemens-star resolution target: spoke spacing shrinks toward center."""
    device = resolve(device)
    y, x = _grid(shape, device)
    theta = torch.atan2(y, x)
    r = torch.sqrt(y * y + x * x)
    star = 0.5 * (1.0 + torch.sin(spokes * theta))
    edge = min(shape) / 2.0 - 1.0
    return torch.where((r > inner) & (r < edge), star,
                       torch.zeros((), device=device))


def rings(shape: tuple[int, int], period: float = 12.0,
          device=None) -> torch.Tensor:
    """Concentric rings with fixed radial period."""
    device = resolve(device)
    y, x = _grid(shape, device)
    r = torch.sqrt(y * y + x * x)
    img = 0.5 * (1.0 + torch.cos(2.0 * math.pi * r / period))
    edge = min(shape) / 2.0 - 1.0
    return torch.where(r < edge, img, torch.zeros((), device=device))


def line_pairs(shape: tuple[int, int], min_period: int = 4,
               max_period: int = 32, device=None) -> torch.Tensor:
    """Vertical line pairs with spacing increasing left to right: each
    band holds lines at one spatial period, the period chirped smoothly
    from ``min_period`` up to ``max_period`` pixels across the field."""
    device = resolve(device)
    h, w = shape
    x = torch.arange(w, dtype=torch.float32, device=device)
    frac = x / max(w - 1, 1)
    period = min_period * (max_period / min_period) ** frac
    phase = torch.cumsum(2.0 * math.pi / period, 0)
    stripes = 0.5 * (1.0 + torch.sin(phase))
    return stripes[None, :].expand(h, w).contiguous()


def sparse_points(shape: tuple[int, int], spacing: int = 24,
                  device=None) -> torch.Tensor:
    """Isolated point emitters on a regular lattice (PSF measurement)."""
    img = torch.zeros(shape, dtype=torch.float32, device=resolve(device))
    img[spacing // 2::spacing, spacing // 2::spacing] = 1.0
    return img

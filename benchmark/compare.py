"""The comparisons that decide ``correct``: a noise-free output against the
plain reference, and a noisy one against the Poisson law of the
reference's mean. Every number is a magnitude that a sound run keeps
small; each cell's limits are in its ``workloads/<cell>.json``.
"""

from __future__ import annotations

import math

import torch


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest absolute gap over the reference's largest magnitude (NaN
    where the shapes differ or the output is not finite)."""
    if tuple(got.shape) != tuple(want.shape):
        return math.nan
    got = got.to(want.device, torch.float64)
    if not bool(torch.isfinite(got).all()):
        return math.nan
    return float((got - want).abs().max() / want.abs().max())


def total_z(counts: torch.Tensor, mean: torch.Tensor) -> float:
    """|sum(counts) - sum(mean)| in standard deviations of a sum of
    independent Poisson counts whose means sum to ``sum(mean)``."""
    c = float(counts.to(mean.device, torch.float64).sum())
    m = float(mean.sum())
    return abs(c - m) / math.sqrt(m) if m > 0 else math.nan


def block_sums(x: torch.Tensor, block) -> torch.Tensor:
    """Sums over tiles of the last two dimensions, ``block`` rows by
    ``block`` columns, or ``block[0]`` by ``block[1]`` for a pair (a sum of
    independent Poisson counts is Poisson in the summed mean); rows and
    columns past the last whole tile are left out."""
    by, bx = (block, block) if isinstance(block, int) else block
    if by == bx == 1:
        return x
    *lead, h, w = x.shape
    h, w = h // by, w // bx
    return x[..., :h * by, :w * bx].reshape(*lead, h, by, w, bx).sum((-3, -1))


def dispersion_z(counts: torch.Tensor, mean: torch.Tensor,
                 min_mean: float = 1.0) -> float:
    """|z| of the Poisson dispersion over the entries whose mean reaches
    ``min_mean``: ``sum((c - m)^2 / m - 1)`` against its standard
    deviation ``sqrt(sum(2 + 1 / m))``. Counts drawn from the right means
    read ~N(0, 1); counts without noise read ``sqrt(n / 2)``; counts
    whose spread is doubled read ``sqrt(n / 2)`` too."""
    c = counts.to(mean.device, torch.float64).flatten()
    m = mean.flatten()
    keep = m >= min_mean
    if not bool(keep.any()):
        return math.nan
    c, m = c[keep], m[keep]
    if not bool(torch.isfinite(c).all()):
        return math.nan
    num = float(((c - m).square() / m - 1.0).sum())
    return abs(num) / math.sqrt(float((2.0 + 1.0 / m).sum()))

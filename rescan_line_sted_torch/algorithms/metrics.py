"""Resolution metrics (port of ``fwhm_1d`` from the JAX package's
``algorithms/metrics.py``; the rest of that module is queued in
ROADMAP.md open item 10)."""

from __future__ import annotations

import math

import torch


def fwhm_1d(profile: torch.Tensor) -> torch.Tensor:
    """Full width at half maximum of a 1D profile, subpixel, in pixels.

    The profile must have ONE lobe above half maximum; crossings are found
    by linear interpolation between samples. Returns NaN when the contract
    is violated (multi-lobed, flat or non-positive profiles, or a half-max
    level never crossed on one side).
    """
    peak_val = profile.max()
    flat = (peak_val <= 0) | (peak_val <= profile.min())
    p = profile / torch.where(flat, 1.0, peak_val)
    n = p.shape[-1]
    idx = torch.arange(n, dtype=p.dtype, device=p.device)
    half = 0.5
    above = p >= half
    n_crossings = (above[:-1] != above[1:]).sum()
    boundary_above = above[0].int() + above[-1].int()
    multi_lobed = (n_crossings + boundary_above) > 2
    peak = torch.argmax(p)
    left_cand = torch.where((~above[:-1]) & above[1:] & (idx[:-1] < peak),
                            idx[:-1], -math.inf)
    i_l = left_cand.max()
    right_cand = torch.where(above[:-1] & (~above[1:]) & (idx[:-1] >= peak),
                             idx[:-1], math.inf)
    i_r = right_cand.min()

    def interp(i):
        # non-finite i (no crossing) is masked out by ``ok`` below
        i0 = torch.nan_to_num(i, posinf=0.0, neginf=0.0).long().clamp(0, n - 2)
        y0, y1 = p[i0], p[i0 + 1]
        t = (half - y0) / torch.where(y1 == y0, 1.0, y1 - y0)
        return i0.to(p.dtype) + t

    x_l = interp(i_l)
    x_r = interp(i_r)
    ok = torch.isfinite(i_l) & torch.isfinite(i_r) & ~multi_lobed & ~flat
    return torch.where(ok, x_r - x_l, math.nan)

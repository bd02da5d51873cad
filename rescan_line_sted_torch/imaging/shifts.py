"""Gather-based circular shifts of centered profiles and PSFs to scan
positions (port of ``rescan_line_sted_tpu.imaging.shifts``).

A centered array has its peak at ``n // 2``; shifting it "to position p"
places the peak at index p, wrapping circularly:
``shifted[i] = arr[(i - p + n//2) % n]``.
"""

from __future__ import annotations

import torch


def shifted_profiles(profile: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
    """Shift a centered 1D profile [W] to each position: out [C, W]."""
    w = profile.shape[-1]
    idx = (torch.arange(w, device=profile.device)[None, :]
           - positions[:, None] + w // 2) % w
    return profile[idx]


def shifted_images(psf: torch.Tensor,
                   positions_yx: torch.Tensor) -> torch.Tensor:
    """Shift a centered 2D PSF [H, W] to each (y, x) position: out
    [C, H, W]."""
    h, w = psf.shape
    iy = (torch.arange(h, device=psf.device)[None, :]
          - positions_yx[:, 0:1] + h // 2) % h                   # [C, H]
    ix = (torch.arange(w, device=psf.device)[None, :]
          - positions_yx[:, 1:2] + w // 2) % w                   # [C, W]
    return psf[iy[:, :, None], ix[:, None, :]]


def flip_centered(arr: torch.Tensor) -> torch.Tensor:
    """Point-reflect a centered array through the grid center:
    ``out[i] = in[(2c - i) % n]`` with ``c = n // 2``, on every axis."""
    out = arr
    for ax in range(arr.ndim):
        out = torch.flip(out, dims=(ax,))
        if arr.shape[ax] % 2 == 0:
            out = torch.roll(out, 1, dims=ax)
    return out

"""Circular 1D convolution helpers on ``torch.fft`` (port of the JAX
package's ``kernels/fftconv.py``, which XLA computes outside any kernel).

Kernels are supplied centered (peak at ``n // 2``); convolutions are
circular on the simulation grid.
"""

from __future__ import annotations

import torch


def circulant_matrix(profile: torch.Tensor) -> torch.Tensor:
    """Centered 1D kernel [W] -> circulant matrix ``M[a, x] = k(x - a)``.

    ``img @ M`` is circular convolution along the last axis.
    """
    w = profile.shape[-1]
    a = torch.arange(w, device=profile.device)
    return profile[(a[None, :] - a[:, None] + w // 2) % w]


def circulant_window(profile: torch.Tensor, d_rows: int, d_cols: int,
                     s_row: int, s_col: int) -> torch.Tensor:
    """Banded window of the transposed circulant, straight from the profile:
    ``W[r, c] = k((r - s_row) - (c - s_col))`` for ``r < d_rows``,
    ``c < d_cols`` (equal to rows ``(arange(d_rows) - s_row) % w`` and
    columns ``(arange(d_cols) - s_col) % w`` of ``circulant_matrix(p).T``).
    """
    w = profile.shape[-1]
    r = torch.arange(d_rows, device=profile.device)[:, None] - s_row
    c = torch.arange(d_cols, device=profile.device)[None, :] - s_col
    return profile[(r - c + w // 2) % w]


def profile_to_otf1d(profile: torch.Tensor) -> torch.Tensor:
    """Centered 1D kernel [n] -> 1D OTF [n//2+1] (rfft)."""
    return torch.fft.rfft(torch.fft.ifftshift(profile, dim=-1))


def convolve_otf1d(img: torch.Tensor, otf: torch.Tensor, axis: int,
                   n: int) -> torch.Tensor:
    """Circular 1D convolution along ``axis`` with a precomputed 1D OTF."""
    spec = torch.fft.rfft(img, dim=axis)
    shape = [1] * spec.ndim
    shape[axis] = otf.shape[-1]
    return torch.fft.irfft(spec * otf.reshape(shape), n=n, dim=axis)

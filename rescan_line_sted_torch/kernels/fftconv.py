"""Circular FFT convolution helpers on ``torch.fft`` (port of the JAX
package's ``kernels/fftconv.py``, which XLA computes outside any kernel).

Kernels are supplied centered (peak at ``n // 2`` on every axis);
convolutions are circular on the simulation grid; 2D helpers batch over
leading axes.
"""

from __future__ import annotations

import math

import torch


def kernel_to_otf(kernel: torch.Tensor) -> torch.Tensor:
    """Centered real kernel [..., H, W] -> OTF [..., H, W//2+1] (rfft2)."""
    return torch.fft.rfft2(torch.fft.ifftshift(kernel, dim=(-2, -1)))


def convolve_otf(img: torch.Tensor, otf: torch.Tensor,
                 shape=None) -> torch.Tensor:
    """Circular convolution of ``img`` [..., H, W] with a precomputed OTF."""
    shape = tuple(img.shape[-2:]) if shape is None else shape
    return torch.fft.irfft2(torch.fft.rfft2(img) * otf, s=shape)


def correlate_otf(img: torch.Tensor, otf: torch.Tensor,
                  shape=None) -> torch.Tensor:
    """Circular cross-correlation ``out(r) = sum_a img(a) k(a - r)``:
    multiplication by ``conj(otf)`` in the spectral domain."""
    shape = tuple(img.shape[-2:]) if shape is None else shape
    return torch.fft.irfft2(torch.fft.rfft2(img) * otf.conj(), s=shape)


def correlate_otf_at(img: torch.Tensor, otf: torch.Tensor,
                     pos: torch.Tensor) -> torch.Tensor:
    """``correlate_otf(img, otf)`` at ONE pixel per batch element, with no
    inverse FFT: ``img`` real [C, H, W], ``otf`` [H, W//2+1] (or [C, H,
    W//2+1]), ``pos`` integer [C, 2] as (y, x); returns [C].

    The irfft2 of ``S = rfft2(img) * conj(otf)`` at (y, x) is ``(1/(H W))
    Re(sum_{ky,kx} wx[kx] S[ky,kx] e^{2 pi i ky y / H} e^{2 pi i kx x /
    W})``, ``wx`` folding the Hermitian half of the rfft axis (1 at kx = 0
    and, for even W, at kx = W/2; 2 elsewhere). ``ky * y`` reaches (H-1)^2,
    past float32's exact integers, so phases are reduced modulo H (W) in
    int64 before the float32 ``exp``.
    """
    h, w = img.shape[-2:]
    wr = w // 2 + 1
    spec = torch.fft.rfft2(img) * otf.conj()
    wx = torch.full((wr,), 2.0, device=img.device)
    wx[0] = 1.0
    if w % 2 == 0:
        wx[-1] = 1.0
    ky = torch.arange(h, device=img.device)
    kx = torch.arange(wr, device=img.device)
    py = (pos[:, 0:1].long() * ky[None, :]) % h                  # [C, H]
    px = (pos[:, 1:2].long() * kx[None, :]) % w                  # [C, Wr]
    ey = torch.polar(torch.ones(py.shape, device=img.device),
                     (2.0 * math.pi / h) * py.float())
    ex = torch.polar(torch.ones(px.shape, device=img.device),
                     (2.0 * math.pi / w) * px.float()) * wx
    t = torch.einsum("...hw,...w->...h", spec, ex)
    vals = torch.einsum("...h,...h->...", t, ey)
    return vals.real / (h * w)


def fft_convolve(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """One-shot circular convolution with a centered kernel."""
    return convolve_otf(img, kernel_to_otf(kernel))


def fft_correlate(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """One-shot circular correlation with a centered kernel."""
    return correlate_otf(img, kernel_to_otf(kernel))


def convolve_profiles(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Circular 1D convolution of two centered profiles -> centered
    profile."""
    n = a.shape[-1]
    spec = (torch.fft.rfft(torch.fft.ifftshift(a, dim=-1))
            * torch.fft.rfft(torch.fft.ifftshift(b, dim=-1)))
    return torch.fft.fftshift(torch.fft.irfft(spec, n=n), dim=-1)


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

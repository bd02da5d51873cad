"""Fourier Ring Correlation: resolution measured from two independent
noisy acquisitions of one field (port of the JAX package's
``algorithms/frc.py``; Nieuwenhuizen et al., Nat. Methods 10, 557 (2013)).

The JAX package bins the rFFT2 bins into rings with a one-hot matmul, a
TPU workaround (segment sums lower poorly there). The port builds each
ring's member bins once on the host in numpy (``_ring_index``,
``_sector_ring_index``; cached per shape, ring count, sector and device)
and sums them with gathers and ``torch.sum``: the bins of each ring are
laid out in rows of ``_ROW`` (padded with a zero), each row is summed, and
each ring sums its rows the same way. No matmul runs, so TF32 plays no
part, and no atomics run, so one input gives the same bits on every call
(``index_add_`` on the card would add in a varying order). Nothing reads
a value back to the host: the results stay 0-d tensors on the input's
device. Each call of a public resolution entry is one span ``rls.frc``.

Conventions, as in the JAX package: the DC ring and rings left empty are
dropped; a resolution is ``1 / k_c`` at the first ring where the curve
falls below the threshold, linearly interpolated; NaN if it never falls
below, 2.0 (Nyquist) if it starts below.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from rescan_line_sted_torch.device import host_table
from rescan_line_sted_torch.utils.observability import span

_ROW = 256   # bins summed per row of the first gather


def _frequencies(shape: tuple[int, int]):
    h, w = shape
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    return fy, fx, np.sqrt(fy * fy + fx * fx)


def _rings_of(r: np.ndarray, num_rings: int, member: np.ndarray):
    """Ring of each rFFT2 bin (-1: dropped) and the kept rings' mean
    frequencies (float32), for the bins where ``member`` holds."""
    idx = np.minimum((r / 0.5 * num_rings).astype(np.int64), num_rings - 1)
    idx = np.where(member, idx, -1).ravel()
    on = idx >= 0
    counts = np.bincount(idx[on], minlength=num_rings)
    freqs = (np.bincount(idx[on], weights=r.ravel()[on],
                         minlength=num_rings) / np.maximum(counts, 1.0))
    keep = counts > 0
    keep[0] = False  # DC ring: 0/0 after mean subtraction
    new_id = np.where(keep, np.cumsum(keep) - 1, -1)
    return (np.where(on, new_id[np.maximum(idx, 0)], -1),
            freqs[keep].astype(np.float32))


def _ring_index(shape: tuple[int, int], num_rings: int):
    """Kept ring of each bin of ``rfft2`` on ``shape`` ([H * (W//2+1)],
    -1 for the DC ring and bins of empty rings) and the rings' mean
    frequencies [R] in cycles/pixel: the JAX ``_ring_matrix``'s rows as
    indices."""
    _, _, r = _frequencies(shape)
    return _rings_of(r, num_rings, np.ones(r.shape, bool))


def _sector_ring_index(shape: tuple[int, int], num_rings: int, axis: str,
                       half_angle_deg: float):
    """As ``_ring_index``, restricted to the bins whose frequency vector
    lies within ``half_angle_deg`` of the kx axis (``axis='x'``) or the ky
    axis (``'y'``): the JAX ``_sector_ring_matrix``'s rows as indices."""
    fy, fx, r = _frequencies(shape)
    # angle from the kx axis in [0, 90] deg (rfft half-plane; |fy| folds
    # the hermitian symmetry, which FRC already assumes)
    ang = np.degrees(np.arctan2(np.abs(fy), np.abs(fx)) * np.ones_like(r))
    in_sector = (ang <= half_angle_deg if axis == "x"
                 else ang >= 90.0 - half_angle_deg)
    return _rings_of(r, num_rings, in_sector)


@functools.lru_cache(maxsize=32)
def _plan(shape, num_rings, sector, device):
    """Gather tables of the ring sums on ``device``: ``rows`` [n_rows,
    _ROW] holds each ring's bins (``n_bins`` pads), ``ring_rows`` [R,
    max rows] each ring's rows (``n_rows`` pads); and the ring
    frequencies [R]."""
    if sector is None:
        ring, freqs = _ring_index(shape, num_rings)
    else:
        ring, freqs = _sector_ring_index(shape, num_rings, *sector)
    n_bins = ring.size
    order = np.argsort(ring, kind="stable")
    order = order[ring[order] >= 0]                  # kept bins by ring
    sizes = np.bincount(ring[order], minlength=freqs.size)
    n_rows = -(-sizes // _ROW)                       # rows of each ring
    first_row = np.cumsum(n_rows) - n_rows
    first_bin = np.cumsum(sizes) - sizes
    k = ring[order]
    slot = first_row[k] * _ROW + np.arange(order.size) - first_bin[k]
    rows = np.full(n_rows.sum() * _ROW, n_bins, np.int64)
    rows[slot] = order
    j = np.arange(n_rows.max())[None, :]
    table = np.where(j < n_rows[:, None], first_row[:, None] + j,
                     n_rows.sum())
    return (host_table(rows.reshape(-1, _ROW), device),
            host_table(table, device), host_table(freqs, device))


def _ring_sums(values: torch.Tensor, shape, num_rings, sector=None):
    """Sums over each kept ring of ``values`` [n, H * (W//2+1)] -> [n, R],
    and the ring frequencies [R]."""
    rows, ring_rows, freqs = _plan(tuple(shape), num_rings, sector,
                                   values.device)
    pad = values.new_zeros(values.shape[0], 1)
    per_row = torch.cat([values, pad], 1)[:, rows].sum(-1)
    return torch.cat([per_row, pad], 1)[:, ring_rows].sum(-1), freqs


def _spectra(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """``[Re F1 conj F2, |F1|^2, |F2|^2]`` per rFFT2 bin, [3, bins], of
    the mean-subtracted images."""
    f1 = torch.fft.rfft2(img1 - img1.mean())
    f2 = torch.fft.rfft2(img2 - img2.mean())
    return torch.stack([torch.real(f1 * torch.conj(f2)), f1.abs() ** 2,
                        f2.abs() ** 2]).reshape(3, -1)


def _correlation(sums: torch.Tensor) -> torch.Tensor:
    return sums[0] / torch.sqrt(sums[1] * sums[2]).clamp_min(1e-30)


def frc_curve(img1: torch.Tensor, img2: torch.Tensor,
              num_rings: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """FRC(k) between two independent acquisitions [H, W] of one field.

    Returns ``(freqs, frc)``: ring-centre spatial frequencies in
    cycles/pixel (0 .. 0.5) and the correlation per ring,

        FRC(k) = Re sum_ring F1 conj(F2) /
                 sqrt(sum_ring |F1|^2 . sum_ring |F2|^2).
    """
    sums, freqs = _ring_sums(_spectra(img1, img2), img1.shape[-2:],
                             num_rings)
    return freqs, _correlation(sums)


def _resolution_from_curve(freqs: torch.Tensor, frc: torch.Tensor,
                           threshold: float) -> torch.Tensor:
    """First-crossing resolution shared by the radial and sectored
    variants (see :func:`frc_resolution` for the conventions)."""
    below = frc < threshold
    crossing = (~below[:-1]) & below[1:]
    idx = torch.argmax(crossing.int())  # 0 if none: guarded below
    f0, f1 = torch.take(freqs, idx), torch.take(freqs, idx + 1)
    y0, y1 = torch.take(frc, idx), torch.take(frc, idx + 1)
    t = (y0 - threshold) / (y0 - y1).clamp_min(1e-30)
    res = 1.0 / (f0 + t * (f1 - f0)).clamp_min(1e-30)
    res = torch.where(crossing.any(), res, torch.nan)
    return torch.where(below[0], 2.0, res)


@span("rls.frc")
def frc_resolution(img1: torch.Tensor, img2: torch.Tensor,
                   num_rings: int = 64,
                   threshold: float = 1.0 / 7.0) -> torch.Tensor:
    """Resolution (pixels, a 0-d tensor) from the FRC 1/7 criterion:
    ``1 / k_c`` at the first ring frequency where the FRC drops below
    ``threshold`` (linearly interpolated); NaN if the curve never crosses
    (images essentially identical), 2.0 px (Nyquist) if it starts below
    (no correlated signal)."""
    freqs, frc = frc_curve(img1, img2, num_rings)
    return _resolution_from_curve(freqs, frc, threshold)


@span("rls.frc")
def frc_sectored_resolution(img1: torch.Tensor, img2: torch.Tensor,
                            num_rings: int = 48,
                            half_angle_deg: float = 30.0,
                            threshold: float = 1.0 / 7.0
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-axis resolution ``(res_x, res_y)`` in pixels.

    On an anisotropically scaled canvas (the unfused rescan canvas: x
    magnified by R/b, y shrunk by b) a radial ring mixes two physical
    frequencies. Sectored FRC keeps, in each ring, the bins within
    ``half_angle_deg`` of one frequency axis, so each crossing measures
    resolution along one image axis and rescales with that axis's factor.
    """
    spectra = _spectra(img1, img2)
    out = []
    for axis in ("x", "y"):
        sums, freqs = _ring_sums(spectra, img1.shape[-2:], num_rings,
                                 (axis, float(half_angle_deg)))
        out.append(_resolution_from_curve(freqs, _correlation(sums),
                                          threshold))
    return out[0], out[1]

"""Padded and apodized (non-circular) acquisition boundaries (port of the
JAX package's ``imaging/boundary.py``).

All convolutions are circular on the simulation grid; content near the
field edges therefore wraps. ``boundary="padded"`` acquires on a
zero-padded grid and crops: with a margin of at least the PSF and
illumination support, wrap contributions vanish and the result equals an
open-boundary acquisition. ``boundary="apodized"`` tapers the sample to
zero at its edges instead.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from rescan_line_sted_torch.config import Grid, RescanPointGeometry
from rescan_line_sted_torch.imaging import analytic


def default_margin(geom) -> int:
    """A pad margin for ``boundary="padded"``: ~1/8 of the field (>= 8 px),
    rounded up until ``margin % b == 0``, ``round(R * margin) % b == 0``
    and ``R * margin`` is integral (so the rescan crop needs no subpixel
    shift) where one exists within 64 px. Pass an explicit margin >= the
    PSF support for very wide PSFs."""
    h, w = geom.grid.shape
    b = getattr(geom, "binning", 1)
    r = getattr(geom, "rescan_factor", None)
    base = ((max(8, min(h, w) // 8) + b - 1) // b) * b
    if r is None:
        return base
    for m in range(base, base + 64):
        if m % b == 0 and round(r * m) % b == 0 \
                and abs(r * m - round(r * m)) < 1e-6:
            return m
    return base


def pad_sample(sample: torch.Tensor, margin: int) -> torch.Tensor:
    """Zero-pad a sample by ``margin`` pixels on every side."""
    return torch.nn.functional.pad(sample, (margin, margin, margin, margin))


def apodize_sample(sample: torch.Tensor, margin: int) -> torch.Tensor:
    """Taper a sample to zero over ``margin`` pixels at every edge
    (separable raised-cosine / Tukey window). Edge content is attenuated,
    not imaged faithfully; use ``boundary="padded"`` where it matters."""
    if margin < 0:
        raise ValueError(f"margin must be >= 0, got {margin}")
    if margin == 0:
        return sample

    def window(n: int) -> torch.Tensor:
        x = torch.arange(n, dtype=torch.float32, device=sample.device)
        ramp_in = 0.5 - 0.5 * torch.cos(
            math.pi * torch.clamp(x / margin, 0, 1))
        ramp_out = 0.5 - 0.5 * torch.cos(
            math.pi * torch.clamp((n - 1 - x) / margin, 0, 1))
        return ramp_in * ramp_out

    h, w = sample.shape[-2:]
    return sample * window(h)[:, None] * window(w)[None, :]


def padded_geometry(geom, margin: int):
    """The same geometry on the padded grid, its chunk lowered until it
    divides the padded scan-step count (``num_steps``: H * W for point
    scans, rescanned or not; W for line scans)."""
    padded = dataclasses.replace(geom, grid=Grid(geom.grid.height + 2 * margin,
                                                 geom.grid.width + 2 * margin))
    chunk = geom.chunk
    while padded.num_steps % chunk:
        chunk -= 1
    return dataclasses.replace(padded, chunk=chunk)


def _crop_scaled(img: torch.Tensor, axis: int, x0f: float,
                 n_out: int) -> torch.Tensor:
    """Crop ``n_out`` pixels of a rescanned axis from canvas coordinate
    ``x0f``. A non-integral ``x0f`` first shifts the canvas by its
    fractional part band-limitedly (rfft phase ramp, float64 phases built
    on the host), so the crop lands exactly on the original field."""
    x0 = math.floor(x0f + 1e-9)
    frac = x0f - x0
    if frac > 1e-9:
        n = img.shape[axis]
        ph = analytic._np_phases(-np.arange(n // 2 + 1) * frac / n,
                                 img.device)
        shape = [1] * img.ndim
        shape[axis] = n // 2 + 1
        img = torch.fft.irfft(torch.fft.rfft(img, dim=axis)
                              * ph.reshape(shape), n=n, dim=axis)
    return img.narrow(axis, x0, n_out)


def acquire_padded(engine_fn, sample: torch.Tensor, geom, margin: int,
                   **kwargs):
    """Run ``engine_fn(padded_sample, padded_geom, **kwargs)`` and crop its
    ``AcquisitionResult`` image back to the original field (for rescan
    canvases the x-crop scales by the rescan factor, and under 2D pixel
    reassignment the y-crop too)."""
    rescanned = hasattr(geom, "rescan_factor")
    if rescanned and margin % geom.binning:
        raise ValueError(
            f"margin={margin} must be divisible by binning={geom.binning}, "
            "or the binned row crop shifts off the original field")
    res = engine_fn(pad_sample(sample, margin),
                    padded_geometry(geom, margin), **kwargs)
    img = res.image
    h, w = sample.shape[-2:]
    if rescanned:
        r = float(geom.rescan_factor)
        b = geom.binning
        img = _crop_scaled(img, 1, r * margin / b, int(round(r * w)) // b)
        if isinstance(geom, RescanPointGeometry):
            img = _crop_scaled(img, 0, r * margin / b, int(round(r * h)) // b)
        else:
            img = img[margin // b: margin // b + h // b]
    else:
        img = img[margin: margin + h, margin: margin + w]
    return dataclasses.replace(res, image=img.contiguous())

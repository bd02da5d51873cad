"""Descanned line-STED engine (port of the JAX package's
``imaging/line_sted.py``; BASELINE config 2).

The excitation line runs along y and is scanned along x: ``W`` scan
positions give one image column each through a descanned slit. Methods:

* ``"analytic"``: one FFT correlation of the sample with the closed-form
  system kernel (``analytic.line_system_kernel``) and one Poisson draw;
* ``"scan"``: the per-scan-position process. Collapsed noise folds the
  detection into the step (``q = slit (*) gx``): the raster is ONE product
  ``sample_y @ circulant(brightness * eff * q)``, then one draw. Per-step
  noise samples every camera frame on one of the JAX package's TPU routes,
  taken here whatever the device (a CUDA sample launches the kernels, a CPU
  one runs their plain versions):

  1. kernel K3 (``kernels/line_fused.line_sted_fused``) when the slit fits
     its sampled window and ``use_pallas`` is True, or when ``_line_band``
     gives no band windows; the JAX gate ``vmem_ok`` modelled the TPU's
     VMEM and (8, 128) tiling, and K3's own limit replaces it (the width
     must leave room for its resident profiles in shared memory,
     ``line_fused.MAX_WIDTH``), so ``use_pallas=True`` takes K3 at 2048^2
     where the TPU took the banded route;
  2. otherwise the banded route: per chunk a ``D_in``-column sample window
     times the chunk-invariant table gives only the ``D_out`` camera rows
     the slit can read, as frames [C, D_out, H], sampled by K2b
     (``poisson_rows_tiered``) and slit-summed;
  3. otherwise the full-frame W-major route: frames [C, W, H] from the
     detection circulant, K2b, slit sum;
  4. ``use_pallas=False``: the full-frame route with frames [C, H, W] and
     ``maybe_poisson`` (K2c on the card).

Boundaries: ``"circular"``, ``"padded"`` and ``"apodized"``
(``imaging/boundary.py``).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from rescan_line_sted_torch.config import (
    _aperture_support,
    _support,
    cache_key_ok,
)
from rescan_line_sted_torch.device import as_sample
from rescan_line_sted_torch.imaging import analytic
from rescan_line_sted_torch.imaging import boundary as boundaries
from rescan_line_sted_torch.imaging.point_sted import AcquisitionResult
from rescan_line_sted_torch.imaging.shifts import shifted_profiles
from rescan_line_sted_torch.kernels import fftconv, line_fused
from rescan_line_sted_torch.kernels.poisson import poisson_rows_tiered
from rescan_line_sted_torch.physics import models
from rescan_line_sted_torch.physics import psf as psfs
from rescan_line_sted_torch.physics.dose import line_sted_dose
from rescan_line_sted_torch.physics.noise import maybe_poisson


def line_sted_image(
    sample,
    params,
    geom,
    generator: torch.Generator | None = None,
    method: str = "analytic",
    noise_mode: str = "collapsed",
    boundary: str = "circular",
    margin: int | None = None,
    use_pallas: bool | None = None,
    slit_support: int | None = None,
    device=None,
) -> AcquisitionResult:
    """Simulate a descanned line-STED acquisition of ``sample`` [H, W].

    ``sample`` (a tensor or array) is taken as float32 and moved to
    ``device``: None means the CUDA card (a CUDA ``sample`` stays on its
    card), and raises without one; pass ``device="cpu"`` for the plain
    PyTorch versions. ``generator`` draws shot noise; None gives the
    noise-free mean. ``noise_mode`` (scan method): ``"collapsed"`` draws
    once from the detected mean, ``"per_step"`` samples every camera frame.
    ``boundary``: "circular", "padded" (the dose is reported for the
    requested field) or "apodized"; ``margin`` defaults to
    ``boundary.default_margin(geom)``.

    Per-step routing (module doc): ``use_pallas=True`` selects the fused
    kernel K3, ``False`` excludes it and K2b (the full-frame route with
    ``maybe_poisson``), None takes K3 only where no band windows exist.
    ``slit_support``: height of the camera window K3 samples; sized from
    the slit halfwidth when None.
    """
    sample = as_sample(sample, geom.grid.shape, device)
    if boundary not in ("circular", "padded", "apodized"):
        raise ValueError(f"unknown boundary {boundary!r}")
    if margin is None and boundary != "circular":
        margin = boundaries.default_margin(geom)
    if boundary == "apodized":
        sample = boundaries.apodize_sample(sample, margin)
    elif boundary == "padded":
        res = boundaries.acquire_padded(
            lambda s, g, **kw: line_sted_image(s, params, g, **kw),
            sample, geom, margin, generator=generator, method=method,
            noise_mode=noise_mode, use_pallas=use_pallas,
            slit_support=slit_support, device=sample.device)
        return dataclasses.replace(
            res, dose=line_sted_dose(params, geom, sample.device))
    models.line_model(params)           # raises on a JAX package model
    if method == "analytic":
        image = analytic_images(sample, params, generator)
    elif method == "scan":
        image = _scan(sample, params, geom, generator, noise_mode,
                      use_pallas, slit_support)
    else:
        raise ValueError(f"unknown method {method!r}")
    return AcquisitionResult(
        image=image, dose=line_sted_dose(params, geom, sample.device))


def analytic_images(samples: torch.Tensor, params,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """The analytic method on a batch of samples [..., H, W]: one FFT
    correlation with the closed-form system kernel and ONE draw over the
    whole batch (K2c on the card), ``brightness * corr(sample, K)``."""
    k = analytic.line_system_kernel(tuple(samples.shape[-2:]), params,
                                    samples.device)
    return maybe_poisson(
        generator, params.brightness * fftconv.fft_correlate(samples, k))


def effective_line_profile(width: int, params, device=None) -> torch.Tensor:
    """Centered 1D effective (depleted) excitation line profile, [W]."""
    return models.effective_line_profile(width, params, device)


def _scan(sample, params, geom, generator, noise_mode="collapsed",
          use_pallas=None, slit_support=None):
    if noise_mode not in ("collapsed", "per_step"):
        raise ValueError(f"unknown noise_mode {noise_mode!r}")
    h, w = geom.grid.shape
    chunk = geom.chunk
    if w % chunk:
        raise ValueError("chunk must divide width")
    per_step = generator is not None and noise_mode == "per_step"
    dev = sample.device
    bright = params.brightness

    eff = effective_line_profile(w, params, dev)
    slit = psfs.slit_profile(w, params.slit_halfwidth, dev)
    # separable detection: the y-convolution hoists out of the scan
    gx = psfs.detection_profile(w, params.sigma_det, dev)
    otf_y = fftconv.profile_to_otf1d(
        psfs.detection_profile(h, params.sigma_det, dev))
    sample_y = fftconv.convolve_otf1d(sample, otf_y, axis=-2, n=h)
    if not per_step:
        q = fftconv.convolve_profiles(slit, gx)
        img = sample_y @ fftconv.circulant_matrix(bright * eff * q)
        return maybe_poisson(generator, img)

    slit_fits = True
    if slit_support is None:            # size the sampled window to fit
        hw = float(params.slit_halfwidth)
        slit_support = min(w, int(2 * hw) + 10)
        slit_fits = slit_support >= 2 * hw + 2 or slit_support >= w
    band = _line_band(params, w, chunk)
    if (slit_fits and w <= line_fused.MAX_WIDTH and use_pallas is not False
            and (use_pallas is True or band is None)):
        eff_scaled = bright * eff
        plan = (_k3_plan(params, w, slit_support, dev)
                if cache_key_ok(params) else
                line_fused.line_plan(eff_scaled, gx, slit, slit_support))
        return line_fused.line_sted_fused(sample_y.contiguous(), eff_scaled,
                                          gx, slit, generator, slit_support,
                                          plan=plan)

    img = torch.empty((h, w), dtype=torch.float32, device=dev)
    sample_t = sample_y.T                                        # [W, H]
    if use_pallas is not False and band is not None:
        d_in, d_out = band
        s_in, s_out = (d_in - chunk) // 2, (d_out - chunk) // 2
        ci = torch.arange(chunk, device=dev)[:, None]
        di = torch.arange(d_in, device=dev)[None, :]
        do = torch.arange(d_out, device=dev)[None, :]
        # chunk-invariant tables: illumination window, windowed detection
        # circulant, and the slit weights inside the output window
        ill_w = eff[(w // 2 + di - s_in - ci) % w]               # [C, Di]
        g0w = fftconv.circulant_window(gx, d_out, d_in, s_out, s_in)
        table = (bright * g0w[None] * ill_w[:, None, :]).reshape(
            chunk * d_out, d_in)                                 # [C*Do, Di]
        slit_w = slit[(w // 2 + do - s_out - ci) % w]            # [C, Do]
        win = torch.arange(d_in, device=dev) - s_in
        for p0 in range(0, w, chunk):
            cam = (table @ sample_t[(p0 + win) % w]).reshape(
                chunk, d_out, h)                                 # [C, Do, H]
            frames = poisson_rows_tiered(cam, generator)
            img[:, p0:p0 + chunk] = torch.einsum("cxh,cx->hc", frames,
                                                 slit_w)
        return img

    gx_mat = fftconv.circulant_matrix(gx)          # cam = emitted @ gx_mat
    for p0 in range(0, w, chunk):
        pos = torch.arange(p0, p0 + chunk, device=dev)
        ill = shifted_profiles(eff, pos)                         # [C, W]
        slits = shifted_profiles(slit, pos)                      # [C, W]
        if use_pallas is not False:    # W-major frames, K2b
            emitted_t = ill[:, :, None] * sample_t[None]         # [C, W, H]
            cam_t = poisson_rows_tiered(
                bright * (gx_mat.T @ emitted_t), generator)      # [C, W, H]
            img[:, p0:p0 + chunk] = torch.einsum("cwh,cw->hc", cam_t, slits)
        else:
            emitted_y = ill[:, None, :] * sample_y[None]         # [C, H, W]
            cam = maybe_poisson(generator, bright * (emitted_y @ gx_mat))
            img[:, p0:p0 + chunk] = torch.einsum("chw,cw->hc", cam, slits)
    return img


@functools.lru_cache(maxsize=8)
def _k3_plan(params, w: int, slit_support: int,
             device: torch.device) -> line_fused.LinePlan:
    """K3's rows, weights and tap run (``line_fused.line_plan``) for the
    profiles ``_scan`` hands it, worked out once per params, width,
    sampled window and device: a later image makes no host round trip.
    Keyed only on params that ``config.cache_key_ok`` admits."""
    eff = params.brightness * effective_line_profile(w, params, device)
    gx = psfs.detection_profile(w, params.sigma_det, device)
    slit = psfs.slit_profile(w, params.slit_halfwidth, device)
    return line_fused.line_plan(eff, gx, slit, slit_support)


def _line_band(params, w: int, chunk: int) -> tuple[int, int] | None:
    """Static band windows ``(d_in, d_out)`` of the per-step banded route:
    the illumination's ``D_in = C + 2 S_exc`` sample-column window (rounded
    up to 128, as the JAX package does) and the ``D_out = C + 2 (slit_hw +
    2)`` camera rows the slit can read (rounded up to 8). None for a model
    whose excitation is not the Gaussian envelope, or where a window would
    not be narrower than the frame."""
    m = getattr(params, "model", None)
    if m is not None and not getattr(m, "gaussian_excitation", False):
        return None
    s_exc = getattr(params, "exc_support", None)
    if s_exc is None:
        s_exc = _support(params.sigma_exc)
    slit_hw = getattr(params, "slit_support_px", None)
    if slit_hw is None:
        slit_hw = _aperture_support(params.slit_halfwidth)
    d_in = -(-(chunk + 2 * s_exc) // 128) * 128
    if d_in >= w:
        return None
    d_out = -(-(chunk + 2 * slit_hw) // 8) * 8
    if d_out >= w:
        return None
    return (d_in, d_out)

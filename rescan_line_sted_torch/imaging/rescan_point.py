"""Rescanned point-STED: 2D pixel reassignment, ISM (port of the JAX
package's ``imaging/rescan_point.py``).

The full camera frame captured at every point-scan position ``p`` is
(re-binned and) accumulated into a magnified canvas at ``R * p``: camera
pixel ``x`` lands at ``u = R*p + (x - p)``, in both axes, wrapping
circularly on the ``round(R*H)/b x round(R*W)/b`` canvas. At depletion 0
this is classic rescan confocal; with depletion it is rescan STED.

Methods:

* ``"analytic"`` (default): the closed-form canvas mean
  (``rescan_point_canvas_mean``), any rescan factor and any binning, and
  one Poisson draw (K2c on the card). For b = 1, with centred PSFs (centre
  ``c``) and canvas frequency ``k``::

      canvas_hat(k) = B * D_hat(k) * E(k) * S_R(k)
      D_hat(k) = sum_a det[a] exp(-2i pi k.(a - c) / Nc)
      E(k)     = sum_a eff[a] exp(+2i pi k.(R-1)(a - c) / Nc)
      S_R(k)   = sum_a sample[a] exp(-2i pi k.R a / Nc)

  ``E`` and ``S_R`` are scaled 2D DFTs, separable per axis: two complex64
  matrix products each against phase tables built in float64 on the host
  (``_phase_tables``, cached per shape, factor and device); where the
  canvas is exactly R times the field, ``S_R`` is the sample's FFT read
  periodically (``_placed_spectrum``). ``D_hat`` is one zero-padded
  rfft2. For b > 1 the map is b-periodically shift-variant
  in both axes, and the canvas is a sum over the b^2 residue classes of the
  emitter position (``_canvas_mean_bn``). Exact for samples that are zero
  within ~PSF support of every edge; pad otherwise.

* ``"scan"``: the per-scan-position process. Per chunk of raster
  positions: the shifted illumination, the two 1D detection convolutions,
  the b x b re-binning, the per-frame draw (``noise_mode="per_step"``:
  kernel K2b, ``poisson_rows_tiered``; its plain version on CPU tensors),
  and spectral placement (each frame's rfft2, zero-padded to the canvas,
  times its position's 2D phase ramp, contracted over the chunk); one
  inverse FFT per image. ``reassignment`` "rounded" snaps each offset
  ``(R-1) p / b`` to the nearest binned canvas pixel, "subpixel" places it
  exactly (band-limited), "auto" picks subpixel exactly when the offsets
  are fractional. Collapsed noise draws once from the canvas (K2c).

Subpixel placement spreads integer counts band-limitedly, so per-step
subpixel canvases ring below zero; collapsed noise then means shot noise
of the ideal canvas.

Boundaries: ``"circular"``, ``"padded"`` (both rescanned axes cropped,
``imaging/boundary.py``) and ``"apodized"``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from rescan_line_sted_torch.device import as_sample
from rescan_line_sted_torch.imaging import boundary as boundaries
from rescan_line_sted_torch.imaging.analytic import _np_phases
from rescan_line_sted_torch.imaging.point_sted import AcquisitionResult
from rescan_line_sted_torch.imaging.rescan import _rebin
from rescan_line_sted_torch.imaging.shifts import shifted_images
from rescan_line_sted_torch.kernels import fftconv
from rescan_line_sted_torch.kernels.poisson import poisson_rows_tiered
from rescan_line_sted_torch.parallel.mesh import gather_dtensors
from rescan_line_sted_torch.physics import models
from rescan_line_sted_torch.physics import psf as psfs
from rescan_line_sted_torch.physics.dose import point_sted_dose
from rescan_line_sted_torch.physics.noise import maybe_poisson

_SIGMA_FROM_FWHM = 2.3548200450309493


def effective_point_psf(shape, params, device=None) -> torch.Tensor:
    """Centred depleted point illumination ``exc * exp(-s * dep)``, through
    ``params.model`` (``physics/models.py``)."""
    return models.effective_point_psf(shape, params, device)


def _sigma_ill(params, size: int) -> torch.Tensor:
    """Effective illumination width (sigma, px) from the FWHM of the
    depleted point PSF's central x-profile."""
    from rescan_line_sted_torch.algorithms.metrics import fwhm_1d

    eff = effective_point_psf((size, size), params)
    return fwhm_1d(eff[size // 2]) / _SIGMA_FROM_FWHM


def optimal_rescan_factor_point(params, size: int) -> torch.Tensor:
    """Theory-optimal 2D rescan factor ``R = 1 + sigma_det^2 /
    sigma_ill^2``. Not capped: strong depletion pushes it high (R ~ 25 at
    s = 8 with matched widths); see ``practical_rescan_factor_point``."""
    sd = torch.as_tensor(params.sigma_det)
    return 1.0 + sd.square() / _sigma_ill(params, size).square()


def practical_rescan_factor_point(params, size: int,
                                  tolerance: float = 0.05,
                                  cap: float | None = None,
                                  snap: int | None = 8) -> torch.Tensor:
    """Smallest 2D rescan factor within ``tolerance`` of the optimal
    resolution, rounded up to a multiple of ``1/snap`` (never past the
    optimum) and optionally capped: the isotropic form of
    ``rescan.practical_rescan_factor``."""
    from rescan_line_sted_torch.imaging.rescan import (
        practical_factor_from_sigmas)

    return practical_factor_from_sigmas(_sigma_ill(params, size),
                                        params.sigma_det, tolerance, cap,
                                        snap)


@gather_dtensors
def rescanned_point_sted_image(
    sample,
    params,
    geom,
    generator: torch.Generator | None = None,
    method: str = "analytic",
    noise_mode: str = "collapsed",
    reassignment: str = "auto",
    boundary: str = "circular",
    margin: int | None = None,
    device=None,
) -> AcquisitionResult:
    """Simulate a rescanned point-STED (ISM) acquisition of ``sample``
    [H, W]; returns the canvas ``[round(R*H)/b, round(R*W)/b]`` and the
    point scan's dose.

    ``params`` is ``PointSTEDParams`` (``pinhole_radius`` is unused: the
    camera keeps the whole frame); ``geom`` is ``RescanPointGeometry``.
    ``sample`` (a tensor or array) is taken as float32 and moved to
    ``device``: None means the CUDA card (a CUDA ``sample`` stays on its
    card), and raises without one; pass ``device="cpu"`` for the plain
    PyTorch versions. ``generator`` draws shot noise; None gives the
    noise-free mean. ``noise_mode`` ("collapsed" | "per_step") and
    ``reassignment`` ("auto" | "rounded" | "subpixel") apply to the scan
    method (module doc). ``boundary``: "circular", "padded" (the dose is
    reported for the requested field) or "apodized"; ``margin`` defaults to
    ``boundary.default_margin(geom)``.
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
            lambda s, g, **kw: rescanned_point_sted_image(s, params, g, **kw),
            sample, geom, margin, generator=generator, method=method,
            noise_mode=noise_mode, reassignment=reassignment,
            device=sample.device)
        return dataclasses.replace(
            res, dose=point_sted_dose(params, geom, sample.device))
    models.point_model(params)          # raises on a JAX package model
    if method == "analytic":
        image = maybe_poisson(generator,
                              rescan_point_canvas_mean(sample, params, geom))
    elif method == "scan":
        image = _scan(sample, params, geom, generator, noise_mode,
                      reassignment)
    else:
        raise ValueError(f"unknown method {method!r}")
    return AcquisitionResult(
        image=image, dose=point_sted_dose(params, geom, sample.device))


@functools.lru_cache(maxsize=2)
def _phase_tables(h: int, w: int, hc: int, wc: int, r: float, b: int,
                  device: torch.device):
    """The static phase tables of the closed form, built in float64 on the
    host and held as complex64 on ``device``: the placement tables ``py``
    [h/b, Hc], ``px`` [w/b, Kx] of the (residue-subsampled) sample at R*m,
    and the illumination tables ``by`` [h, Hc], ``bx`` [w, Kx] at the
    b-scaled frequencies. Cached, as the JAX package builds them once per
    compile (about 200 MB on the card at 2048^2, R = 2); do not mutate."""
    ky = np.arange(hc, dtype=np.float64)
    kx = np.arange(wc // 2 + 1, dtype=np.float64)
    my = np.arange(h // b, dtype=np.float64)
    mx = np.arange(w // b, dtype=np.float64)
    ay = np.arange(h, dtype=np.float64) - h // 2
    ax = np.arange(w, dtype=np.float64) - w // 2
    py = _np_phases(ky[None, :] * r * my[:, None] / hc, device)
    px = _np_phases(kx[None, :] * r * mx[:, None] / wc, device)
    by = _np_phases(-ky[None, :] * (r - 1.0) * ay[:, None] / (b * hc), device)
    bx = _np_phases(-kx[None, :] * (r - 1.0) * ax[:, None] / (b * wc), device)
    return py, px, by, bx


def _tables(geom, device):
    h, w = geom.grid.shape
    hc, wc = geom.canvas_shape
    return _phase_tables(h, w, hc, wc, float(geom.rescan_factor),
                         geom.binning, torch.device(device))


def _illumination_hat(params, shape, by, bx, device) -> torch.Tensor:
    """``E`` [Hc, Kx]: the illumination's scaled 2D DFT, two complex64
    products against the phase tables."""
    eff = effective_point_psf(shape, params, device).to(torch.complex64)
    return (by.T @ eff) @ bx


def _detection_hat(params, geom, device) -> torch.Tensor:
    """``D_hat`` [Hc, Kx] (b = 1): the rfft2 of the detection PSF embedded
    in the canvas, recentred by ``+c``."""
    h, w = geom.grid.shape
    hc, wc = geom.canvas_shape
    det = psfs.detection_psf((h, w), params.sigma_det, device)
    d_embed = torch.zeros((hc, wc), dtype=torch.float32, device=device)
    d_embed[:h, :w] = det
    dy = _np_phases(-np.arange(hc) * (h // 2) / hc, device)
    dx = _np_phases(-np.arange(wc // 2 + 1) * (w // 2) / wc, device)
    return torch.fft.rfft2(d_embed) * dy[:, None] * dx[None, :]


def _placed_spectrum(sample, geom, py, px) -> torch.Tensor:
    """``S_R`` [..., Hc, Kx] (b = 1). Where the canvas is exactly R times
    the field in both axes, ``R a / Nc = a / N`` and ``S_R`` is the
    sample's own 2D DFT read periodically: one FFT, exact to float32's
    rounding. The two products against the phase tables carry ~4e-7 of
    the spectrum instead (192^2, R = 2), which RL's iterations amplify."""
    h, w = geom.grid.shape
    hc, wc = geom.canvas_shape
    r = float(geom.rescan_factor)
    if r * h != hc or r * w != wc:
        return (py.T @ sample.to(torch.complex64)) @ px
    dev = sample.device
    f = torch.fft.fft2(sample.to(torch.float32))
    f = f.index_select(-2, torch.arange(hc, device=dev) % h)
    return f.index_select(-1, torch.arange(wc // 2 + 1, device=dev) % w)


def rescan_point_canvas_mean(sample: torch.Tensor, params,
                             geom) -> torch.Tensor:
    """Noise-free rescanned point-STED canvas: the closed form of the module
    doc, exact for any rescan factor and any binning. Linear in ``sample``.

    With ``binning > 1`` the emitter position ``a = b*m + rho`` per axis
    splits the sample into b^2 residue classes: ``canvas_hat = B * E_b *
    sum_rho Dy_ry Dx_rx S_rho`` with ``D*_r`` the phase-r binned detection
    profile spectra (``_binned_axis_spectra``), ``E_b`` the illumination
    DFT at the b-scaled frequencies and ``S_rho`` the scaled DFT of the
    rho-residue subsample placed at ``R*m``."""
    dev = sample.device
    h, w = geom.grid.shape
    hc, wc = geom.canvas_shape
    b = geom.binning
    py, px, by, bx = _tables(geom, dev)
    e_hat = _illumination_hat(params, (h, w), by, bx, dev)
    if b == 1:
        s_hat = _placed_spectrum(sample, geom, py, px)
        canvas = torch.fft.irfft2(s_hat * e_hat
                                  * _detection_hat(params, geom, dev),
                                  s=(hc, wc))
        return params.brightness * canvas
    r = float(geom.rescan_factor)
    dy = _binned_axis_spectra(h, hc, b, r, hc,
                              psfs.detection_profile(h, params.sigma_det,
                                                     dev))
    dx = _binned_axis_spectra(w, wc, b, r, wc // 2 + 1,
                              psfs.detection_profile(w, params.sigma_det,
                                                     dev))
    s_split = sample.reshape(h // b, b, w // b, b).to(torch.complex64)
    canvas_hat = torch.zeros((hc, wc // 2 + 1), dtype=torch.complex64,
                             device=dev)
    for ry in range(b):
        for rx in range(b):
            s_hat = (py.T @ s_split[:, ry, :, rx]) @ px
            canvas_hat = canvas_hat + dy[ry][:, None] * dx[rx][None, :] \
                * s_hat
    canvas = torch.fft.irfft2(e_hat * canvas_hat, s=(hc, wc))
    return params.brightness * canvas


def _binned_axis_spectra(n: int, nc: int, b: int, r: float, nk: int,
                         det_profile: torch.Tensor) -> torch.Tensor:
    """Per-residue binned-detection spectra of one axis, [b, nk]: ``d_rho[u]
    = sum_j det[(b u + j - rho) % n]`` FFT-embedded on the canvas ring (its
    first ``nk`` modes: all ``nc`` for y, the one-sided ``nc//2 + 1`` for
    x), recentred to the binned centre ``n // (2b)`` and times the residue
    placement phase ``exp(-2i pi k (R-1) rho / (b nc))``."""
    dev = det_profile.device
    u_idx = torch.arange(n // b, device=dev)
    j_idx = torch.arange(b, device=dev)
    rho_idx = torch.arange(b, device=dev)
    gather = (b * u_idx[None, :, None] + j_idx[None, None, :]
              - rho_idx[:, None, None]) % n
    d = det_profile[gather].sum(-1)                              # [b, n/b]
    kk = np.arange(nk, dtype=np.float64)
    center_ph = _np_phases(-kk * (n // (2 * b)) / nc, dev)
    rho_ph = _np_phases(kk[None, :] * (r - 1.0) * np.arange(b)[:, None]
                        / (b * nc), dev)
    spec = torch.fft.fft(d, n=nc, dim=-1)[:, :nk]
    return spec * center_ph[None, :] * rho_ph


def rescan_point_system_kernel(geom, params, device=None) -> torch.Tensor:
    """Centred effective rescan kernel H on the canvas grid, [Hc, Wc]:
    ``H(v) = sum_t eff(t) det(v + (R-1) t)``, the detection PSF smeared by
    the (R-1)-scaled depleted spot. The noise-free canvas is ``brightness *
    conv(place_2d(sample, R), H)`` (binning 1 only)."""
    if geom.binning != 1:
        raise ValueError("system kernel defined for binning=1")
    hc, wc = geom.canvas_shape
    dev = torch.device(device or "cpu")
    _, _, by, bx = _tables(geom, dev)
    e_hat = _illumination_hat(params, geom.grid.shape, by, bx, dev)
    return torch.fft.fftshift(torch.fft.irfft2(
        e_hat * _detection_hat(params, geom, dev), s=(hc, wc)))


def _scan(sample, params, geom, generator, noise_mode="collapsed",
          reassignment="auto"):
    if noise_mode not in ("collapsed", "per_step"):
        raise ValueError(f"unknown noise_mode {noise_mode!r}")
    if reassignment not in ("auto", "rounded", "subpixel"):
        raise ValueError(f"unknown reassignment {reassignment!r}")
    h, w = geom.grid.shape
    b = geom.binning
    hc, wc = geom.canvas_shape
    chunk = geom.chunk
    if geom.num_steps % chunk:
        raise ValueError("chunk must divide height * width")
    r = float(geom.rescan_factor)
    if reassignment == "auto":
        step = (r - 1.0) / b
        reassignment = "rounded" if abs(step - round(step)) < 1e-9 \
            else "subpixel"
    dev = sample.device
    per_step = generator is not None and noise_mode == "per_step"

    # per-position canvas phase ramps, separable per axis, f64 host-built
    oy = (r - 1.0) * np.arange(h, dtype=np.float64) / b
    ox = (r - 1.0) * np.arange(w, dtype=np.float64) / b
    if reassignment == "rounded":
        oy, ox = np.round(oy), np.round(ox)
    phy = _np_phases(np.arange(hc)[None, :] * oy[:, None] / hc, dev)  # [h, Hc]
    phx = _np_phases(np.arange(wc // 2 + 1)[None, :] * ox[:, None] / wc,
                     dev)                                             # [w, Kx]

    eff = effective_point_psf((h, w), params, dev)
    otf_y = fftconv.profile_to_otf1d(
        psfs.detection_profile(h, params.sigma_det, dev))
    otf_x = fftconv.profile_to_otf1d(
        psfs.detection_profile(w, params.sigma_det, dev))
    canvas_hat = torch.zeros((hc, wc // 2 + 1), dtype=torch.complex64,
                             device=dev)
    for s0 in range(0, geom.num_steps, chunk):      # raster order
        flat = torch.arange(s0, s0 + chunk, device=dev)
        pos = torch.stack([flat // w, flat % w], dim=-1)         # [C, 2]
        ill = shifted_images(eff, pos)                           # [C, H, W]
        blurred = fftconv.convolve_otf1d(
            fftconv.convolve_otf1d(ill * sample, otf_x, axis=-1, n=w),
            otf_y, axis=-2, n=h)
        frames = _rebin(params.brightness * blurred, b)          # [C, h/b, w/b]
        if per_step:
            frames = poisson_rows_tiered(frames.contiguous(), generator)
        spec = torch.fft.rfft2(frames, s=(hc, wc))               # [C, Hc, Kx]
        canvas_hat += torch.einsum("chk,ch,ck->hk", spec, phy[pos[:, 0]],
                                   phx[pos[:, 1]])
    canvas = torch.fft.irfft2(canvas_hat, s=(hc, wc))
    if generator is not None and not per_step:
        canvas = maybe_poisson(generator, canvas)
    return canvas

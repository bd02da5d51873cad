"""Point-scanning STED engine (port of the JAX package's
``imaging/point_sted.py``; BASELINE config 1).

Methods:

* ``"analytic"``: one FFT correlation of the sample with the closed-form
  system kernel (``analytic.point_system_kernel``) and one Poisson draw;
* ``"scan"``: the per-scan-position process over all ``H * W`` pixels.
  Collapsed noise reduces exactly to one circular correlation with ``P =
  eff . (pinhole (*) det)`` and one draw. Per-step noise samples every
  camera frame with K2b (``poisson_rows_tiered``; its plain version on CPU
  tensors), on the banded route when ``_point_band`` gives windows
  (translating 2D windows, batched over row blocks: ``_banded_point_scan``)
  and otherwise on the full-frame route (per chunk of raster positions:
  shifted illumination, separable detection by two 1D FFT convolutions,
  K2b, and the pinhole read out as ``fftconv.correlate_otf_at``; chunks may
  cross rows, and the raster is rebuilt from the stacked outputs).

Boundaries: ``"circular"``, ``"padded"`` and ``"apodized"``
(``imaging/boundary.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from rescan_line_sted_torch.config import (
    Replaceable,
    _aperture_support,
    _support,
)
from rescan_line_sted_torch.device import as_sample
from rescan_line_sted_torch.imaging import analytic
from rescan_line_sted_torch.imaging import boundary as boundaries
from rescan_line_sted_torch.imaging.shifts import shifted_images
from rescan_line_sted_torch.kernels import fftconv
from rescan_line_sted_torch.kernels.poisson import poisson_rows_tiered
from rescan_line_sted_torch.parallel.mesh import gather_dtensors
from rescan_line_sted_torch.physics import models
from rescan_line_sted_torch.physics import psf as psfs
from rescan_line_sted_torch.physics.dose import DoseReport, point_sted_dose
from rescan_line_sted_torch.physics.noise import maybe_poisson


@dataclasses.dataclass(frozen=True)
class AcquisitionResult(Replaceable):
    image: torch.Tensor
    dose: DoseReport


@gather_dtensors
def point_sted_image(
    sample,
    params,
    geom,
    generator: torch.Generator | None = None,
    method: str = "analytic",
    noise_mode: str = "collapsed",
    boundary: str = "circular",
    margin: int | None = None,
    device=None,
) -> AcquisitionResult:
    """Simulate a descanned point-STED acquisition of ``sample`` [H, W].

    ``sample`` (a tensor or array) is taken as float32 and moved to
    ``device``: None means the CUDA card (a CUDA ``sample`` stays on its
    card), and raises without one; pass ``device="cpu"`` for the plain
    PyTorch versions. ``generator`` draws shot noise; None gives the
    noise-free mean. ``noise_mode`` (scan method): ``"collapsed"`` draws
    once from the detected mean, ``"per_step"`` samples every camera frame.
    ``boundary``: "circular", "padded" (the dose is reported for the
    requested field) or "apodized"; ``margin`` defaults to
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
            lambda s, g, **kw: point_sted_image(s, params, g, **kw),
            sample, geom, margin, generator=generator, method=method,
            noise_mode=noise_mode, device=sample.device)
        return dataclasses.replace(
            res, dose=point_sted_dose(params, geom, sample.device))
    models.point_model(params)          # raises on a JAX package model
    if method == "analytic":
        k = analytic.point_system_kernel(geom.grid.shape, params,
                                         sample.device)
        image = maybe_poisson(
            generator, params.brightness * fftconv.fft_correlate(sample, k))
    elif method == "scan":
        image = _scan(sample, params, geom, generator, noise_mode)
    else:
        raise ValueError(f"unknown method {method!r}")
    return AcquisitionResult(
        image=image, dose=point_sted_dose(params, geom, sample.device))


def _scan(sample, params, geom, generator, noise_mode="collapsed"):
    if noise_mode not in ("collapsed", "per_step"):
        raise ValueError(f"unknown noise_mode {noise_mode!r}")
    shape = geom.grid.shape
    h, w = shape
    chunk = geom.chunk
    if geom.num_steps % chunk:
        raise ValueError("chunk must divide height * width")
    per_step = generator is not None and noise_mode == "per_step"
    dev = sample.device

    eff = models.effective_point_psf(shape, params, dev)
    pin = psfs.pinhole_mask(shape, params.pinhole_radius, dev)
    if not per_step:
        det = psfs.detection_psf(shape, params.sigma_det, dev)
        p2d = eff * fftconv.fft_convolve(pin, det)
        img = params.brightness * fftconv.fft_correlate(sample, p2d)
        return maybe_poisson(generator, img)

    band = _point_band(params, h, w, chunk)
    if band is not None:
        return _banded_point_scan(sample, params, geom, generator, eff, pin,
                                  band)

    otf_y = fftconv.profile_to_otf1d(
        psfs.detection_profile(h, params.sigma_det, dev))
    otf_x = fftconv.profile_to_otf1d(
        psfs.detection_profile(w, params.sigma_det, dev))
    pin_otf = fftconv.kernel_to_otf(pin)
    vals = []
    for s0 in range(0, geom.num_steps, chunk):      # raster order
        flat = torch.arange(s0, s0 + chunk, device=dev)
        pos = torch.stack([flat // w, flat % w], dim=-1)         # [C, 2]
        ill = shifted_images(eff, pos)                           # [C, H, W]
        blurred = fftconv.convolve_otf1d(
            fftconv.convolve_otf1d(ill * sample, otf_x, axis=-1, n=w),
            otf_y, axis=-2, n=h)
        cam = poisson_rows_tiered((params.brightness * blurred).contiguous(),
                                  generator)
        vals.append(fftconv.correlate_otf_at(cam, pin_otf, pos))
    return torch.cat(vals).reshape(shape)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _point_band(params, h: int, w: int,
                chunk: int) -> tuple[int, int, int, int] | None:
    """Static 2D band windows ``(dy_in, dx_in, dy_out, dx_out)`` of the
    banded per-step route: a chunk of positions within one row reads a
    sample window bounded by the excitation support and produces only the
    camera window the pinhole reads. ``dx_in`` rounds up to 128 when ``w
    >= 256`` (to 8 otherwise), as the JAX package does, so both packages
    route alike. None for a model whose excitation is not the Gaussian
    envelope, a chunk that does not divide ``w``, or windows not smaller
    than the field."""
    m = getattr(params, "model", None)
    if m is not None and not getattr(m, "gaussian_excitation", False):
        return None
    s_exc = getattr(params, "exc_support", None)
    if s_exc is None:
        s_exc = _support(params.sigma_exc)
    pin = getattr(params, "pin_support", None)
    if pin is None:
        pin = _aperture_support(params.pinhole_radius)
    if w % chunk:
        return None
    kx = 128 if w >= 256 else 8
    dx_in = _round_up(chunk + 2 * s_exc, kx)
    dy_in = _round_up(2 * s_exc + 2, 8)
    dx_out = _round_up(chunk + 2 * pin, 8)
    dy_out = _round_up(2 * pin + 2, 8)
    if dx_in >= w or dy_in >= h or dx_out >= w or dy_out >= h:
        return None
    return (dy_in, dx_in, dy_out, dx_out)


def _banded_point_scan(sample, params, geom, generator, eff, pin, band,
                       draw_noise: bool = True):
    """Per-step point-STED scan on translating 2D windows (``_point_band``).

    One iteration covers ``hc`` rows x one x-chunk: the y-convolution with
    the illumination folded in (a chunk-invariant table), the
    x-convolution, K2b on the camera windows [hc, C, Dy_out, Dx_out] and
    the pinhole-weighted sum. ``draw_noise=False`` skips the draw (the
    noise-free windowed scan, equal to the collapsed closed form).
    """
    h, w = geom.grid.shape
    chunk = geom.chunk
    dev = sample.device
    dy_in, dx_in, dy_out, dx_out = band
    sy_in, sx_in = dy_in // 2, (dx_in - chunk) // 2
    sy_out, sx_out = dy_out // 2, (dx_out - chunk) // 2
    cy, cx = h // 2, w // 2
    # the largest row block <= 64 that divides h (t1 is [hc, C*Do_y, Di_x])
    hc = 64
    while h % hc:
        hc //= 2

    det_y = psfs.detection_profile(h, params.sigma_det, dev)
    det_x = psfs.detection_profile(w, params.sigma_det, dev)
    cc = torch.arange(chunk, device=dev)
    yi = torch.arange(dy_in, device=dev)
    xi = torch.arange(dx_in, device=dev)
    y2 = torch.arange(dy_out, device=dev)
    x2 = torch.arange(dx_out, device=dev)
    # chunk-invariant tables
    eff_wc = eff[((cy + yi - sy_in) % h)[None, :, None],
                 (cx + xi[None, None, :] - sx_in - cc[:, None, None]) % w]
    dety_blk = det_y[(cy + (y2[:, None] - sy_out) - (yi[None, :] - sy_in))
                     % h]                                    # [Do_y, Di_y]
    detx_blk = det_x[(cx + (x2[:, None] - sx_out) - (xi[None, :] - sx_in))
                     % w]                                    # [Do_x, Di_x]
    pin_wc = pin[((cy + y2 - sy_out) % h)[None, :, None],
                 (cx + x2[None, None, :] - sx_out - cc[:, None, None]) % w]
    # stage-1 table, y-conv with the illumination folded in:
    # P[xi, yi, (c, y2)] = dety_blk[y2, yi] * eff_wc[c, yi, xi]
    p_t = torch.einsum("oy,cyx->xyco", dety_blk, eff_wc).reshape(
        dx_in, dy_in, chunk * dy_out)
    row_off = (torch.arange(hc, device=dev)[:, None]
               + torch.arange(dy_in, device=dev)[None, :] - sy_in)

    img = torch.empty((h, w), dtype=torch.float32, device=dev)
    for y_base in range(0, h, hc):
        for x0 in range(0, w, chunk):
            s_x = torch.roll(sample, sx_in - x0, dims=1)[:, :dx_in]
            s_w = s_x[(y_base + row_off) % h]        # [hc, Di_y, Di_x]
            t1 = torch.einsum("xyn,hyx->hnx", p_t, s_w)  # [hc, C*Do_y, Di_x]
            cam = torch.einsum("hnx,ox->hno", t1, detx_blk)
            cam = params.brightness * cam.reshape(hc, chunk, dy_out, dx_out)
            counts = (poisson_rows_tiered(cam.contiguous(), generator)
                      if draw_noise else cam)
            img[y_base:y_base + hc, x0:x0 + chunk] = torch.einsum(
                "hcyx,cyx->hc", counts, pin_wc)
    return img

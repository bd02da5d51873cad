"""Closed-form system kernels and the rescanned canvas (port of
``rescan_line_sted_tpu.imaging.analytic``).

Descanned point- and line-STED collapse to ONE circular correlation of
the sample with a system kernel: ``img = brightness * corr(sample, K)``
with ``K = eff . (pinhole (*) det)`` (point) or ``K(vy, vx) = e(vx) .
flip(det (*)_x slit)(vy, vx)`` (line, ``e`` the 1D effective line).

Reassigning camera column x of scan position x0 to canvas column
``u = R*x0 + (x - x0)`` gives ``canvas(y, u) = sum_a sample(., a)
H(y - ., u - R*a)``: the sample upsampled by R along x convolved with the
rescan kernel ``H(vy, vx) = sum_t e(t) det(vy, vx + (R-1) t)``. Subpixel
placement uses band-limited phase ramps; detector binning by b splits the
map into b column-phase kernels ``H_rho``. The canvas differs from the
per-step scan only through circular wrap, so the two agree on samples that
are zero within ~PSF support of their x-edges.

The placement of phase-split column m at canvas column R*m takes one of
two routes, chosen once per plan from the geometry alone
(``_fft_placement``). Where ``R * (W/b)`` is exactly the canvas width
``Wc`` (R = 1.5, 2, 3, ... at the usual widths), ``R*m/Wc = m/(W/b)``:
the placement is the plain length-``W/b`` DFT, extended periodically to
the canvas's ``Wc//2+1`` frequencies, and runs as an FFT. At any other R
(R = 1 + pi/16) it is a complex product with the host-built phase table
``pm``. Both compute the same linear map, so autograd's transpose of
either is the exact adjoint.
"""

from __future__ import annotations

import functools
from fractions import Fraction

import numpy as np
import torch

from rescan_line_sted_torch.device import host_table, plan_cache
from rescan_line_sted_torch.imaging.shifts import flip_centered
from rescan_line_sted_torch.kernels import fftconv
from rescan_line_sted_torch.physics import models
from rescan_line_sted_torch.physics import psf as psfs
from rescan_line_sted_torch.utils.observability import span


def point_system_kernel(shape, params, device=None) -> torch.Tensor:
    """Centered system kernel of descanned point-STED, [H, W]:
    ``K = psf_eff . (pinhole (*) psf_det)``."""
    eff = models.effective_point_psf(shape, params, device)
    det = psfs.detection_psf(shape, params.sigma_det, device)
    pin = psfs.pinhole_mask(shape, params.pinhole_radius, device)
    return eff * fftconv.fft_convolve(pin, det)


def line_system_kernel(shape, params, device=None) -> torch.Tensor:
    """Centered system kernel of descanned line-STED, [H, W]: ``K(vy, vx)
    = e_eff(vx) . flip(det (*)_x slit)(vy, vx)``."""
    h, w = shape
    eff = models.effective_line_profile(w, params, device)
    det = psfs.detection_psf(shape, params.sigma_det, device)
    slit = psfs.slit_profile(w, params.slit_halfwidth, device)
    d = torch.fft.irfft(torch.fft.rfft(det, dim=-1)
                        * torch.fft.rfft(torch.fft.ifftshift(slit)),
                        n=w, dim=-1)
    return eff[None, :] * flip_centered(d)


def _np_phases(theta: np.ndarray, device=None) -> torch.Tensor:
    """``exp(-2i pi theta)`` built in float64 on the host -> complex64.

    Phase arguments reach ~1e4 radians at large widths; in f32 they would
    lose ~1e-4 of phase and break the 1e-5 parity bar. A CUDA copy goes
    from pinned memory without blocking, so the host keeps queueing work.
    """
    z = np.exp(-2j * np.pi * np.asarray(theta, np.float64))
    return host_table(z.astype(np.complex64), device)


@functools.lru_cache(maxsize=4)
def _phase_tables(w: int, wc: int, r: float, b: int, device: torch.device):
    """The static phase tables of the rescan kernels, built in float64 on
    the host and held as complex64 on ``device``: the detection centring
    ``center_ph`` [K], the stretched line's phases ``pe`` [W, K] and the
    residue phases ``rho_ph`` [b, K] (K = Wc//2+1). Cached per geometry
    and device, as the JAX package builds them once per compile (~34 MB
    on the card at 2048^2, R = 2), outside inference mode (they serve
    autograd calls); do not mutate. The placement's table, where the
    geometry needs one, is ``_placement_phases``."""
    kk = np.arange(wc // 2 + 1, dtype=np.float64)
    t_c = np.arange(w, dtype=np.float64) - w // 2
    with torch.inference_mode(False):
        return (_np_phases(-kk * (w // (2 * b)) / wc, device),
                _np_phases(-kk[None, :] * (r - 1.0) * t_c[:, None]
                           / (b * wc), device),
                _np_phases(kk[None, :] * (r - 1.0) * np.arange(b)[:, None]
                           / (b * wc), device))


@functools.lru_cache(maxsize=4)
def _placement_phases(w: int, wc: int, r: float, b: int,
                      device: torch.device):
    """The placement table ``pm`` [w/b, K] of phase-split column m at R*m,
    ``exp(-2i pi k R m / Wc)``, built and cached as ``_phase_tables`` are.
    Only the product route builds it (``_fft_placement`` false)."""
    kk = np.arange(wc // 2 + 1, dtype=np.float64)
    with torch.inference_mode(False):
        return _np_phases(kk[None, :] * r * np.arange(w // b)[:, None] / wc,
                          device)


def _tables(geom, device):
    return _phase_tables(geom.grid.width, geom.canvas_shape[1],
                         float(geom.rescan_factor), geom.binning,
                         torch.device(device or "cpu"))


def _fft_placement(geom) -> bool:
    """Whether the placement at R*m is the plain length-``W/b`` DFT:
    exactly where ``R * (W/b) == Wc``, in exact arithmetic (``R`` as the
    binary fraction it is), so that no tolerance decides the route."""
    w, b = geom.grid.width, geom.binning
    return (Fraction(float(geom.rescan_factor)) * (w // b)
            == geom.canvas_shape[1])


def _periodic(f: torch.Tensor, k: int) -> torch.Tensor:
    """``f`` [..., n] extended periodically along its last axis to ``k``
    columns, ``f[..., j mod n]``: a view where ``k <= n``, else one
    ``cat``."""
    n = f.shape[-1]
    if k <= n:
        return f[..., :k]
    return torch.cat([f] * (k // n) + [f[..., :k % n]], dim=-1)


def rescan_x_kernels_rfft(geom, params, device=None) -> torch.Tensor:
    """rfft-domain column-phase rescan kernels ``H_rho`` [b, Wc//2+1].

    ``H_rho_hat(k) = D_hat_rho(k) * E_hat_rho(k)`` with ``d_rho(X) =
    sum_j det_x(b X + j - rho)`` the phase-rho binned detection profile
    and ``E_hat_rho`` the (R-1)-stretched effective line's phase sum.
    Brightness is NOT included.
    """
    b = geom.binning
    w, wc = geom.grid.width, geom.canvas_shape[1]
    center_ph, pe, rho_ph = _tables(geom, device)

    eff = models.effective_line_profile(w, params, device)
    det_x = psfs.detection_profile(w, params.sigma_det, device)

    x_idx = torch.arange(w // b, device=device)
    j_idx = torch.arange(b, device=device)
    gather = (b * x_idx[None, :, None] + j_idx[None, None, :]
              - j_idx[:, None, None]) % w                        # [rho, X, j]
    d = det_x[gather].sum(-1)                                    # [b, w/b]
    d_hat = torch.fft.rfft(d, n=wc, dim=-1) * center_ph[None, :]
    e_base = eff.to(torch.complex64) @ pe                        # [K]
    return d_hat * e_base[None, :] * rho_ph


def _binned_row_matrix(h: int, b: int, det_y: torch.Tensor) -> torch.Tensor:
    """[h, h/b] matrix G with ``(G^T @ sample)[Y] = sum_j conv_y(sample,
    det_y)[b Y + j]`` -- the y-convolve + row-bin of the scan engine."""
    my = fftconv.circulant_matrix(det_y)                         # [h, h]
    return my.reshape(h, h // b, b).sum(-1)


@plan_cache(maxsize=4)
def _canvas_constants(params, geom, device):
    """The closed form's constants on ``device``, built once per (params,
    geometry, device) where they can key a cache (``device.plan_cache``):
    the y-convolve + row-bin matrix ``gy_t`` [h/b, h] (a dense circulant,
    16 MB at 2048^2), the column-phase kernels ``h_hat`` [b, 1, K] and the
    placement's route: ``pm`` None where the placement is an FFT
    (``_fft_placement``, decided here, once a plan), else the placement
    phases ``pm`` [w/b, K]."""
    b = geom.binning
    h = geom.grid.height
    det_y = psfs.detection_profile(h, params.sigma_det, device)
    gy_t = _binned_row_matrix(h, b, det_y).T                     # [hc, h]
    h_hat = rescan_x_kernels_rfft(geom, params, device)[:, None, :]
    pm = (None if _fft_placement(geom) else
          _placement_phases(geom.grid.width, geom.canvas_shape[1],
                            float(geom.rescan_factor), b, device))
    return gy_t, h_hat, pm


def _canvas_map(params, geom, device):
    """The rescan closed form as a function ``sample [..., H, W] -> canvas
    [..., H/b, Wc]`` (leading dimensions batch), on its constants
    (``_canvas_constants``). Linear in ``sample``; ``rescan_canvas_mean``
    and the fusion operators (``algorithms/fusion.py``) share it.

    The placement of the phase-split rows ``s_ph`` [.., b, hc, w/b] on
    the canvas's K = Wc//2+1 frequencies takes the plan's route: where
    ``R * (W/b) == Wc``, ``fft(s_ph)`` extended periodically to K columns
    (``_periodic``), inside the counter span ``rls.image.fft_placement``,
    once an application; elsewhere the complex product ``s_ph @ pm``."""
    b = geom.binning
    h, w = geom.grid.shape
    hc, wc = geom.canvas_shape
    with span("rls.image.tables"):
        gy_t, h_hat, pm = _canvas_constants(params, geom,
                                            torch.device(device or "cpu"))

    @span("rls.image.products")
    def canvas(sample: torch.Tensor) -> torch.Tensor:
        lead = sample.shape[:-2]
        s_yb = gy_t @ sample                                     # [.., hc, w]
        # split columns by phase: a = b*m + rho -> [.., b(rho), hc, w/b(m)]
        s_ph = s_yb.reshape(*lead, hc, w // b, b).movedim(-1, -3)
        if pm is None:
            with span("rls.image.fft_placement"):
                placed = _periodic(torch.fft.fft(s_ph, dim=-1),
                                   wc // 2 + 1)                  # [.., K]
        else:
            placed = s_ph.to(torch.complex64) @ pm
        canvas_rfft = (placed * h_hat).sum(-3)                   # [.., hc, K]
        return params.brightness * torch.fft.irfft(canvas_rfft, n=wc,
                                                   dim=-1)

    return canvas


def rescan_canvas_mean(sample: torch.Tensor, params, geom) -> torch.Tensor:
    """Noise-free rescanned canvas [..., H/b, Wc] of ``sample`` [..., H,
    W]: exact closed form for any ``rescan_factor >= 1`` and any
    ``binning``."""
    return _canvas_map(params, geom, sample.device)(sample)


def rescan_system_kernel(geom, params, device=None) -> torch.Tensor:
    """Centered effective rescan kernel H on the canvas grid, [H/b, Wc].

    ``H(vy, vx) = sum_t e_eff(t) det(vy, vx + (R-1) t)``: the detection PSF
    sheared by the (R-1)-stretched effective excitation line; any
    ``rescan_factor`` (fractional R via exact phase placement). With
    ``binning > 1`` the system is b-periodically shift-variant; the
    returned kernel is the position-aligned average over the b column/row
    phases (the exact per-phase kernels are ``rescan_x_kernels_rfft``).
    For b = 1 the noise-free canvas is ``brightness * conv(place_x(sample,
    R), H)``. Built on ``device`` (None: the CPU); the phases and the y
    gather are host tables in float64.
    """
    b = geom.binning
    h, w = geom.grid.shape
    hc, wc = geom.canvas_shape
    kk = np.arange(wc // 2 + 1, dtype=np.float64)
    rho = np.arange(b, dtype=np.float64)

    # x: phase rho's response sits at relative offset -rho/b on the canvas
    # (camera-column quantization); align each before averaging.
    h_hat = rescan_x_kernels_rfft(geom, params, device)          # [b, K]
    align = _np_phases(kk[None, :] * rho[:, None] / (b * wc), device)
    hx = torch.fft.fftshift(torch.fft.irfft((h_hat * align).mean(0), n=wc))

    # y: binned detection profile, phase-aligned the same way.
    det_y = psfs.detection_profile(h, params.sigma_det, device)
    y_idx = np.arange(hc)
    gather = (b * y_idx[None, :, None] + np.arange(b)[None, None, :]
              - np.arange(b)[:, None, None]) % h                # [b, hc, b]
    dy = det_y[host_table(gather, device)].sum(-1)               # [b, hc]
    ky = np.arange(hc // 2 + 1, dtype=np.float64)
    centery = _np_phases(-ky * (h // (2 * b)) / hc, device)
    aligny = _np_phases(ky[None, :] * rho[:, None] / (b * hc), device)
    gy = torch.fft.fftshift(torch.fft.irfft(
        (torch.fft.rfft(dy, n=hc, dim=-1) * centery[None, :] * aligny
         ).mean(0), n=hc))                                       # [hc]
    return torch.outer(gy, hx)


def upsample_x(sample: torch.Tensor, factor: int,
               out_width: int) -> torch.Tensor:
    """Zero-insertion upsampling along x: pixel a -> column factor * a
    (columns past ``out_width`` are dropped, as JAX's scatter drops
    them)."""
    w = sample.shape[-1]
    keep = min(w, -(-out_width // factor))
    out = sample.new_zeros(sample.shape[:-1] + (out_width,))
    out[..., torch.arange(keep, device=sample.device) * factor] = \
        sample[..., :keep]
    return out

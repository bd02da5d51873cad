"""Rescanned line-STED engine (port of the JAX package's
``imaging/rescan.py``).

Camera-based detection with pixel reassignment: the camera frame captured
at scan position ``x0`` is re-binned by the detector binning factor ``b``
and accumulated into the canvas at column offset ``(R - 1) * x0 / b``
(camera column x lands at canvas column ``R*x0 + (x - x0)``), wrapping
circularly on the ``round(R*W)/b``-wide canvas.

Methods:

* ``"analytic"``: the closed-form canvas mean
  (``analytic.rescan_canvas_mean``'s canvas map) and one Poisson draw (K2c
  on the card).
* ``"scan"``: the per-scan-position process. Where band windows exist
  (``_illum_band``) it runs on the banded route: the y-convolution is
  hoisted out of the loop, then ONE call of the banded fused scan (kernel
  K1 on the card) convolves (each frame over its band: the window columns
  within both profiles' supports, ``_band_supports``), samples
  (``noise_mode="per_step"``) and places every frame.
  ``reassignment="rounded"`` snaps each offset to the nearest binned
  canvas pixel; ``"subpixel"`` places a rational step
  ``(R-1)/b = p/q`` (q <= 8, q | chunk) exactly through q class canvases
  whose fractional residues are applied once per image as spectral shifts,
  and any other step (irrational, or q > 8) through K1's NUFFT spreading
  mode: each frame is spread by 8 exponential-of-semicircle taps onto the
  two parity canvases of a 2x-oversampled grid, merged and deconvolved once
  per image; ``"auto"`` picks subpixel exactly when offsets are fractional.

Without band windows (a model whose excitation is not the Gaussian
envelope, a frame no wider than the windows, a binning that misaligns
them, or windows beyond K1's shared memory, ``banded_fits``: D_in above
~850 at chunk 32) the scan takes the JAX package's TPU routes
(``_full_frame_scan``), whatever the device (a CUDA sample launches the
kernels, a CPU one runs their plain versions):

==========  =========  ============  ====================================
placement   noise      use_pallas    route
==========  =========  ============  ====================================
rounded     per-step   None / True   K4 (``rescan_fused``), draws inside,
                                     where ``runs_fit``; else W-major
                                     frames, K2b, FFT placement
rounded     collapsed  True          K4 noise-free where ``runs_fit``,
                                     then K2c; else as the last row
rounded     per-step   False         frames, K2c per frame, K5 scatter
subpixel    per-step   None / True   W-major frames, K2b, FFT placement
subpixel    per-step   False         frames, K2c per frame, FFT placement
any other   collapsed  (any)         FFT phase accumulation, then K2c
==========  =========  ============  ====================================

The frames of the non-K4 routes are the dense product ``emitted @
circulant(gx)``; FFT placement adds each frame's rfft (zero-padded to the
canvas) times its position's phase ramp ``exp(-2i pi k off / wc)`` (built
in float64 on the host) and inverts once per image. The JAX gates
``noisy_vmem_ok`` and ``fused_fits`` modelled the TPU's VMEM and 8-aligned
placement; K4's own bound ``rescan_fused.runs_fit`` replaces them: where
the tap runs exceed it, the K4 rows take the W-major K2b route with
rounded phase ramps (per-step) or FFT phase accumulation (collapsed), as
the JAX package took its hybrid where ``noisy_vmem_ok`` failed.

Subpixel placement spreads a camera pixel band-limitedly over the canvas:
per-step subpixel canvases carry small negative excursions (sinc ringing
of integer counts), and ``noise_mode="collapsed"`` then means "shot noise
of the ideal canvas".

What a call takes from (params, geometry, placement, device) alone -- the
profiles, the y-convolution's OTF, offsets and classes or NUFFT tables, K1's
plan (``banded_plan``: its windows and placement scalars), the finish's
phase tables and the dose ledger -- is built once into the entry's plan
(``_image_plan``; the closed form's constants in
``analytic._canvas_constants``) and reused while the arguments can key a
cache (``device.plan_cache``), so a call issues only the work that depends
on its sample.

Boundaries: ``"circular"`` (the grid wraps), ``"padded"`` (acquire on a
zero-padded grid and crop, ``imaging/boundary.py``) and ``"apodized"``
(taper the sample's edges to zero).

Row-sharded samples (a ``DTensor``, ``Shard(0)`` on one mesh axis of
more than one rank, ``Replicate()`` elsewhere) take the JAX package's
routing: the scan goes to ``parallel.rescanned_line_sted_sharded`` (K1 on
every rank, a halo exchange of the detection support) wherever the
unsharded call would take K1; any other call, or one whose sharded
preconditions fail (``ShardedPreconditionError``), gathers the sample
(``full_tensor``), runs the unsharded engine on the rank's card and
returns the canvas re-sharded by rows, as GSPMD shards the JAX scan.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from rescan_line_sted_torch.config import RescanGeometry, RescanParams
from rescan_line_sted_torch.device import as_sample, host_table, plan_cache
from rescan_line_sted_torch.imaging import analytic
from rescan_line_sted_torch.imaging import boundary as boundaries
from rescan_line_sted_torch.imaging.line_sted import effective_line_profile
from rescan_line_sted_torch.imaging.point_sted import AcquisitionResult
from rescan_line_sted_torch.imaging.shifts import shifted_profiles
from rescan_line_sted_torch.kernels import fftconv
from rescan_line_sted_torch.kernels.poisson import poisson_rows_tiered
from rescan_line_sted_torch.kernels.rescan_accumulate import (
    rescan_accumulate,
)
from rescan_line_sted_torch.kernels.rescan_banded_fused import (
    BandedPlan,
    banded_fits,
    banded_plan,
    rescan_banded_fused,
)
from rescan_line_sted_torch.kernels.rescan_fused import rescan_fused, runs_fit
from rescan_line_sted_torch.parallel.mesh import (
    gather_dtensors,
    is_dtensor,
    whole,
)
from rescan_line_sted_torch.physics import models
from rescan_line_sted_torch.physics import psf as psfs
from rescan_line_sted_torch.physics.dose import DoseReport, line_sted_dose
from rescan_line_sted_torch.physics.noise import maybe_poisson
from rescan_line_sted_torch.utils.observability import span

_SIGMA_FROM_FWHM = 2.3548200450309493


@span("rls.image")
def rescanned_line_sted_image(
    sample,
    params: RescanParams,
    geom: RescanGeometry,
    generator: torch.Generator | None = None,
    method: str = "analytic",
    noise_mode: str = "collapsed",
    reassignment: str = "auto",
    boundary: str = "circular",
    margin: int | None = None,
    device=None,
    use_pallas: bool | None = None,
) -> AcquisitionResult:
    """Simulate a full rescanned line-STED acquisition of ``sample`` [H, W].

    Returns the canvas ``[H/b, round(R*W)/b]`` for any ``rescan_factor >=
    1`` and any binning. ``sample`` (a tensor or array) is taken as
    float32, as the JAX package takes it, and moved to ``device``: None
    means the CUDA card (a CUDA ``sample`` stays on its card), and raises
    without one; pass ``device="cpu"`` for the plain PyTorch versions.
    ``generator`` (a ``torch.Generator``) draws shot noise; ``None`` gives
    the noise-free mean. ``reassignment`` ("auto" | "rounded" |
    "subpixel") and ``noise_mode`` ("collapsed" | "per_step") apply to the
    scan method (module doc). ``boundary``: "circular", "padded" (open
    boundary via pad-acquire-crop; the dose is reported for the requested
    field) or "apodized"; ``margin`` defaults to
    ``boundary.default_margin(geom)``. ``use_pallas`` selects among the
    routes without band windows as the JAX argument does (module doc);
    geometries with band windows always take K1.
    """
    if is_dtensor(sample):
        return _row_sharded_call(
            sample, params, geom, generator=generator, method=method,
            noise_mode=noise_mode, reassignment=reassignment,
            boundary=boundary, margin=margin, device=device,
            use_pallas=use_pallas)
    sample = as_sample(sample, geom.grid.shape, device)
    if boundary not in ("circular", "padded", "apodized"):
        raise ValueError(f"unknown boundary {boundary!r}")
    if margin is None and boundary != "circular":
        margin = boundaries.default_margin(geom)
    if boundary == "apodized":
        sample = boundaries.apodize_sample(sample, margin)
    elif boundary == "padded":
        res = boundaries.acquire_padded(
            lambda s, g, **kw: rescanned_line_sted_image(s, params, g, **kw),
            sample, geom, margin, generator=generator, method=method,
            noise_mode=noise_mode, reassignment=reassignment,
            device=sample.device, use_pallas=use_pallas)
        return dataclasses.replace(
            res, dose=line_sted_dose(params, geom, sample.device))
    models.line_model(params)           # raises on a JAX package model
    if method not in ("analytic", "scan"):
        raise ValueError(f"unknown method {method!r}")
    if method == "scan" and noise_mode not in ("collapsed", "per_step"):
        raise ValueError(f"unknown noise_mode {noise_mode!r}")
    placement = (None if method == "analytic"
                 else _resolve_reassignment(geom, reassignment))
    with span("rls.image.tables"):
        plan = _image_plan(params, geom, placement, sample.device)
    if method == "analytic":
        image = maybe_poisson(generator, plan.canvas(sample))
    else:
        image = _scan(sample, plan, params, geom, generator, noise_mode,
                      placement, use_pallas)
    with span("rls.image.tables"):
        dose = DoseReport(*plan.dose.clone().unbind())
    return AcquisitionResult(image=image, dose=dose)


def _row_sharded_mesh(sample):
    """``(mesh, axis)`` when ``sample`` is a 2-D ``DTensor`` whose rows are
    split over exactly ONE mesh axis of more than one rank (``Shard(0)``
    there, ``Replicate()`` on every other axis); None otherwise."""
    if not is_dtensor(sample) or sample.ndim != 2:
        return None
    mesh = sample.device_mesh
    placements = sample.placements
    if not all(p.is_shard(0) or p.is_replicate() for p in placements):
        return None
    split = [i for i, p in enumerate(placements) if p.is_shard(0)]
    if len(split) != 1 or mesh.size(split[0]) <= 1:
        return None
    names = mesh.mesh_dim_names
    return mesh, (names[split[0]] if names else split[0])


def _route_row_sharded(sample, params, geom, generator, noise_mode,
                       reassignment):
    """The row-sharded scan (``parallel.rescanned_line_sted_sharded``)
    where the unsharded call would take K1 (band windows present;
    ``use_pallas`` does not choose there); None when the sample is not
    row-sharded or the sharded engine's preconditions fail, a scan that
    takes no K1 among them (``ShardedPreconditionError``, caught alone:
    any other error, a plain ``ValueError`` of argument validation
    included, propagates as it would unsharded)."""
    hit = _row_sharded_mesh(sample)
    if hit is None:
        return None
    from rescan_line_sted_torch.parallel import sharded_rescan

    mesh, axis = hit
    try:
        return sharded_rescan.rescanned_line_sted_sharded(
            sample, params, geom, mesh, axis=axis, generator=generator,
            noise_mode=noise_mode, reassignment=reassignment)
    except sharded_rescan.ShardedPreconditionError:
        return None


def _row_sharded_call(sample, params, geom, **kw):
    """``rescanned_line_sted_image`` of a ``DTensor`` sample (module doc):
    the row-sharded scan, else the gathered route."""
    params = whole(params)
    if kw["method"] == "scan" and kw["boundary"] == "circular":
        routed = _route_row_sharded(sample, params, geom, kw["generator"],
                                    kw["noise_mode"], kw["reassignment"])
        if routed is not None:
            return routed
    return gather_dtensors(rescanned_line_sted_image)(
        sample, params, geom, **kw)


def _sigma_ill(params, width: int, device=None) -> torch.Tensor:
    """Effective line width (sigma, px) from the depleted profile's FWHM."""
    from rescan_line_sted_torch.algorithms.metrics import fwhm_1d

    eff = effective_line_profile(width, params, device)
    return fwhm_1d(eff) / _SIGMA_FROM_FWHM


def optimal_rescan_factor(params: RescanParams, width: int) -> torch.Tensor:
    """Optimal rescan factor ``R = 1 + sigma_det^2 / sigma_ill_eff^2``
    (``sigma_ill_eff`` from the depleted line's FWHM). Not capped: strong
    depletion can return R ~ 11+; see ``practical_rescan_factor``."""
    sd = torch.as_tensor(params.sigma_det)
    return 1.0 + sd.square() / _sigma_ill(params, width).square()


def rescan_kernel_sigma(params: RescanParams, width: int,
                        factors) -> torch.Tensor:
    """Reassigned-kernel width ``sigma(R)^2 = sigma_ill^2 (1 - 1/R)^2 +
    sigma_det^2 / R^2`` (sample px), broadcast over ``factors``."""
    sigma_ill = _sigma_ill(params, width)
    t = 1.0 / torch.as_tensor(factors, dtype=torch.float32)
    sd = torch.as_tensor(params.sigma_det)
    return torch.sqrt(sigma_ill.square() * (1.0 - t).square()
                      + sd.square() * t.square())


def practical_rescan_factor(params: RescanParams, width: int,
                            tolerance: float = 0.05,
                            cap: float | None = None,
                            snap: int | None = 8) -> torch.Tensor:
    """Smallest rescan factor within ``tolerance`` of the optimal
    resolution, rounded UP to a multiple of ``1/snap`` (never past the
    optimum) and optionally capped (see the JAX package's docstring for
    the closed-form derivation)."""
    return practical_factor_from_sigmas(
        _sigma_ill(params, width), params.sigma_det, tolerance, cap, snap)


def practical_factor_from_sigmas(sigma_ill, sigma_det,
                                 tolerance: float = 0.05,
                                 cap: float | None = None,
                                 snap: int | None = 8) -> torch.Tensor:
    """The closed-form tolerance-band solve behind
    ``practical_rescan_factor``."""
    si2 = torch.as_tensor(sigma_ill, dtype=torch.float32).square()
    sd2 = torch.as_tensor(sigma_det, dtype=torch.float32).square()
    target = (1.0 + tolerance) ** 2 * si2 * sd2 / (si2 + sd2)
    disc = torch.clamp_min(si2 * si2 - (si2 + sd2) * (si2 - target), 0.0)
    t = (si2 + torch.sqrt(disc)) / (si2 + sd2)
    r = torch.clamp_min(1.0 / torch.clamp_min(t, 1e-12), 1.0)
    if snap:
        r = torch.minimum(torch.ceil(r * snap) / snap, 1.0 + sd2 / si2)
    if cap is not None:
        r = torch.clamp_max(r, cap)
    return r


def _rebin(cam: torch.Tensor, b: int) -> torch.Tensor:
    """Sum camera pixels in b x b blocks: [..., H, W] -> [..., H/b, W/b]."""
    if b == 1:
        return cam
    *lead, h, w = cam.shape
    return cam.reshape(*lead, h // b, b, w // b, b).sum(dim=(-3, -1))


def _rational_step(step: float, chunk: int):
    """Smallest q <= 8 with q | chunk and ``step * q`` integral (1e-9 tol).
    Returns ``(p, q)`` with ``step == p / q``, or None."""
    for q_try in range(1, 9):
        if chunk % q_try == 0 \
                and abs(step * q_try - round(step * q_try)) < 1e-9:
            return int(round(step * q_try)), q_try
    return None


def _residue_finish(fracs, wc: int, device):
    """``folded [q, wc, H] -> [H, wc]``: the class canvases summed, each
    shifted by its fractional canvas offset ``fracs[r]`` as ONE spectral
    phase ramp, built here once in f64 on the host onto ``device``."""
    if len(fracs) == 1:
        return span("rls.image.finish")(
            lambda folded: folded[0].T.contiguous())
    kdim = wc // 2 + 1
    ph = analytic._np_phases(np.arange(kdim)[None, :]
                             * np.asarray(fracs, np.float64)[:, None] / wc,
                             device)                             # [q, K]

    @span("rls.image.finish")
    def finish(folded: torch.Tensor) -> torch.Tensor:
        spec = torch.fft.rfft(folded, n=wc, dim=1)               # [q, K, H]
        return torch.fft.irfft((spec * ph[:, :, None]).sum(0), n=wc,
                               dim=0).T.contiguous()

    return finish


_NUFFT_P = 8  # spreading-window width (fine-grid taps); see _nufft_beta


def _nufft_beta(p: int) -> float:
    """Exponential-of-semicircle shape parameter for oversampling 2:
    ``beta = 0.976 * pi * P * (1 - 1/(2 sigma))`` (the finufft tuning);
    aliasing error ~2e-8 at P = 8."""
    return 0.976 * 3.141592653589793 * p * 0.75


def _nufft_spread_tables(offs, p: int = _NUFFT_P, device=None):
    """Per-position NUFFT spreading tables for any-step subpixel placement.

    Frame ``c`` shifts by the real canvas offset ``offs[c]``, i.e. by
    ``2 * offs[c]`` on the 2x-oversampled fine grid, straddled by ``p``
    integer taps weighted by the ES window. Tap ``t`` lands on the
    parity-``(n0 + t) % 2`` coarse canvas at integer offset
    ``(n0 + t - parity) / 2``; grouped by parity, each position has two
    P/2-tap filters and two integer offsets. Built in float64 on the host
    (floor and Python-sign modulo on int64), weights cast to f32 last.

    Returns ``(offsets2 [2, W] int32, weights [W, 2 * P/2] f32)`` for
    ``banded_plan(spread_weights=, offsets2=)``: the offsets on the host,
    where the plan counts its spreading items before it sends them to
    ``device``, the weights on ``device``.
    """
    offs = np.asarray(offs, np.float64)
    p2 = p // 2
    fine = 2.0 * offs
    n0 = np.floor(fine).astype(np.int64) - (p2 - 1)
    beta = _nufft_beta(p)

    def phi(z):
        u = 1.0 - np.square(2.0 * z / p)
        return np.where(u > 0.0, np.exp(beta * (np.sqrt(np.maximum(u, 0.0))
                                                - 1.0)), 0.0)

    offsets2 = np.empty((2, offs.size), np.int64)
    weights = np.empty((offs.size, 2 * p2), np.float64)
    for parity in (0, 1):
        t0 = (parity - n0) % 2                       # first tap, parity pi
        taps = n0[:, None] + t0[:, None] + 2 * np.arange(p2)[None, :]
        offsets2[parity] = (n0 + t0 - parity) // 2
        weights[:, parity * p2:(parity + 1) * p2] = phi(taps - fine[:, None])
    return (torch.from_numpy(offsets2.astype(np.int32)),
            host_table(weights.astype(np.float32), device))


@functools.lru_cache(maxsize=8)
def _nufft_deconv_inv(wc: int, p: int = _NUFFT_P) -> np.ndarray:
    """``1 / phi_hat(pi k / wc)`` for k in [0, wc/2] (f32 host array; do
    not mutate): the once-per-image window deconvolution, by float64
    trapezoid quadrature of the ES window's continuous transform on 8193
    points."""
    beta = _nufft_beta(p)
    z = np.linspace(-p / 2.0, p / 2.0, 8193)
    phi = np.exp(beta * (np.sqrt(np.maximum(
        1.0 - np.square(2.0 * z / p), 0.0)) - 1.0))
    xi = np.pi * np.arange(wc // 2 + 1, dtype=np.float64) / wc
    trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy < 2
    phi_hat = trapezoid(phi[None, :] * np.cos(xi[:, None] * z[None, :]),
                        z, axis=1)
    return (1.0 / phi_hat).astype(np.float32)


def _nufft_finish(wc: int, device, dinv: np.ndarray | None = None):
    """``folded [2, wc, H] -> [H, wc]``: merge the two parity canvases of
    the 2x-oversampled fine grid (spectrum ``E_hat(k) + exp(-i pi k / wc)
    O_hat(k)``, phases built in float64 on the host) and divide by the
    window's ``phi_hat`` (``dinv``, default ``_nufft_deconv_inv(wc)``): the
    exact subpixel placement. Its two tables are put on ``device`` here,
    once."""
    ph = analytic._np_phases(np.arange(wc // 2 + 1) / (2.0 * wc),
                             device)                              # [K]
    dinv_t = host_table(_nufft_deconv_inv(wc) if dinv is None else dinv,
                        device)

    @span("rls.image.finish")
    def finish(folded: torch.Tensor) -> torch.Tensor:
        spec = torch.fft.rfft(folded, n=wc, dim=1)                # [2, K, H]
        fine = spec[0] + ph[:, None] * spec[1]
        return torch.fft.irfft(fine * dinv_t[:, None], n=wc,
                               dim=0).T.contiguous()

    return finish


def _illum_band(params, w: int, chunk: int,
                b: int = 1) -> tuple[int, int | None] | None:
    """Static band windows ``(d_in, d_out)`` of the banded scan.

    For chunk positions ``[p0, p0+C)`` the illumination is < 4e-10 of peak
    outside a ``d_in = C + 2 S_exc``-column sample window, and the camera
    response is < ~1e-12 outside a ``d_out = C + 2 (S_exc + S_det)``-column
    frame window (both rounded up to multiples of 128, as in the JAX
    package, so both packages truncate identically). ``d_out`` is None when
    the frame window would not be narrower than the frame or the binning
    misaligns it; the whole return is None when no window pays or the
    model's excitation is not the Gaussian envelope.
    """
    m = getattr(params, "model", None)
    if m is not None and not getattr(m, "gaussian_excitation", False):
        return None
    s_exc, s_det = _band_supports(params)
    d_in = -(-(chunk + 2 * s_exc) // 128) * 128
    if d_in >= w:
        return None
    d_out = -(-(chunk + 2 * (s_exc + s_det)) // 128) * 128
    if d_out >= w:
        return (d_in, None)
    if chunk % b or ((d_out - chunk) // 2) % b:
        return (d_in, None)
    return (d_in, d_out)


def _band_supports(params) -> tuple[int, int]:
    """``(s_exc, s_det)``: the support half-widths (px) that ``_illum_band``
    sizes the windows by, the params' own where set; K1 convolves each
    frame only where both reach (``banded_plan(supports=)``)."""
    from rescan_line_sted_torch.config import _support

    s_exc = getattr(params, "exc_support", None)
    s_det = getattr(params, "det_support", None)
    return (_support(params.sigma_exc) if s_exc is None else int(s_exc),
            _support(params.sigma_det) if s_det is None else int(s_det))


def _resolve_reassignment(geom, reassignment: str) -> str:
    """``reassignment`` with "auto" resolved: rounded exactly when every
    offset ``(R-1) x0 / b`` is integral."""
    if reassignment not in ("auto", "rounded", "subpixel"):
        raise ValueError(f"unknown reassignment {reassignment!r}")
    if reassignment == "auto":
        step = (float(geom.rescan_factor) - 1.0) / geom.binning
        return "rounded" if abs(step - round(step)) < 1e-9 else "subpixel"
    return reassignment


def _k1_windows(params, geom, reassignment="auto"):
    """``(d_in, d_out, pq)`` where the scan takes K1: its band windows and
    the placement step ``(p, q)`` (``(None, 1)`` rounded, None for NUFFT
    spreading); None where the banded route does not apply (no band
    windows, windows that do not fit the canvas, or windows beyond K1's
    shared memory, ``banded_fits``, whatever the device)."""
    reassignment = _resolve_reassignment(geom, reassignment)
    w = geom.grid.shape[1]
    b = geom.binning
    chunk = geom.chunk
    if w % chunk:
        raise ValueError("chunk must divide width")
    wc = geom.canvas_shape[1]
    step = (float(geom.rescan_factor) - 1.0) / b
    if reassignment == "rounded":
        pq = (None, 1)                     # round() is integral for any R
    else:
        pq = _rational_step(step, chunk)   # None: no classes, NUFFT mode
    n_spread = _NUFFT_P // 2 if pq is None else 0
    windowed = _illum_band(params, w, chunk, b)
    if (windowed is None or windowed[1] is None or chunk % 8
            or (windowed[1] // b + max(n_spread - 1, 0) + 7) // 8 * 8 + 8
            > wc
            or not banded_fits(windowed[0], windowed[1] // b, chunk, b,
                               n_spread)):
        return None
    return windowed[0], windowed[1], pq


@dataclasses.dataclass(frozen=True, eq=False)
class _Banded:
    """The banded scan's tables for one (params, geometry, placement,
    device): the y-convolution's OTF, K1's plan (``banded_plan``: its
    windows, profiles, placement and band) and the finish that turns K1's
    folded canvases into the image."""

    otf_y: torch.Tensor
    k1: BandedPlan
    finish: object

    def y_convolved(self, sample: torch.Tensor) -> torch.Tensor:
        """K1's one per-sample input: ``sample`` convolved along y."""
        with span("rls.image.yconv"):
            return fftconv.convolve_otf1d(sample, self.otf_y, axis=-2,
                                          n=sample.shape[-2])


@dataclasses.dataclass(frozen=True, eq=False)
class _Plan:
    """What an image call takes from (params, geometry, placement, device)
    alone: the dose ledger's values ``[4]`` in ``DoseReport``'s field
    order (each result gets its own copy, so that an in-place edit of one
    result's dose reaches no other), and the closed form's canvas map
    (``analytic._canvas_map``) or, where the scan takes K1, its tables."""

    dose: torch.Tensor
    canvas: object
    banded: _Banded | None


@plan_cache(maxsize=8)
def _image_plan(params, geom, reassignment, device) -> _Plan:
    """The entry's plan for ``reassignment`` ("rounded" or "subpixel", as
    ``_resolve_reassignment`` gives it; None for the closed form), built
    once per key where the arguments can key a cache
    (``device.plan_cache``): a later call issues only the work that
    depends on its sample."""
    report = line_sted_dose(params, geom, device)
    dose = torch.stack([getattr(report, f.name)
                        for f in dataclasses.fields(report)])
    if reassignment is None:
        return _Plan(dose=dose, banded=None,
                     canvas=analytic._canvas_map(params, geom, device))
    return _Plan(dose=dose, canvas=None,
                 banded=_banded_tables(params, geom, reassignment, device))


def _banded_tables(params, geom, reassignment, device) -> _Banded | None:
    """The banded scan's tables (``_Banded``); None where the scan does not
    take K1 (``_k1_windows``). Integer and rational steps place through
    classes (``_residue_finish``); any other subpixel step through K1's
    NUFFT spreading mode (``_nufft_finish``)."""
    found = _k1_windows(params, geom, reassignment)
    if found is None:
        return None
    d_in, d_out, pq = found
    h, w = geom.grid.shape
    b = geom.binning
    wc = geom.canvas_shape[1]
    step = (float(geom.rescan_factor) - 1.0) / b

    eff_b = params.brightness * effective_line_profile(w, params, device)
    otf_y = fftconv.profile_to_otf1d(
        psfs.detection_profile(h, params.sigma_det, device))
    gx = psfs.detection_profile(w, params.sigma_det, device)
    pos = torch.arange(w, device=device)
    k1 = dict(wc=wc, d_in=d_in, d_out=d_out, chunk=geom.chunk, binning=b,
              supports=_band_supports(params))
    if pq is None:
        offsets2, weights = _nufft_spread_tables(
            step * np.arange(w, dtype=np.float64), device=device)
        offsets = torch.zeros(w, dtype=torch.int32, device=device)
        k1.update(spread_weights=weights, offsets2=offsets2)
        finish = _nufft_finish(wc, device)
    else:
        bf_p, bf_q = pq
        if bf_p is None:
            offsets = torch.round(
                (geom.rescan_factor - 1.0) * pos / b).to(torch.int32)
            fracs = [0.0]
        else:
            offsets = torch.div(bf_p * pos, bf_q,
                                rounding_mode="floor").to(torch.int32)
            k1.update(classes=(pos % bf_q).to(torch.int32), q=bf_q,
                      class_bounds=(0, bf_q - 1))  # pos % q over pos >= 0
            fracs = [((bf_p * r) % bf_q) / bf_q for r in range(bf_q)]
        finish = _residue_finish(fracs, wc, device)
    return _Banded(otf_y=otf_y, k1=banded_plan(eff_b, gx, offsets, **k1),
                   finish=finish)


def _banded_inputs(sample, params, geom, reassignment="auto"):
    """K1's inputs for this acquisition from the entry's plan
    (``_image_plan``): ``(sample_y, k1_plan, finish)``, where
    ``finish(rescan_banded_fused(sample_y, k1_plan, generator=...))`` is
    the ``[H/b, wc]`` canvas. None where the scan does not take K1
    (``_k1_windows``)."""
    with span("rls.image.tables"):
        plan = _image_plan(params, geom,
                           _resolve_reassignment(geom, reassignment),
                           sample.device)
    banded = plan.banded
    if banded is None:
        return None
    return banded.y_convolved(sample).contiguous(), banded.k1, banded.finish


def _scan(sample, plan: _Plan, params, geom, generator, noise_mode,
          reassignment, use_pallas):
    """The scan method's canvas: K1 with ``plan``'s tables where it has
    them, else ``_full_frame_scan`` (``reassignment`` resolved, as the
    plan's key is)."""
    per_step = generator is not None and noise_mode == "per_step"
    banded = plan.banded
    if banded is not None:
        canvas = banded.finish(rescan_banded_fused(
            banded.y_convolved(sample).contiguous(), banded.k1,
            generator=generator if per_step else None))
    else:
        canvas = _full_frame_scan(
            sample, params, geom, generator if per_step else None,
            reassignment, use_pallas)
    if generator is not None and not per_step:
        canvas = maybe_poisson(generator, canvas)
    return canvas


def _full_frame_scan(sample, params, geom, generator, reassignment,
                     use_pallas):
    """The scan without band windows (module doc's table): kernel K4 for
    rounded placement with per-step noise or ``use_pallas=True`` where its
    tap runs fit (``runs_fit``); else per-chunk frames ``emitted @
    circulant(gx)``, sampled per frame when ``generator`` is given (K2b on
    W-major frames unless ``use_pallas=False``, else K2c) and placed by the
    K5 scatter (rounded, ``use_pallas=False``) or by FFT phase
    accumulation. Returns the canvas ``[H/b, wc]`` (noise-free when
    ``generator`` is None)."""
    h, w = geom.grid.shape
    b, chunk = geom.binning, geom.chunk
    if w % chunk:
        raise ValueError("chunk must divide width")
    hc, wc = geom.canvas_shape
    dev = sample.device
    per_step = generator is not None
    subpixel = reassignment == "subpixel"
    eff_b = params.brightness * effective_line_profile(w, params, dev)
    gx = psfs.detection_profile(w, params.sigma_det, dev)
    otf_y = fftconv.profile_to_otf1d(
        psfs.detection_profile(h, params.sigma_det, dev))
    sample_y = fftconv.convolve_otf1d(sample, otf_y, axis=-2, n=h)
    r1 = float(geom.rescan_factor) - 1.0

    def rounded(pos):                  # jnp.round: half to even, in f32
        return torch.round(r1 * pos / b).to(torch.int32)

    if not subpixel and (use_pallas is True
                         or (per_step and use_pallas is None)) \
            and runs_fit(eff_b, gx, b):
        offsets = rounded(torch.arange(w, device=dev))
        return rescan_fused(sample_y.contiguous(), eff_b, gx, offsets, wc,
                            b, generator)

    gx_mat = fftconv.circulant_matrix(gx)          # cam = emitted @ gx_mat
    w_major = per_step and use_pallas is not False
    scatter = per_step and use_pallas is False and not subpixel
    if scatter:
        canvas = torch.zeros((hc, wc), dtype=torch.float32, device=dev)
    else:
        offs = r1 * np.arange(w, dtype=np.float64) / b
        if not subpixel:
            offs = np.round(offs)
        ph = analytic._np_phases(offs[:, None] * np.arange(wc // 2 + 1)[None]
                                 / wc, dev)                       # [W, K]
        spec = torch.zeros((hc, wc // 2 + 1), dtype=torch.complex64,
                           device=dev)
    for p0 in range(0, w, chunk):
        pos = torch.arange(p0, p0 + chunk, device=dev)
        ill = shifted_profiles(eff_b, pos)                       # [C, W]
        if w_major:
            emitted_t = ill[:, :, None] * sample_y.T[None]       # [C, W, H]
            frames_t = poisson_rows_tiered(           # [C, W/b, H/b]
                _rebin(gx_mat.T @ emitted_t, b).contiguous(), generator)
            spec += torch.einsum("ckh,ck->hk",
                                 torch.fft.rfft(frames_t, n=wc, dim=1),
                                 ph[p0:p0 + chunk])
            continue
        frames = maybe_poisson(generator, _rebin(      # [C, H/b, W/b]
            (ill[:, None, :] * sample_y[None]) @ gx_mat, b))
        if scatter:
            canvas = rescan_accumulate(canvas, frames, rounded(pos))
        else:
            spec += torch.einsum("chk,ck->hk",
                                 torch.fft.rfft(frames, n=wc, dim=-1),
                                 ph[p0:p0 + chunk])
    if scatter:
        return canvas
    return torch.fft.irfft(spec, n=wc, dim=-1)

"""Resolution metrics (port of the JAX package's ``algorithms/metrics.py``).

Every measurement is a tensor op on the input's device: nothing reads a
value back to the host, so a sweep queues its FWHMs on the card without a
sync, and measures all its points in one batched call.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from rescan_line_sted_torch.config import PointSTEDParams, Replaceable
from rescan_line_sted_torch.device import resolve
from rescan_line_sted_torch.imaging import analytic


def fwhm_1d(profile: torch.Tensor) -> torch.Tensor:
    """Full width at half maximum of a 1D profile, subpixel, in pixels.

    The profile must have ONE lobe above half maximum; crossings are found
    by linear interpolation between samples. Returns NaN when the contract
    is violated (multi-lobed, flat or non-positive profiles, or a half-max
    level never crossed on one side). Leading dimensions are a batch of
    profiles, each measured alone (as under ``jax.vmap``).
    """
    peak_val = profile.amax(-1, keepdim=True)
    flat = (peak_val <= 0) | (peak_val <= profile.amin(-1, keepdim=True))
    p = profile / torch.where(flat, 1.0, peak_val)
    n = p.shape[-1]
    idx = torch.arange(n, dtype=p.dtype, device=p.device)
    half = 0.5
    above = p >= half
    n_crossings = (above[..., :-1] != above[..., 1:]).sum(-1)
    boundary_above = above[..., 0].int() + above[..., -1].int()
    multi_lobed = (n_crossings + boundary_above) > 2
    peak = torch.argmax(p, -1, keepdim=True)
    left_cand = torch.where((~above[..., :-1]) & above[..., 1:]
                            & (idx[:-1] < peak), idx[:-1], -math.inf)
    i_l = left_cand.amax(-1)
    right_cand = torch.where(above[..., :-1] & (~above[..., 1:])
                             & (idx[:-1] >= peak), idx[:-1], math.inf)
    i_r = right_cand.amin(-1)

    def interp(i):
        # non-finite i (no crossing) is masked out by ``ok`` below; the
        # gather reads on the device (indexing with a 0-d tensor would read
        # the index back to the host)
        i0 = torch.nan_to_num(i, posinf=0.0, neginf=0.0).long().clamp(0, n - 2)
        y0 = p.gather(-1, i0[..., None])[..., 0]
        y1 = p.gather(-1, i0[..., None] + 1)[..., 0]
        t = (half - y0) / torch.where(y1 == y0, 1.0, y1 - y0)
        return i0.to(p.dtype) + t

    x_l = interp(i_l)
    x_r = interp(i_r)
    ok = (torch.isfinite(i_l) & torch.isfinite(i_r) & ~multi_lobed
          & ~flat[..., 0])
    return torch.where(ok, x_r - x_l, math.nan)


def fwhm_2d(kernel: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(FWHM along y, FWHM along x) through the peak of a centered kernel
    (leading dimensions: a batch of kernels)."""
    h, w = kernel.shape[-2:]
    return fwhm_1d(kernel[..., :, w // 2]), fwhm_1d(kernel[..., h // 2, :])


@dataclasses.dataclass(frozen=True)
class ResolutionReport(Replaceable):
    """System-kernel resolution measurement for one configuration (0-d
    tensors, pixels)."""

    fwhm_y: torch.Tensor
    fwhm_x: torch.Tensor


def system_resolution_report(shape: tuple[int, int], params,
                             device=None) -> ResolutionReport:
    """FWHM of the modality's closed-form system kernel, computed on
    ``device`` (None: the CUDA card, raising without one; pass
    ``device="cpu"`` for the CPU).

    Point params -> point-STED kernel; line params -> descanned line-STED
    kernel (anisotropic: x is the STED-sharpened scan axis, y the
    diffraction-limited line axis).
    """
    device = resolve(device)
    if isinstance(params, PointSTEDParams):
        k = analytic.point_system_kernel(shape, params, device)
    else:
        k = analytic.line_system_kernel(shape, params, device)
    fy, fx = fwhm_2d(k)
    return ResolutionReport(fwhm_y=fy, fwhm_x=fx)

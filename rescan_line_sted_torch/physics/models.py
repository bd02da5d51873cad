"""Pluggable illumination models (port of the JAX package's
``physics/models.py``).

Every engine builds its illumination through the ``model`` field of its
params (``LineSTEDParams.model`` / ``PointSTEDParams.model``); None means
the closed forms of ``physics/psf.py``. A model is any object with
``excitation(arg, params, device=None)`` and ``depletion(arg, params,
device=None)`` returning float32 tensors on ``device``, where ``arg`` is
the width of a line model and the ``(H, W)`` shape of a point model.

The shipped alternatives:

* ``PupilDonutModel``: a circular pupil with a charge-``m`` vortex phase
  ``e^{i m theta}``, focused by FFT: ``|FFT(pupil)|^2`` has an exact
  on-axis zero and Airy-like rings. The aperture cutoff puts the first
  intensity ring at ``r = sigma_dep * sqrt(2)``, as the default donut's.
* ``VectorialDonutModel``: the Richards-Wolf high-NA focal intensity
  ``|Ex|^2 + |Ey|^2 + |Ez|^2`` of the vortex beam, whose on-axis null
  depends on the polarization's handedness.
* ``EnvelopedStripeModel``: the standing-wave stripe under a finite
  Gaussian envelope.
* ``InterferenceStripeModel``: a two-beam interference stripe whose
  fringe visibility the polarization limits.

``gaussian_excitation = True`` on each shipped model says that its
excitation is the package's Gaussian, so the params' static
``exc_support`` bounds the effective illumination and the banded engines
apply. A model without the attribute declines the band windows and takes
the full-frame routes.

A model of the JAX package returns ``jax`` arrays; placed on the port's
params it raises ``TypeError`` (``convert.params_from_jax`` carries the
shipped ones across).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from rescan_line_sted_torch.physics import psf as psfs

# First-intensity-ring radius of a charge-1 vortex-pupil donut with aperture
# cutoff f_max (cycles/pixel): r_ring ~= _VORTEX_RING_CONST / f_max.
_VORTEX_RING_CONST = 0.3925


def _f32(x) -> np.float32:
    return np.float32(x)


def _pupil_grid(sigma_dep, shape, device=None):
    """Frequency radius, azimuth, aperture cutoff and the ring-calibrated
    aperture mask of the vortex pupil (first intensity ring at
    ``sigma_dep * sqrt(2)``; the DC sample is excluded, since the vortex
    phase is singular there). Returns ``(fr, phi, f_max, mask)``; f_max is
    the float32 value the JAX package computes, a number or, for a tensor
    ``sigma_dep``, a 0-d tensor."""
    h, w = shape
    fy = torch.fft.fftfreq(h, device=device, dtype=torch.float32)[:, None]
    fx = torch.fft.fftfreq(w, device=device, dtype=torch.float32)[None, :]
    fr = torch.sqrt(fy * fy + fx * fx)
    phi = torch.atan2(fy, fx)
    if isinstance(sigma_dep, torch.Tensor):
        # full_like: ``number / tensor`` would multiply by a reciprocal
        f_max = torch.clamp_max(
            torch.full_like(sigma_dep, _VORTEX_RING_CONST)
            / (float(np.sqrt(_f32(2.0))) * sigma_dep), 0.5)
    else:
        f_max = _f32(_VORTEX_RING_CONST) / (np.sqrt(_f32(2.0))
                                            * _f32(sigma_dep))
        f_max = float(min(f_max, _f32(0.5)))  # aperture within Nyquist
    mask = ((fr <= f_max) & (fr > 0.0)).to(torch.float32)
    return fr, phi, f_max, mask


def _normalized(inten: torch.Tensor) -> torch.Tensor:
    return inten / torch.clamp_min(inten.max(), 1e-30)


def _vortex_donut(sigma_dep, shape, charge: int, device=None):
    """``|FFT(circ(f <= f_max) e^{i m theta})|^2``, peak-normalized."""
    _, theta, _, mask = _pupil_grid(sigma_dep, shape, device)
    pupil = torch.complex(mask * torch.cos(charge * theta),
                          mask * torch.sin(charge * theta))
    field = torch.fft.fftshift(torch.fft.ifft2(pupil))
    return _normalized(field.abs().square())


def _vectorial_donut(sigma_dep, shape, charge: int, na: float,
                     polarization: str, device=None):
    """High-NA vectorial focal intensity of a vortex beam (Richards-Wolf):
    ``|Ex|^2 + |Ey|^2 + |Ez|^2`` with the pupil's s/p rotation, ``sqrt(cos
    th)`` apodization and ``e^{i m phi}`` vortex, peak-normalized. The
    aperture keeps the scalar model's ring calibration; ``na`` sets
    ``sin(theta_max)``."""
    fr, phi, f_max, mask = _pupil_grid(sigma_dep, shape, device)
    f_max = (torch.clamp_min(f_max, 1e-30) if isinstance(f_max, torch.Tensor)
             else max(f_max, float(_f32(1e-30))))
    sin_th = torch.clamp(fr / f_max, 0.0, 1.0) * na
    cos_th = torch.sqrt(torch.clamp_min(1.0 - sin_th * sin_th, 0.0))
    r2 = float(np.sqrt(_f32(2.0)))
    if polarization in ("circular+", "circular-"):
        s = 1.0 if polarization == "circular+" else -1.0
        ex0, ey0 = 1.0 / r2, complex(0.0, s / r2)
    elif polarization in ("linear-x", "linear-y"):
        ex0, ey0 = (1.0, 0.0) if polarization == "linear-x" else (0.0, 1.0)
    else:
        raise ValueError(f"unknown polarization {polarization!r}")
    cosp, sinp = torch.cos(phi), torch.sin(phi)
    # s/p rotation of the collimated input into the converging cone
    axx = cos_th * cosp * cosp + sinp * sinp
    axy = (cos_th - 1.0) * sinp * cosp
    ayy = cos_th * sinp * sinp + cosp * cosp
    azx = -sin_th * cosp
    azy = -sin_th * sinp
    apod = mask * torch.sqrt(torch.clamp_min(cos_th, 0.0))
    pupil = apod * torch.complex(torch.cos(charge * phi),
                                 torch.sin(charge * phi))
    inten = torch.zeros(tuple(shape), dtype=torch.float32, device=device)
    for gx, gy in ((axx, axy), (axy, ayy), (azx, azy)):
        comp = torch.fft.fftshift(torch.fft.ifft2(pupil * (gx * ex0
                                                           + gy * ey0)))
        inten = inten + comp.abs().square()
    return _normalized(inten)


@dataclasses.dataclass(frozen=True)
class GaussianStripeModel:
    """Default line-STED illumination: Gaussian excitation line profile,
    ``sin^2`` standing-wave depletion stripe (physics/psf.py)."""

    gaussian_excitation = True

    def excitation(self, width: int, params, device=None) -> torch.Tensor:
        return psfs.line_excitation_profile(width, params.sigma_exc, device)

    def depletion(self, width: int, params, device=None) -> torch.Tensor:
        return psfs.stripe_depletion_profile(width, params.stripe_period,
                                             device)


@dataclasses.dataclass(frozen=True)
class GaussianDonutModel:
    """Default point-STED illumination: Gaussian excitation PSF and the
    ``u e^{1-u}`` LG01-like donut (physics/psf.py)."""

    gaussian_excitation = True

    def excitation(self, shape, params, device=None) -> torch.Tensor:
        return psfs.gaussian_psf(shape, params.sigma_exc, device)

    def depletion(self, shape, params, device=None) -> torch.Tensor:
        return psfs.donut_psf(shape, params.sigma_dep, device)


@dataclasses.dataclass(frozen=True)
class PupilDonutModel:
    """Vortex-phase pupil donut ``|FFT(circ(f <= f_max) e^{i m
    theta})|^2``, peak-normalized, first ring at ``sigma_dep * sqrt(2)``;
    ``charge`` is the vortex charge m."""

    gaussian_excitation = True

    charge: int = 1

    def excitation(self, shape, params, device=None) -> torch.Tensor:
        return psfs.gaussian_psf(shape, params.sigma_exc, device)

    def depletion(self, shape, params, device=None) -> torch.Tensor:
        return _vortex_donut(params.sigma_dep, tuple(shape), self.charge,
                             device)


@dataclasses.dataclass(frozen=True)
class VectorialDonutModel:
    """Richards-Wolf vectorial vortex donut (``_vectorial_donut``).
    ``polarization``: ``"circular+"`` (co-handed with the vortex: null
    kept), ``"circular-"`` (counter-handed: the z-field fills the null),
    ``"linear-x"`` / ``"linear-y"`` (partial fill); ``na``: the
    objective's numerical aperture."""

    gaussian_excitation = True

    charge: int = 1
    na: float = 0.9
    polarization: str = "circular+"

    def excitation(self, shape, params, device=None) -> torch.Tensor:
        return psfs.gaussian_psf(shape, params.sigma_exc, device)

    def depletion(self, shape, params, device=None) -> torch.Tensor:
        return _vectorial_donut(params.sigma_dep, tuple(shape), self.charge,
                                self.na, self.polarization, device)


@dataclasses.dataclass(frozen=True)
class EnvelopedStripeModel:
    """Standing-wave stripe under a Gaussian envelope of width
    ``envelope_sigmas * stripe_period`` pixels, peak-normalized."""

    gaussian_excitation = True

    envelope_sigmas: float = 4.0

    def excitation(self, width: int, params, device=None) -> torch.Tensor:
        return psfs.line_excitation_profile(width, params.sigma_exc, device)

    def depletion(self, width: int, params, device=None) -> torch.Tensor:
        stripe = psfs.stripe_depletion_profile(width, params.stripe_period,
                                               device)
        x = torch.arange(width, dtype=torch.float32, device=device) \
            - (width // 2)
        period = params.stripe_period
        if isinstance(period, torch.Tensor):
            two_sig_sq = 2.0 * (self.envelope_sigmas * period).square()
        else:
            sig = _f32(self.envelope_sigmas) * _f32(period)
            two_sig_sq = float(_f32(2.0) * sig * sig)
        env = torch.exp(-x.square() / two_sig_sq)
        out = stripe * env
        return _normalized(out)


@dataclasses.dataclass(frozen=True)
class InterferenceStripeModel:
    """Two-beam interference stripe ``I(x) = (1 - v cos(2 pi x / P)) / (1
    + v)`` with fringe visibility v = 1 for s-polarization and ``|cos 2
    theta|`` for p-polarization, ``sin theta = wavelength_px / (2 P)``."""

    gaussian_excitation = True

    polarization: str = "s"
    wavelength_px: float = 4.0

    def excitation(self, width: int, params, device=None) -> torch.Tensor:
        return psfs.line_excitation_profile(width, params.sigma_exc, device)

    def depletion(self, width: int, params, device=None) -> torch.Tensor:
        period = params.stripe_period
        tensor = isinstance(period, torch.Tensor)
        if self.polarization == "s":
            vis, denom = 1.0, 2.0
        elif self.polarization == "p" and tensor:
            sin_th = torch.clamp(torch.full_like(period, self.wavelength_px)
                                 / (2.0 * period), 0.0, 1.0)
            vis = torch.abs(1.0 - 2.0 * sin_th * sin_th)
            denom = 1.0 + vis
        elif self.polarization == "p":
            sin_th = np.clip(_f32(self.wavelength_px)
                             / (_f32(2.0) * _f32(period)),
                             _f32(0.0), _f32(1.0))
            v = np.abs(_f32(1.0) - _f32(2.0) * sin_th * sin_th)
            vis, denom = float(v), float(_f32(1.0) + v)
        else:
            raise ValueError(f"unknown polarization {self.polarization!r}")
        x = torch.arange(width, dtype=torch.float32, device=device) \
            - (width // 2)
        fringe = torch.cos(2.0 * math.pi * x
                           / (period if tensor else float(period)))
        return (1.0 - vis * fringe) / denom


DEFAULT_LINE_MODEL = GaussianStripeModel()
DEFAULT_POINT_MODEL = GaussianDonutModel()


def _checked(m):
    if type(m).__module__.split(".")[0] == "rescan_line_sted_tpu":
        raise TypeError(
            f"{type(m).__name__} is a model of the JAX package; carry the "
            "params across with rescan_line_sted_torch.convert."
            "params_from_jax")
    return m


def line_model(params):
    """The illumination model of line-STED params (None -> default)."""
    return _checked(getattr(params, "model", None) or DEFAULT_LINE_MODEL)


def point_model(params):
    """The illumination model of point-STED params (None -> default)."""
    return _checked(getattr(params, "model", None) or DEFAULT_POINT_MODEL)


def profiles(m, arg, params, device=None):
    """``(excitation, depletion)`` of model ``m`` on ``arg`` (width or
    shape); raises ``TypeError`` unless both are tensors."""
    exc = m.excitation(arg, params, device)
    dep = m.depletion(arg, params, device)
    if not (isinstance(exc, torch.Tensor) and isinstance(dep, torch.Tensor)):
        raise TypeError(
            f"illumination model {type(m).__name__} must return torch "
            f"tensors, got {type(exc).__name__} and {type(dep).__name__} "
            "(a JAX model's params are carried across by "
            "rescan_line_sted_torch.convert.params_from_jax)")
    return exc, dep


def effective_point_psf(shape, params, device=None) -> torch.Tensor:
    """Depleted point illumination ``exc * exp(-s * dep)`` [H, W] through
    the params' model."""
    return psfs.effective_psf(*profiles(point_model(params), shape, params,
                                        device), params.depletion)


def effective_line_profile(width: int, params, device=None) -> torch.Tensor:
    """Depleted line-excitation profile through the params' model."""
    return psfs.effective_psf(*profiles(line_model(params), width, params,
                                        device), params.depletion)

"""Illumination models (port of the JAX package's defaults).

Only the default models are ported so far: ``GaussianStripeModel`` for
line-STED and ``GaussianDonutModel`` for point-STED. The pupil,
vectorial, enveloped and interference models are queued in ROADMAP.md
(open item 11, ``physics/models.py``); params carrying any other model
raise ``NotImplementedError`` here rather than being imaged with the
default forms.
"""

from __future__ import annotations

import dataclasses

import torch

from rescan_line_sted_torch.physics import psf as psfs


@dataclasses.dataclass(frozen=True)
class GaussianStripeModel:
    """Default line-STED illumination: Gaussian excitation line profile,
    ``sin^2`` standing-wave depletion stripe (physics/psf.py).

    ``gaussian_excitation = True`` tells the banded scan engine that the
    params' static ``exc_support`` bound applies."""

    gaussian_excitation = True

    def excitation(self, width: int, params, device=None) -> torch.Tensor:
        return psfs.line_excitation_profile(width, params.sigma_exc, device)

    def depletion(self, width: int, params, device=None) -> torch.Tensor:
        return psfs.stripe_depletion_profile(width, params.stripe_period,
                                             device)


@dataclasses.dataclass(frozen=True)
class GaussianDonutModel:
    """Default point-STED illumination: Gaussian excitation PSF and the
    ``u e^{1-u}`` LG01-like donut (physics/psf.py).

    ``gaussian_excitation = True``: the params' static ``exc_support``
    bounds the effective PSF (the banded point scan's windows)."""

    gaussian_excitation = True

    def excitation(self, shape, params, device=None) -> torch.Tensor:
        return psfs.gaussian_psf(shape, params.sigma_exc, device)

    def depletion(self, shape, params, device=None) -> torch.Tensor:
        return psfs.donut_psf(shape, params.sigma_dep, device)


DEFAULT_LINE_MODEL = GaussianStripeModel()
DEFAULT_POINT_MODEL = GaussianDonutModel()


def _unported(m):
    return NotImplementedError(
        f"illumination model {type(m).__name__} is not ported yet "
        "(ROADMAP.md open item 11: physics/models.py)")


def line_model(params):
    """The illumination model of line-STED params (None -> default)."""
    m = getattr(params, "model", None)
    if m is None or isinstance(m, GaussianStripeModel):
        return DEFAULT_LINE_MODEL
    raise _unported(m)


def point_model(params):
    """The illumination model of point-STED params (None -> default)."""
    m = getattr(params, "model", None)
    if m is None or isinstance(m, GaussianDonutModel):
        return DEFAULT_POINT_MODEL
    raise _unported(m)


def effective_point_psf(shape, params, device=None) -> torch.Tensor:
    """Depleted point illumination ``exc * exp(-s * dep)`` [H, W] through
    the params' model."""
    m = point_model(params)
    return psfs.effective_psf(m.excitation(shape, params, device),
                              m.depletion(shape, params, device),
                              params.depletion)


def effective_line_profile(width: int, params, device=None) -> torch.Tensor:
    """Depleted line-excitation profile through the params' model."""
    m = line_model(params)
    return psfs.effective_psf(m.excitation(width, params, device),
                              m.depletion(width, params, device),
                              params.depletion)

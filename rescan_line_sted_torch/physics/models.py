"""Illumination models for line-STED (port of the JAX package's default).

Only the default ``GaussianStripeModel`` is ported so far. The pupil,
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


DEFAULT_LINE_MODEL = GaussianStripeModel()


def line_model(params):
    """The illumination model of line-STED params (None -> default)."""
    m = getattr(params, "model", None)
    if m is None or isinstance(m, GaussianStripeModel):
        return DEFAULT_LINE_MODEL
    raise NotImplementedError(
        f"illumination model {type(m).__name__} is not ported yet "
        "(ROADMAP.md open item 11: physics/models.py)")


def effective_line_profile(width: int, params, device=None) -> torch.Tensor:
    """Depleted line-excitation profile through the params' model."""
    m = line_model(params)
    return psfs.effective_psf(m.excitation(width, params, device),
                              m.depletion(width, params, device),
                              params.depletion)

"""Photodose accounting (port of ``rescan_line_sted_tpu.physics.dose``).

For circular scans that visit every position the accumulated dose is
spatially uniform: under a line scan every pixel receives
``sum_x(exc_profile)`` excitation and ``s * sum_x(stripe_profile)``
depletion, and emits ``sum_x(eff_profile)`` photons per unit sample
brightness; under a point scan the same sums run over the 2D PSFs.
"""

from __future__ import annotations

import dataclasses

import torch

from rescan_line_sted_torch.config import Replaceable
from rescan_line_sted_torch.physics import models
from rescan_line_sted_torch.physics import psf as psfs


@dataclasses.dataclass(frozen=True)
class DoseReport(Replaceable):
    """Per-pixel photodose and signal ledger for one acquisition (all f32
    0-d tensors; ``num_steps`` is the scan-position count)."""

    excitation_dose: torch.Tensor
    depletion_dose: torch.Tensor
    emission_per_unit_sample: torch.Tensor
    num_steps: torch.Tensor

    @property
    def total_dose(self) -> torch.Tensor:
        return self.excitation_dose + self.depletion_dose

    @property
    def signal_per_dose(self) -> torch.Tensor:
        return self.emission_per_unit_sample / self.total_dose


def _report(exc, dep, params, geom, device) -> DoseReport:
    eff = psfs.effective_psf(exc, dep, params.depletion)
    return DoseReport(
        excitation_dose=exc.sum(),
        depletion_dose=params.depletion * dep.sum(),
        emission_per_unit_sample=eff.sum(),
        num_steps=torch.full((), float(geom.num_steps), device=device),
    )


def line_sted_dose(params, geom, device=None, profiles=None) -> DoseReport:
    """Dose ledger of a line scan over all ``geom.grid.width`` columns.
    ``profiles``: the model's ``(excitation, depletion)`` on this grid and
    device, where the caller holds them (they do not depend on the
    depletion power); else built here."""
    if profiles is None:
        profiles = models.profiles(models.line_model(params),
                                   geom.grid.width, params, device)
    return _report(*profiles, params, geom, device)


def point_sted_dose(params, geom, device=None, profiles=None) -> DoseReport:
    """Dose ledger of a point scan over all ``height * width`` pixels: every
    pixel receives ``sum(exc_psf)`` excitation and ``s * sum(dep_psf)``
    depletion. ``profiles`` as for ``line_sted_dose``."""
    if profiles is None:
        profiles = models.profiles(models.point_model(params),
                                   geom.grid.shape, params, device)
    return _report(*profiles, params, geom, device)

"""Acquisition result container (the point-STED engine itself is queued
in ROADMAP.md open item 8)."""

from __future__ import annotations

import dataclasses

import torch

from rescan_line_sted_torch.physics.dose import DoseReport


@dataclasses.dataclass(frozen=True)
class AcquisitionResult:
    image: torch.Tensor
    dose: DoseReport

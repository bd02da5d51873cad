"""Line-STED helpers used by the rescanned engine (the descanned
line-STED engine itself is queued in ROADMAP.md open item 8)."""

from __future__ import annotations

import torch

from rescan_line_sted_torch.physics import models


def effective_line_profile(width: int, params, device=None) -> torch.Tensor:
    """Centered 1D effective (depleted) excitation line profile, [W]."""
    return models.effective_line_profile(width, params, device)

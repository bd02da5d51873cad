"""The benchmark's inputs, made on the device by the benchmark and handed
alike to the program and to the plain reference.

``siemens_star`` is a frozen copy of the port's
``rescan_line_sted_torch/data/samples.siemens_star``: a fixed resolution
target, so every seed images the same sample and only the shot noise
differs from seed to seed.
"""

from __future__ import annotations

import torch


def siemens_star(shape, device, spokes: int = 16,
                 inner: float = 2.0) -> torch.Tensor:
    """Siemens-star target [H, W] in float32, peak 1: ``spokes`` bright
    spokes between radius ``inner`` and the field's edge."""
    y = (torch.arange(shape[0], dtype=torch.float32, device=device)
         - shape[0] // 2)[:, None]
    x = (torch.arange(shape[1], dtype=torch.float32, device=device)
         - shape[1] // 2)[None, :]
    theta = torch.atan2(y, x)
    r = torch.sqrt(y * y + x * x)
    star = 0.5 * (1.0 + torch.sin(spokes * theta))
    edge = min(shape) / 2.0 - 1.0
    return torch.where((r > inner) & (r < edge), star,
                       torch.zeros((), device=device))

"""Procedural ground-truth samples (port of ``siemens_star`` from the JAX
package's ``data/samples.py``; the other samples are queued in ROADMAP.md
open item 13). Nonnegative f32 fluorophore density with peak ~1."""

from __future__ import annotations

import torch

from rescan_line_sted_torch.device import resolve


def siemens_star(shape: tuple[int, int], spokes: int = 16,
                 inner: float = 2.0, device=None) -> torch.Tensor:
    """Siemens-star resolution target: spoke spacing shrinks toward center.
    Made on ``device`` (None: the CUDA card; raises without one)."""
    device = resolve(device)
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

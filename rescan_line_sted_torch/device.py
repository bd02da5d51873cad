"""Where the port's entry points run: on the card unless asked otherwise."""

from __future__ import annotations

import numpy as np
import torch


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card.

    Raises when ``device`` is None and no card is visible: the port never
    falls back to the CPU quietly (pass ``device="cpu"`` for that).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device=\"cpu\" to run the "
                "port's plain PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def as_sample(sample, grid_shape, device=None) -> torch.Tensor:
    """``sample`` (a tensor or array) as float32 on ``device``, as the JAX
    package takes it: None means the card a CUDA sample lies on, else the
    CUDA card (``resolve``). Raises ``ValueError`` unless its shape is
    ``grid_shape``."""
    if device is None and isinstance(sample, torch.Tensor) and sample.is_cuda:
        device = sample.device
    sample = torch.as_tensor(sample, dtype=torch.float32,
                             device=resolve(device))
    if tuple(sample.shape) != tuple(grid_shape):
        raise ValueError(f"sample shape {tuple(sample.shape)} does not match "
                         f"the grid {tuple(grid_shape)}")
    return sample


def host_table(table: np.ndarray, device=None) -> torch.Tensor:
    """A host-built numpy table on ``device``; a CUDA copy goes from pinned
    memory without blocking (the array is copied, never aliased)."""
    t = torch.from_numpy(np.array(table))
    if torch.device(device or "cpu").type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t

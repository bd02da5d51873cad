"""Where the port's entry points run: on the card unless asked otherwise."""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist


def rank_card() -> torch.device:
    """This process's CUDA card: ``cuda:{LOCAL_RANK % device_count}`` under
    a process group (the rank within its host when the launcher sets
    ``LOCAL_RANK``, else the global rank), the current card otherwise
    (``cuda:0`` unless the caller chose another)."""
    if dist.is_available() and dist.is_initialized():
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        return torch.device("cuda", local % torch.cuda.device_count())
    return torch.device("cuda", torch.cuda.current_device())


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means this process's CUDA
    card (``rank_card``).

    Raises when ``device`` is None and no card is visible: the port never
    falls back to the CPU quietly (pass ``device="cpu"`` for that).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device=\"cpu\" to run the "
                "port's plain PyTorch versions on the CPU")
        return rank_card()
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

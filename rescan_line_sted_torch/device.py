"""Where the port's entry points run: on the card unless asked otherwise."""

from __future__ import annotations

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

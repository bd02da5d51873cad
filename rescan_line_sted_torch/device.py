"""Where the port's entry points run: on the card unless asked otherwise,
and the tables they keep there per (params, geometry, device)."""

from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.distributed as dist

from rescan_line_sted_torch.config import cache_key_ok
from rescan_line_sted_torch.utils.observability import span


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


@span("rls.host_table")
def host_table(table: np.ndarray, device=None) -> torch.Tensor:
    """A host-built numpy table on ``device``; a CUDA copy goes from pinned
    memory without blocking (the array is copied, never aliased). Each
    call is one ``rls.host_table`` span in a profiled run."""
    t = torch.from_numpy(np.array(table))
    if torch.device(device or "cpu").type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


@span("rls.read_back")
def read_back(t: torch.Tensor) -> list:
    """``t.tolist()``: a deliberate read of a tensor on the host, which
    waits for the card where ``t`` lies on one. Each call is one
    ``rls.read_back`` span in a profiled run."""
    return t.tolist()


def plan_cache(maxsize: int):
    """Decorator: keep what ``build(params, geom, *key, device)`` returns,
    the tables a call needs that depend on nothing but its arguments, for
    the next call with equal arguments (at most ``maxsize`` plans, least
    recently used out).

    Each build is one ``rls.plan_build`` span, and runs outside inference
    mode, so that a plan first built under ``torch.inference_mode`` can
    serve a later autograd call. The same builder runs without the cache
    where the arguments cannot key one (``config.cache_key_ok``: a tensor
    field, such as calibration's, or an unhashable model) and while the
    current CUDA stream captures a graph. Callers must not mutate a
    plan's tensors."""
    def wrap(build):
        @functools.wraps(build)
        def built(*args):
            with span("rls.plan_build"), torch.inference_mode(False):
                return build(*args)

        cached = functools.lru_cache(maxsize=maxsize)(built)

        @functools.wraps(build)
        def plan(params, geom, *key):
            device = torch.device(key[-1])
            if (cache_key_ok(params) and cache_key_ok(geom)
                    and not (device.type == "cuda"
                             and torch.cuda.is_current_stream_capturing())):
                return cached(params, geom, *key)
            return built(params, geom, *key)

        plan.cache_info = cached.cache_info
        plan.cache_clear = cached.cache_clear
        return plan

    return wrap

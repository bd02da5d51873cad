"""Multi-process initialization (port of the JAX package's
``parallel/multihost.py``).

JAX stitches one process per host into one runtime with
``jax.distributed.initialize``; the port's counterpart is one
``torch.distributed`` process group with one rank per card (or, over gloo,
several ranks sharing a card). After it, ``parallel.make_mesh`` spans every
rank and the sharded engines exchange halos and gather over it.

Single-process safe: ``initialize_multihost()`` with no arguments and no
cluster environment is a no-op, so pipelines can call it unconditionally.

Usage (one call per process, before the first mesh)::

    from rescan_line_sted_torch.parallel import initialize_multihost, make_mesh

    initialize_multihost()                       # torchrun's or SLURM's env
    # or explicitly:
    initialize_multihost("10.0.0.1:29500", num_processes=4, process_id=rank)

    mesh = make_mesh({"batch": 2, "space": 2})   # spans all ranks
"""

from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist


def is_initialized() -> bool:
    """True when the process is already part of a process group."""
    return dist.is_available() and dist.is_initialized()


def _cluster_env() -> tuple[str, int, int] | None:
    """``(init_method, world, rank)`` from a launcher's environment:
    torchrun (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``)
    or SLURM (``SLURM_PROCID``, ``SLURM_NTASKS``, with ``MASTER_ADDR`` and
    ``MASTER_PORT`` set by the job); None when there is none, or a SLURM
    step of one task."""
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        return "env://", int(env["WORLD_SIZE"]), int(env["RANK"])
    if "SLURM_PROCID" in env and int(env.get("SLURM_NTASKS", "1")) > 1:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            raise ValueError(
                "a SLURM step of several tasks needs MASTER_ADDR and "
                "MASTER_PORT (the coordinator of rank 0) in its environment")
        return ("tcp://{MASTER_ADDR}:{MASTER_PORT}".format(**env),
                int(env["SLURM_NTASKS"]), int(env["SLURM_PROCID"]))
    return None


def _backend(backend: str | None, world: int) -> str:
    """The process group's backend. NCCL gives every rank a card of its
    own, so the default is ``nccl`` where every rank on this host has one
    (``LOCAL_WORLD_SIZE``, else ``world``, at most the visible cards) and
    ``gloo`` otherwise -- CPU ranks, or ranks sharing cards -- logged;
    ``nccl`` asked for with ranks sharing cards raises and names
    ``gloo``, never switching by itself."""
    on_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend is None:
        backend = "nccl" if 0 < on_host <= cards else "gloo"
        logging.getLogger(__name__).info(
            "process group backend %s: %d rank(s) on this host, %d CUDA "
            "card(s)", backend, on_host, cards)
    if backend == "nccl" and on_host > cards:
        raise ValueError(
            f"{on_host} ranks on this host share {cards} CUDA "
            "device(s): NCCL needs a card per rank; pass "
            "backend=\"gloo\" to run them over gloo")
    return backend


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         backend: str | None = None,
                         **kwargs) -> tuple[int, int]:
    """Join (or create) the process group; returns ``(rank, world)``.

    * With arguments: explicit wiring. ``coordinator_address`` is rank 0's
      ``host:port`` (``tcp://`` is added) or an init method URL
      (``tcp://...``, ``file:///path`` for a store in a shared file);
      ``num_processes`` and ``process_id`` are the world size and rank.
    * Without arguments: torchrun's or SLURM's environment
      (``_cluster_env``). With no cluster environment at all the call is a
      NO-OP returning ``(0, 1)``, so single-process runs and multi-process
      runs share one code path.
    * ``backend``: by default ``nccl`` where every rank on the host has a
      card of its own, else ``gloo`` (``_backend``); ``nccl`` with more
      ranks on a host than cards raises and names ``backend="gloo"``.
      ``**kwargs`` go to ``torch.distributed.init_process_group``.
    * Idempotent: a second call returns the existing wiring. Every other
      failure (a mis-wired cluster, a timeout) propagates: a real cluster
      must never degrade to N independent worlds.
    """
    if is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if coordinator_address is None:
        if num_processes is not None or process_id is not None:
            raise ValueError("explicit wiring needs coordinator_address")
        found = _cluster_env()
        if found is None:
            return 0, 1          # no cluster environment: single process
        init_method, num_processes, process_id = found
    else:
        if num_processes is None or process_id is None:
            raise ValueError("explicit wiring needs num_processes and "
                             "process_id")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    backend = _backend(backend, num_processes)
    if torch.cuda.is_available():      # the rank's card (device.rank_card)
        local = int(os.environ.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=int(num_processes),
                            rank=int(process_id), **kwargs)
    return dist.get_rank(), dist.get_world_size()


def local_device_slice(mesh, axis_name: str) -> tuple[int, int]:
    """Index range ``[lo, hi)`` of ``axis_name`` that this process owns --
    for host-side work (loading samples, writing per-shard TIFFs) that must
    touch only the shards this rank holds.

    Ownership is read off the mesh's rank array (``mesh.mesh``, NOT assumed
    from the rank): an axis index is local when any of its entries is this
    process's rank (0 without a process group). Raises when the local
    indices are not one contiguous range -- a per-index mask, not a slice,
    is the correct tool there -- or when there are none.
    """
    rank = dist.get_rank() if is_initialized() else 0
    axis = list(mesh.mesh_dim_names).index(axis_name)
    moved = torch.as_tensor(mesh.mesh).movedim(axis, 0)
    local = [i for i in range(moved.shape[0])
             if bool((moved[i] == rank).any())]
    if not local:
        raise ValueError(f"process {rank} owns no devices on {axis_name!r}")
    lo, hi = local[0], local[-1] + 1
    if local != list(range(lo, hi)):
        raise ValueError(
            f"process {rank}'s devices are not contiguous along "
            f"{axis_name!r} (indices {local}); use a per-index ownership "
            "mask instead of a slice")
    return lo, hi

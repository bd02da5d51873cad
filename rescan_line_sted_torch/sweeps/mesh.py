"""Mesh-aware sweep execution (port of the JAX package's
``sweeps/mesh.py``).

The mesh machinery lives in ``parallel/mesh.py`` (it is used by more than
sweeps); this module re-exports it under the JAX package's path and adds
the sweep-specific convenience.
"""

from __future__ import annotations

import torch

from rescan_line_sted_torch.kernels import _build
from rescan_line_sted_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    full_tensor,
    is_dtensor,
    make_mesh,
    replicate,
    replicated_sharding,
    shard_batch,
)


def rank_generator(generator: torch.Generator, index: int
                   ) -> torch.Generator:
    """A generator on ``generator``'s device for stream ``index``: seeded
    from the key words drawn from ``generator`` (seeded alike on every
    rank), the second offset by ``index`` (``_build.offset_key``), so ranks
    that run different points draw independent noise. The words come by
    value, with nothing read back from the card (outside CUDA-graph
    capture)."""
    key = _build.offset_key(_build.draw_key(generator, generator.device),
                            index)
    return _build.key_generator(key, generator.device)


def _local_rows(x, mesh, index: int, n: int):
    """Rank ``index``'s block of the leading dim of ``x`` over ``n``
    ranks (a ``DTensor`` from ``shard_batch`` gives its local tensor)."""
    if is_dtensor(x) and list(x.placements) == batch_sharding(mesh, 1):
        return x.to_local()
    x = torch.as_tensor(full_tensor(x))
    if x.ndim < 1 or x.shape[0] % n:
        raise ValueError(f"batched argument of shape {tuple(x.shape)} does "
                         f"not split over {n} ranks")
    step = x.shape[0] // n
    return x[index * step:(index + 1) * step]


def _shard_result(tree, mesh, axis: str, local_batch: int):
    """Every tensor of the sweep's result whose leading dim is the local
    batch as a ``DTensor``, ``Shard(0)`` over ``axis``; others (scalars
    such as the dose budget) stay as they are."""
    from torch.distributed.tensor import DTensor

    from rescan_line_sted_torch.parallel.mesh import _map_tensors

    placements = batch_sharding(mesh, 1, axis)

    def put(t):
        if t.ndim >= 1 and t.shape[0] == local_batch:
            return DTensor.from_local(t, mesh, placements, run_check=False)
        return t
    return _map_tensors(put, tree, lambda x: isinstance(x, torch.Tensor))


def run_sharded_sweep(sweep_fn, mesh, sample, batched_args, *args):
    """``sweep_fn(sample, *batched_args, *args)`` with the sweep axis
    sharded over the mesh ``"batch"`` axis and the sample replicated: each
    rank runs ``sweep_fn`` on its block of every batched argument (a whole
    tensor, or a ``DTensor`` from ``shard_batch``; the batch must split
    evenly), and each batched field of the result comes back as a
    ``DTensor``, ``Shard(0)`` over ``"batch"``.

    A ``torch.Generator`` among ``args`` is replaced on each rank by
    ``rank_generator(generator, index)``: the ranks' points draw
    independent noise (the same statistics as, not the draws of, the
    unsharded sweep)."""
    names = mesh.mesh_dim_names
    dim = names.index("batch")
    index, n = mesh.get_local_rank(dim), mesh.size(dim)
    sample = full_tensor(sample)
    local = tuple(_local_rows(a, mesh, index, n) for a in batched_args)
    args = tuple(rank_generator(a, index)
                 if isinstance(a, torch.Generator) else a for a in args)
    out = sweep_fn(sample, *local, *args)
    return _shard_result(out, mesh, "batch",
                         local[0].shape[0] if local else 0)

"""Device-mesh utilities (port of the JAX package's ``parallel/mesh.py``).

The JAX package shards inputs over a ``jax.sharding.Mesh`` and lets GSPMD
insert the collectives. The port's counterpart is a ``DeviceMesh`` over the
ranks of a ``torch.distributed`` process group and ``DTensor`` placements:
``Shard(0)`` stands for ``P(axis, None)``, ``Replicate()`` for ``P()``.

* ``batch`` axis -- sweep points / orientations / samples: embarrassingly
  parallel (``sweeps/mesh.run_sharded_sweep``).
* ``space`` axis -- image rows for large fields: the rescan scan runs row
  blocks on every rank with a halo exchange
  (``parallel/sharded_rescan.py``); the other entry points gather a
  row-sharded sample (``gather_dtensors``).

The engines never dispatch on a ``DTensor`` (DTensor has no sharding rules
for FFTs or for the port's ctypes kernels): entry points unwrap with
``to_local`` or ``full_tensor`` and wrap their results with
``DTensor.from_local`` / ``distribute_tensor``.

On CUDA tensors PyTorch 2.11's gloo fails a point-to-point send ("writev:
Bad address", the group left broken) and ``DTensor.full_tensor`` over it
ends the process (``scripts/torch_dist_probe.py``). ``host_staged`` names
the one branch that copies through the host for it.

Usage::

    mesh = make_mesh({"batch": 2, "space": 2})
    powers = shard_batch(mesh, powers)           # leading dim over "batch"
    sample = replicate(mesh, sample)             # or shard rows over "space"
"""

from __future__ import annotations

import dataclasses
import functools
import math
import sys

import torch
import torch.distributed as dist

_DTENSOR_MODULE = "torch.distributed.tensor"


def is_dtensor(x) -> bool:
    """True for a ``DTensor`` (without importing DTensor's machinery when
    no caller has)."""
    mod = sys.modules.get(_DTENSOR_MODULE)
    return mod is not None and isinstance(x, mod.DTensor)


def _mesh_device(device_type: str) -> torch.device:
    from rescan_line_sted_torch.device import rank_card

    return rank_card() if device_type == "cuda" else torch.device("cpu")


def make_mesh(axes: dict[str, int] | None = None,
              devices: str | None = None):
    """Create a ``DeviceMesh`` over the process group's ranks.

    ``axes`` maps axis name -> size (the product must equal the world
    size); ``None`` puts every rank on a single ``"batch"`` axis.
    ``devices`` is the mesh's device type, ``"cuda"`` (each rank's card,
    ``device.rank_card``) or ``"cpu"``; None means ``"cuda"`` where a card
    is visible. Without a process group the mesh is a world of one rank (an
    in-process store; NCCL on a card, else gloo), as a single JAX process
    needs no wiring.
    """
    from torch.distributed.device_mesh import init_device_mesh

    if devices is None:
        devices = "cuda" if torch.cuda.is_available() else "cpu"
    world = dist.get_world_size() if dist.is_initialized() else 1
    if axes is None:
        axes = {"batch": world}
    sizes = tuple(axes.values())
    if math.prod(sizes) != world:
        raise ValueError(f"mesh axes {axes} need {math.prod(sizes)} devices, "
                         f"got {world}")
    if not dist.is_initialized():
        dist.init_process_group("nccl" if devices == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    if devices == "cuda":
        torch.cuda.set_device(_mesh_device(devices))
    return init_device_mesh(devices, sizes, mesh_dim_names=tuple(axes))


def batch_sharding(mesh, ndim: int, axis: str = "batch") -> list:
    """Placements sharding the leading dim over ``axis`` and replicating
    over every other mesh axis (``P(axis, None, ...)`` for a rank-``ndim``
    tensor)."""
    from torch.distributed.tensor import Replicate, Shard

    if ndim < 1:
        raise ValueError("a batch sharding needs a leading dim")
    return [Shard(0) if name == axis else Replicate()
            for name in mesh.mesh_dim_names]


def replicated_sharding(mesh) -> list:
    """Placements replicating over every mesh axis (``P()``)."""
    from torch.distributed.tensor import Replicate

    return [Replicate()] * mesh.ndim


def _is_array(x) -> bool:
    import numpy as np

    return isinstance(x, (torch.Tensor, np.ndarray))


def _map_tensors(fn, tree, leaf=_is_array):
    """``fn`` over every ``leaf`` of ``tree`` (by default each tensor or
    numpy array, taken as a tensor): tuples, lists, dicts and the fields of
    frozen dataclasses (rebuilt through ``replace``); Python scalars and
    everything else are left alone."""
    if leaf(tree):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        items = [_map_tensors(fn, x, leaf) for x in tree]
        if all(a is b for a, b in zip(items, tree)):
            return tree
        if hasattr(tree, "_fields"):                 # a named tuple
            return type(tree)(*items)
        return type(tree)(items)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v, leaf) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        changes = {}
        for f in dataclasses.fields(tree):
            old = getattr(tree, f.name)
            new = _map_tensors(fn, old, leaf)
            if new is not old:
                changes[f.name] = new
        return dataclasses.replace(tree, **changes) if changes else tree
    return tree


def _distribute(mesh, placements_of):
    from torch.distributed.tensor import distribute_tensor

    dev = _mesh_device(mesh.device_type)

    def put(x):
        # every rank holds the same values (as a JAX host array is the same
        # in every process): each keeps its own shard, no communication
        x = torch.as_tensor(x).to(dev)
        return distribute_tensor(x, mesh, placements_of(x),
                                 src_data_rank=None)
    return put


def shard_batch(mesh, tree, axis: str = "batch"):
    """Every tensor of ``tree`` as a ``DTensor`` with its leading dim
    sharded over ``axis`` (tensor fields of the config dataclasses too)."""
    return _map_tensors(_distribute(
        mesh, lambda x: batch_sharding(mesh, x.ndim, axis)), tree)


def replicate(mesh, tree):
    """Every tensor of ``tree`` as a ``DTensor`` replicated over the
    mesh."""
    return _map_tensors(_distribute(
        mesh, lambda x: replicated_sharding(mesh)), tree)


def host_staged(group, device: torch.device) -> bool:
    """Whether ``group``'s collectives on ``device`` tensors must copy
    through the host: gloo on CUDA tensors (module doc).
    NCCL, and gloo on CPU tensors, take them as they are. Raises for any
    other backend: a route through it has not been checked."""
    name = str(dist.get_backend(group))
    if ":" in name:                     # e.g. "cpu:gloo,cuda:nccl"
        name = dict(part.split(":") for part in name.split(","))[device.type]
    if name == "nccl":
        return False
    if name == "gloo":
        return device.type == "cuda"
    raise ValueError(f"no tensor route through the {name!r} backend "
                     "(nccl and gloo are supported)")


def _shard_sizes(length: int, n: int) -> list[int]:
    """DTensor's shard lengths of a dim of ``length`` over ``n`` ranks
    (``torch.chunk``'s split)."""
    step = -(-length // n)
    return [max(0, min(step, length - k * step)) for k in range(n)]


def full_tensor(x) -> torch.Tensor:
    """The whole tensor of the DTensor ``x`` on this rank's device
    (``DTensor.full_tensor``; over gloo on a card, gathered through host
    memory, ``host_staged``). A plain tensor is returned as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    local = x.to_local()
    if all(isinstance(p, Replicate) for p in x.placements):
        return local
    if not any(host_staged(mesh.get_group(i), local.device)
               for i in range(mesh.ndim)):
        return x.full_tensor()
    out = local.cpu()
    for i in reversed(range(mesh.ndim)):
        p = x.placements[i]
        if isinstance(p, Replicate):
            continue
        if not isinstance(p, Shard):
            raise ValueError(f"cannot gather a {p} placement")
        sizes = _shard_sizes(x.shape[p.dim], mesh.size(i))
        pad = list(out.shape)
        pad[p.dim] = max(sizes)
        mine = out.new_zeros(pad)
        mine.narrow(p.dim, 0, out.shape[p.dim]).copy_(out)
        parts = [torch.empty_like(mine) for _ in sizes]
        dist.all_gather(parts, mine, group=mesh.get_group(i))
        out = torch.cat([t.narrow(p.dim, 0, n) for t, n in zip(parts, sizes)],
                        dim=p.dim)
    return out.to(local.device)


def reshard_like(out, like):
    """``out`` (a tensor, a tuple or list of them, or a result with an
    ``image``) as ``DTensor``s placed as ``like``'s DTensor: trailing dims
    aligned, so ``Shard(d)`` of ``like`` becomes ``Shard(d + out.ndim -
    like.ndim)``; where ``out`` has no such dim (a fused image of views
    sharded over their batch axis) it is replicated. Every rank holds all
    of ``out``; each keeps its own shard."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = like.device_mesh

    def place(t):
        shift = t.ndim - like.ndim
        placements = [Shard(p.dim + shift)
                      if isinstance(p, Shard) and p.dim + shift >= 0
                      else Replicate() for p in like.placements]
        return _distribute(mesh, lambda _: placements)(t)

    if isinstance(out, torch.Tensor):
        return place(out)
    if isinstance(out, (tuple, list)):
        return type(out)(reshard_like(o, like) for o in out)
    if hasattr(out, "image") and hasattr(out, "replace"):
        return out.replace(image=place(out.image))
    return out


def whole(tree):
    """``tree`` with every ``DTensor`` in it (in tuples, lists, dicts and
    dataclass fields too) as its whole tensor (``full_tensor``)."""
    return _map_tensors(full_tensor, tree, is_dtensor)


def _dtensors(tree):
    """The ``DTensor``s of ``tree``, in ``_map_tensors``' order."""
    if is_dtensor(tree):
        yield tree
    elif isinstance(tree, (tuple, list, dict)):
        for x in (tree.values() if isinstance(tree, dict) else tree):
            yield from _dtensors(x)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _dtensors(getattr(tree, f.name))


def gather_dtensors(fn):
    """Decorator for the entry points that take a row-sharded sample as
    the JAX package's GSPMD lets them (``line_sted_image``,
    ``point_sted_image``, orientations, fusion, ISM): a call with any
    ``DTensor`` argument runs on the whole tensors (``full_tensor``) on the
    rank's card, and its result comes back placed as the first DTensor
    argument (``reshard_like``). Every rank computes the whole result; a
    noisy call draws alike on every rank when their generators are seeded
    alike. Calls without a DTensor pass straight through."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        like = (next(_dtensors((args, kwargs)), None)
                if _DTENSOR_MODULE in sys.modules else None)
        if like is None:
            return fn(*args, **kwargs)
        return reshard_like(fn(*whole(args), **whole(kwargs)), like)
    return wrapper

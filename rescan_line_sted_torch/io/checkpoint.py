"""Checkpoint / resume for long sweeps (port of the JAX package's
``io/checkpoint.py``; SURVEY.md section 6).

Per-chunk sweep results are checkpointed to ``.npz`` so an interrupted
dose / FOV sweep resumes where it stopped; any nested state can be saved
and loaded too.

The JAX package flattens pytrees. The port flattens its own trees: its
result dataclasses (``dataclasses.fields``, recursively), tuples, lists,
dicts with string keys and ``None``; anything else (a tensor, an array, a
scalar) is a leaf. Leaves are saved from the host under path keys
(``leaf:point/image``), and the structure, with each dataclass's module
and name, as JSON under ``__treedef__``, so a chunk can be loaded without
an example of its structure (``load_state(path)``): a resume learns the
shapes from the file, not from a run. Loaded leaves are numpy arrays in
the same structure, as in the JAX package. Checkpoints written by the JAX
package do not load here (their ``__treedef__`` is a JAX treedef, not the
port's JSON): ``load_state`` raises on them.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os

import numpy as np
import torch

_PACKAGE = "rescan_line_sted_torch"


def _walk(tree, path: tuple, leaves: dict):
    """The JSON structure of ``tree``; its leaves go into ``leaves`` under
    their path keys."""
    if tree is None:
        return None
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        cls = type(tree)
        return {"dataclass": f"{cls.__module__}:{cls.__qualname__}",
                "fields": {f.name: _walk(getattr(tree, f.name),
                                         path + (f.name,), leaves)
                           for f in dataclasses.fields(tree)}}
    if isinstance(tree, dict):
        if not all(isinstance(k, str) for k in tree):
            raise TypeError("checkpoint dicts need string keys")
        return {"dict": {k: _walk(tree[k], path + (k,), leaves)
                         for k in sorted(tree)}}
    if isinstance(tree, (tuple, list)):
        return {type(tree).__name__: [_walk(v, path + (str(i),), leaves)
                                      for i, v in enumerate(tree)]}
    leaves["leaf:" + "/".join(path)] = tree
    return "leaf"


def flatten(tree) -> tuple[str, dict]:
    """``(structure, leaves)``: the structure as canonical JSON, and the
    leaves by path key in traversal order."""
    leaves = {}
    structure = _walk(tree, (), leaves)
    return json.dumps(structure, sort_keys=True), leaves


def rebuild(like, leaves: dict, path: tuple = ()):
    """A tree of ``like``'s structure whose leaves are taken from
    ``leaves`` by path key."""
    if like is None:
        return None
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return type(like)(**{f.name: rebuild(getattr(like, f.name), leaves,
                                             path + (f.name,))
                             for f in dataclasses.fields(like)})
    if isinstance(like, dict):
        return {k: rebuild(v, leaves, path + (k,)) for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        return type(like)(rebuild(v, leaves, path + (str(i),))
                          for i, v in enumerate(like))
    return leaves["leaf:" + "/".join(path)]


def _from_structure(node, leaves, path: tuple = ()):
    """The tree a stored structure describes; a dataclass's class is
    imported by name, from this package only."""
    if node is None:
        return None
    if node == "leaf":
        return leaves["leaf:" + "/".join(path)]
    if "dataclass" in node:
        module, name = node["dataclass"].split(":")
        if module != _PACKAGE and not module.startswith(_PACKAGE + "."):
            raise ValueError(f"checkpoint names {node['dataclass']!r}, "
                             f"outside {_PACKAGE}: pass like= to load it")
        cls = importlib.import_module(module)
        for part in name.split("."):
            cls = getattr(cls, part)
        return cls(**{k: _from_structure(v, leaves, path + (k,))
                      for k, v in node["fields"].items()})
    if "dict" in node:
        return {k: _from_structure(v, leaves, path + (k,))
                for k, v in node["dict"].items()}
    kind, items = next(iter(node.items()))
    out = [_from_structure(v, leaves, path + (str(i),))
           for i, v in enumerate(items)]
    return tuple(out) if kind == "tuple" else out


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _spec(x) -> tuple[np.dtype, tuple]:
    if isinstance(x, torch.Tensor):
        return torch.empty((), dtype=x.dtype).numpy().dtype, tuple(x.shape)
    return np.asarray(x).dtype, np.shape(x)


def to_numpy(tree):
    """``tree`` with every leaf a numpy array on the host (a tensor is
    copied from its device once)."""
    _, leaves = flatten(tree)
    return rebuild(tree, {k: _host(v) for k, v in leaves.items()})


def save_state(path: str, tree) -> None:
    """Save a tree of tensors / arrays to ``path`` (.npz), from the host."""
    structure, leaves = flatten(tree)
    np.savez(path, __treedef__=np.asarray(structure),
             **{k: _host(v) for k, v in leaves.items()})


def load_state(path: str, like=None):
    """Load a tree saved by :func:`save_state`, its leaves numpy arrays.

    ``like`` (optional) gives the expected structure: raises
    ``ValueError`` if the stored structure or any leaf shape/dtype
    disagrees with it -- resuming after a config change must fail loudly,
    not silently misassign leaves. Without ``like`` the stored structure
    is rebuilt as it is.
    """
    with np.load(path, allow_pickle=False) as data:
        try:
            stored = json.loads(str(data["__treedef__"]))
        except (KeyError, json.JSONDecodeError):
            raise ValueError(f"checkpoint {path!r} was not written by "
                             f"{_PACKAGE}.io.save_state")
        stored_def = json.dumps(stored, sort_keys=True)
        if like is None:
            leaves = {k: data[k] for k in data.files if k != "__treedef__"}
            return _from_structure(stored, leaves)
        treedef, want = flatten(like)
        if stored_def != treedef:
            raise ValueError(
                f"checkpoint {path!r} treedef mismatch:\n"
                f"  stored:   {stored_def}\n  expected: {treedef}")
        loaded = {}
        for i, (key, leaf) in enumerate(want.items()):
            arr = data[key]
            want_dtype, want_shape = _spec(leaf)
            if arr.shape != want_shape or arr.dtype != want_dtype:
                raise ValueError(
                    f"checkpoint {path!r} leaf {i} mismatch "
                    f"({key[len('leaf:'):]}): stored "
                    f"{arr.dtype}{list(arr.shape)}, expected "
                    f"{want_dtype}{list(want_shape)}")
            loaded[key] = arr
        return rebuild(like, loaded)


class SweepCheckpoint:
    """Chunked-sweep checkpoint directory.

    Usage::

        ckpt = SweepCheckpoint(dir)
        for i, chunk in enumerate(chunks):
            if ckpt.has(i):
                results.append(ckpt.load(i, like=example))
                continue
            out = run(chunk)
            ckpt.save(i, out)
            results.append(out)
    """

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._meta_path = os.path.join(directory, "meta.json")

    def _chunk_path(self, i: int) -> str:
        return os.path.join(self.directory, f"chunk_{i:05d}.npz")

    def has(self, i: int) -> bool:
        return os.path.exists(self._chunk_path(i))

    def save(self, i: int, tree) -> None:
        tmp = self._chunk_path(i) + ".tmp.npz"
        save_state(tmp, tree)
        os.replace(tmp, self._chunk_path(i))  # atomic: no torn checkpoints

    def load(self, i: int, like=None):
        return load_state(self._chunk_path(i), like)

    def completed(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            # strictly chunk_<digits>.npz: a stale chunk_*.npz.tmp.npz left
            # by an interrupted save must not crash (or count as) a resume
            stem = name[len("chunk_"):-len(".npz")]
            if (name.startswith("chunk_") and name.endswith(".npz")
                    and stem.isdigit()):
                out.append(int(stem))
        return sorted(out)

    def write_meta(self, **meta) -> None:
        with open(self._meta_path, "w") as f:
            json.dump(meta, f, indent=2)

    def read_meta(self) -> dict:
        if not os.path.exists(self._meta_path):
            return {}
        with open(self._meta_path) as f:
            return json.load(f)

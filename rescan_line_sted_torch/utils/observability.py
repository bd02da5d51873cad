"""Tracing, profiling, metrics and debug utilities (port of the JAX
package's ``utils/observability.py``).

* ``trace(...)`` -- a ``torch.profiler`` trace of the host and the card,
  written as a Chrome trace (Perfetto reads it);
* ``span(name)`` -- a named stretch of the port's host code in that trace
  (``rls.<layer>.<stage>``), recorded only while the profiler runs;
* ``SETUP`` -- the seconds of the port's own set-up: its import and the
  first load of the kernel library;
* ``Timer`` / ``time_fn`` -- wall-clock timing, ``time_fn``'s fenced
  with ``torch.cuda.synchronize`` and its first call timed apart from the
  steady state;
* ``emit_metrics`` -- structured JSON-lines / CSV metric emission;
* ``debug_mode`` -- raises ``FloatingPointError`` where an op's floating
  output holds a NaN, as ``jax_debug_nans`` does;
* ``enable_compilation_cache`` -- the directory of the port's compiled
  artifacts (the nvcc kernel library and the native TIFF codec).
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import functools
import json
import logging
import math
import os
import time
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

logger = logging.getLogger("rescan_line_sted_torch")

BUILD_DIR_ENV = "RLS_TORCH_BUILD_DIR"

# the port's own set-up, in seconds: ``import_s``, the package's import
# (``rescan_line_sted_torch/__init__.py``, torch already imported);
# ``library_s``, the first ``kernels._build.lib()`` call (the sources'
# hash, nvcc where the library is not built, the load and its signatures)
# and ``built``, whether that call ran nvcc
SETUP: dict = {}


def enable_compilation_cache(path: str | None = None) -> str:
    """Set and return the directory the port's compiled artifacts live in.

    The port has no JIT: what it compiles once and keeps is the kernel
    library that nvcc builds from ``csrc/`` (``kernels/_build.py``, keyed by
    a hash of the sources) and the native TIFF codec (``io/native``), both
    built at first use into this directory and reused by every later
    process. ``RLS_TORCH_BUILD_DIR``, if set and not empty, wins over
    ``path``; the default is ``rescan_line_sted_torch/_build`` inside the
    project tree (git-ignored). A build directory cannot be switched off:
    an empty ``RLS_TORCH_BUILD_DIR`` counts as unset.
    """
    from rescan_line_sted_torch.kernels import _build

    env = os.environ.get(BUILD_DIR_ENV)
    if env:
        path = env
    elif path is None:
        path = str(_build.DEFAULT_BUILD_DIR)
    _build.BUILD_DIR = Path(path)
    return str(path)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (host ops, and the card's kernels and copies when
    a card is visible) and write ``log_dir/trace.json``, a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class span:
    """A named span of host code in the profiler's trace, as a context
    manager (``with span("rls.image.tables"):``) or a decorator.

    While ``torch.profiler`` runs it enters ``record_function(name)``, so
    the span lands in the profiler's own trace, beside the card's kernels
    and copies and on their clock, nested in the spans open around it
    (exported with ``cat: "user_annotation"``, without arguments). With
    the profiler off it costs one check of the profiler's flag and
    records nothing. A counter is a span around the work it counts
    (``device.host_table``, ``device.read_back``): its occurrences are the
    count."""

    __slots__ = ("name", "_record")

    def __init__(self, name: str):
        self.name = name
        self._record = None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self._record = torch.profiler.record_function(self.name)
            self._record.__enter__()
        return self

    def __exit__(self, *exc):
        if self._record is not None:
            record, self._record = self._record, None
            record.__exit__(*exc)
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not torch.autograd._profiler_enabled():
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return spanned


# factories whose output is uninitialized memory, not a result
_UNINITIALIZED = {torch.ops.aten.empty, torch.ops.aten.empty_like,
                  torch.ops.aten.empty_strided, torch.ops.aten.new_empty,
                  torch.ops.aten.new_empty_strided, torch.ops.aten.resize_}


class _NaNCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in _UNINITIALIZED:
            return out
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if (isinstance(t, torch.Tensor)
                    and (t.is_floating_point() or t.is_complex())
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


@contextlib.contextmanager
def debug_mode():
    """NaN checking: inside the block, every PyTorch op whose floating or
    complex output holds a NaN raises ``FloatingPointError``, as
    ``jax_debug_nans`` does (NaN only, not infinities).

    Each check reads a flag back from the op's device, so on the card it
    syncs after every op: slow, for debugging only. It sees the torch ops
    around a kernel, not inside a ctypes kernel launch: a NaN a CUDA kernel
    writes is caught at the first torch op that consumes its output.
    """
    with _NaNCheck():
        yield


def _fence(out) -> None:
    """Synchronize every CUDA device that holds a tensor of ``out`` (a
    tensor, or tuples, lists, dicts and dataclasses of them)."""
    devices, todo = set(), [out]
    while todo:
        x = todo.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, (tuple, list)):
            todo += list(x)
        elif isinstance(x, dict):
            todo += list(x.values())
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            todo += [getattr(x, f.name) for f in dataclasses.fields(x)]
    for d in devices:
        torch.cuda.synchronize(d)


class Timer:
    """Wall-clock timer (as in the JAX package, it does not fence: sync the
    card inside the block, or use ``time_fn``)."""

    def __init__(self):
        self.elapsed = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False


def time_fn(fn, *args, warmup: int = 1, iters: int = 5):
    """Measure steady-state wall time of ``fn(*args)``.

    Returns ``(seconds_per_call, first_call_seconds)``; the first call
    (kernel builds, cached tables) is reported separately. Each timing is
    fenced by syncing the CUDA devices of the output's tensors; a CPU
    output needs no fence.
    """
    t0 = time.perf_counter()
    out = fn(*args)
    _fence(out)
    first = time.perf_counter() - t0
    for _ in range(max(warmup - 1, 0)):
        _fence(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _fence(out)
    return (time.perf_counter() - t0) / iters, first


def json_safe(obj):
    """Map non-finite floats to None, recursively: the metrics contract
    uses NaN for 'no measurable value' (e.g. fwhm_2d on a filled STED
    null), but bare NaN in json.dumps output is not RFC-compliant JSON --
    strict parsers (jq, JSON.parse) reject the whole document. 0-d tensors,
    on the CPU or a card, go through ``float()``."""
    if isinstance(obj, dict):
        return {k: json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_safe(v) for v in obj]
    if isinstance(obj, (str, bool, int)) or obj is None:
        return obj
    if isinstance(obj, torch.Tensor) and obj.ndim:
        return obj
    try:
        f = float(obj)  # Python / numpy float scalars, 0-d tensors
    except (TypeError, ValueError):
        return obj
    return f if math.isfinite(f) else None


def emit_metrics(metrics: dict, path: str | None = None) -> str:
    """Log a metrics dict and optionally append it to a JSON-lines or CSV
    file. Non-finite floats are sanitized in BOTH formats (see
    ``json_safe``): JSON null in .jsonl, an empty cell in .csv -- so the
    two outputs of the same metrics never diverge."""
    safe = json_safe(metrics)
    line = json.dumps(safe, sort_keys=True, default=float)
    logger.info("metrics %s", line)
    if path:
        if path.endswith(".csv"):
            exists = os.path.exists(path)
            with open(path, "a", newline="") as f:
                writer = csv.DictWriter(f, fieldnames=sorted(metrics))
                if not exists:
                    writer.writeheader()
                writer.writerow({k: ("" if v is None else v)
                                 for k, v in safe.items()})
        else:
            with open(path, "a") as f:
                f.write(line + "\n")
    return line

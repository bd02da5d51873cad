"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (Hopper), one process
per source, all started together, and links the objects into ONE shared
library with a plain C interface, loaded with ``ctypes``. The library is
keyed by a hash of the sources and built into ``rescan_line_sted_torch/
_build/`` (listed in ``.gitignore``), so a checkout builds from its own
sources only and a changed source rebuilds. A failed build raises with
nvcc's stderr; nothing falls back to a plain version.

Every C entry point that launches returns ``cudaGetLastError()``;
``check`` raises on a non-zero code. ``LAUNCHES`` counts the launches of each kernel (of K1,
each placement mode and shared-memory layout apart; of K6, each primitive
apart): every wrapper adds
one where it launches, so a run can show which kernels its main path went
through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES = {"rescan_banded_fused": 0, "rescan_banded_fused_spread": 0,
            "rescan_banded_fused_wide": 0,
            "rescan_banded_fused_spread_wide": 0,
            "poisson_rows_tiered": 0, "poisson_flat": 0, "line_sted_fused": 0,
            "rescan_fused": 0, "rescan_accumulate": 0,
            **{f"primitives_{k}": 0 for k in (
                "fma", "uniform", "uniform_block", "exp", "inv_term",
                "knuth_round", "place_add", "sgemm", "tf32x3")}}

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_LL = ctypes.c_longlong
# C signatures of the entry points (every one returns a cudaError_t code)
_SIGNATURES = {
    "rls_poisson_rows_tiered": [_P, _P, _I, _I, _U, _U, _P, _P],
    "rls_poisson_flat": [_P, _P, _LL, _U, _U, _P, _P],
    "rls_rescan_banded_fused": [_P] * 9 + [_I] * 10 + [_U, _U, _P, _P,
                                                    ctypes.POINTER(_I)],
    "rls_rescan_banded_fused_smem": [_I] * 5 + [ctypes.POINTER(_LL)],
    "rls_line_sted_fused": [_P] * 6 + [_I] * 7 + [_U, _U, _P, _P,
                                                  ctypes.POINTER(_I)],
    "rls_rescan_fused": [_P] * 5 + [_I] * 9 + [_U, _U, _P, _P,
                                               ctypes.POINTER(_I)],
    "rls_rescan_accumulate": [_P] * 4 + [_I] * 5 + [_P],
    "rls_prim_fma": [_P, _I, _I, _P],
    "rls_prim_uniform": [_P, _I, _I, _U, _U, _P],
    "rls_prim_uniform_block": [_P, _I, _I, _U, _U, _P],
    "rls_prim_exp": [_P, _I, _I, ctypes.c_float, _P],
    "rls_prim_inv_term": [_P, _I, _I, ctypes.c_float, _U, _U, _P],
    "rls_prim_knuth_round": [_P, _I, _I, ctypes.c_float, _U, _U, _P],
    "rls_prim_place_add": [_P, _P, _P, _I, _I, _P],
    "rls_prim_sgemm": [_P, _P, _P, _I, _I, _I, _I, _P],
    "rls_prim_tf32x3": [_P, _P, _P, _I, _I, _I, _I, _P],
}

_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ at first use")


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"librls_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if this source hash has not been built."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    jobs = []
    for cu in (p for p in _sources() if p.suffix == ".cu"):
        obj = tmp.with_suffix(f".{cu.stem}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(cu), "-o", str(obj)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    logs, failed = [], []
    for cmd, _, proc in jobs:          # wait for every compiler we started
        _, err = proc.communicate()
        logs.append(err)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{err}")
    objs = [str(obj) for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        cmd = [nvcc, "-shared", "-o", str(tmp), *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
    finally:
        for obj in objs:
            Path(obj).unlink(missing_ok=True)
    out.with_suffix(".log").write_text("".join(logs))
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code}")


def stream_handle(device: torch.device) -> int:
    """The raw handle of the current stream of ``device`` (a CUDA tensor's
    device), read on every call: a caller may switch streams between
    launches."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def require_cuda_f32(name: str, *tensors) -> None:
    """Raise unless every tensor is a contiguous float32 CUDA tensor on one
    device (the kernels read raw pointers)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: expected CUDA tensors on one device, "
                             f"got {t.device}")
        if t.dtype.is_floating_point and t.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")


def key_words(generator, device) -> tuple[int, int, torch.Tensor | None]:
    """The kernel's two 31-bit Philox key words, drawn from ``generator``
    with ``torch.randint`` and never read back on the host from a card:
    ``(s0, s1, None)`` by value from a CPU generator, or ``(0, 0, keys)``
    from a CUDA generator on ``device``, ``keys`` the two words left on
    the card (int64) for the kernel to read. Both draw the same words from
    the same generator state; the CUDA path stays valid under CUDA-graph
    capture. No generator (a noise-free call) gives ``(0, 0, None)``."""
    if generator is None:
        return 0, 0, None
    on_host = generator.device.type == "cpu"
    if not on_host and generator.device != torch.device(device):
        raise ValueError(f"generator on {generator.device}, tensor on "
                         f"{device}")
    s = torch.randint(0, 2**31 - 1, (2,), generator=generator,
                      device=generator.device, dtype=torch.int64)
    if on_host:
        s0, s1 = s.tolist()
        return s0, s1, None
    return 0, 0, s

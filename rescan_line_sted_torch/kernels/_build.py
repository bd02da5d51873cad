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
import time
from pathlib import Path

import torch

from rescan_line_sted_torch.utils.observability import SETUP

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
DEFAULT_BUILD_DIR = _PKG / "_build"
# where the library is built; utils.observability.enable_compilation_cache
# sets it
BUILD_DIR = DEFAULT_BUILD_DIR
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
    "rls_poisson_flat": [_P, _P, _LL, _U, _U, _P, _I, _I, _P],
    "rls_sm_count": [_I, ctypes.POINTER(_I)],
    "rls_rescan_banded_fused": [_P] * 9 + [_I] * 12 + [_U, _U, _P, _P,
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
    """The loaded kernel library (built on first call, which it times into
    ``observability.SETUP``: ``library_s``, and ``built`` where it ran
    nvcc)."""
    global _lib
    if _lib is None:
        t0 = time.perf_counter()
        built = not library_path().exists()
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
        SETUP["library_s"] = time.perf_counter() - t0
        SETUP["built"] = built
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
    first = tensors[0]
    for t in tensors:
        if not t.is_cuda or (t is not first and t.device != first.device):
            raise ValueError(f"{name}: expected CUDA tensors on one device, "
                             f"got {t.device}")
        if t.dtype.is_floating_point and t.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")


_SMS: dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """The number of SMs of CUDA ``device`` (``cudaDeviceGetAttribute``,
    read once per card)."""
    index = device.index
    if index not in _SMS:
        count = ctypes.c_int()
        check(lib().rls_sm_count(index, ctypes.byref(count)), "rls_sm_count")
        _SMS[index] = count.value
    return _SMS[index]


KEY_MOD = 2**31 - 1     # key words lie in [0, KEY_MOD), as torch.randint draws
_M64 = 2**64 - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def mix_words(seed: int, counter: int) -> tuple[int, int]:
    """Two key words in ``[0, KEY_MOD)`` from a generator's seed and a
    counter (its Philox offset / 4), by a fixed 64-bit mix (splitmix64 of
    an odd multiple of the seed plus the counter), so that distinct
    (seed, counter) pairs give unrelated words."""
    h = _splitmix64((seed * 0xD1342543DE82EF95 + counter) & _M64)
    return (h >> 32) % KEY_MOD, (h & 0xFFFFFFFF) % KEY_MOD


def generator_words(generator) -> tuple[int, int]:
    """A CUDA generator's key words on the host, with no device work: mixed
    from its seed and its Philox offset, which then advances by 4 (CUDA
    generators keep their offset in multiples of 4, as torch's own kernels
    advance it). A later draw from the generator, ours or torch's, starts
    at the new offset; ``manual_seed`` or ``set_state`` restore the words."""
    offset = generator.get_offset()
    generator.set_offset(offset + 4)
    return mix_words(generator.initial_seed(), offset // 4)


def key_words(generator, device, key=None
              ) -> tuple[int, int, torch.Tensor | None]:
    """The kernel's two 31-bit Philox key words from ``generator``, by value
    as ``(s0, s1, None)`` with no host-device sync: from a CPU generator the
    two words ``torch.randint`` draws; from a CUDA generator on ``device``
    ``generator_words`` (no kernel launch). Under CUDA-graph capture a CUDA
    generator's words are drawn on the card instead, ``(0, 0, keys)``,
    ``keys`` an int64 tensor of two for the kernel to read. No generator
    (a noise-free call) gives ``(0, 0, None)``.

    ``key`` gives the words instead of a generator (``draw_key``,
    ``offset_key``): a pair of ints, or an int64 tensor of two on the host
    or on ``device`` (left there for the kernel to read)."""
    if key is not None:
        if generator is not None:
            raise ValueError("pass a generator or key words, not both")
        if not isinstance(key, torch.Tensor):
            s0, s1 = key
            return int(s0), int(s1), None
        if key.shape != (2,):
            raise ValueError(f"key words: expected two, got {key.shape}")
        if key.device.type == "cpu":
            s0, s1 = key.tolist()
            return int(s0), int(s1), None
        if key.device != torch.device(device):
            raise ValueError(f"key words on {key.device}, tensor on {device}")
        return 0, 0, key.to(torch.int64).contiguous()
    if generator is None:
        return 0, 0, None
    gen_device = generator.device
    if gen_device.type == "cpu":
        s0, s1 = torch.randint(0, KEY_MOD, (2,), generator=generator,
                               dtype=torch.int64).tolist()
        return s0, s1, None
    index = gen_device.index
    if index is None:                   # "cuda": the current card
        index = torch.cuda.current_device()
    if not isinstance(device, torch.device):
        device = torch.device(device)
    if device.index != index or device.type != "cuda":
        raise ValueError(f"generator on {gen_device}, tensor on {device}")
    if torch.cuda.is_current_stream_capturing():
        # a graph replays its kernels, not this host code: words taken on
        # the host now would be baked into every replay, while torch.randint
        # on the card takes the graph's Philox offset anew on each replay
        return 0, 0, torch.randint(0, KEY_MOD, (2,), generator=generator,
                                   device=gen_device, dtype=torch.int64)
    s0, s1 = generator_words(generator)
    return s0, s1, None


def draw_key(generator, device):
    """The key words a kernel would draw from ``generator`` (``key_words``),
    in the form the wrappers' ``key`` argument takes: a pair of ints, or,
    under CUDA-graph capture, an int64 tensor of two on the card."""
    s0, s1, keys = key_words(generator, device)
    return (s0, s1) if keys is None else keys


def offset_key(key, index: int):
    """``key`` with its second word offset by ``index`` modulo ``KEY_MOD``:
    the key of stream ``index`` (a rank's), as the JAX package offsets a
    device's seed (``seed.at[1].add(axis_index * stride)``). Stream 0 is
    ``key`` itself. A tensor key stays on its device, with no host read."""
    if isinstance(key, torch.Tensor):
        out = key.clone()
        out[1:].add_(index).remainder_(KEY_MOD)
        return out
    return int(key[0]), (int(key[1]) + index) % KEY_MOD


def key_generator(key, device="cpu") -> torch.Generator:
    """A generator on ``device`` seeded from the key words (the plain
    versions draw with ``torch.poisson`` from a CPU one): distinct words
    seed distinct generators. A key tensor on the card is read back."""
    s0, s1 = key.tolist() if isinstance(key, torch.Tensor) else key
    return torch.Generator(device).manual_seed(int(s0) * KEY_MOD + int(s1))

"""ctypes loader for the native TIFF codec (port of the JAX package's
``io/native/loader.py``; builds with g++ on first use).

The shared library is compiled lazily into the port's build directory
(``utils.observability.enable_compilation_cache``, by default the
git-ignored ``rescan_line_sted_torch/_build/``), named by a hash of its
source so a changed source rebuilds, and written through a temporary file
so concurrent processes never load a torn library. If no toolchain is
available the codec reports itself unavailable and ``io/tiff.py`` falls
back to its pure-Python writer. No pybind11: the C ABI surface is two
functions, ctypes is enough.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

logger = logging.getLogger("rescan_line_sted_torch")

_SRC = Path(__file__).resolve().parent / "tiff_fast.cpp"
_FLAGS = ["-O3", "-shared", "-fPIC"]
_lock = threading.Lock()
_lib = None
_tried = False

_SAMPLE_FORMAT = {np.dtype(np.uint8): 1, np.dtype(np.uint16): 1,
                  np.dtype(np.float32): 3, np.dtype(np.float64): 3}


def library_path() -> Path:
    """Where the codec is (or will be) built: the build directory, under
    a name keyed by the source and flags."""
    from rescan_line_sted_torch.kernels import _build

    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return Path(_build.BUILD_DIR) / f"_tiff_fast_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(_SRC),
                        "-lpthread"],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            path = library_path()
            if not path.exists():
                _compile(path)
            lib = ctypes.CDLL(str(path))
            lib.tiff_encoded_size.restype = ctypes.c_uint64
            lib.tiff_encoded_size.argtypes = [ctypes.c_uint32] * 4
            lib.tiff_encode.restype = ctypes.c_int
            lib.tiff_encode.argtypes = [
                ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
                ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
                ctypes.c_void_p, ctypes.c_int]
            _lib = lib
        except Exception as e:  # toolchain missing / build failure
            logger.info("native TIFF codec unavailable (%s); "
                        "using pure-Python writer", e)
            _lib = None
        return _lib


def native_available() -> bool:
    return _load() is not None


def tiff_encode_native(arr: np.ndarray,
                       num_threads: int = 8) -> np.ndarray | None:
    """Encode [N, H, W] as TIFF bytes (uint8 array), or None if the codec is
    unavailable or the stack doesn't fit TIFF's 32-bit offsets."""
    lib = _load()
    if lib is None or arr.dtype not in _SAMPLE_FORMAT:
        return None
    arr = np.ascontiguousarray(arr)
    n, h, w = arr.shape
    size = lib.tiff_encoded_size(n, h, w, arr.dtype.itemsize)
    if size >= 2**32:
        return None
    out = np.empty(size, np.uint8)  # no zero-init, encoded in place
    rc = lib.tiff_encode(
        arr.ctypes.data_as(ctypes.c_void_p), n, h, w, arr.dtype.itemsize,
        _SAMPLE_FORMAT[arr.dtype],
        out.ctypes.data_as(ctypes.c_void_p), num_threads)
    if rc != 0:
        return None
    return out

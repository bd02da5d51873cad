"""Minimal pure-numpy TIFF I/O (port of the JAX package's ``io/tiff.py``;
component C13, SURVEY.md section 3).

The reference ships a small TIFF helper (``np_tif.py``-style,
``tif_to_array`` / ``array_to_tif``) for figure intermediates. This is an
independent minimal implementation of the same capability: baseline
little-endian TIFF, grayscale, single image ``[H, W]`` or stack ``[N, H, W]``,
uint8/uint16/float32/float64, uncompressed, one strip per page. Host-side and
not performance-critical (device arrays are pulled to host first).
"""

from __future__ import annotations

import struct

import numpy as np

_SAMPLE_FORMAT = {  # TIFF tag 339
    np.dtype(np.uint8): 1,
    np.dtype(np.uint16): 1,
    np.dtype(np.float32): 3,
    np.dtype(np.float64): 3,
}

_TYPE_SHORT, _TYPE_LONG = 3, 4


def _entry(tag: int, typ: int, count: int, value: int) -> bytes:
    return struct.pack("<HHII", tag, typ, count, value)


def array_to_tif(arr: np.ndarray, path: str, use_native: bool | None = None
                 ) -> None:
    """Write ``[H, W]`` or ``[N, H, W]`` grayscale array as a (multi-page) TIFF.

    Large stacks route through the native C++ codec (``io/native``,
    byte-identical output) when it is available; ``use_native`` forces the
    choice for testing.
    """
    arr = np.asarray(arr)
    if arr.ndim == 2:
        arr = arr[None]
    if arr.ndim != 3:
        raise ValueError(f"expected [H,W] or [N,H,W], got shape {arr.shape}")
    if arr.dtype not in _SAMPLE_FORMAT:
        arr = arr.astype(np.float32)

    if use_native is None:
        use_native = arr.nbytes >= (1 << 20)
    if use_native:
        from rescan_line_sted_torch.io.native import tiff_encode_native

        blob = tiff_encode_native(arr)
        if blob is not None:
            blob.tofile(path)
            return
    n, h, w = arr.shape
    bps = arr.dtype.itemsize * 8
    fmt = _SAMPLE_FORMAT[arr.dtype]
    page_bytes = h * w * arr.dtype.itemsize

    with open(path, "wb") as f:
        f.write(struct.pack("<2sHI", b"II", 42, 8))  # header, first IFD at 8
        offset = 8
        for i in range(n):
            # IFD: count + 9 entries + next pointer
            n_entries = 9
            ifd_size = 2 + n_entries * 12 + 4
            data_offset = offset + ifd_size
            next_ifd = data_offset + page_bytes if i + 1 < n else 0
            entries = [
                _entry(256, _TYPE_LONG, 1, w),            # ImageWidth
                _entry(257, _TYPE_LONG, 1, h),            # ImageLength
                _entry(258, _TYPE_SHORT, 1, bps),         # BitsPerSample
                _entry(259, _TYPE_SHORT, 1, 1),           # Compression: none
                _entry(262, _TYPE_SHORT, 1, 1),           # Photometric: minIsBlack
                _entry(273, _TYPE_LONG, 1, data_offset),  # StripOffsets
                _entry(278, _TYPE_LONG, 1, h),            # RowsPerStrip
                _entry(279, _TYPE_LONG, 1, page_bytes),   # StripByteCounts
                _entry(339, _TYPE_SHORT, 1, fmt),         # SampleFormat
            ]
            f.write(struct.pack("<H", n_entries))
            f.write(b"".join(entries))
            f.write(struct.pack("<I", next_ifd))
            f.write(arr[i].astype(arr.dtype, copy=False).tobytes("C"))
            offset = next_ifd if next_ifd else offset


# TIFF field types the reader can decode (type id -> (struct fmt, size)).
_FIELD_TYPES = {1: ("B", 1), 3: ("H", 2), 4: ("I", 4)}  # BYTE, SHORT, LONG


def _read_values(buf: bytes, typ: int, count: int, raw: bytes):
    """Decode a tag's value array, following the offset pointer when the
    values don't fit the 4-byte inline field (e.g. multi-strip
    StripOffsets/StripByteCounts from standard writers)."""
    if typ not in _FIELD_TYPES:
        return None  # RATIONAL etc.: not consumed by this reader
    fmt, size = _FIELD_TYPES[typ]
    total = size * count
    if total > 4:
        (ptr,) = struct.unpack("<I", raw[:4])
        data = buf[ptr:ptr + total]
    else:
        data = raw[:total]
    return list(struct.unpack("<" + fmt * count, data))


def tif_to_array(path: str) -> np.ndarray:
    """Read a grayscale baseline TIFF: ours (:func:`array_to_tif`) or a
    standard writer's (multi-strip StripOffsets/ByteCounts are followed and
    concatenated). Uncompressed, single-sample-per-pixel, strip-organized
    only; anything else is rejected rather than mis-decoded. Returns
    ``[H, W]`` for single page, ``[N, H, W]`` else.
    """
    with open(path, "rb") as f:
        buf = f.read()
    order, magic, ifd_off = struct.unpack("<2sHI", buf[:8])
    if order != b"II" or magic != 42:
        raise ValueError("not a little-endian baseline TIFF")
    pages = []
    while ifd_off:
        (n_entries,) = struct.unpack("<H", buf[ifd_off:ifd_off + 2])
        tags = {}
        for k in range(n_entries):
            base = ifd_off + 2 + 12 * k
            tag, typ, count = struct.unpack("<HHI", buf[base:base + 8])
            vals = _read_values(buf, typ, count, buf[base + 8:base + 12])
            if vals is not None:
                tags[tag] = vals
        (ifd_off,) = struct.unpack(
            "<I", buf[ifd_off + 2 + 12 * n_entries:][:4])
        if 322 in tags or 323 in tags:
            raise ValueError("tiled TIFFs not supported")
        if tags.get(259, [1])[0] != 1:
            raise ValueError("compressed TIFFs not supported")
        if tags.get(277, [1])[0] != 1:
            raise ValueError("only 1 sample/pixel (grayscale) supported")
        w, h = tags[256][0], tags[257][0]
        bps_vals = tags.get(258, [8])
        if len(set(bps_vals)) != 1:
            raise ValueError("mixed per-sample bit depths not supported")
        bps = bps_vals[0]
        fmt = tags.get(339, [1])[0]
        try:
            dtype = {(1, 8): np.uint8, (1, 16): np.uint16,
                     (3, 32): np.float32, (3, 64): np.float64}[(fmt, bps)]
        except KeyError:
            raise ValueError(
                f"unsupported sample format/bit depth ({fmt}, {bps})")
        offsets = tags[273]
        nbytes = h * w * np.dtype(dtype).itemsize
        counts = tags.get(279, [nbytes])
        if len(offsets) != len(counts):
            raise ValueError("StripOffsets/StripByteCounts length mismatch")
        data = b"".join(buf[o:o + c] for o, c in zip(offsets, counts))
        if len(data) < nbytes:
            raise ValueError("truncated TIFF strip data")
        page = np.frombuffer(data[:nbytes], dtype=dtype)
        pages.append(page.reshape(h, w))
    out = np.stack(pages)
    return out[0] if out.shape[0] == 1 else out

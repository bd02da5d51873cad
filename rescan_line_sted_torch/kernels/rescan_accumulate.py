"""Rescan pixel-reassignment scatter-add: CUDA kernel K5 and its plain
version.

Port of ``rescan_line_sted_tpu/kernels/rescan_accumulate.py``. The scatter
engine of the rescan scan adds each (re-binned) camera frame into the
canvas at a per-frame column offset, wrapping circularly on the canvas.

K5 (``csrc/rescan_accumulate.cu``) lets one thread own each canvas element
and walk the frames in order, several frames' loads in flight, skipping the
frames that miss its block's columns: deterministic, no atomics, the sums
in the order canvas, frame 0, 1, ..., and any frame width, wider than the
canvas included. The JAX wrapper gave way to XLA's scatter when a frame
plus the TPU's 8-row alignment padding was wider than the canvas (``w_pad
> wc``); K5 needs no padding, so it takes every width. The kernel reduces
int32 or int64 offsets mod Wc itself, so conforming inputs reach it with
no eager op before the launch.
"""

from __future__ import annotations

import torch

from rescan_line_sted_torch.kernels import _build


def _cols(offsets: torch.Tensor, w: int, wc: int) -> torch.Tensor:
    """Canvas column of every frame column, [N, w]: ``(offsets[:, None] +
    arange(w)) mod wc``."""
    x = torch.arange(w, device=offsets.device)
    return torch.remainder(offsets.to(torch.int64)[:, None] + x[None, :], wc)


def _check(canvas, frames, offsets):
    if canvas.ndim != 2 or frames.ndim != 3 \
            or frames.shape[1] != canvas.shape[0] \
            or offsets.shape != (frames.shape[0],):
        raise ValueError("need canvas [H, Wc], frames [N, H, w] and offsets "
                         "[N]")


def rescan_accumulate_reference(canvas: torch.Tensor, frames: torch.Tensor,
                                offsets: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: one ``index_add_`` over the canvas columns
    ``(offsets[:, None] + arange(w)) mod wc``, duplicates accumulating.
    Returns a new canvas."""
    _check(canvas, frames, offsets)
    n, h, w = frames.shape
    cols = _cols(offsets, w, canvas.shape[1])
    return canvas.clone().index_add_(
        1, cols.reshape(-1), frames.permute(1, 0, 2).reshape(h, n * w))


def rescan_accumulate(canvas: torch.Tensor, frames: torch.Tensor,
                      offsets: torch.Tensor) -> torch.Tensor:
    """``canvas`` [H, Wc] plus ``frames`` [N, H, w] added at per-frame
    column offsets ``offsets`` [N] (any integers, wrapped mod Wc); returns
    a new canvas.

    A CUDA ``canvas`` launches kernel K5 (``LAUNCHES["rescan_accumulate"]``)
    or raises; a CPU one runs ``rescan_accumulate_reference``.
    """
    if not canvas.is_cuda:
        return rescan_accumulate_reference(canvas, frames, offsets)
    _check(canvas, frames, offsets)
    n, h, w = frames.shape
    wc = canvas.shape[1]
    if h > 4 * 65535:
        raise ValueError("rescan_accumulate: at most 262140 canvas rows")
    # conforming inputs pass as they are; others are converted once
    if offsets.device != canvas.device or not offsets.is_contiguous() \
            or offsets.dtype not in (torch.int32, torch.int64):
        offsets = offsets.to(canvas.device, torch.int64).contiguous()
    if not frames.is_contiguous():
        frames = frames.contiguous()
    if not canvas.is_contiguous():
        canvas = canvas.contiguous()
    _build.require_cuda_f32("rescan_accumulate", canvas, frames)
    out = torch.empty_like(canvas)
    code = _build.lib().rls_rescan_accumulate(
        canvas.data_ptr(), frames.data_ptr(), offsets.data_ptr(),
        out.data_ptr(), h, wc, n, w, int(offsets.dtype == torch.int64),
        _build.stream_handle(canvas.device))
    _build.check(code, "rescan_accumulate")
    _build.LAUNCHES["rescan_accumulate"] += 1
    return out

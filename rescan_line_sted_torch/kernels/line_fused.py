"""Fused descanned line-STED scan: CUDA kernel K3 and its plain version.

Port of ``rescan_line_sted_tpu/kernels/line_fused.py`` (``line_sted_fused``).
For each scan position the camera frame (emitted ``sample_y * eff``
shifted to the position, x-convolved with ``gx``) is centred on the
position; the slit rows inside the static sampled window
``[w//2 - win//2, w//2 + win//2)`` (``win`` = ``slit_support`` rounded up
to 8) are Poisson-sampled and weighted by the slit, and the slit rows
outside it add their weighted mean (nonzero only when ``slit_support`` is
undersized). Both versions compute only the frame rows between the slit's
first and last nonzero values (``_rows``); the rest are multiplied by 0.

The frame row ``r`` of position ``pos`` is a circular correlation of the
sample along x with ``K_r(d) = gx(r - d) eff(d)``, the same for every
position. The plain version runs it over every offset, as one matrix
product per chunk of positions. Kernel K3 (``csrc/line_fused.cu``) sweeps
only the shortest circular run of offsets holding every nonzero tap
(``_taps``, ``_span``): the profiles underflow to 0 in float32 a few dozen
columns from their centres, so that run is 63 offsets at the line
settings (depletion 8), whatever the width. It never forms the [W, W]
circulant the TPU kernel kept resident: each CTA forms ``K_r`` over the
run once, from only the profile values the run reads. ``line_plan``
works out the rows, their weights (left on the profiles' device) and the
run on the host, once per set of profiles: the line engine caches it
(``imaging/line_sted._k3_plan``), so an image makes no host round trip.
Its shared memory holds ``K_r`` and the sample over the run; the line
engine takes K3 up to ``MAX_WIDTH`` columns, and the C entry raises where
a block's shared memory is too small for the run.

The TPU kernel multiplied every frame row by its slit weight, 0 outside
the slit, so a row that overflowed to infinity there gave NaN; here rows
outside the slit's span are not computed, and K3 reads a sample value
only through the taps of its run: a non-finite value reaches only the
outputs whose run covers it (the plain version, like the TPU, spreads it
over every output of its lane). Parity holds on finite inputs.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from rescan_line_sted_torch.kernels import _build
from rescan_line_sted_torch.kernels.poisson import poisson_reference

# The widest frame the line engine hands K3; wider frames take the
# engine's other routes, as frames beyond the TPU's VMEM did.
MAX_WIDTH = 16384
_CHUNK = 256               # positions per matrix product of the plain version
# K3's last launch: shared memory per CTA, threads, CTAs, CTAs per SM,
# positions per thread
LAUNCH_SHAPE: dict[str, int] = {}


def _rows(slit: torch.Tensor, w: int, slit_support: int):
    """The frame rows the output reads, centred on the position: ``(i0,
    ws, wm)`` for rows ``i0 .. i0 + n - 1`` (from the slit's first to its
    last nonzero value), with the weight of each row's Poisson draw
    (``ws``: slit inside the sampled window) and of its mean (``wm``: slit
    outside it), as float32 numpy arrays."""
    win = min(w, ((slit_support + 7) // 8) * 8)
    lo = w // 2 - win // 2
    s = slit.detach().to("cpu", torch.float32).numpy()
    nz = np.flatnonzero(s)
    if nz.size == 0:
        return 0, np.zeros(0, np.float32), np.zeros(0, np.float32)
    i = np.arange(nz[0], nz[-1] + 1)
    inside = (i >= lo) & (i < lo + win)
    return (int(nz[0]), np.where(inside, s[i], 0.0).astype(np.float32),
            np.where(inside, 0.0, s[i]).astype(np.float32))


def _taps(eff: torch.Tensor, gx: torch.Tensor, i0: int, n: int) -> np.ndarray:
    """Which taps of the computed rows are nonzero, [n, W] bool: row ``i0
    + k`` weighs the sample at centred offset ``j`` by ``gx[(i0 + k - j +
    W//2) mod W] * eff[j]``, the float32 product K3 forms."""
    w = eff.shape[0]
    e = eff.detach().to("cpu", torch.float32).numpy()
    g = gx.detach().to("cpu", torch.float32).numpy()
    c = (i0 + np.arange(n) + w // 2) % w
    return g[(c[:, None] - np.arange(w)[None, :]) % w] * e[None, :] != 0


def _span(taps: np.ndarray) -> tuple[int, int]:
    """``(j0, n)``: the shortest circular run of offsets ``j0 .. j0 + n -
    1`` (mod W) that holds every nonzero tap of ``taps`` [rows, W]."""
    w = taps.shape[-1]
    nz = np.flatnonzero(taps.any(0))
    if nz.size in (0, w):
        return 0, int(nz.size)
    gaps = np.diff(np.r_[nz, nz[0] + w])     # to the next nonzero offset
    i = int(np.argmax(gaps))
    return int(nz[(i + 1) % nz.size]), int(w - gaps[i] + 1)


class LinePlan(NamedTuple):
    """What K3 needs besides the sample, from the profiles alone: the
    computed rows ``i0 .. i0 + n_rows - 1``, the weights of each row's
    draw (``ws``) and mean (``wm``) as float32 tensors on the profiles'
    device, and the tap run ``j0 .. j0 + n_taps - 1`` (mod W)."""

    i0: int
    n_rows: int
    j0: int
    n_taps: int
    ws: torch.Tensor
    wm: torch.Tensor


def line_plan(eff_scaled: torch.Tensor, gx: torch.Tensor, slit: torch.Tensor,
              slit_support: int = 64) -> LinePlan:
    """``_rows`` and ``_span`` of these profiles (reads them on the host:
    one round trip), the weights moved back to the profiles' device."""
    w = eff_scaled.shape[0]
    i0, ws, wm = _rows(slit, w, slit_support)
    j0, n_taps = _span(_taps(eff_scaled, gx, i0, ws.size))
    dev = eff_scaled.device
    return LinePlan(i0, int(ws.size), j0, n_taps,
                    torch.from_numpy(ws).to(dev), torch.from_numpy(wm).to(dev))


def _check(sample_y, eff_scaled, gx, slit):
    h, w = sample_y.shape
    if eff_scaled.shape != (w,) or gx.shape != (w,) or slit.shape != (w,):
        raise ValueError("eff_scaled, gx and slit need one entry per column")


def line_sted_fused_reference(sample_y: torch.Tensor,
                              eff_scaled: torch.Tensor, gx: torch.Tensor,
                              slit: torch.Tensor,
                              generator: torch.Generator | None = None,
                              slit_support: int = 64) -> torch.Tensor:
    """Plain torch version of K3: the same rows, weights and sums, one
    matrix product per chunk of positions, ``poisson_reference`` for the
    draws. Same arguments and result as ``line_sted_fused``."""
    _check(sample_y, eff_scaled, gx, slit)
    h, w = sample_y.shape
    dev = sample_y.device
    i0, ws, wm = _rows(slit, w, slit_support)
    out = torch.zeros((h, w), dtype=torch.float32, device=dev)
    if ws.size == 0:
        return out
    j = torch.arange(w, device=dev)
    c = (i0 + np.arange(ws.size) + w // 2) % w
    k_t = (gx[(torch.from_numpy(c).to(dev)[None, :] - j[:, None]) % w]
           * eff_scaled[:, None])                                 # [W, n]
    drawn = np.flatnonzero(ws) if generator is not None else []
    wt = torch.from_numpy(wm if generator is not None else ws + wm).to(dev)
    ws_t = torch.from_numpy(ws[drawn]).to(dev) if len(drawn) else None
    drawn = torch.from_numpy(np.asarray(drawn, np.int64)).to(dev)
    a = torch.arange(w, device=dev)
    for p0 in range(0, w, _CHUNK):
        p = torch.arange(p0, min(p0 + _CHUNK, w), device=dev)
        # cam[y, p, k] = sum_a s_y[y, a] K_k((a - p + w//2) mod w)
        g = k_t[(a[:, None] - p[None, :] + w // 2) % w]           # [W, P, n]
        cam = (sample_y @ g.reshape(w, -1)).reshape(h, p.numel(), -1)
        cols = cam @ wt
        if ws_t is not None:
            cols = cols + poisson_reference(cam[..., drawn], generator) @ ws_t
        out[:, p0:p0 + p.numel()] = cols
    return out


def line_sted_fused(sample_y: torch.Tensor, eff_scaled: torch.Tensor,
                    gx: torch.Tensor, slit: torch.Tensor,
                    generator: torch.Generator | None = None,
                    slit_support: int = 64, *,
                    plan: LinePlan | None = None) -> torch.Tensor:
    """Per-step descanned line-STED scan over all W column positions.

    sample_y: [H, W] y-convolved sample; eff_scaled: [W] centered
    brightness-scaled effective excitation profile; gx: [W] centered
    detection x-profile (the TPU kernel took its [W, W] circulant); slit:
    [W] centered slit profile; ``slit_support``: the sampled-window
    height. ``generator`` draws per-camera-frame shot noise; None =
    noise-free. ``plan``: ``line_plan`` of these profiles and window, as
    the line engine caches it; None works it out here (one host round
    trip). Returns the descanned image [H, W].

    A CUDA ``sample_y`` launches kernel K3 (``LAUNCHES["line_sted_fused"]``)
    or raises (a tap run beyond a block's shared memory, a build or CUDA
    error); a CPU one runs ``line_sted_fused_reference``.
    """
    if not sample_y.is_cuda:
        return line_sted_fused_reference(sample_y, eff_scaled, gx, slit,
                                          generator, slit_support)
    _check(sample_y, eff_scaled, gx, slit)
    h, w = sample_y.shape
    dev = sample_y.device
    if plan is None:
        plan = line_plan(eff_scaled, gx, slit, slit_support)
    s = sample_y.contiguous()
    eff = eff_scaled.contiguous()
    gx = gx.contiguous()
    _build.require_cuda_f32("line_sted_fused", s, eff, gx, plan.ws, plan.wm)
    out = torch.empty((h, w), dtype=torch.float32, device=dev)
    s0, s1, keys = _build.key_words(generator, dev)
    info = (ctypes.c_int * 6)()
    code = _build.lib().rls_line_sted_fused(
        s.data_ptr(), eff.data_ptr(), gx.data_ptr(), plan.ws.data_ptr(),
        plan.wm.data_ptr(), out.data_ptr(), h, w, plan.i0, plan.n_rows,
        plan.j0, plan.n_taps, int(generator is not None), s0, s1,
        None if keys is None else keys.data_ptr(), _build.stream_handle(dev),
        info)
    _build.check(code, "line_sted_fused")
    if info[0] > info[1]:
        raise ValueError(
            f"line_sted_fused: width {w} with a run of {plan.n_taps} taps "
            f"over {plan.n_rows} rows needs {info[0]} bytes of shared memory "
            f"per block, above the {info[1]} this card allows")
    _build.LAUNCHES["line_sted_fused"] += 1
    LAUNCH_SHAPE.update(smem_bytes=info[0], threads=info[2], ctas=info[3],
                        ctas_per_sm=info[4], positions_per_thread=info[5],
                        rows=plan.n_rows, taps=plan.n_taps)
    return out

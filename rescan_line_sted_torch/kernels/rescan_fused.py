"""Full-frame fused rescan scan: CUDA kernel K4 and its plain version.

Port of ``rescan_line_sted_tpu/kernels/rescan_fused.py``. At every scan
position ``p`` the camera frame

    cam_p[y, x] = sum_a sample_y[y, a] eff[(a - p + W//2) mod W]
                  gx[(x - a + W//2) mod W]

(the excitation rolled to ``p``, emitted, x-convolved with the detection
profile: ``emitted @ circulant(gx)``) is binned ``b x b``, optionally
Poisson-sampled, and added into the canvas ``[H/b, wc]`` at columns
``(offsets[p] + X) mod wc``.

The TPU kernel formed the whole frame at every position against the
resident [W, W] circulant. ``eff`` and ``gx`` underflow to exactly 0 in
float32 a few dozen columns from their centres, so both versions here sum
only the shortest circular run of nonzero taps of each (``_run``, found on
the host): frame column ``xa_p + r`` (``xa_p = p + e0 + g0``) is ``sum_i
em_p[i] gx[g0 + r - i]`` over the eff run ``i``, which is exact for finite
samples. A profile without zeros gives a run of W taps and the dense
frame. Kernel K4 (``csrc/rescan_fused.cu``) never forms the circulant.

The plain version runs the same sums as one matrix product per chunk of
positions (the eff run's sample columns times the banded gx run), then
bins, draws with ``poisson_reference`` and places with ``index_add_``.

K4 keeps its runs and frames in shared memory; ``runs_fit`` is the static
bound (``MAX_RUN``) under which the rescan engine hands it a scan, decided
on the host whatever the device, as ``line_fused.MAX_WIDTH`` is for K3.

K4's draws: binned element ``(p, Y, X)`` takes the single-draw uniform
(Philox4x32-10, ``csrc/philox.cuh``) of index ``((Y * wc + c) * ceil(W /
4)) * 4 + p``, ``c = (offsets[p] + X) mod wc`` its canvas column (one-to-one
with X for a fixed p, since W/b <= wc), so one Philox block serves four
consecutive positions of one canvas element; a bright warp draws on the
multi-draw stream of the same index. No host reference reproduces this
stream count by count: K4's draws are held to their statistics (seed-mean,
variance / mean, totals) and to determinism. The plain version draws with
``poisson_reference``.

K4 places each chunk of 16 positions as a strip of canvas columns summed
in position order; a chunk whose frame windows wrap the camera columns
places the windows' heads and wrapped tails as two strips
(``chunk_paths`` counts both kinds on the host).
"""

from __future__ import annotations

import ctypes

import torch

from rescan_line_sted_torch.kernels import _build
from rescan_line_sted_torch.kernels.line_fused import _span
from rescan_line_sted_torch.kernels.poisson import poisson_reference

_CHUNK = 64                # positions per matrix product of the plain version
# K4's smallest layout (one binned row of b sample rows per block) holds the
# two profiles' runs (ne taps rounded up to 16, ng taps and 64 zeros), one
# staged sample window per sample row (ne + 16 columns, padded to a stride
# of 16 mod 32) and the frames (ne + ng - 1 columns rounded up to 16 and
# padded to a bank stride) of 16 positions per sample row: at most
# 18 * b * (ne + ng + 48) floats. While b * (ne + ng + 45) <= MAX_RUN (b <=
# 32) that is under 34000 floats (133 KB), inside a Hopper block's 227 KB of
# opt-in shared memory less K4's static plan (under 1 KB). At b = 1 the
# bound admits a combined run ne + ng - 1 of up to 1704 columns.
MAX_RUN = 1750


def _run(profile: torch.Tensor) -> tuple[int, int]:
    """``(j0, n)``: the shortest circular run ``j0 .. j0 + n - 1`` (mod W)
    of centred indices that holds every nonzero value of ``profile`` [W]
    (``(0, 0)`` for an all-zero profile, ``(0, W)`` for one without
    zeros)."""
    p = profile.detach().to("cpu", torch.float32).numpy()
    return _span((p != 0)[None, :])


def runs_fit(eff_scaled: torch.Tensor, gx: torch.Tensor,
             binning: int = 1) -> bool:
    """Whether K4's smallest shared-memory layout holds the nonzero tap
    runs of ``eff_scaled`` and ``gx`` at this binning (``MAX_RUN``): a
    bound on the host that needs no card, so the engine routes a scan the
    same way on every device."""
    (_, ne), (_, ng) = _run(eff_scaled), _run(gx)
    return binning * (ne + ng + 45) <= MAX_RUN


_KP = 16                   # K4's scan positions per chunk


def chunk_paths(w: int, binning: int, eff_scaled: torch.Tensor,
                gx: torch.Tensor) -> dict:
    """How K4 places its chunks of 16 positions at width ``w``: ``strip``,
    one strip of canvas columns; ``split``, a chunk with a frame window
    that wraps the camera columns (binned window start ``xab`` with ``xab
    + lb > W/b``), placed as a strip of heads and one of tails. The rule
    of ``csrc/rescan_fused.cu``, on the host."""
    (e0, ne), (g0, ng) = _run(eff_scaled), _run(gx)
    if ne == 0 or ng == 0:
        return {"strip": 0, "split": 0}
    b, wb = binning, w // binning
    lb = min(wb, -(-(ne + ng - 1 + b - 1) // b))
    xab = (torch.arange(w) + e0 + g0) % w // b
    wraps = torch.nn.functional.pad(xab + lb > wb, (0, -w % _KP))
    split = int(wraps.reshape(-1, _KP).any(1).sum())
    return {"strip": -(-w // _KP) - split, "split": split}


def _check(sample_y, eff_scaled, gx, offsets, wc, binning):
    h, w = sample_y.shape
    if eff_scaled.shape != (w,) or gx.shape != (w,) \
            or offsets.shape != (w,):
        raise ValueError("the fused scan visits every column: eff_scaled, "
                         "gx and offsets need one entry per column")
    if h % binning or w % binning:
        raise ValueError("binning must divide the frame")
    if w // binning > wc:
        raise ValueError("frame wider than canvas")


def _window(pos, w, b, e0, g0, l):
    """Per position: the binned column ``xab`` where its frame window
    starts, and the window column ``[C, l]`` of each run column ``r``
    (``((xa + r) mod W) // b - xab mod W/b``, frame columns past W folded
    back)."""
    wb = w // b
    xa = (pos + e0 + g0) % w                                      # [C]
    xab = xa // b
    r = torch.arange(l, device=pos.device)
    xl = torch.remainder((xa[:, None] + r[None, :]) % w // b
                         - xab[:, None], wb)
    return xab, xl


def rescan_fused_reference(sample_y: torch.Tensor, eff_scaled: torch.Tensor,
                           gx: torch.Tensor, offsets: torch.Tensor, wc: int,
                           binning: int = 1,
                           generator: torch.Generator | None = None
                           ) -> torch.Tensor:
    """Plain torch version of K4: per chunk of positions, the eff run's
    sample columns times the banded gx run (one matrix product), row and
    column binning, ``poisson_reference`` when ``generator`` is given, and
    ``index_add_`` placement. Same arguments and result as
    ``rescan_fused``."""
    _check(sample_y, eff_scaled, gx, offsets, wc, binning)
    h, w = sample_y.shape
    b = binning
    hb, wb = h // b, w // b
    dev = sample_y.device
    canvas = torch.zeros((hb, wc), dtype=torch.float32, device=dev)
    (e0, ne), (g0, ng) = _run(eff_scaled), _run(gx)
    if ne == 0 or ng == 0:
        return canvas
    l = ne + ng - 1
    lb = min(wb, -(-(l + b - 1) // b))
    i = torch.arange(ne, device=dev)
    k = torch.arange(l, device=dev)[None, :] - i[:, None]         # [ne, l]
    inside = (k >= 0) & (k < ng)
    band = torch.where(inside, gx[(g0 + k.clamp(0, ng - 1)) % w], 0.0)
    effr = eff_scaled[(e0 + i) % w]
    offs = torch.remainder(offsets.to(dev, torch.int64), wc)
    for p0 in range(0, w, _CHUNK):
        pos = torch.arange(p0, min(p0 + _CHUNK, w), device=dev)
        c = pos.numel()
        cols = (pos[:, None] + e0 + i[None, :] + w - w // 2) % w    # [C, ne]
        em = sample_y[:, cols] * effr                             # [H, C, ne]
        run = (em @ band).reshape(hb, b, c, l).sum(1)             # [hb, C, l]
        xab, xl = _window(pos, w, b, e0, g0, l)
        frames = torch.zeros((hb, c, lb), dtype=torch.float32, device=dev)
        frames.scatter_add_(2, xl[None].expand(hb, c, l), run)
        if generator is not None:
            frames = poisson_reference(frames, generator)
        target = (offs[p0:p0 + c, None]
                  + (xab[:, None] + torch.arange(lb, device=dev)) % wb) % wc
        canvas.index_add_(1, target.reshape(-1), frames.reshape(hb, c * lb))
    return canvas


def rescan_fused(sample_y: torch.Tensor, eff_scaled: torch.Tensor,
                 gx: torch.Tensor, offsets: torch.Tensor, wc: int,
                 binning: int = 1,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """Fused rescan scan over all W column positions (module doc).

    sample_y: [H, W] y-convolved sample; eff_scaled: [W] centred
    brightness-scaled effective excitation profile; gx: [W] centred
    detection x-profile (the TPU kernel took its [W, W] circulant);
    offsets: [W] integer canvas column offsets (binned pixels, any
    integers, wrapped mod wc); ``binning`` sums camera pixels in b x b
    blocks before the draws and the placement. ``generator`` draws
    per-camera-frame shot noise; None = noise-free. Returns the canvas
    [H/b, wc].

    A CUDA ``sample_y`` launches kernel K4 (``LAUNCHES["rescan_fused"]``)
    or raises (a run too long for a block's shared memory, a build or
    CUDA error); a CPU one runs ``rescan_fused_reference``.
    """
    if not sample_y.is_cuda:
        return rescan_fused_reference(sample_y, eff_scaled, gx, offsets, wc,
                                      binning, generator)
    _check(sample_y, eff_scaled, gx, offsets, wc, binning)
    h, w = sample_y.shape
    dev = sample_y.device
    out = torch.zeros((h // binning, wc), dtype=torch.float32, device=dev)
    (e0, ne), (g0, ng) = _run(eff_scaled), _run(gx)
    if ne == 0 or ng == 0:
        return out
    s = sample_y.contiguous()
    eff, gxc = eff_scaled.contiguous(), gx.contiguous()
    offs = torch.remainder(offsets.to(dev, torch.int64), wc).to(torch.int32)
    _build.require_cuda_f32("rescan_fused", s, eff, gxc, offs, out)
    s0, s1, keys = _build.key_words(generator, dev)
    info = (ctypes.c_int * 5)()
    code = _build.lib().rls_rescan_fused(
        s.data_ptr(), eff.data_ptr(), gxc.data_ptr(), offs.data_ptr(),
        out.data_ptr(), h, w, binning, wc, e0, ne, g0, ng,
        int(generator is not None), s0, s1,
        None if keys is None else keys.data_ptr(), _build.stream_handle(dev),
        info)
    _build.check(code, "rescan_fused")
    if info[2] == 0:
        raise ValueError(
            f"rescan_fused: runs of {ne} and {ng} taps at width {w} need "
            f"{info[0]} bytes of shared memory per block, above the "
            f"{info[1]} this card allows")
    _build.LAUNCHES["rescan_fused"] += 1
    return out


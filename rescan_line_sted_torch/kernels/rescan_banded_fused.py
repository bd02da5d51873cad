"""Banded fused rescan scan: CUDA kernel K1 and its plain version.

Port of ``rescan_line_sted_tpu/kernels/rescan_banded_fused.py``, all its
placement modes. Per chunk of C scan positions the scan

1. takes the chunk's ``D_in``-row window of the extended y-convolved
   sample (``sample_ext[r] = sample_y^T[(r - s_in) % W]``),
2. multiplies it by the chunk-invariant binned conv table
   ``[C, D_out/b, D_in]`` (illumination-scaled detection circulant window
   with the row binning folded in; the kernel keeps its two factors) and
   bins ``b`` adjacent lanes,
3. optionally draws per-frame shot noise (K2a inside the kernel,
   ``torch.poisson`` in the plain version), and
4. places every frame window. Integer and class placement adds it into
   its class canvas at its integer offset. NUFFT spreading placement
   (``spread_weights`` / ``offsets2``) convolves it per parity with its
   position's 4 window taps (``dob + 3`` rows) and adds the result into
   that parity's canvas at the parity's integer offset. Frame windows are
   unwrapped camera coordinates: a window that crosses the camera's
   periodic boundary splits at row ``m0`` of its chunk into two placements
   ``W/b`` apart (``sa_lo`` / ``sa_hi``), before spreading.

The tables and placement scalars are built here in plain torch (with
floor division and Python-sign modulo, as the JAX wrapper does), and the
kernel (``csrc/rescan_banded_fused.cu``) or the plain loop consumes them.

K1's limit is decided on the host, the same on every device:
``banded_fits`` holds the shared memory of K1's smaller layout to Hopper's
opt-in limit per block, and the rescan engine sends band windows beyond it
to its routes without band windows (``imaging/rescan.py``), as the JAX
package declines its banded kernel above a VMEM bound.
"""

from __future__ import annotations

import ctypes

import torch

from rescan_line_sted_torch.kernels import _build, fftconv
from rescan_line_sted_torch.kernels.poisson import poisson_reference

# K1's shared-memory layouts (csrc/rescan_banded_fused.cu: kLanes,
# kPassRows, make_layout); a card test holds this mirror to the C entry
# rls_rescan_banded_fused_smem
_LANES = 16
_PASS_ROWS = 512
_RING_STRIDE = 20          # floats per ring row in the asynchronous layouts
# dynamic shared memory a block may opt into on Hopper (H100, H200): a
# constant, not a device query, so the route never depends on the card
SMEM_OPTIN = 232448


def layout_smem_bytes(d_in: int, dob: int, chunk: int, binning: int = 1,
                      n_spread: int = 0) -> tuple[int, int, int]:
    """Dynamic shared memory (bytes) of K1's three layouts: (G resident,
    G as its Toeplitz generator, the generator with synchronous staging).
    Each holds the two-slot frame-row ring (rows of 16 floats; 20 in the
    first two) and the illumination window; the first two the raw sample
    window twice (16 b + 8 floats a row, for the copy of the next chunk),
    a binned one when b > 1 (24 a row) and two buffers of placement
    scalars (5 C + 4 ints) and spreading taps; the third one binned window
    (16 a row) and one buffer of taps."""
    b = binning
    gen = (b * (dob - 1) + d_in + 3) // 4 * 4
    g_res = d_in * (dob + (8 - dob % 32) % 32)
    ill, taps = chunk * d_in, chunk * 2 * n_spread
    staged = (2 * _PASS_ROWS * _RING_STRIDE + 2 * d_in * (16 * b + 8)
              + (d_in * 24 if b > 1 else 0) + 2 * (5 * chunk + 4) + 2 * taps)
    lean = 2 * _PASS_ROWS * _LANES + d_in * 16 + gen + ill + taps
    return (4 * (staged + g_res + ill), 4 * (staged + gen + ill), 4 * lean)


def banded_smem_bytes(d_in: int, dob: int, chunk: int, binning: int = 1,
                      n_spread: int = 0) -> int:
    """Dynamic shared memory (bytes) of K1's smallest layout, which keeps
    the binned detection window as its Toeplitz generator and stages one
    binned sample window at a time: the two-slot frame-row ring, the
    sample window, the generator (rounded to 4 floats), the illumination
    window and the chunk's spreading taps."""
    return layout_smem_bytes(d_in, dob, chunk, binning, n_spread)[2]


def banded_fits(d_in: int, dob: int, chunk: int, binning: int = 1,
                n_spread: int = 0) -> bool:
    """Whether K1 runs these band windows (``dob = d_out / binning``;
    ``n_spread`` taps per parity in NUFFT mode, else 0)."""
    return banded_smem_bytes(d_in, dob, chunk, binning,
                             n_spread) <= SMEM_OPTIN


def kernel_smem_bytes(d_in: int, dob: int, chunk: int, binning: int = 1,
                      n_spread: int = 0) -> tuple[int, int, int]:
    """The C entry's own byte counts of K1's three layouts (as
    ``layout_smem_bytes``); builds the kernel library (needs nvcc, no
    card)."""
    out = (ctypes.c_longlong * 3)()
    _build.lib().rls_rescan_banded_fused_smem(d_in, dob, chunk, binning,
                                              n_spread, out)
    return int(out[0]), int(out[1]), int(out[2])


# The launch shape of K1's last launch in each mode (LAUNCHES' names): the
# layout (0 G resident, 1 generator, 2 generator with synchronous staging),
# its bytes of shared memory per CTA, CTAs, CTAs per SM, threads per CTA
LAUNCH_SHAPE: dict[str, dict] = {}
LAYOUTS = ("resident", "generator", "generator, synchronous staging")


_TF32_MASK = -8192     # 0xffffe000 as int32: the TF32 bits of a float32


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's operand split (plain version): ``hi = x & 0xffffe000`` and
    ``lo = (x - hi) & 0xffffe000``, both float32 holding TF32 values (low
    13 mantissa bits zero), as the kernel forms them before its three
    tensor-core passes."""
    x = x.to(torch.float32)
    hi = (x.view(torch.int32) & _TF32_MASK).view(torch.float32)
    lo = ((x - hi).view(torch.int32) & _TF32_MASK).view(torch.float32)
    return hi, lo


def three_pass_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as K1's engine computes it (plain version): hi * hi in
    one float32 accumulation, hi * lo + lo * hi in a second, summed at the
    end. The products of two TF32 values are exact in float32; the card
    differs only in the order and rounding of its float32 sums."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    return ah @ bh + (al @ bh + ah @ bl)


def _check(h, w, *, wc, d_in, d_out, chunk, binning, n_spread=0):
    """The JAX wrapper's argument guards (minus its TPU sub-row rule)."""
    b = binning
    if d_out is None:
        raise ValueError("banded fused scan needs a frame window (d_out)")
    if w % chunk or chunk % 8:
        raise ValueError("chunk must divide W and be a multiple of 8")
    if not chunk <= d_in < w:
        raise ValueError("need chunk <= d_in < W (the slice-built extended "
                         "sample wraps the circular boundary at most once)")
    if chunk % b or d_out % b or ((d_out - chunk) // 2) % b:
        raise ValueError("binning must align the frame window")
    if ((d_out // b) + max(n_spread - 1, 0) + 7) // 8 * 8 + 8 > wc:
        raise ValueError("frame window wider than canvas")


def _spread_args(w, classes, q, spread_weights, offsets2):
    """``(n_spread, q)`` of a call: NUFFT spreading forces two parity
    canvases and excludes class placement, as the JAX wrapper does."""
    if spread_weights is None:
        return 0, q
    if offsets2 is None or classes is not None or q != 1:
        raise ValueError("NUFFT spreading takes offsets2 and excludes "
                         "class placement")
    n_spread = spread_weights.shape[-1] // 2
    if spread_weights.shape != (w, 2 * n_spread) or offsets2.shape != (2, w):
        raise ValueError("spread_weights must be [W, 2 * P/2] and offsets2 "
                         "[2, W]")
    return n_spread, 2


def _tables(sample_y, eff_scaled, gx, int_offsets, classes, *, wc, d_in,
            d_out, chunk, binning, q, offsets2=None):
    """Conv table factors, extended sample and placement scalars: the
    detection window ``g0w [D_out, D_in]`` and illumination window
    ``ill_w [C, D_in]`` whose product, row-binned, is the conv table
    (module doc). ``sa_lo`` / ``sa_hi`` are ``[W]`` canvas starts, or
    ``[2, W]`` per parity when ``offsets2`` is given."""
    h, w = sample_y.shape
    if int_offsets.shape != (w,) or (classes is not None
                                     and classes.shape != (w,)):
        raise ValueError("int_offsets and classes need one entry per column")
    if classes is not None:
        lo, hi = torch.stack(torch.aminmax(classes)).tolist()  # one sync
        if lo < 0 or hi >= q:
            raise ValueError(f"classes must lie in [0, {q})")
    b = binning
    wb = w // b
    dev = sample_y.device
    n_chunks = w // chunk
    s_in = (d_in - chunk) // 2
    s_out = (d_out - chunk) // 2

    ci = torch.arange(chunk, device=dev)[:, None]
    di = torch.arange(d_in, device=dev)[None, :]
    ill_w = eff_scaled[(w // 2 + di - s_in - ci) % w]            # [C, Di]
    g0w = fftconv.circulant_window(gx, d_out, d_in, s_out, s_in)  # [Do, Di]

    sample_t = sample_y.T
    head = sample_t[w - s_in:] if s_in else sample_t[:0]
    sample_ext = torch.cat([head, sample_t, sample_t[:d_in - s_in]], dim=0)

    p0s = torch.arange(n_chunks, device=dev) * chunk
    gstart = torch.div(p0s - s_out, b, rounding_mode="floor")
    k0 = torch.div(gstart, wb, rounding_mode="floor")
    m0 = (wb * (k0 + 1) - gstart).to(torch.int32)
    icp = torch.arange(w, device=dev) // chunk
    offs = int_offsets if offsets2 is None else offsets2
    sa_lo = torch.remainder(gstart[icp] + offs.to(dev, torch.int64)
                            - wb * k0[icp], wc)
    sa_hi = torch.remainder(sa_lo - wb, wc)
    cls = (torch.zeros(w, dtype=torch.int32, device=dev) if classes is None
           else classes.to(dev, torch.int32))
    return (g0w, ill_w, sample_ext.contiguous(), sa_lo.to(torch.int32),
            sa_hi.to(torch.int32), m0, cls)


def rescan_banded_fused_reference(
    sample_y: torch.Tensor, eff_scaled: torch.Tensor, gx: torch.Tensor,
    int_offsets: torch.Tensor, *, wc: int, d_in: int, d_out: int,
    chunk: int, binning: int = 1, classes: torch.Tensor | None = None,
    q: int = 1, generator: torch.Generator | None = None,
    spread_weights: torch.Tensor | None = None,
    offsets2: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain torch version of K1: one batched matmul per chunk,
    ``torch.poisson`` when ``generator`` is given, ``index_add_``
    placement (after per-parity spreading in NUFFT mode). Same arguments
    and result as ``rescan_banded_fused``."""
    h, w = sample_y.shape
    n_spread, q = _spread_args(w, classes, q, spread_weights, offsets2)
    _check(h, w, wc=wc, d_in=d_in, d_out=d_out, chunk=chunk,
           binning=binning, n_spread=n_spread)
    b = binning
    hb, dob = h // b, d_out // b
    g0w, ill_w, sample_ext, sa_lo, sa_hi, m0, cls = _tables(
        sample_y, eff_scaled, gx, int_offsets, classes, wc=wc, d_in=d_in,
        d_out=d_out, chunk=chunk, binning=b, q=q, offsets2=offsets2)
    table = (g0w[None] * ill_w[:, None, :]).reshape(
        chunk * dob, b, d_in).sum(1)                             # [C*dob, Di]
    dev = sample_y.device
    r = torch.arange(dob, device=dev)
    out = torch.zeros(q * wc, hb, dtype=torch.float32, device=dev)
    if n_spread:
        wts = spread_weights.to(dev, torch.float32).reshape(w, 2, n_spread)
        rs = torch.arange(dob + n_spread - 1, device=dev)
    for ic in range(w // chunk):
        p0 = ic * chunk
        cam = table @ sample_ext[p0:p0 + d_in]                   # [C*dob, H]
        if b != 1:
            cam = cam.reshape(chunk * dob, hb, b).sum(-1)
        if generator is not None:
            cam = poisson_reference(cam, generator)
        pos = slice(p0, p0 + chunk)
        if not n_spread:
            start = torch.where(r[None, :] < m0[ic], sa_lo[pos, None],
                                sa_hi[pos, None])
            target = cls[pos, None].long() * wc + (start + r[None, :]) % wc
            out.index_add_(0, target.reshape(-1), cam)
            continue
        # split at m0 BEFORE spreading, then spread each part per parity:
        # row r' of parity pi is sum_u w[pos, pi, u] * part[r' - u]
        cam = cam.reshape(chunk, dob, hb)
        hi = (r >= m0[ic])[None, :, None]
        for part, sa in ((torch.where(hi, 0.0, cam), sa_lo),
                         (torch.where(hi, cam, 0.0), sa_hi)):
            for pi in range(2):
                spread = torch.zeros(chunk, dob + n_spread - 1, hb,
                                     device=dev)
                for u in range(n_spread):
                    spread[:, u:u + dob] += wts[pos, pi, u, None, None] * part
                target = pi * wc + (sa[pi, pos, None] + rs[None, :]) % wc
                out.index_add_(0, target.reshape(-1),
                               spread.reshape(-1, hb))
    return out.reshape(q, wc, hb)


def rescan_banded_fused(
    sample_y: torch.Tensor, eff_scaled: torch.Tensor, gx: torch.Tensor,
    int_offsets: torch.Tensor, *, wc: int, d_in: int, d_out: int,
    chunk: int, binning: int = 1, classes: torch.Tensor | None = None,
    q: int = 1, generator: torch.Generator | None = None,
    spread_weights: torch.Tensor | None = None,
    offsets2: torch.Tensor | None = None,
    key=None,
) -> torch.Tensor:
    """Banded fused rescan scan over all W column positions (module doc).

    sample_y: [H, W] y-convolved sample; eff_scaled: [W] centered
    brightness-scaled effective excitation profile; gx: [W] centered
    detection x-profile; int_offsets: [W] integer canvas column offsets
    (binned pixels) per scan position; classes: [W] class index in [0, q)
    (None = all zero); d_in/d_out: the band windows of
    ``imaging.rescan._illum_band``. ``generator`` draws per-camera-frame
    shot noise; None = noise-free. ``key`` gives the draws' two Philox key
    words instead (``_build.draw_key`` / ``offset_key``: a rank's stream;
    a CPU ``sample_y`` draws from ``_build.key_generator(key)``); pass
    one of the two.

    NUFFT spreading placement (``imaging.rescan._nufft_spread_tables``):
    ``spread_weights`` [W, 2 * P/2] per-position window taps split by
    parity of the 2x-oversampled fine grid, and ``offsets2`` [2, W] int32
    per-parity integer offsets. Then ``q`` is 2 (the parity canvases),
    ``classes`` must be None and ``int_offsets`` is ignored.

    Returns folded class canvases ``[q, wc, H/b]`` (canvas-column-major).
    A CUDA ``sample_y`` launches kernel K1 (``LAUNCHES`` counts each
    placement mode and shared-memory layout apart: ``_spread`` for NUFFT
    placement, ``_wide`` for windows whose resident factors exceed the
    card's shared memory); a CPU one runs ``rescan_banded_fused_reference``.
    """
    if key is not None and generator is not None:
        raise ValueError("pass a generator or key words, not both")
    if not sample_y.is_cuda:
        return rescan_banded_fused_reference(
            sample_y, eff_scaled, gx, int_offsets, wc=wc, d_in=d_in,
            d_out=d_out, chunk=chunk, binning=binning, classes=classes, q=q,
            generator=generator if key is None else _build.key_generator(key),
            spread_weights=spread_weights, offsets2=offsets2)
    h, w = sample_y.shape
    n_spread, q = _spread_args(w, classes, q, spread_weights, offsets2)
    _check(h, w, wc=wc, d_in=d_in, d_out=d_out, chunk=chunk,
           binning=binning, n_spread=n_spread)
    b = binning
    hb, dob = h // b, d_out // b
    g0w, ill_w, sample_ext, sa_lo, sa_hi, m0, cls = _tables(
        sample_y, eff_scaled, gx, int_offsets, classes, wc=wc, d_in=d_in,
        d_out=d_out, chunk=chunk, binning=b, q=q, offsets2=offsets2)
    # binned detection factor, d-major [D_in, dob]
    g_t = g0w.reshape(dob, b, d_in).sum(1).T.contiguous()
    ill_w = ill_w.contiguous()
    taps = [spread_weights.contiguous()] if n_spread else []
    _build.require_cuda_f32("rescan_banded_fused", g_t, ill_w, sample_ext,
                            sa_lo, sa_hi, m0, cls, *taps)
    out = torch.empty((q, wc, hb), dtype=torch.float32,
                      device=sample_y.device)
    s0, s1, keys = _build.key_words(generator, sample_y.device, key)
    info = (ctypes.c_int * 5)()
    code = _build.lib().rls_rescan_banded_fused(
        g_t.data_ptr(), ill_w.data_ptr(), sample_ext.data_ptr(),
        sa_lo.data_ptr(), sa_hi.data_ptr(), m0.data_ptr(), cls.data_ptr(),
        taps[0].data_ptr() if taps else None, out.data_ptr(), h, w, chunk,
        d_in, dob, b, q, wc, n_spread,
        int(generator is not None or key is not None), s0, s1,
        None if keys is None else keys.data_ptr(),
        _build.stream_handle(sample_y.device), info)
    _build.check(code, "rescan_banded_fused")
    if info[0] < 0:
        raise RuntimeError(
            f"rescan_banded_fused: internal error: the host bound "
            f"banded_fits and K1's layout disagree (band windows d_in="
            f"{d_in}, d_out={d_out} at chunk {chunk} fit no layout of "
            "this card's shared memory); the rescan engine routes such "
            "windows around K1")
    name = "rescan_banded_fused" + ("_spread" if n_spread else "") + (
        "_wide" if info[0] >= 1 else "")
    _build.LAUNCHES[name] += 1
    LAUNCH_SHAPE[name] = {"layout": LAYOUTS[info[0]], "smem_bytes": info[1],
                          "ctas": info[2], "ctas_per_sm": info[3],
                          "threads": info[4], "d_in": d_in, "dob": dob,
                          "chunk": chunk, "binning": b}
    return out

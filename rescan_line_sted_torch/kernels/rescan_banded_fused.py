"""Banded fused rescan scan: CUDA kernel K1 and its plain version.

Port of ``rescan_line_sted_tpu/kernels/rescan_banded_fused.py``, all its
placement modes. Per chunk of C scan positions the scan

1. takes the chunk's ``D_in``-row window of the extended y-convolved
   sample (``sample_ext[r] = sample_y^T[(r - s_in) % W]``),
2. multiplies it by the chunk-invariant binned conv table
   ``[C, D_out/b, D_in]`` (illumination-scaled detection circulant window
   with the row binning folded in; the kernel keeps its two factors) and
   bins ``b`` adjacent lanes; given the profiles' ``supports``, each
   32-row group of a frame only over its band (``band_runs``), the window
   columns both the illumination and the detection reach,
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

The tables and placement scalars, which depend on the band windows,
profiles and placement alone, are built here in plain torch (with floor
division and Python-sign modulo, as the JAX wrapper does) into a
``BandedPlan`` (``banded_plan``), which a caller builds once and passes
with each sample (the rescan engine keeps one per geometry); the kernel
(``csrc/rescan_banded_fused.cu``) or the plain loop consumes them with the
call's extended sample.

K1's limit is decided on the host, the same on every device:
``banded_fits`` holds the shared memory of K1's smaller layout to Hopper's
opt-in limit per block, and the rescan engine sends band windows beyond it
to its routes without band windows (``imaging/rescan.py``), as the JAX
package declines its banded kernel above a VMEM bound.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from rescan_line_sted_torch.device import host_table, read_back
from rescan_line_sted_torch.kernels import _build, fftconv
from rescan_line_sted_torch.kernels.poisson import poisson_reference
from rescan_line_sted_torch.utils.observability import span

# K1's shared-memory layouts (csrc/rescan_banded_fused.cu: kLanes,
# kPassRows, make_layout); a card test holds this mirror to the C entry
# rls_rescan_banded_fused_smem
_LANES = 16
_PASS_ROWS = 512
_THREADS = 512             # threads per CTA (kThreads)
_GROUP_ROWS = 32           # frame rows a warp's product takes (kGroupRows)
_SPREAD_ROWS = 3           # canvas rows of a spreading item (kSpreadRows)
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
    a binned one when b > 1 (24 a row), two buffers of placement scalars
    (5 C + 4 ints) and spreading taps and, when spreading, two slots of
    the placement's frame table (16 ints for each of the most frames a
    512-row pass holds); the third one binned window (16 a row) and one
    buffer of taps."""
    b = binning
    gen = (b * (dob - 1) + d_in + 3) // 4 * 4
    g_res = d_in * (dob + (8 - dob % 32) % 32)
    ill, taps = chunk * d_in, chunk * 2 * n_spread
    dobp = -(-dob // _GROUP_ROWS) * _GROUP_ROWS
    tab = 16 * min(chunk, (_PASS_ROWS - 1) // dobp + 2) if n_spread else 0
    staged = (2 * _PASS_ROWS * _RING_STRIDE + 2 * d_in * (16 * b + 8)
              + (d_in * 24 if b > 1 else 0) + 2 * (5 * chunk + 4) + 2 * taps
              + 2 * tab)
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
# its bytes of shared memory per CTA, CTAs, CTAs per SM, threads per CTA,
# the windows, the band's group-k-steps a chunk and their share of the
# whole windows' (``band_runs``), and the spreading placement's busy
# threads (``spread_busy``; 0.0 in class mode)
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


def band_runs(d_in: int, dob: int, chunk: int, binning: int = 1,
              supports: tuple[int, int] | None = None) -> torch.Tensor:
    """The band K1 convolves (``band_run`` in ``csrc/rescan_banded_fused.cu``):
    ``[C, ceil(dob / 32), 2]`` int64, for each position c of a chunk and
    each 32-row group of its binned frame, the 8-aligned run ``[k_lo,
    k_hi)`` of window columns that c lights (within ``s_exc`` of its
    centre ``s_in + c``) and that a row of the group detects (unbinned
    rows within ``s_det`` of the diagonal ``d = u + s_in - s_out``);
    ``[0, 0)`` where the two miss each other. ``supports = (s_exc,
    s_det)`` in window columns (px); None takes the whole window, as a
    half-width of -1 does on its side in the kernel."""
    s_exc, s_det = (-1, -1) if supports is None else supports
    b = binning
    s_in = (d_in - chunk) // 2
    diag = s_in - (dob * b - chunk) // 2
    c = torch.arange(chunk)[:, None]
    r0 = torch.arange(0, dob, _GROUP_ROWS)[None, :]
    r1 = (r0 + _GROUP_ROWS).clamp(max=dob) - 1
    lo = torch.zeros(chunk, r0.shape[1], dtype=torch.int64)
    hi = torch.full_like(lo, d_in - 1)
    if s_exc >= 0:
        lo, hi = lo.maximum(s_in + c - s_exc), hi.minimum(s_in + c + s_exc)
    if s_det >= 0:
        lo = lo.maximum(b * r0 + diag - s_det)
        hi = hi.minimum(b * r1 + b - 1 + diag + s_det)
    empty = lo > hi
    k_lo = torch.where(empty, 0, lo // 8 * 8)
    k_hi = torch.where(empty, 0, (hi // 8 * 8 + 8).clamp(max=d_in))
    return torch.stack([k_lo, k_hi], -1)


def band_k_steps(d_in: int, dob: int, chunk: int, binning: int = 1,
                 supports: tuple[int, int] | None = None) -> tuple[int, int]:
    """``(band, whole)``: the group-k-steps of 8 K1 issues a chunk on the
    band (``band_runs``) and on the whole windows, ``C * ceil(dob / 32) *
    ceil(d_in / 8)``."""
    runs = band_runs(d_in, dob, chunk, binning, supports)
    band = int(((runs[..., 1] - runs[..., 0] + 7) // 8).sum())
    return band, chunk * -(-dob // _GROUP_ROWS) * -(-d_in // 8)


def spread_busy(sa_lo: torch.Tensor, sa_hi: torch.Tensor, m0: torch.Tensor,
                *, wc: int, dob: int, chunk: int, n_spread: int) -> float:
    """The share of K1's 512 threads that hold a spreading placement item
    in a pass, averaged over the launch's passes, from the placement
    scalars (``[2, W]`` canvas starts per parity, ``[W / C]`` wrap splits)
    on the host. A pass (512 frame rows of a chunk) places, per parity,
    the canvas rows its lo placements cover, ``len = min(diff + dob +
    n_spread - 1, wc)`` from its first position's start (``diff`` to its
    last one's), and, where the chunk wraps (``m0 < dob``), those of the
    same range ``W/b`` earlier that the first range misses (``spread_rows``
    in ``csrc/rescan_banded_fused.cu``). Each range is cut into blocks of
    three rows, and each block is four items (lane quads), a warp's 32
    threads 8 blocks: ``min(4 B, 512)`` threads hold one, for the ``B``
    blocks of both parities."""
    span = dob + n_spread - 1
    dobp = -(-dob // _GROUP_ROWS) * _GROUP_ROWS
    rows_used = chunk * dobp
    first = torch.arange(0, rows_used, _PASS_ROWS)
    end = (first + _PASS_ROWS).clamp(max=rows_used)
    c_first, c_last = first // dobp, (end - 1) // dobp          # [passes]
    slo = sa_lo.long().reshape(2, -1, chunk)                     # [2, n, C]
    base_lo, last = slo[..., c_first], slo[..., c_last]          # [2, n, P]
    length = ((last - base_lo) % wc + span).clamp(max=wc)
    o = (sa_hi.long().reshape(2, -1, chunk)[..., c_first] - base_lo) % wc
    rel_hi = torch.maximum(o, length)
    n_hi = ((o + length).clamp(max=wc) - rel_hi).clamp(min=0)
    n_hi = torch.where((m0.long() < dob)[None, :, None], n_hi, 0)
    blocks = (-(-length // _SPREAD_ROWS) - (-n_hi // _SPREAD_ROWS)).sum(0)
    busy = (4 * blocks).clamp(max=_THREADS).double() / _THREADS  # [n, P]
    return float(busy.mean())


def _check(w, *, wc, d_in, d_out, chunk, binning, n_spread=0,
           supports=None):
    """The JAX wrapper's argument guards (minus its TPU sub-row rule), and
    the band's."""
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
    if supports is not None and (len(supports) != 2 or min(supports) < 0):
        raise ValueError("supports must be two half-widths >= 0, or None")


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
    if offsets2.device.type != "cpu":
        raise ValueError("offsets2 must be on the host, where the plan "
                         "counts its spreading items")
    return n_spread, 2


@dataclasses.dataclass(frozen=True, eq=False)
class BandedPlan:
    """K1's tables that depend on the band windows, profiles and placement
    alone, not on the sample (``banded_plan``): the detection window
    ``g0w [D_out, D_in]`` (the plain version's) and its row-binned,
    d-major factor ``g_t [D_in, dob]`` (the kernel's), the illumination
    window ``ill_w [C, D_in]``, whose product, row-binned, is the conv
    table (module doc); the placement scalars ``sa_lo`` / ``sa_hi``
    (``[W]`` canvas starts, or ``[2, W]`` per parity in NUFFT mode), ``m0``
    (``[W / C]``) and ``cls`` (``[W]``); the spreading taps ``taps`` (NUFFT
    mode, else None); the shape they were built for; the band
    ``supports`` (None: the whole windows) with its group-k-steps a chunk
    and their share of the whole windows' (``band_k_steps``); and the
    spreading placement's busy threads (``spread_busy``; 0.0 in class
    mode)."""

    w: int
    wc: int
    d_in: int
    d_out: int
    chunk: int
    binning: int
    q: int
    n_spread: int
    g0w: torch.Tensor
    g_t: torch.Tensor
    ill_w: torch.Tensor
    sa_lo: torch.Tensor
    sa_hi: torch.Tensor
    m0: torch.Tensor
    cls: torch.Tensor
    taps: torch.Tensor | None
    supports: tuple[int, int] | None
    band_k_steps: int
    band_share: float
    spread_busy: float


def banded_plan(eff_scaled: torch.Tensor, gx: torch.Tensor,
                int_offsets: torch.Tensor, *, wc: int, d_in: int,
                d_out: int, chunk: int, binning: int = 1,
                classes: torch.Tensor | None = None, q: int = 1,
                spread_weights: torch.Tensor | None = None,
                offsets2: torch.Tensor | None = None,
                class_bounds: tuple[int, int] | None = None,
                supports: tuple[int, int] | None = None,
                device=None) -> BandedPlan:
    """K1's tables (``BandedPlan``), the one input of
    ``rescan_banded_fused`` besides the sample, validated and built on
    ``device`` (None: ``eff_scaled``'s) with floor division and
    Python-sign modulo, as the JAX wrapper builds them.

    eff_scaled: [W] centered brightness-scaled effective excitation
    profile; gx: [W] centered detection x-profile; int_offsets: [W]
    integer canvas column offsets (binned pixels) per scan position;
    classes: [W] class index in [0, q) (None = all zero); d_in/d_out: the
    band windows of ``imaging.rescan._illum_band``.

    NUFFT spreading placement (``imaging.rescan._nufft_spread_tables``):
    ``spread_weights`` [W, 2 * P/2] per-position window taps split by
    parity of the 2x-oversampled fine grid, and ``offsets2`` [2, W] int32
    per-parity integer offsets, on the host, where the plan counts its
    ``spread_busy`` before it sends them to ``device``. Then ``q`` is 2
    (the parity canvases), ``classes`` must be None and ``int_offsets`` is
    ignored.

    ``supports = (s_exc, s_det)``: the half-widths (px) beyond which the
    illumination and the detection profile are taken as zero
    (``imaging.rescan._band_supports``); each frame is then convolved only
    over its band (``band_runs``: per 32-row group, the 8-aligned run of
    window columns where both reach). None convolves the whole windows.

    Classes outside ``[0, q)`` are refused: ``class_bounds``, where the
    caller made the classes and knows their least and largest value on
    the host, else read back from ``classes`` (one sync on a card)."""
    w = eff_scaled.shape[-1]
    n_spread, q = _spread_args(w, classes, q, spread_weights, offsets2)
    _check(w, wc=wc, d_in=d_in, d_out=d_out, chunk=chunk, binning=binning,
           n_spread=n_spread, supports=supports)
    if int_offsets.shape != (w,) or (classes is not None
                                     and classes.shape != (w,)):
        raise ValueError("int_offsets and classes need one entry per column")
    if classes is not None:
        lo, hi = (class_bounds if class_bounds is not None
                  else read_back(torch.stack(torch.aminmax(classes))))
        if lo < 0 or hi >= q:
            raise ValueError(f"classes must lie in [0, {q})")
    b = binning
    wb, dob = w // b, d_out // b
    dev = eff_scaled.device if device is None else torch.device(device)
    s_in = (d_in - chunk) // 2
    s_out = (d_out - chunk) // 2

    ci = torch.arange(chunk, device=dev)[:, None]
    di = torch.arange(d_in, device=dev)[None, :]
    ill_w = eff_scaled[(w // 2 + di - s_in - ci) % w]            # [C, Di]
    g0w = fftconv.circulant_window(gx, d_out, d_in, s_out, s_in)  # [Do, Di]

    def placement(offs, on):
        """(m0, sa_lo, sa_hi) of ``offs`` on device ``on``."""
        p0s = torch.arange(w // chunk, device=on) * chunk
        gstart = torch.div(p0s - s_out, b, rounding_mode="floor")
        k0 = torch.div(gstart, wb, rounding_mode="floor")
        icp = torch.arange(w, device=on) // chunk
        sa_lo = torch.remainder(gstart[icp] + offs.to(on, torch.int64)
                                - wb * k0[icp], wc)
        return ((wb * (k0 + 1) - gstart).to(torch.int32), sa_lo,
                torch.remainder(sa_lo - wb, wc))

    offs, busy = int_offsets, 0.0
    if offsets2 is not None:
        m0_host, lo_host, hi_host = placement(offsets2, "cpu")
        busy = spread_busy(lo_host, hi_host, m0_host, wc=wc, dob=dob,
                           chunk=chunk, n_spread=n_spread)
        offs = host_table(offsets2.numpy(), dev)
    m0, sa_lo, sa_hi = placement(offs, dev)
    cls = (torch.zeros(w, dtype=torch.int32, device=dev) if classes is None
           else classes.to(dev, torch.int32))
    if supports is not None:
        supports = (int(supports[0]), int(supports[1]))
    steps, whole = band_k_steps(d_in, dob, chunk, b, supports)
    return BandedPlan(
        w=w, wc=wc, d_in=d_in, d_out=d_out, chunk=chunk, binning=b, q=q,
        n_spread=n_spread, g0w=g0w,
        g_t=g0w.reshape(dob, b, d_in).sum(1).T.contiguous(),
        ill_w=ill_w.contiguous(), sa_lo=sa_lo.to(torch.int32),
        sa_hi=sa_hi.to(torch.int32), m0=m0, cls=cls,
        taps=(None if spread_weights is None
              else spread_weights.to(dev).contiguous()),
        supports=supports, band_k_steps=steps, band_share=steps / whole,
        spread_busy=busy)


def banded_table(plan: BandedPlan) -> torch.Tensor:
    """The plain version's binned conv table ``[C * dob, D_in]``: ``g0w``
    times ``ill_w``, row-binned, zero outside the plan's band
    (``band_runs``), in the plan's dtype."""
    c, b, d_in = plan.chunk, plan.binning, plan.d_in
    dob = plan.d_out // b
    table = (plan.g0w[None] * plan.ill_w[:, None, :]).reshape(
        c * dob, b, d_in).sum(1)
    if plan.supports is None:
        return table
    runs = band_runs(d_in, dob, c, b, plan.supports).to(table.device)
    runs = runs[:, torch.arange(dob, device=table.device) // _GROUP_ROWS]
    d = torch.arange(d_in, device=table.device)
    keep = (d >= runs[..., :1]) & (d < runs[..., 1:])            # [C, dob, Di]
    return torch.where(keep.reshape(c * dob, d_in), table, 0.0)


def _sample_shape(sample_y: torch.Tensor, plan: BandedPlan
                  ) -> tuple[int, int]:
    """``sample_y``'s ``(H, W)``, held to the width ``plan`` was built
    for."""
    h, w = sample_y.shape
    if w != plan.w:
        raise ValueError(f"plan built for W = {plan.w}, called with a "
                         f"sample of width {w}")
    return h, w


def _sample_ext(sample_y: torch.Tensor, d_in: int, chunk: int
                ) -> torch.Tensor:
    """The extended sample ``[W + D_in - C, H]``: ``sample_ext[r] =
    sample_y^T[(r - s_in) % W]``, so each chunk's window is a slice."""
    w = sample_y.shape[1]
    s_in = (d_in - chunk) // 2
    sample_t = sample_y.T
    head = sample_t[w - s_in:] if s_in else sample_t[:0]
    return torch.cat([head, sample_t, sample_t[:d_in - s_in]],
                     dim=0).contiguous()


def rescan_banded_fused_reference(
    sample_y: torch.Tensor, plan: BandedPlan,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Plain torch version of K1: one batched matmul per chunk (its conv
    table zero outside the band, ``banded_table``), ``torch.poisson`` when
    ``generator`` is given, ``index_add_`` placement (after per-parity
    spreading in NUFFT mode). Same arguments (but key words) and result as
    ``rescan_banded_fused``."""
    h, w = _sample_shape(sample_y, plan)
    q, n_spread, wc, chunk = plan.q, plan.n_spread, plan.wc, plan.chunk
    sa_lo, sa_hi, m0, cls = plan.sa_lo, plan.sa_hi, plan.m0, plan.cls
    b, d_in = plan.binning, plan.d_in
    hb, dob = h // b, plan.d_out // b
    sample_ext = _sample_ext(sample_y, d_in, chunk)
    table = banded_table(plan)                                   # [C*dob, Di]
    dev = sample_y.device
    r = torch.arange(dob, device=dev)
    out = torch.zeros(q * wc, hb, dtype=torch.float32, device=dev)
    if n_spread:
        wts = plan.taps.to(dev, torch.float32).reshape(w, 2, n_spread)
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
    sample_y: torch.Tensor, plan: BandedPlan, *,
    generator: torch.Generator | None = None, key=None,
) -> torch.Tensor:
    """Banded fused rescan scan over all W column positions (module doc).

    sample_y: [H, W] y-convolved sample; plan: K1's tables for its band
    windows, profiles and placement (``banded_plan``, which validates
    them), taken as they are. ``generator`` draws per-camera-frame shot
    noise; None = noise-free. ``key`` gives the draws' two Philox key
    words instead (``_build.draw_key`` / ``offset_key``: a rank's stream;
    a CPU ``sample_y`` draws from ``_build.key_generator(key)``); pass
    one of the two.

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
            sample_y, plan,
            generator if key is None else _build.key_generator(key))
    with span("rls.k1"):   # key words and launch
        h, w = _sample_shape(sample_y, plan)
        q, n_spread, wc = plan.q, plan.n_spread, plan.wc
        b, chunk, d_in, d_out = (plan.binning, plan.chunk, plan.d_in,
                                 plan.d_out)
        hb, dob = h // b, d_out // b
        sample_ext = _sample_ext(sample_y, d_in, chunk)
        taps = [plan.taps] if n_spread else []
        _build.require_cuda_f32("rescan_banded_fused", plan.g_t, plan.ill_w,
                                sample_ext, plan.sa_lo, plan.sa_hi, plan.m0,
                                plan.cls, *taps)
        out = torch.empty((q, wc, hb), dtype=torch.float32,
                          device=sample_y.device)
        s0, s1, keys = _build.key_words(generator, sample_y.device, key)
        info = (ctypes.c_int * 5)()
        code = _build.lib().rls_rescan_banded_fused(
            plan.g_t.data_ptr(), plan.ill_w.data_ptr(), sample_ext.data_ptr(),
            plan.sa_lo.data_ptr(), plan.sa_hi.data_ptr(), plan.m0.data_ptr(),
            plan.cls.data_ptr(), taps[0].data_ptr() if taps else None,
            out.data_ptr(), h, w, chunk, d_in, dob, b, q, wc, n_spread,
            int(generator is not None or key is not None),
            *(plan.supports or (-1, -1)), s0, s1,
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
        LAUNCH_SHAPE[name] = {
            "layout": LAYOUTS[info[0]], "smem_bytes": info[1],
            "ctas": info[2], "ctas_per_sm": info[3], "threads": info[4],
            "d_in": d_in, "dob": dob, "chunk": chunk, "binning": b,
            "band_k_steps": plan.band_k_steps,
            "band_share": plan.band_share, "spread_busy": plan.spread_busy}
        return out

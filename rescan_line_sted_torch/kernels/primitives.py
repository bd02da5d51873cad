"""K6: the card's primitive rates, and the composite bound built from them.

Port of ``scripts/perf_vpu_bound.py`` (``_bench`` and its seven bodies):
each primitive the engine kernels are built from is measured in a minimal
CUDA kernel (``csrc/primitives.cu``) that repeats one operation, so a
kernel's bound can be a sum of counts over rates measured on this card
rather than over datasheet peaks. The TPU's uniform body is measured twice
here, as the two ways the kernels draw: one single-draw uniform per
element (K2b, K4) and the four uniforms of one Philox block (K1). A
wrapper launches its kernel on a CUDA tensor (adding one to
``_build.LAUNCHES["primitives_<name>"]``) and runs its plain version on a
CPU tensor. The plain versions are the float32 chains (the fma chain
rounded once per step as ``fmaf`` rounds), the exp chain in float64, or
the same float32 steps on the same Philox stream (``kernels.poisson``).
The TPU's matrix-unit body is measured twice too: in fp32 FFMA
(``sgemm``) and on the tensor cores in three TF32 passes (``tf32x3``, on
``wgmma``: the rate K1's convolution is charged at); both compute the same
product, whose plain version is its closed form in float64
(``tf32_passes_reference`` emulates the passes themselves).

``calls(device, check=True)`` gives every kernel and its plain version on
the inputs the rates use, with constants at which each rep moves the
result, so ``CHECKS``' comparisons see how many reps a kernel ran.
``primitive_rates(device)`` times each kernel with CUDA events (reps folded
until a call lasts about 1 ms, median of 7) and ``composite_bound(counts,
rates)`` mirrors ``perf_vpu_bound.composite_bound``:

    T >= conv FMAs / max(fma, sgemm rate) + tensor-core conv FMAs / tf32x3
         rate + exps / exp rate
         + single draws / uniform rate + Philox blocks / uniform_block rate
         + inversion terms / inv_term rate + Knuth rounds / knuth_round rate
         + placement windows / place_add rate

Run ``python -m rescan_line_sted_torch.kernels.primitives`` for this card's
rates (``--device cpu`` times the plain versions, which says nothing about
the card).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
from fractions import Fraction
from typing import Callable, NamedTuple

import numpy as np
import torch

from rescan_line_sted_torch.kernels import _build
from rescan_line_sted_torch.kernels.poisson import (
    _INV_TIERS,
    _CUT,
    philox4x32_10,
    single_draw_uniforms,
)

UNROLL = 16                     # dependent operations per unrolled step
WIN_ROWS, CANVAS_ROWS, COLS = 136, 3080, 512     # the TPU body's placement
WINDOW = WIN_ROWS * COLS        # elements of one placement window
GEMM_SHAPE = (4096, 128, 512)   # (M, K, N) of the TPU's mxu body
TILE = 128                      # the product kernels' C tile: M, N % 128
TF32_MASK = -8192               # 0xffffe000 as an int32: TF32's 19 bits
FILL = 132 * 2048               # threads that fill an H100: 132 SMs x 2048
PLACE_CANVASES = 33             # place_add canvases: 64 x 33 CTAs, 2 per SM
INV_LAM = 0.3                   # the TPU bodies' rate
EXP_SCALE = 0.5                 # the TPU body's exp chain: x = exp(-x) / 2
KNUTH_THRESHOLD = float(np.float32(np.exp(-0.3)))
KNUTH_ROUNDS = 24               # Knuth rounds of an element below the cut
PTRS_DRAWS = 2                  # a bright element's least draws: one attempt
NAMES = ("fma", "uniform", "uniform_block", "exp", "inv_term", "knuth_round",
         "place_add", "sgemm", "tf32x3")
TARGET_MS, REPEATS = 1.0, 7     # a rate call's least length; timings per rate
# The checks' constants. exp(-x) / 2 reaches its float32 fixed point within
# 16 steps, so the check runs x = 2 exp(-x) (fixed point 0.85, slope -0.85:
# after 32 steps one rep more or less moves x by 1e-3 or more); at 0.3 the
# inversion terms underflow within one unrolled step of 16, so the check
# runs lam = 16!^(1/16), where 16 terms multiply the term by about 1 and
# the CDF grows by about e^lam per 16 reps.
CHECK_EXP_SCALE = 2.0
CHECK_INV_LAM = math.factorial(UNROLL) ** (1.0 / UNROLL)
# Per primitive: the reps at which a kernel is held against its plain
# version on ``calls(device, check=True)``, and the largest relative error
# allowed (0: the same float32 steps). One rep more or less moves each
# result by more than its tolerance.
CHECKS = {"fma": (32, 0.0), "uniform": (32, 0.0), "uniform_block": (16, 0.0),
          "exp": (32, 1e-5), "inv_term": (48, 0.0), "knuth_round": (32, 0.0),
          "place_add": (48, 0.0), "sgemm": (2, 1e-6), "tf32x3": (2, 1e-6)}
# The product bodies on ``normal_operands`` (the checks' eighths above are
# exact in TF32's high part, so they cannot tell the passes apart): each
# (M, K, N) at reps 1 and 3, held within NORMAL_TOL of the float64 product,
# which one TF32 pass misses.
NORMAL_SHAPES = (GEMM_SHAPE, (256, 64, 128))
NORMAL_REPS = (1, 3)
NORMAL_TOL = 1e-5


def _reps(reps: int) -> int:
    if reps <= 0 or reps % UNROLL:
        raise ValueError(f"reps must be a positive multiple of {UNROLL}")
    return reps


def _elementwise(name: str, out: torch.Tensor, reps: int, *args) -> None:
    _build.require_cuda_f32(f"primitives_{name}", out)
    code = getattr(_build.lib(), f"rls_prim_{name}")(
        out.data_ptr(), out.numel(), reps, *args,
        _build.stream_handle(out.device))
    _build.check(code, f"primitives_{name}")
    _build.LAUNCHES[f"primitives_{name}"] += 1


# ---- plain versions -------------------------------------------------------

def _fma32(x: np.float32, a: np.float32, c: np.float32) -> np.float32:
    """``fmaf(x, a, c)``: ``x a + c`` exactly, rounded once to float32
    (nearest, ties to even)."""
    v = Fraction(float(x)) * Fraction(float(a)) + Fraction(float(c))
    f = np.float32(float(v))
    near = (np.nextafter(f, np.float32(-np.inf)), f,
            np.nextafter(f, np.float32(np.inf)))
    return min(near, key=lambda y: (abs(Fraction(float(y)) - v),
                                    int(y.view(np.uint32)) & 1))


def fma_reference(n: int, reps: int, device=None) -> torch.Tensor:
    """``x <- fmaf(x, 0.999999, 1e-7)`` from 0.5, ``reps`` times, each
    step rounded once to float32 as the card's FFMA rounds."""
    a, c = np.float32(0.999999), np.float32(1e-7)
    x = np.float32(0.5)
    for _ in range(reps):
        x = _fma32(x, a, c)
    return torch.full((n,), float(x), dtype=torch.float32, device=device)


def uniform_reference(n: int, reps: int, key: tuple[int, int],
                      device=None) -> torch.Tensor:
    """The float32 sum, in draw order, of each element's ``reps`` single-draw
    uniforms: draw r of element i has index ``r * n + i``."""
    u = single_draw_uniforms(n * reps, key).reshape(reps, n)
    x = np.zeros(n, np.float32)
    for row in u:
        x = x + row
    return torch.from_numpy(x).to(device)


def uniform_block_reference(n: int, reps: int, key: tuple[int, int],
                            device=None) -> torch.Tensor:
    """The float32 sum, in draw order, of the four words' uniforms of each
    element's ``reps`` single-draw Philox blocks: rep r of element i takes
    block ``r * n + i`` (single-draw indices ``4 (r n + i)`` to ``+ 3``)."""
    u = single_draw_uniforms(4 * n * reps, key).reshape(reps, n, 4)
    x = np.zeros(n, np.float32)
    for row in u:
        for word in range(4):
            x = x + row[:, word]
    return torch.from_numpy(x).to(device)


def exp_reference(n: int, reps: int, scale: float = EXP_SCALE,
                  device=None) -> torch.Tensor:
    """``x <- scale exp(-x)`` from 0.3, ``reps`` times, in float64 (for the
    scales used, 0.5 and 2, a contraction: float32 rounding does not
    accumulate)."""
    x = 0.3
    for _ in range(reps):
        x = scale * math.exp(-x)
    return torch.full((n,), x, dtype=torch.float32, device=device)


def inv_term_reference(n: int, reps: int, key: tuple[int, int],
                       lam: float = INV_LAM, device=None) -> torch.Tensor:
    """``reps`` CDF-inversion terms from ``term = cdf = 0.7`` on each
    element's single-draw uniform (index i), in float32; returns ``count +
    cdf``."""
    u = single_draw_uniforms(n, key)
    term = np.full(n, 0.7, np.float32)
    cdf = np.full(n, 0.7, np.float32)
    cnt = np.zeros(n, np.float32)
    lam32 = np.float32(lam)
    for r in range(reps):
        k = r % UNROLL
        cnt = cnt + (u > cdf).astype(np.float32)
        term = term * (lam32 * np.float32(1.0 / (k + 1)))
        cdf = cdf + term
    return torch.from_numpy(cnt + cdf).to(device)


def multi_draw_uniforms(n: int, draws: int, key: tuple[int, int]
                        ) -> np.ndarray:
    """The multi-draw stream of ``csrc/philox.cuh`` (``Uniforms``): draw t
    of element i is word ``t % 4`` of Philox(i lo, i hi, t // 4, 0), as
    ``(bits >> 9) * 2^-23 + 2^-24``; returns [draws, n] float32."""
    blocks = -(-draws // 4)
    i = np.tile(np.arange(n, dtype=np.uint64), blocks)
    t = np.repeat(np.arange(blocks, dtype=np.uint64), n)
    ctr = np.stack([i & np.uint64(0xFFFFFFFF), i >> np.uint64(32), t,
                    np.zeros_like(i)], axis=1)
    bits = philox4x32_10(ctr, key).reshape(blocks, n, 4)
    bits = bits.transpose(0, 2, 1).reshape(blocks * 4, n)[:draws]
    return ((bits >> 9).astype(np.float32) * np.float32(2.0 ** -23)
            + np.float32(2.0 ** -24))


def knuth_round_reference(n: int, reps: int, key: tuple[int, int],
                          device=None) -> torch.Tensor:
    """``reps`` Knuth rounds on each element's multi-draw stream, in
    float32: ``prod *= u``, ``small += prod >= exp(-0.3)``; returns
    ``small + prod``."""
    u = multi_draw_uniforms(n, reps, key)
    thr = np.float32(KNUTH_THRESHOLD)
    prod = np.ones(n, np.float32)
    small = np.zeros(n, np.float32)
    for row in u:
        prod = prod * row
        small = small + (prod >= thr).astype(np.float32)
    return torch.from_numpy(small + prod).to(device)


# place_add's edge cases: (name, canvases, offsets): one canvas and 33, the
# first and last offsets (0 and 2944), repeated offsets and offsets one row
# apart, and rep counts of 1, 7 and 4099 (two blocks of the kernel's 2048
# offsets and three more: a multiple of neither the block nor its
# four-offset reads)
_LAST = CANVAS_ROWS - WIN_ROWS
PLACE_CASES = (
    ("1 canvas, offset 0, 1 rep", 1, (0,)),
    ("33 canvases, offset 2944, 1 rep", 33, (_LAST,)),
    ("1 canvas, one offset repeated, 7 reps", 1, (5,) * 7),
    ("33 canvases, offsets 1 row apart, 7 reps", 33, tuple(range(100, 107))),
    ("33 canvases, 0 and 2944 repeated, 7 reps", 33,
     (0, _LAST, 0, _LAST, _LAST, 1, 0)),
    ("33 canvases, 4099 reps", 33,
     tuple(np.random.default_rng(5).integers(0, _LAST + 1, 4099).tolist())))


def place_add_case(i: int, device=None
                   ) -> tuple[str, torch.Tensor, torch.Tensor]:
    """``PLACE_CASES[i]`` as ``(name, canvases, offsets)`` on ``device``:
    the canvases hold seeded uniforms, so every add rounds."""
    name, n, offsets = PLACE_CASES[i]
    canvas = torch.rand((n, CANVAS_ROWS, COLS),
                        generator=torch.Generator().manual_seed(5 + i))
    return (name, canvas.to(device),
            torch.tensor(offsets, dtype=torch.int32, device=device))


def place_add_reference(canvas: torch.Tensor, window: torch.Tensor,
                        offsets: torch.Tensor) -> torch.Tensor:
    """Add ``window`` [136, 512] into every canvas of ``canvas`` [G, 3080,
    512] at each row offset of ``offsets`` in turn; returns a new tensor."""
    out = canvas.clone()
    for base in offsets.tolist():
        out[:, base:base + WIN_ROWS] += window
    return out


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernels' exact TF32 split of float32 ``x``: ``x_hi = x &
    0xffffe000`` and ``x_lo = (x - x_hi) & 0xffffe000`` on the bits."""
    x = x.float().contiguous()
    hi = (x.view(torch.int32) & TF32_MASK).view(torch.float32)
    lo = ((x - hi).view(torch.int32) & TF32_MASK).view(torch.float32)
    return hi, lo


def tf32_passes_reference(a: torch.Tensor, b: torch.Tensor, reps: int,
                          passes: int = 3) -> torch.Tensor:
    """``sum_rep`` of the TF32 passes of ``a @ (b + rep * 1e-9)`` in
    float64, each rep's ``b + rep * 1e-9`` rounded to float32 and split as
    the kernel splits it: ``passes=3`` hi * hi + hi * lo + lo * hi (the
    tf32x3 kernel's products), ``passes=1`` hi * hi alone (one TF32 pass,
    which misses 1e-5 on values TF32 does not hold exactly)."""
    if passes not in (1, 3):
        raise ValueError("passes is 1 or 3")
    ah, al = (t.double() for t in tf32_split(a))
    out = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float64,
                      device=a.device)
    for rep in range(reps):
        pert = np.float32(rep) * np.float32(1e-9)
        bh, bl = (t.double() for t in tf32_split(b.float() + float(pert)))
        out += ah @ bh
        if passes == 3:
            out += ah @ bl + al @ bh
    return out


def normal_operands(m: int, k: int, n: int, seed: int = 0
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Seeded standard-normal float32 ``a`` [m, k] and ``b`` [k, n] (numpy):
    values one TF32 pass does not hold, unlike the rate calls' eighths."""
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((m, k), np.float32)),
            torch.from_numpy(rng.standard_normal((k, n), np.float32)))


def product_float64(a: torch.Tensor, b: torch.Tensor, reps: int
                    ) -> torch.Tensor:
    """``sum_rep a @ (b + rep * 1e-9)`` in closed form, float64: ``reps a @
    b + 1e-9 reps (reps - 1) / 2 * rowsum(a)``."""
    a64, b64 = a.double(), b.double()
    return reps * (a64 @ b64) \
        + 1e-9 * reps * (reps - 1) / 2 * a64.sum(1, keepdim=True)


def sgemm_reference(a: torch.Tensor, b: torch.Tensor, reps: int
                    ) -> torch.Tensor:
    """``product_float64`` rounded to float32: the product bodies' plain
    version."""
    return product_float64(a, b, reps).float()


# ---- the kernels ----------------------------------------------------------

def fma(out: torch.Tensor, reps: int) -> torch.Tensor:
    """Each element of ``out`` (float32) gets the fma chain of ``reps``
    steps."""
    reps = _reps(reps)
    if not out.is_cuda:
        return out.copy_(fma_reference(out.numel(), reps).reshape(out.shape))
    _elementwise("fma", out, reps)
    return out


def uniform(out: torch.Tensor, reps: int, key: tuple[int, int]) -> torch.Tensor:
    """Each element gets the sum of ``reps`` single-draw Philox uniforms
    under the key words ``key``."""
    reps = _reps(reps)
    if not out.is_cuda:
        return out.copy_(uniform_reference(out.numel(), reps, key)
                         .reshape(out.shape))
    _elementwise("uniform", out, reps, *key)
    return out


def uniform_block(out: torch.Tensor, reps: int, key: tuple[int, int]
                  ) -> torch.Tensor:
    """Each element gets the sum of the four uniforms of each of its
    ``reps`` single-draw Philox blocks."""
    reps = _reps(reps)
    if not out.is_cuda:
        return out.copy_(uniform_block_reference(out.numel(), reps, key)
                         .reshape(out.shape))
    _elementwise("uniform_block", out, reps, *key)
    return out


def exp(out: torch.Tensor, reps: int, scale: float = EXP_SCALE
        ) -> torch.Tensor:
    """Each element gets the exp chain ``x <- scale exp(-x)`` of ``reps``
    steps."""
    reps = _reps(reps)
    if not out.is_cuda:
        return out.copy_(exp_reference(out.numel(), reps, scale)
                         .reshape(out.shape))
    _elementwise("exp", out, reps, ctypes.c_float(scale))
    return out


def inv_term(out: torch.Tensor, reps: int, key: tuple[int, int],
             lam: float = INV_LAM) -> torch.Tensor:
    """Each element gets ``reps`` CDF-inversion terms at rate ``lam``."""
    reps = _reps(reps)
    if not out.is_cuda:
        return out.copy_(inv_term_reference(out.numel(), reps, key, lam)
                         .reshape(out.shape))
    _elementwise("inv_term", out, reps, ctypes.c_float(lam), *key)
    return out


def knuth_round(out: torch.Tensor, reps: int, key: tuple[int, int]
                ) -> torch.Tensor:
    """Each element gets ``reps`` Knuth rounds on its multi-draw stream."""
    reps = _reps(reps)
    if not out.is_cuda:
        return out.copy_(knuth_round_reference(out.numel(), reps, key)
                         .reshape(out.shape))
    _elementwise("knuth_round", out, reps, ctypes.c_float(KNUTH_THRESHOLD),
                 *key)
    return out


def place_add(canvas: torch.Tensor, window: torch.Tensor,
              offsets: torch.Tensor) -> torch.Tensor:
    """Add ``window`` [136, 512] into each canvas of ``canvas`` [G, 3080,
    512] at the row offsets ``offsets`` [reps] in order, in place."""
    if canvas.ndim != 3 or canvas.shape[1:] != (CANVAS_ROWS, COLS) \
            or window.shape != (WIN_ROWS, COLS) or offsets.ndim != 1:
        raise ValueError("place_add takes canvases [G, 3080, 512], a window "
                         "[136, 512] and offsets [reps]")
    if offsets.numel() and (int(offsets.min()) < 0
                            or int(offsets.max()) > CANVAS_ROWS - WIN_ROWS):
        raise ValueError("place_add offsets must lie in [0, 2944]")
    if not canvas.is_cuda:
        return canvas.copy_(place_add_reference(canvas, window, offsets))
    offs = offsets.to(canvas.device, torch.int32).contiguous()
    _build.require_cuda_f32("primitives_place_add", canvas, window, offs)
    if canvas.data_ptr() % 16:
        raise ValueError("place_add: the canvases must start 16-byte aligned "
                         "(the kernel's TMA copies)")
    code = _build.lib().rls_prim_place_add(
        canvas.data_ptr(), window.data_ptr(), offs.data_ptr(),
        canvas.shape[0], offs.numel(), _build.stream_handle(canvas.device))
    _build.check(code, "primitives_place_add")
    _build.LAUNCHES["primitives_place_add"] += 1
    return canvas


def _product(name: str, a: torch.Tensor, b: torch.Tensor, reps: int,
             k_step: int) -> torch.Tensor:
    (m, k), (k2, n) = a.shape, b.shape
    if k != k2 or m % TILE or n % TILE or k % k_step or not 0 < k <= TILE \
            or reps <= 0:
        raise ValueError(f"{name} takes a [M, K] and b [K, N] with M % {TILE}"
                         f", N % {TILE} and K % {k_step} zero, K <= {TILE},"
                         " and reps > 0")
    if not a.is_cuda:
        return sgemm_reference(a, b, reps)
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    _build.require_cuda_f32(f"primitives_{name}", a, b, out)
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError(f"{name}: a and b must start 16-byte aligned")
    code = getattr(_build.lib(), f"rls_prim_{name}")(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, reps,
        _build.stream_handle(a.device))
    _build.check(code, f"primitives_{name}")
    _build.LAUNCHES[f"primitives_{name}"] += 1
    return out


def sgemm(a: torch.Tensor, b: torch.Tensor, reps: int) -> torch.Tensor:
    """``sum_rep a @ (b + rep * 1e-9)`` [M, N] in fp32 FFMA (no tensor
    cores); M % 128 == 0, N % 128 == 0, K % 8 == 0 and K <= 128 (the
    kernel's 128 x 128 tiles keep K resident in shared memory)."""
    return _product("sgemm", a, b, reps, 8)


def tf32x3(a: torch.Tensor, b: torch.Tensor, reps: int) -> torch.Tensor:
    """``sgemm``'s product on the tensor cores, each k-step of 8 in three
    TF32 passes (hi * hi into one fp32 accumulator, hi * lo + lo * hi into
    a second); M % 128 == 0, N % 128 == 0, K % 32 == 0 and K <= 128 (the
    kernel's TMA slices of 32, resident in shared memory)."""
    return _product("tf32x3", a, b, reps, 32)


# ---- rates and the composite bound ---------------------------------------

def place_offsets(reps: int, device=None) -> torch.Tensor:
    """Row offsets of the place_add windows: ``7 r mod 2945``, every row of
    the canvas in turn at no alignment."""
    return (7 * torch.arange(reps) % (CANVAS_ROWS - WIN_ROWS + 1)).to(
        device, torch.int32)


class Call(NamedTuple):
    run: Callable[[int], torch.Tensor]     # the kernel, ``reps`` repetitions
    plain: Callable[[int], torch.Tensor]   # its plain version, same inputs
    units: int                             # the work of one rep


def calls(device, key=(12345, 678), check: bool = False) -> dict[str, Call]:
    """Per primitive: the kernel and its plain version on inputs made here
    (``FILL`` elements, ``PLACE_CANVASES`` canvases and ``place_offsets``,
    the GEMM_SHAPE product of eighths), and the work one rep does (in
    operations, uniforms, Philox blocks, windows or FMAs). ``plain`` reads
    the inputs as they stand, so call it before ``run`` (place_add adds in
    place). With ``check`` the exp and inv_term chains take the checks'
    constants; the rates use the TPU bodies'."""
    m, k, n = GEMM_SHAPE
    scale = CHECK_EXP_SCALE if check else EXP_SCALE
    lam = CHECK_INV_LAM if check else INV_LAM
    out = torch.empty(FILL, dtype=torch.float32, device=device)
    canvas = torch.zeros((PLACE_CANVASES, CANVAS_ROWS, COLS),
                         dtype=torch.float32, device=device)
    g = torch.Generator().manual_seed(0)
    window = torch.rand((WIN_ROWS, COLS), generator=g).to(device)
    offsets = place_offsets(1 << 20, device)
    a = (torch.randint(0, 8, (m, k), generator=g) / 8).to(device)
    b = (torch.randint(0, 8, (k, n), generator=g) / 8).to(device)
    return {
        "fma": Call(lambda r: fma(out, r),
                    lambda r: fma_reference(FILL, r, device), FILL),
        "uniform": Call(lambda r: uniform(out, r, key),
                        lambda r: uniform_reference(FILL, r, key, device),
                        FILL),
        "uniform_block": Call(
            lambda r: uniform_block(out, r, key),
            lambda r: uniform_block_reference(FILL, r, key, device), FILL),
        "exp": Call(lambda r: exp(out, r, scale),
                    lambda r: exp_reference(FILL, r, scale, device), FILL),
        "inv_term": Call(lambda r: inv_term(out, r, key, lam),
                         lambda r: inv_term_reference(FILL, r, key, lam,
                                                      device), FILL),
        "knuth_round": Call(
            lambda r: knuth_round(out, r, key),
            lambda r: knuth_round_reference(FILL, r, key, device), FILL),
        "place_add": Call(
            lambda r: place_add(canvas, window, offsets[:r]),
            lambda r: place_add_reference(canvas, window, offsets[:r]),
            PLACE_CANVASES),
        "sgemm": Call(lambda r: sgemm(a, b, r),
                      lambda r: sgemm_reference(a, b, r), m * k * n),
        "tf32x3": Call(lambda r: tf32x3(a, b, r),
                       lambda r: sgemm_reference(a, b, r), m * k * n),
    }


def _event_ms(fn, repeats: int) -> list[float]:
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def primitive_rates(device=None) -> dict:
    """Each primitive's rate on the card (units per second: operations for
    fma, exp, inv_term and knuth_round, uniforms, Philox blocks for
    uniform_block, windows for place_add, FMAs for sgemm and tf32x3): reps
    grow until a call lasts ``TARGET_MS``, then the median of ``REPEATS``
    CUDA-event timings. Raises without a card."""
    from rescan_line_sted_torch.device import resolve

    device = resolve(device)
    if device.type != "cuda":
        raise RuntimeError("primitive_rates times the CUDA kernels: it "
                           "needs a card")
    rates = {}
    for name, (run, _, units) in calls(device).items():
        reps = UNROLL
        run(reps)
        torch.cuda.synchronize()
        while True:
            ms = float(np.median(_event_ms(lambda: run(reps), 3)))
            if ms >= TARGET_MS or reps >= 1 << 20:
                break
            grow = max(2, math.ceil(1.2 * TARGET_MS / max(ms, 1e-3)))
            reps = min(reps * grow, 1 << 20)
        ms = float(np.median(_event_ms(lambda: run(reps), REPEATS)))
        rates[name] = {"rate": units * reps / (ms * 1e-3), "reps": reps,
                       "ms": ms}
    return rates


def tiered_counts(lam: torch.Tensor) -> dict:
    """Sampler work of K2a's tiered ladder on rates ``lam``, counted per
    element at the element's own tier (a lower bound of the warp's tier):
    ``uniforms``, one per element of rate in (0, 10); ``exps``, one per
    element of rate 1e-3 or more (the Bernoulli tier takes none; a bright
    element's PTRS takes logs); CDF-inversion terms (kmax per element in
    [1e-3, 10)); Knuth rounds (a bright element's ``PTRS_DRAWS`` draws,
    each at least a round's work: the sampler stops at the first
    acceptance)."""
    lam = lam.clamp_min(0)
    terms = 0
    lo = 1e-3
    for hi, kmax in _INV_TIERS:
        terms += kmax * int(((lam >= lo) & (lam < hi)).sum())
        lo = hi
    return {"uniforms": int(((lam > 0) & (lam < _CUT)).sum()),
            "exps": int((lam >= 1e-3).sum()), "inv_terms": terms,
            "knuth_rounds": PTRS_DRAWS * int((lam >= _CUT).sum())}


def knuth_counts(lam: torch.Tensor) -> dict:
    """Sampler work of the Knuth + PTRS sampler (K3's draws) on ``lam``:
    one exp (or log) per element of rate > 0; for an element below the
    cut, Knuth's rounds until its count is settled, min(rate + 1,
    ``KNUTH_ROUNDS``) in expectation; ``PTRS_DRAWS`` draws of the
    multi-draw stream per bright one (each round and draw takes its
    uniform from that stream, which the knuth_round rate includes)."""
    lam = lam.clamp_min(0)
    low = lam[(lam > 0) & (lam < _CUT)].double()
    return {"exps": int((lam > 0).sum()), "inv_terms": 0,
            "knuth_rounds": float((low + 1.0).clamp(max=KNUTH_ROUNDS).sum())
            + PTRS_DRAWS * int((lam >= _CUT).sum())}


def composite_bound(counts: dict, rates: dict) -> dict:
    """The least time (ms) of a kernel from its counts and the measured
    primitive rates (``primitive_rates``). ``counts`` may hold ``conv_fma``
    (FFMA work, charged at the faster FFMA rate, the fma chain's or
    sgemm's), ``tc_fma`` (a convolution's fp32 FMAs done on the tensor
    cores in three TF32 passes, charged at the tf32x3 rate), ``exps``,
    ``philox_blocks`` (single-draw blocks whose four words all
    serve: a quarter block per draw of K1, K2b, K2c and K4), ``inv_terms``,
    ``knuth_rounds`` and ``windows``
    (placed elements / 69632, the [136, 512] window). Returns each term and
    the total."""
    def rate(name):
        r = rates[name]
        return r["rate"] if isinstance(r, dict) else r

    t = {"conv_ms": counts.get("conv_fma", 0) / max(rate("fma"),
                                                    rate("sgemm"))
         + (counts["tc_fma"] / rate("tf32x3") if counts.get("tc_fma")
            else 0.0),
         "sampler_ms": counts.get("exps", 0) / rate("exp")
         + counts.get("philox_blocks", 0) / rate("uniform_block")
         + counts.get("inv_terms", 0) / rate("inv_term")
         + counts.get("knuth_rounds", 0) / rate("knuth_round"),
         "placement_ms": counts.get("windows", 0) / rate("place_add")}
    t = {k: 1e3 * v for k, v in t.items()}
    t["total_ms"] = sum(t.values())
    return t


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' checks the plain "
                         "versions' shapes only")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        for name, (run, _, units) in calls("cpu").items():
            run(UNROLL)
            print(f"{name:14s} plain version ran ({units} units per rep); "
                  "not a rate of any card")
        return 0
    print("card (name, power limit, sm clock, max sm clock):", _card())
    rates = primitive_rates(args.device)
    for name, r in rates.items():
        print(f"{name:14s} {r['rate']:.4e} per s  ({r['reps']} reps, "
              f"{r['ms']:.3f} ms)")
    print("after timing:", _card())
    print("PRIMITIVE_RATES " + json.dumps(rates))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Poisson samplers: CUDA kernels K2b / K2c and their plain versions.

Port of ``rescan_line_sted_tpu/kernels/poisson_pallas.py``. The device
sampler K2a (``csrc/poisson.cuh``) keeps the TPU sampler's tiers and
bounds; K1 calls it per camera frame element, K2b (``poisson_rows_tiered``)
runs it standalone over ``[rows, cols]``, and K2c (``poisson_flat``) runs
the flat Knuth + PTRS sampler over any shape.

Dispatch: a CUDA tensor launches the kernel (or raises); a CPU tensor takes
the plain version, ``torch.poisson`` on the clamped rate. Rates are clamped
at 0 and NaN rates give NaN counts on both routes. The kernels draw their
two Philox key words from ``generator``; the plain version draws from it
directly, so the two routes give different (equally distributed) counts.

``poisson_rows_tiered_reference`` is K2b (or, with ``flat=True``, K2c) draw
for draw below the bright tier: numpy Philox4x32-10 on the kernel's
counters, the kernel's uniforms and tiers, and the plain quantile function,
so a card run can be checked count by count.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from rescan_line_sted_torch.kernels import _build

_CUT = 10.0
# CDF-inversion tier ladder of K2a: (upper rate bound, CDF terms). Each
# cell's truncation P(Poisson(hi) > kmax) stays under 5e-5.
_INV_TIERS = ((0.1, 3), (0.33, 4), (0.85, 6), (1.5, 8), (_CUT, 24))


def poisson_reference(lam: torch.Tensor,
                      generator: torch.Generator | None = None
                      ) -> torch.Tensor:
    """Plain version of every sampler: ``torch.poisson(clamp(lam, 0))``
    with NaN rates propagated (``torch.poisson`` itself rejects them).
    Like the kernels' counts, the draws carry no gradient."""
    lam = lam.detach().clamp_min(0.0)
    nan = torch.isnan(lam)
    counts = torch.poisson(torch.where(nan, 0.0, lam), generator=generator)
    return torch.where(nan, lam, counts)


def inversion_from_uniform(u: torch.Tensor, lam: torch.Tensor,
                           kmax: int) -> torch.Tensor:
    """Plain version of K2a's inversion tiers: the Poisson quantile
    ``N(u) = #{k < kmax : u > F(k)}`` in float32, excess mass on kmax."""
    term = torch.exp(-lam)
    cdf = term
    n = torch.zeros_like(lam)
    for k in range(kmax):
        n = n + (u > cdf).to(lam.dtype)
        if k + 1 < kmax:
            term = term * (lam * (1.0 / (k + 1)))
            cdf = cdf + term
    return n


def philox4x32_10(ctr: np.ndarray, key: tuple[int, int]) -> np.ndarray:
    """Philox4x32-10 (``csrc/philox.cuh``) of uint32 counters ``ctr``
    [n, 4] under the two key words; returns the [n, 4] uint32 blocks."""
    mask = np.uint64(0xFFFFFFFF)
    x0, x1, x2, x3 = (ctr[:, i].astype(np.uint64) for i in range(4))
    k0, k1 = np.uint64(key[0]), np.uint64(key[1])
    for _ in range(10):
        p0 = np.uint64(0xD2511F53) * x0      # 32 x 32 bits: fits in 64
        p1 = np.uint64(0xCD9E8D57) * x2
        x0, x1, x2, x3 = ((p1 >> np.uint64(32)) ^ x1 ^ k0, p1 & mask,
                          (p0 >> np.uint64(32)) ^ x3 ^ k1, p0 & mask)
        k0 = (k0 + np.uint64(0x9E3779B9)) & mask
        k1 = (k1 + np.uint64(0xBB67AE85)) & mask
    return np.stack([x0, x1, x2, x3], axis=1).astype(np.uint32)


def single_draw_uniforms(n: int, key: tuple[int, int]) -> np.ndarray:
    """K2a's single-draw uniforms of global indices 0..n-1: index i takes
    word i % 4 of Philox(i // 4 (lo, hi), 0, 1), as
    ``(bits >> 9) * 2^-23 + 2^-24`` (exact in float32)."""
    group = np.arange((n + 3) // 4, dtype=np.uint64)
    ctr = np.stack([group & np.uint64(0xFFFFFFFF), group >> np.uint64(32),
                    np.zeros_like(group), np.ones_like(group)], axis=1)
    bits = philox4x32_10(ctr, key).reshape(-1)[:n]
    return ((bits >> 9).astype(np.float32) * np.float32(2.0 ** -23)
            + np.float32(2.0 ** -24))


_WARP = 128   # rates a warp tiers by: four per lane, 32 lanes


def warp_tiers(lam: torch.Tensor, flat: bool = False) -> torch.Tensor:
    """The max rate each element's warp tiers by, shaped as ``lam``: K2b's
    warp covers 128 adjacent columns of a row (the last one of a row
    ragged); K2c's (``flat``) 128 consecutive elements of the flattened
    tensor, across rows. NaN where the warp holds a NaN."""
    lam = lam.detach().clamp_min(0.0)
    cols = lam.numel() if flat or lam.ndim == 0 else lam.shape[-1]
    x = lam.reshape(-1, cols)
    mx = F.pad(x, (0, -cols % _WARP)).reshape(x.shape[0], -1, _WARP)
    mx = torch.where(torch.isnan(mx).any(-1), float("nan"), mx.amax(-1))
    return mx.repeat_interleave(_WARP, dim=1)[:, :cols].reshape(lam.shape)


def poisson_rows_tiered_reference(lam: torch.Tensor, key: tuple[int, int],
                                  flat: bool = False) -> torch.Tensor:
    """K2b's counts for Philox key words ``key`` (``_build.key_words`` of
    the generator K2b is given), on the host: one tier per 128 adjacent
    columns of a row (a warp of four columns per thread), from their max;
    with ``flat``, K2c's: one tier per 128 consecutive elements of the
    flattened tensor. Either way element i takes the single-draw uniform of
    its flat index i. Covers the zero,
    Bernoulli and inversion tiers; raises where a warp would take the
    bright tier (its Knuth / PTRS draws are checked by their statistics).
    The card's ``expf`` and CDF sums may differ from these by an ulp, so a
    count may differ by one where a uniform sits on a CDF boundary."""
    lam = lam.detach().to("cpu", torch.float32).clamp_min(0.0)
    cols = lam.numel() if flat or lam.ndim == 0 else lam.shape[-1]
    rows = lam.numel() // cols
    x = lam.reshape(rows, cols)
    mx = warp_tiers(x, flat)
    if bool((torch.isnan(mx) | (mx >= _CUT)).any()):
        raise ValueError("rates at or above the bright-tier cut (or NaN): "
                         "the kernel draws them with Knuth / PTRS")
    u = torch.from_numpy(single_draw_uniforms(rows * cols, key)).reshape(
        rows, cols)
    out = (u < x).to(torch.float32)                          # Bernoulli tier
    lo = 1e-3
    for hi, kmax in _INV_TIERS:
        tier = (mx >= lo) & (mx < hi)
        out = torch.where(tier, inversion_from_uniform(u, x, kmax), out)
        lo = hi
    return torch.where(mx > 0, out, 0.0).reshape(lam.shape)


def poisson_rows_tiered(lam: torch.Tensor,
                        generator: torch.Generator) -> torch.Tensor:
    """K2b: Poisson counts of ``lam`` [..., cols], sampler tier chosen per
    warp of 128 adjacent columns of a row (mostly-dark rows stay on cheap
    tiers). The key words come from ``generator`` by value, with no
    host-device sync and no kernel launch (``_build.key_words``), as K2c's
    do."""
    if not lam.is_cuda:
        return poisson_reference(lam, generator)
    _build.require_cuda_f32("poisson_rows_tiered", lam)
    cols = lam.shape[-1] if lam.ndim else 1
    rows = lam.numel() // max(cols, 1)
    out = torch.empty_like(lam)
    s0, s1, keys = _build.key_words(generator, lam.device)
    code = _build.lib().rls_poisson_rows_tiered(
        lam.data_ptr(), out.data_ptr(), rows, cols, s0, s1,
        None if keys is None else keys.data_ptr(),
        _build.stream_handle(lam.device))
    _build.check(code, "poisson_rows_tiered")
    _build.LAUNCHES["poisson_rows_tiered"] += 1
    return out


FLAT_THREADS = 256          # K2c's threads per block
# K2c gives each thread one element while four per thread would launch
# fewer than this many blocks per SM, and four from there on. Measured on
# an H100 (scripts/torch_k2b_k4_ab.py, PERF.md): below it one per thread
# runs bright groups' serial draws side by side (2.1x faster at 2^16
# bright rates, 1.25x at 2^18) and costs dim rates at most 1.4 us; above
# it the dim rates' Philox blocks, four times as many, cost 1.7-2.4x
ONE_PER_THREAD_BELOW = 2
GRID_PER_SM = 64            # K2c's grid cap: blocks per SM (grid-stride)


@functools.lru_cache(maxsize=256)
def flat_layout(n: int, sms: int, per_thread: int | None = None
                ) -> tuple[int, int]:
    """K2c's layout for ``n`` rates on a card of ``sms`` SMs: (elements per
    thread, blocks of ``FLAT_THREADS``). One element per thread below
    ``ONE_PER_THREAD_BELOW`` blocks of four per thread per SM, where four
    would leave SMs idle; four at and above it. ``per_thread`` (1 or 4)
    forces a layout. The grid never exceeds ``GRID_PER_SM`` blocks per SM;
    the kernels grid-stride over the rest. Cached: a caller's shapes
    repeat."""
    four = -(-n // (4 * FLAT_THREADS))
    if per_thread is None:
        per_thread = 1 if four < ONE_PER_THREAD_BELOW * sms else 4
    if per_thread not in (1, 4):
        raise ValueError(f"K2c: 1 or 4 elements per thread, not {per_thread}")
    blocks = four if per_thread == 4 else -(-n // FLAT_THREADS)
    return per_thread, max(1, min(blocks, GRID_PER_SM * sms))


def poisson_flat(lam: torch.Tensor, generator: torch.Generator | None = None,
                 key=None, _per_thread: int | None = None) -> torch.Tensor:
    """K2c: Poisson counts of ``lam`` (any shape), K2a's tiers per group of
    128 consecutive rates, one or four elements per thread
    (``flat_layout``; ``_per_thread`` forces one, for tests). The key words
    come from ``generator`` by value, with no host-device sync and no
    kernel launch (``_build.key_words``). ``key`` gives the two words
    instead (``_build.draw_key`` / ``offset_key``: a rank's stream; on the
    CPU the plain version draws from ``_build.key_generator(key)``); pass
    one of the two."""
    if (generator is None) == (key is None):
        raise ValueError("poisson_flat: pass a generator or key words")
    if not lam.is_cuda:
        return poisson_reference(lam, generator if key is None
                                 else _build.key_generator(key))
    _build.require_cuda_f32("poisson_flat", lam)
    dev = lam.device
    n = lam.numel()
    out = torch.empty_like(lam)
    s0, s1, keys = _build.key_words(generator, dev, key)
    per_thread, blocks = flat_layout(n, _build.sm_count(dev), _per_thread)
    code = _build.lib().rls_poisson_flat(
        lam.data_ptr(), out.data_ptr(), n, s0, s1,
        None if keys is None else keys.data_ptr(), per_thread, blocks,
        _build.stream_handle(dev))
    _build.check(code, "poisson_flat")
    _build.LAUNCHES["poisson_flat"] += 1
    return out

"""Port parity and statistics of the Poisson samplers.

On the CPU every sampler runs its plain version (``torch.poisson`` on the
clamped rate); the inversion tiers of the device sampler K2a are checked
through their plain quantile function against the JAX package's on a
deterministic grid of uniforms. K2b's host reference (numpy Philox on the
kernel's counters, the kernel's tiers) is held to the Random123 known
answers and to the Poisson pmf here, and to K2b count by count on the card
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from rescan_line_sted_torch.kernels import _build
from rescan_line_sted_torch.kernels.poisson import (
    _INV_TIERS,
    FLAT_THREADS,
    GRID_PER_SM,
    ONE_PER_THREAD_BELOW,
    flat_layout,
    inversion_from_uniform,
    philox4x32_10,
    poisson_flat,
    poisson_reference,
    poisson_rows_tiered,
    poisson_rows_tiered_reference,
    single_draw_uniforms,
    warp_tiers,
)
from rescan_line_sted_torch.physics.noise import maybe_poisson, poisson_counts
from rescan_line_sted_tpu.kernels.poisson_pallas import (
    _INV_TIERS as J_INV_TIERS,
    _inversion_from_uniform as j_inversion,
)

torch.set_num_threads(1)
SAMPLERS = [poisson_reference, poisson_rows_tiered, poisson_flat,
            lambda lam, g: poisson_counts(g, lam)]
SAMPLER_IDS = ["reference", "rows_tiered", "flat", "poisson_counts"]


@pytest.mark.parametrize("lam_val,kmax", [
    (0.05, 3), (0.29, 4), (0.7, 6), (1.2, 8), (7.0, 24)])
def test_inversion_matches_jax(lam_val, kmax):
    """Same uniforms, same rates: the port's quantile function gives the
    JAX package's counts. The two may differ only where a uniform sits on
    an f32 CDF boundary (a 1-ulp difference in exp or the CDF sum); those
    ties are counted and bounded."""
    m = 400_000
    u = (np.arange(m, dtype=np.float32) + 0.5) / m
    lam = np.full((m,), lam_val, np.float32)
    want = np.asarray(j_inversion(jnp.asarray(u), jnp.asarray(lam), kmax))
    got = inversion_from_uniform(torch.from_numpy(u), torch.from_numpy(lam),
                                 kmax).numpy()
    diff = np.nonzero(got != want)[0]
    assert diff.size <= 4, diff.size
    assert (np.abs(got[diff] - want[diff]) <= 1).all()
    assert got.min() >= 0 and got.max() <= kmax
    pmf = stats.poisson.pmf(np.arange(kmax + 1), lam_val)
    pmf[kmax] += stats.poisson.sf(kmax, lam_val)
    obs = np.bincount(got.astype(np.int64), minlength=kmax + 1) / m
    np.testing.assert_allclose(obs, pmf, atol=1e-4)


def test_inv_tier_budget():
    """The port keeps the JAX ladder, and every cell's truncation
    P(Poisson(hi) > kmax) stays under the 5e-5 budget."""
    assert _INV_TIERS == J_INV_TIERS
    for hi, kmax in _INV_TIERS:
        assert stats.poisson.sf(kmax, hi) < 5e-5, (hi, kmax)


# Random123's known-answer vectors for philox4x32-10: counter, key, output
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", PHILOX_KAT)
def test_philox_known_answers(ctr, key, want):
    got = philox4x32_10(np.array([ctr], np.uint32), key)[0]
    assert tuple(int(v) for v in got) == want


@pytest.mark.parametrize("lam_val,kmax", [
    (5e-4, 1), (0.05, 3), (0.29, 4), (0.7, 6), (1.2, 8), (7.0, 24)])
def test_rows_tiered_reference_statistics(lam_val, kmax):
    """K2b's host reference at one rate per single-draw tier: counts
    capped at the tier's kmax, mean within 5 sigma, chi-square against
    the pmf truncated at kmax (tail mass on kmax)."""
    n = 1 << 17
    x = poisson_rows_tiered_reference(torch.full((256, n // 256), lam_val),
                                      (11, int(lam_val * 1000))).numpy()
    assert x.min() >= 0 and x.max() <= kmax and (x == np.round(x)).all()
    assert abs(x.mean() - lam_val) <= 5 * np.sqrt(lam_val / n)
    pmf = stats.poisson.pmf(np.arange(kmax + 1), lam_val)
    pmf[kmax] += stats.poisson.sf(kmax, lam_val)
    obs = np.bincount(x.astype(np.int64).ravel(), minlength=kmax + 1)
    exp = pmf * n
    keep = exp > 5
    chi2 = ((obs[keep] - exp[keep]) ** 2 / exp[keep]).sum()
    assert stats.chi2.sf(chi2, max(keep.sum() - 1, 1)) > 1e-4


def test_rows_tiered_reference_tiers():
    """Zero and negative warps give 0; a warp's tier comes from the max of
    its 128 adjacent columns of a row, so one bright lane lifts the other
    127, in other 32-column groups too; the ragged last warp of a row
    (301 columns: 45, not a multiple of four) tiers by its own max; the
    bright tier and NaN are refused (K2b draws them with Knuth / PTRS)."""
    lam = torch.zeros((4, 301))
    lam[1] = -0.3
    lam[2] = 0.5
    lam[2, 100] = 1.4              # first warp of row 2: kmax 8, not 6
    lam[2, 290] = 1.2              # the ragged last warp: kmax 8
    x = poisson_rows_tiered_reference(lam, (5, 6))
    assert x.shape == lam.shape and (x[:2] == 0).all() and (x[3] == 0).all()
    u = torch.from_numpy(single_draw_uniforms(lam.numel(), (5, 6)))
    u = u.reshape(lam.shape)
    for lo, hi, kmax in ((0, 128, 8), (128, 256, 6), (256, 301, 8)):
        assert torch.equal(x[2, lo:hi], inversion_from_uniform(
            u[2, lo:hi], lam[2, lo:hi], kmax)), (lo, hi)
    mx = warp_tiers(lam)
    assert (mx[2, :128] == 1.4).all() and (mx[2, 128:256] == 0.5).all() \
        and (mx[2, 256:] == 1.2).all()
    for bad in (10.0, float("nan")):
        lam[3, 3] = bad
        with pytest.raises(ValueError, match="bright"):
            poisson_rows_tiered_reference(lam, (5, 6))


@pytest.mark.parametrize("cols", [1, 3, 5, 130])
def test_rows_tiered_reference_ragged_rows(cols):
    """K2b's warps on rows that are not a multiple of four (or of 128)
    columns: each row's warps hold only its own columns, and every element
    keeps the single-draw uniform of its flat index, so a row that starts
    inside a Philox block takes the block's remaining words."""
    rows = 7
    lam = 0.05 + 0.1 * torch.arange(rows * cols, dtype=torch.float32
                                    ).reshape(rows, cols) / (rows * cols)
    lam[3, cols // 2] = 1.2        # row 3's first warp: kmax 8
    x = poisson_rows_tiered_reference(lam, (7, 8))
    u = torch.from_numpy(single_draw_uniforms(rows * cols, (7, 8)))
    u = u.reshape(rows, cols)
    mx = warp_tiers(lam)
    for r in range(rows):
        for lo in range(0, cols, 128):
            hi = min(lo + 128, cols)
            top = float(lam[r, lo:hi].max())
            assert (mx[r, lo:hi] == top).all()
            kmax = next(k for h, k in _INV_TIERS if top < h)
            assert torch.equal(x[r, lo:hi], inversion_from_uniform(
                u[r, lo:hi], lam[r, lo:hi], kmax)), (r, lo)


@pytest.mark.parametrize("shape", [(3, 100), (300,), (2, 3, 50)])
def test_flat_reference_tiers(shape):
    """K2c's host reference (``flat=True``): one tier per 128 consecutive
    elements of the flattened tensor whatever its shape, the last group
    ragged, the uniforms those of the flat index."""
    flat = torch.full((300,), 0.5)
    flat[130] = 1.4                # second warp: kmax 8, the others 6
    flat[260:] = 0.0               # a ragged last warp of zeros
    lam = flat.reshape(shape)
    x = poisson_rows_tiered_reference(lam, (5, 6), flat=True)
    assert x.shape == lam.shape
    x = x.reshape(-1)
    u = torch.from_numpy(single_draw_uniforms(300, (5, 6)))
    assert torch.equal(x[:128], inversion_from_uniform(u[:128], flat[:128],
                                                       6))
    assert torch.equal(x[128:256], inversion_from_uniform(
        u[128:256], flat[128:256], 8))
    assert torch.equal(x[256:260], inversion_from_uniform(
        u[256:260], flat[256:260], 6))
    assert (x[260:] == 0).all()
    mx = warp_tiers(lam, flat=True).reshape(-1)
    assert (mx[:128] == 0.5).all() and (mx[128:256] == 1.4).all() \
        and (mx[256:] == 0.5).all()
    flat[299] = float("nan")
    assert torch.isnan(warp_tiers(flat, flat=True)[256:]).all()
    with pytest.raises(ValueError, match="bright"):
        poisson_rows_tiered_reference(flat, (5, 6), flat=True)


def test_rows_and_flat_warps_differ():
    """K2b and K2c both tier 128 rates per warp, but K2b's warps stop at a
    row's end and K2c's run across rows: a bright rate lifts only its own
    row in K2b, and the next row's first columns in K2c."""
    lam = torch.full((3, 100), 0.2)
    lam[0, 5] = 1.0
    lam[1, 99] = 1.2
    rows = warp_tiers(lam)
    flat = warp_tiers(lam, flat=True)
    assert (rows[0] == 1.0).all() and (rows[1] == 1.2).all() \
        and (rows[2] == 0.2).all()
    flat = flat.reshape(-1)
    assert (flat[:128] == 1.0).all() and (flat[128:256] == 1.2).all() \
        and (flat[256:] == 0.2).all()


def test_key_words_from_a_cpu_generator():
    """A CPU generator gives the kernels their key words by value, the two
    31-bit words ``torch.randint`` draws from it; no tensor is left for the
    kernel to read. No generator (a noise-free call) gives zeros."""
    got = _build.key_words(torch.Generator().manual_seed(3), "cpu")
    want = torch.randint(0, 2**31 - 1, (2,),
                         generator=torch.Generator().manual_seed(3))
    assert got == (*want.tolist(), None)
    assert _build.key_words(None, "cpu") == (0, 0, None)


def test_key_mix_words_are_in_range_and_distinct():
    """A CUDA generator's words come from its seed and its offset / 4 by a
    fixed mix: every word in [0, KEY_MOD), the pairs distinct over 10^5
    (seed, counter) pairs (small and full 64-bit seeds), and distinct again
    for ranks 0-7 under ``offset_key`` (a rank's stream)."""
    seeds = [*range(300), *(2**64 - 1 - k for k in range(50)),
             *(0x5DEECE66D * k for k in range(1, 51))]
    words = [_build.mix_words(s, c) for s in seeds for c in range(250)]
    assert len(words) == 100_000
    assert all(0 <= w < _build.KEY_MOD for k in words for w in k)
    assert len(set(words)) == len(words)
    ranked = {_build.offset_key(k, r) for k in words for r in range(8)}
    assert len(ranked) == 8 * len(words)
    assert _build.mix_words(7, 3) == _build.mix_words(7 + 2**64, 3)


class _OffsetGenerator:
    """A CUDA generator's Philox state as ``generator_words`` reads it."""

    def __init__(self, seed, offset=0):
        self.seed, self.offset = seed, offset

    def initial_seed(self):
        return self.seed

    def get_offset(self):
        return self.offset

    def set_offset(self, offset):
        assert offset % 4 == 0
        self.offset = offset


def test_generator_words_advance_the_offset():
    """Each call takes the words of (seed, offset / 4) and advances the
    offset by 4, so consecutive calls differ; a restored offset gives the
    same words again, and another seed other words."""
    gen = _OffsetGenerator(1234, offset=8)
    first = [_build.generator_words(gen) for _ in range(5)]
    assert gen.offset == 8 + 4 * 5
    assert first == [_build.mix_words(1234, 2 + k) for k in range(5)]
    assert len(set(first)) == 5
    gen.set_offset(8)
    assert [_build.generator_words(gen) for _ in range(5)] == first
    other = _OffsetGenerator(1235, offset=8)
    assert _build.generator_words(other) != first[0]


@pytest.mark.parametrize("sms", [132, 114, 1])
def test_flat_layout_threshold_and_cap(sms):
    """K2c's layout: one element per thread while four per thread would
    give fewer than ONE_PER_THREAD_BELOW blocks per SM, four from there
    on; the grid covers n in one pass until it reaches its cap of
    GRID_PER_SM blocks per SM, and never exceeds it."""
    last = (ONE_PER_THREAD_BELOW * sms - 1) * 4 * FLAT_THREADS
    cap = GRID_PER_SM * sms
    for n in (1, 255, 256, 257, 65536 % last + 1, last // 2, last):
        per, blocks = flat_layout(n, sms)
        assert per == 1 and 1 <= blocks <= cap
        assert blocks == min(-(-n // FLAT_THREADS), cap)
    for n in (last + 1, last + 4 * FLAT_THREADS, 2048 * 3072,
              4 * 2048 * 2048, 2**31 + 5):
        per, blocks = flat_layout(n, sms)
        assert per == 4 and 1 <= blocks <= cap
        assert blocks == min(-(-n // (4 * FLAT_THREADS)), cap)


@pytest.mark.parametrize("per_thread", [1, 4])
@pytest.mark.parametrize("n", [1, 1000, 65536, 2048 * 3072, 2**33])
def test_flat_layout_forced(per_thread, n):
    """A forced layout keeps its elements per thread at any n, under the
    same cap; 0 elements still launch one block; other layouts raise."""
    per, blocks = flat_layout(n, 132, per_thread)
    assert per == per_thread and 1 <= blocks <= GRID_PER_SM * 132
    assert blocks == min(-(-n // (per_thread * FLAT_THREADS)),
                         GRID_PER_SM * 132)
    assert flat_layout(0, 132, per_thread) == (per_thread, 1)
    with pytest.raises(ValueError, match="per thread"):
        flat_layout(n, 132, 2)


@pytest.mark.parametrize("lam_val", [0.05, 0.7, 5.0, 30.0, 300.0])
def test_plain_sampler_statistics(lam_val):
    n = 200_000
    x = poisson_reference(torch.full((n,), lam_val),
                          torch.Generator().manual_seed(int(lam_val * 7)))
    v = x.double().numpy()
    assert (v == np.round(v)).all() and (v >= 0).all()
    assert abs(v.mean() - lam_val) <= 5 * np.sqrt(lam_val / n)
    assert abs(v.var() - lam_val) <= 5 * np.sqrt((lam_val + 2 * lam_val ** 2)
                                                 / n)
    lo = max(0, int(lam_val - 6 * np.sqrt(lam_val) - 3))
    hi = int(lam_val + 6 * np.sqrt(lam_val) + 5)
    obs, _ = np.histogram(v, bins=np.arange(lo, hi + 2) - 0.5)
    exp = stats.poisson.pmf(np.arange(lo, hi + 1), lam_val) * n
    keep = exp > 5
    chi2 = ((obs[keep] - exp[keep]) ** 2 / exp[keep]).sum()
    assert stats.chi2.sf(chi2, keep.sum() - 1) > 1e-4


@pytest.mark.parametrize("sampler", SAMPLERS, ids=SAMPLER_IDS)
def test_zero_negative_and_nan(sampler):
    lam = torch.tensor([[0.0, -0.5, 3.0], [float("nan"), 12.0, -0.0]])
    x = sampler(lam, torch.Generator().manual_seed(1))
    assert x.shape == lam.shape and x.dtype == torch.float32
    assert x[0, 0] == 0 and x[0, 1] == 0 and x[1, 2] == 0
    assert torch.isnan(x[1, 0]) and int(torch.isnan(x).sum()) == 1


@pytest.mark.parametrize("sampler", SAMPLERS, ids=SAMPLER_IDS)
def test_determinism_under_generator(sampler):
    lam = torch.rand((37, 19), generator=torch.Generator().manual_seed(0)) * 8
    a = sampler(lam, torch.Generator().manual_seed(5))
    b = sampler(lam, torch.Generator().manual_seed(5))
    c = sampler(lam, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_cpu_tensors_launch_nothing():
    _build.reset_launches()
    lam = torch.full((8, 8), 2.0)
    poisson_rows_tiered(lam, torch.Generator())
    poisson_flat(lam, torch.Generator())
    assert all(v == 0 for v in _build.LAUNCHES.values())


def test_maybe_poisson_passthrough():
    mean = torch.rand(5, 6)
    assert maybe_poisson(None, mean) is mean
    x = maybe_poisson(torch.Generator().manual_seed(0), 40.0 * mean)
    assert torch.equal(x, x.round()) and x.shape == mean.shape


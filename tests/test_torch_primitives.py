"""K6's plain versions (``kernels/primitives.py``) against the JAX package's
microkernel bodies (``scripts/perf_vpu_bound.py``), and the composite bound.

The fma, exp, roll_add and mxu bodies run through ``pl.pallas_call(...,
interpret=True)`` with ``_bench``'s grid spec on a small grid (the scratch
carries the chain across grid steps, so a grid of G runs G * reps steps).
The uniform, inv_term and knuth_round bodies seed the TPU's hardware PRNG,
which interpret mode cannot run on the CPU: each is held against a numpy
transcription of its body fed the card's Philox stream, the transcription
using the TPU's ``_uniform`` bit recipe on words from
``kernels.poisson.philox4x32_10`` (uniform_block: the uniform body with all
four words of each block). Deterministic chains agree to 1e-6 relative
(the matrix product to 1e-5), the Philox chains exactly.
"""

import functools
import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from rescan_line_sted_torch.kernels import _build
from rescan_line_sted_torch.kernels import primitives as prim
from rescan_line_sted_torch.kernels.poisson import philox4x32_10

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "perf_vpu_bound", os.path.join(ROOT, "scripts", "perf_vpu_bound.py"))
pvb = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(pvb)
KEY = (1234567, 7654321)


def _jax_body(kernel, reps, scratches, grid, out_shape=None):
    """A body of ``perf_vpu_bound`` under ``_bench``'s grid spec, in
    interpret mode on the CPU."""
    out_shape = out_shape or (pvb.ROWS, pvb.COLS)
    f = pl.pallas_call(
        functools.partial(kernel, reps=reps),
        out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(grid,), in_specs=[],
            out_specs=pl.BlockSpec(out_shape, lambda i, s: (0, 0),
                                   memory_space=pltpu.VMEM),
            scratch_shapes=[pltpu.VMEM(s, jnp.float32) for s in scratches]),
        interpret=True)
    return np.asarray(f(jnp.asarray([3, 4], jnp.int32)))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _tpu_uniform(bits):
    """``perf_vpu_bound._uniform`` on raw 32-bit words, in numpy."""
    small = (bits >> np.uint32(9)).astype(np.int32)
    return small.astype(np.float32) * np.float32(1.0 / (1 << 23)) \
        + np.float32(0.5 / (1 << 23))


def _single_draw_bits(n):
    """The single-draw stream's words, index i: word i % 4 of Philox(i //
    4, 0, 0, 1)."""
    g = np.arange((n + 3) // 4, dtype=np.uint64)
    ctr = np.stack([g, np.zeros_like(g), np.zeros_like(g),
                    np.ones_like(g)], 1)
    return philox4x32_10(ctr, KEY).reshape(-1)[:n]


@pytest.mark.parametrize("grid,reps", [(1, 16), (2, 16)])
@pytest.mark.parametrize("body", ["fma", "exp"])
def test_chains_match_jax_body(body, grid, reps):
    kernel = {"fma": pvb._k_fma, "exp": pvb._k_exp}[body]
    want = _jax_body(kernel, reps, [(pvb.ROWS, pvb.COLS)], grid)
    out = torch.empty(pvb.ROWS * pvb.COLS)
    got = getattr(prim, body)(out, grid * reps).reshape(pvb.ROWS, pvb.COLS)
    assert _rel(got, want) <= 1e-6


@pytest.mark.parametrize("grid,reps", [(1, 16), (2, 24)])
def test_place_add_matches_jax_roll_add(grid, reps):
    """The TPU body adds its constant window at the 8-aligned base ``8 i mod
    2944`` (the roll of a constant window is the window itself), with ``i``
    restarting at every grid step: the same offsets through place_add."""
    want = _jax_body(pvb._k_roll_add, reps, [(pvb.W_PAD, pvb.COLS)], grid,
                     (3080, pvb.COLS))
    offsets = torch.tensor([(8 * i) % (3080 - pvb.W_PAD)
                            for _ in range(grid) for i in range(reps)])
    canvas = torch.zeros((1, prim.CANVAS_ROWS, prim.COLS))
    window = torch.full((prim.WIN_ROWS, prim.COLS), 1e-6)
    got = prim.place_add(canvas, window, offsets)[0]
    assert _rel(got, want) <= 1e-6
    assert float(got[:8].sum()) > 0 and float(got[-8:].abs().sum()) == 0


def test_sgemm_matches_jax_mxu():
    """The TPU body's first 128 rows of ``sum_i A (B + i 1e-9)`` with A =
    0.01 and B = 0.02, one grid step of 3 reps: 1e-5, the port's parity
    bar, since the body sums its 384 products in float32 (1.2e-6 off the
    exact sum here) and the plain version in float64."""
    want = _jax_body(pvb._k_mxu, 3,
                     [(4096, 128), (128, pvb.COLS), (4096, pvb.COLS)], 1)
    a = torch.full((4096, 128), 0.01)
    b = torch.full((128, pvb.COLS), 0.02)
    assert _rel(prim.sgemm(a, b, 3)[:128], want) <= 1e-5


def test_tf32x3_matches_jax_mxu():
    """The tensor-core body (three TF32 passes) computes the TPU matrix
    body's product: its plain version (what a CPU tensor runs) against
    ``_k_mxu`` as for sgemm."""
    want = _jax_body(pvb._k_mxu, 3,
                     [(4096, 128), (128, pvb.COLS), (4096, pvb.COLS)], 1)
    a = torch.full((4096, 128), 0.01)
    b = torch.full((128, pvb.COLS), 0.02)
    assert _rel(prim.tf32x3(a, b, 3)[:128], want) <= 1e-5


def test_sgemm_reference_sums_the_perturbed_products():
    g = torch.Generator().manual_seed(1)
    a, b = torch.rand((128, 16), generator=g), torch.rand((16, 128),
                                                          generator=g)
    want = sum(a.double() @ (b.double() + r * 1e-9) for r in range(5))
    assert _rel(prim.sgemm(a, b, 5), want) <= 1e-6


@pytest.mark.parametrize("name,shape", [
    ("sgemm", (100, 8, 128)), ("sgemm", (128, 8, 64)),
    ("sgemm", (128, 12, 128)), ("sgemm", (128, 136, 128)),
    ("tf32x3", (64, 128, 128)), ("tf32x3", (128, 128, 192)),
    ("tf32x3", (128, 40, 128)), ("tf32x3", (128, 8, 128)),
    ("tf32x3", (128, 160, 128))])
def test_product_shapes_the_tiles_refuse(name, shape):
    """Both product kernels take 128 x 128 tiles of C with K resident in
    shared memory: sgemm K % 8 zero up to 128, tf32x3 K in TMA slices of
    32 up to 128. Other shapes raise on every device."""
    m, k, n = shape
    with pytest.raises(ValueError, match=name):
        getattr(prim, name)(torch.ones((m, k)), torch.ones((k, n)), 1)


@pytest.mark.parametrize("name", ["sgemm", "tf32x3"])
@pytest.mark.parametrize("shape", [prim.GEMM_SHAPE, (256, 64, 128),
                                   (128, 32, 128)])
def test_product_shapes_the_tiles_take(name, shape):
    """GEMM_SHAPE and the card test's [256, 64] x [64, 128] are taken; on
    a CPU tensor the wrapper gives its plain version."""
    m, k, n = shape
    a, b = prim.normal_operands(m, k, n, seed=5)
    got = getattr(prim, name)(a, b, 2)
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert torch.equal(got, prim.sgemm_reference(a, b, 2))


@pytest.mark.parametrize("values", ["normal", "eighths", "tiny", "wide"])
def test_tf32_split_matches_numpy_bit_masks(values):
    """``tf32_split`` is the kernels' split, bit for bit: x_hi = x &
    0xffffe000 and x_lo = (x - x_hi) & 0xffffe000 as numpy computes them on
    the float32 bits (subnormals, negatives and magnitudes across the
    exponent range included), and hi + lo recovers x to 2^-21 of |x| (to
    2^-136 among the subnormals, whose split drops 13 bits of 2^-149)."""
    rng = np.random.default_rng(7)
    x = {"normal": rng.standard_normal(4096),
         "eighths": rng.integers(-64, 64, 4096) / 8,
         "tiny": rng.standard_normal(4096) * 1e-39,
         "wide": rng.standard_normal(4096) * 10.0 ** rng.integers(
             -30, 30, 4096)}[values].astype(np.float32)
    hi, lo = prim.tf32_split(torch.from_numpy(x))
    mask = np.uint32(0xFFFFE000)
    want_hi = (x.view(np.uint32) & mask).view(np.float32)
    want_lo = ((x - want_hi).view(np.uint32) & mask).view(np.float32)
    assert np.array_equal(hi.numpy().view(np.uint32), want_hi.view(np.uint32))
    assert np.array_equal(lo.numpy().view(np.uint32), want_lo.view(np.uint32))
    rest = np.abs(x.astype(np.float64) - hi.double().numpy()
                  - lo.double().numpy())
    assert np.all(rest <= np.maximum(
        2.0 ** -21 * np.abs(x.astype(np.float64)), 2.0 ** -136))


@pytest.mark.parametrize("reps", prim.NORMAL_REPS)
@pytest.mark.parametrize("shape", prim.NORMAL_SHAPES)
def test_tf32_passes_on_normal_operands(shape, reps):
    """On the card checks' normal operands the three TF32 passes
    (hi * hi + hi * lo + lo * hi, as the kernel splits) hold
    ``NORMAL_TOL`` against the float64 product and one pass (hi * hi)
    misses it: the check the card runs can tell the passes apart."""
    a, b = prim.normal_operands(*shape)
    want = prim.product_float64(a, b, reps)
    assert _rel(prim.tf32_passes_reference(a, b, reps, 3), want) \
        <= prim.NORMAL_TOL / 10
    assert _rel(prim.tf32_passes_reference(a, b, reps, 1), want) \
        > 10 * prim.NORMAL_TOL


def test_one_tf32_pass_holds_the_eighths():
    """The rate calls' operands are eighths, exact in TF32's high part, and
    their perturbation is below an ulp of the products: one TF32 pass
    holds ``CHECKS``' tolerance there, so those checks alone could not
    see a tf32x3 whose lo passes were wrong (hence the normal operands)."""
    m, k, n = 256, 64, 128
    g = torch.Generator().manual_seed(0)
    a = torch.randint(0, 8, (m, k), generator=g) / 8
    b = torch.randint(0, 8, (k, n), generator=g) / 8
    reps, tol = prim.CHECKS["tf32x3"]
    assert _rel(prim.tf32_passes_reference(a, b, reps, 1),
                prim.product_float64(a, b, reps)) <= tol


def test_uniform_matches_body_transcription():
    """``_k_uniform``: x += _uniform() UNROLL times per step, one fresh word
    per element and draw (draw r of element i: single-draw index r n + i)."""
    n, reps = 300, 32
    u = _tpu_uniform(_single_draw_bits(n * reps)).reshape(reps, n)
    x = np.zeros(n, np.float32)
    for r in range(reps):
        x = x + u[r]
    got = prim.uniform(torch.empty(n), reps, KEY)
    assert np.array_equal(got.numpy(), x)


def test_uniform_block_matches_body_transcription():
    """``_k_uniform`` with every word of a block: x += _uniform() for the
    four words of block r n + i of the single-draw stream, in word order."""
    n, reps = 300, 16
    words = _single_draw_bits(4 * n * reps).reshape(reps, n, 4)
    x = np.zeros(n, np.float32)
    for r in range(reps):
        for w in range(4):
            x = x + _tpu_uniform(words[r, :, w])
    got = prim.uniform_block(torch.empty(n), reps, KEY)
    assert np.array_equal(got.numpy(), x)


def test_inv_term_matches_body_transcription():
    """``_k_inv_term`` on one grid step: u drawn once per element, lam =
    0.3, term = cdf = 0.7; per unrolled term k: n += u > cdf, term *= lam
    / (k + 1), cdf += term; out = n + cdf."""
    n, reps = 500, 48
    u = _tpu_uniform(_single_draw_bits(n))
    lam = np.full(n, 0.3, np.float32)
    term = np.full(n, 0.7, np.float32)
    cdf = np.full(n, 0.7, np.float32)
    cnt = np.zeros(n, np.float32)
    for _ in range(reps // pvb.UNROLL):
        for k in range(pvb.UNROLL):
            cnt = cnt + (u > cdf).astype(np.float32)
            term = term * (lam * np.float32(1.0 / (k + 1)))
            cdf = cdf + term
    got = prim.inv_term(torch.empty(n), reps, KEY)
    assert _rel(got, cnt + cdf) <= 1e-6
    assert float((got - torch.from_numpy(cdf)).max()) >= 1.0   # counts


def test_knuth_round_matches_body_transcription():
    """``_k_knuth_round``: prod *= u, small += prod >= exp(-0.3), one fresh
    uniform per round, here from the sampler's multi-draw stream (draw t
    of element i: word t % 4 of Philox(i, 0, t // 4, 0)); out = small +
    prod."""
    n, reps = 200, 32
    t = np.arange(reps // 4, dtype=np.uint64)
    i = np.arange(n, dtype=np.uint64)
    ctr = np.stack(np.broadcast_arrays(i[None, :], np.uint64(0), t[:, None],
                                       np.uint64(0)), -1).reshape(-1, 4)
    words = philox4x32_10(ctr, KEY).reshape(reps // 4, n, 4)
    u = _tpu_uniform(words.transpose(0, 2, 1).reshape(reps, n))
    thr = np.full(n, np.exp(-0.3), np.float32)
    prod = np.ones(n, np.float32)
    small = np.zeros(n, np.float32)
    for r in range(reps):
        prod = prod * u[r]
        small = small + (prod >= thr).astype(np.float32)
    got = prim.knuth_round(torch.empty(n), reps, KEY)
    assert np.array_equal(got.numpy(), small + prod)
    assert float(got.max()) >= 1.0


def test_counts_and_composite_bound():
    """Sampler counts per element at its own tier (Knuth's rounds until
    the count is settled, in expectation; a bright element's one PTRS
    attempt), and the composite bound
    as the sum of counts over rates, on hand-made numbers: the convolution
    at the faster FFMA rate, Philox blocks (a quarter per single draw) at
    the ``uniform_block`` rate."""
    lam = torch.tensor([0.0, -1.0, 5e-4, 0.05, 0.2, 0.5, 1.0, 3.0, 12.0,
                        float("nan")])
    c = prim.tiered_counts(lam)
    assert c == {"uniforms": 6, "exps": 6, "inv_terms": 3 + 4 + 6 + 8 + 24,
                 "knuth_rounds": 2}
    k = prim.knuth_counts(lam)
    assert k["exps"] == 7 and k["inv_terms"] == 0
    assert math.isclose(k["knuth_rounds"], 6 + (5e-4 + 0.05 + 0.2 + 0.5
                                                + 1.0 + 3.0) + 2, rel_tol=1e-6)
    assert math.isclose(prim.knuth_counts(torch.tensor([30.0, 9.9, 40.0]))[
        "knuth_rounds"], 10.9 + 2 * 2, rel_tol=1e-6)
    rates = {"fma": 1e12, "sgemm": 2e12, "uniform": 1e11,
             "uniform_block": 5e10, "exp": 2e11, "inv_term": 4e11,
             "knuth_round": {"rate": 5e10}, "place_add": 1e6}
    counts = {"conv_fma": 4e9, "exps": 1e8, "philox_blocks": 2.5e7,
              "inv_terms": 8e8, "knuth_rounds": 5e7, "windows": 3000}
    t = prim.composite_bound(counts, rates)
    assert math.isclose(t["conv_ms"], 2.0)
    assert math.isclose(t["sampler_ms"], 0.5 + 0.5 + 2.0 + 1.0)
    assert math.isclose(t["placement_ms"], 3.0)
    assert math.isclose(t["total_ms"], 9.0)
    rates["fma"] = 4e12
    assert math.isclose(prim.composite_bound(counts, rates)["conv_ms"], 1.0)
    # a convolution on the tensor cores: its FMAs at the tf32x3 rate
    rates["tf32x3"] = {"rate": 8e12}
    tc = prim.composite_bound(dict(counts, conv_fma=0, tc_fma=4e10), rates)
    assert math.isclose(tc["conv_ms"], 5.0)
    assert math.isclose(tc["total_ms"], 5.0 + 4.0 + 3.0)


def _chain_plain(name, n, reps):
    """A chain's plain version at the checks' constants."""
    key = (2024, 77)
    return {
        "fma": lambda: prim.fma_reference(n, reps),
        "uniform": lambda: prim.uniform_reference(n, reps, key),
        "uniform_block": lambda: prim.uniform_block_reference(n, reps, key),
        "exp": lambda: prim.exp_reference(n, reps, prim.CHECK_EXP_SCALE),
        "inv_term": lambda: prim.inv_term_reference(n, reps, key,
                                                    prim.CHECK_INV_LAM),
        "knuth_round": lambda: prim.knuth_round_reference(n, reps, key),
    }[name]()


@pytest.mark.parametrize("name", ["fma", "uniform", "uniform_block", "exp",
                                  "inv_term", "knuth_round"])
def test_check_constants_see_every_rep(name):
    """At a check's reps and constants, a chain one rep shorter or longer,
    or half as long, differs from it by more than the check's tolerance
    (an exact check: differs at all), so the check sees how many reps a
    kernel ran."""
    reps, tol = prim.CHECKS[name]
    want = _chain_plain(name, 64, reps)
    assert torch.isfinite(want).all()
    for other in (reps - 1, reps + 1, reps // 2):
        got = _chain_plain(name, 64, other)
        assert _rel(got, want) > tol if tol else not torch.equal(got, want)


def test_arguments_and_cpu_launches():
    _build.reset_launches()
    out = torch.empty(64)
    for fn in (prim.fma, prim.exp):
        with pytest.raises(ValueError, match="multiple of 16"):
            fn(out, 10)
        fn(out, 16)
    with pytest.raises(ValueError, match="multiple of 16"):
        prim.uniform(out, 0, KEY)
    canvas = torch.zeros((1, prim.CANVAS_ROWS, prim.COLS))
    window = torch.ones((prim.WIN_ROWS, prim.COLS))
    with pytest.raises(ValueError, match="offsets"):
        prim.place_add(canvas, window, torch.tensor([0, 2945]))
    with pytest.raises(ValueError, match="window"):
        prim.place_add(canvas, window[:8], torch.tensor([0]))
    with pytest.raises(ValueError, match="sgemm"):
        prim.sgemm(torch.ones((100, 8)), torch.ones((8, 64)), 1)
    with pytest.raises(ValueError, match="tf32x3"):
        prim.tf32x3(torch.ones((64, 12)), torch.ones((12, 64)), 1)
    with pytest.raises(ValueError, match="tf32x3"):
        prim.tf32x3(torch.ones((64, 136)), torch.ones((136, 64)), 1)
    prim.place_add(canvas, window, torch.tensor([2944, 0, 5]))
    assert float(canvas[0, 2944:].sum()) == 136 * 512
    assert float(canvas[0, 5:136].min()) == 2.0
    assert all(v == 0 for v in _build.LAUNCHES.values())
    with pytest.raises(RuntimeError, match="card"):
        prim.primitive_rates("cpu")

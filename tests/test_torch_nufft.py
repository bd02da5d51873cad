"""Port parity of K1's NUFFT spreading placement (irrational or q > 8
rescan steps): host tables, the plain kernel and the scan end to end,
against the JAX package on the same numpy inputs.

The JAX kernel runs in interpret mode; its scan is called with
``use_pallas=True``, which routes these cells to the NUFFT banded kernel.
Noise-free agreement: max|port - jax| / max|jax| <= 1e-5 (the engine bar);
spreading tables: offsets equal, weights within 1e-7. Off the TPU the JAX
package never routes per-step noise to the kernel, so noise is checked
statistically on the port alone. The CUDA kernel is held to the plain
version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import rescan_line_sted_torch as T
import rescan_line_sted_tpu as J
from rescan_line_sted_torch.convert import geometry_from_jax
from rescan_line_sted_torch.imaging import rescan as trescan
from rescan_line_sted_torch.imaging.line_sted import effective_line_profile
from rescan_line_sted_torch.kernels.rescan_banded_fused import (
    banded_plan,
    rescan_banded_fused,
    rescan_banded_fused_reference,
)
from rescan_line_sted_torch.physics import psf as tpsf
from rescan_line_sted_tpu.data import samples
from rescan_line_sted_tpu.imaging import rescan as jrescan
from rescan_line_sted_tpu.kernels.rescan_banded_fused import (
    rescan_banded_fused as j_banded,
)

torch.set_num_threads(1)
W = 192  # smallest grid where the 128-aligned band windows engage
SAMPLE = np.array(samples.siemens_star((W, W), spokes=10) * 3.0)
KW = dict(sigma_exc=1.2, sigma_det=1.2, depletion=4.0, brightness=50.0)
# the JAX suite's IRRATIONAL_CELLS (tests/test_rescan_nufft.py)
IRRATIONAL_CELLS = [
    (1.0 + np.pi / 16, 1),          # transcendental step
    (1.6180339887, 1),              # golden ratio
    (1.0 + np.pi / 8, 2),           # irrational step with binning
    (1.0 + 3.0 / 16.0, 1),          # rational but q = 16 > 8: no classes
]
CELL_IDS = ["pi16", "golden", "pi8_b2", "q16"]


def _both(rf, b, w=W, chunk=16, **kw):
    params = {**KW, **kw}
    return ((J.RescanParams.create(**params),
             J.RescanGeometry(J.Grid(w, w), rescan_factor=rf, binning=b,
                              chunk=chunk)),
            (T.RescanParams.create(**params),
             T.RescanGeometry(T.Grid(w, w), rescan_factor=rf, binning=b,
                              chunk=chunk)))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _offs(rf, b, w=W):
    return (rf - 1.0) * np.arange(w, dtype=np.float64) / b


@pytest.mark.parametrize("rf,b", IRRATIONAL_CELLS, ids=CELL_IDS)
def test_spread_tables_match_jax(rf, b):
    want_o, want_w = jrescan._nufft_spread_tables(_offs(rf, b))
    got_o, got_w = trescan._nufft_spread_tables(_offs(rf, b))
    assert got_o.dtype == torch.int32 and got_w.dtype == torch.float32
    assert got_o.shape == (2, W) and got_w.shape == (W, 8)
    np.testing.assert_array_equal(got_o.numpy(), np.asarray(want_o))
    assert np.abs(got_w.numpy() - np.asarray(want_w)).max() <= 1e-7


@pytest.mark.parametrize("wc", [44, 230, 2450, 3071])
def test_deconv_inv_matches_jax(wc):
    got, want = trescan._nufft_deconv_inv(wc), jrescan._nufft_deconv_inv(wc)
    assert got.dtype == np.float32 and got.shape == (wc // 2 + 1,)
    assert np.abs(got - want).max() <= 1e-7 * np.abs(want).max()


@pytest.mark.parametrize("wc", [76, 231])
def test_apply_nufft_deconv_matches_jax(wc):
    folded = np.random.default_rng(wc).random((2, wc, 24), np.float32)
    dinv = trescan._nufft_deconv_inv(wc)
    got = trescan._nufft_finish(wc, "cpu", dinv)(torch.from_numpy(folded))
    want = jrescan._apply_nufft_deconv(jnp.asarray(folded), wc,
                                       jnp.asarray(dinv))
    assert got.shape == (24, wc) and _rel(got, want) <= 1e-5


def _kernel_inputs(rf, b, seed=0):
    """The scan's own K1 inputs for one cell: the y-convolved sample and
    the raw arguments (numpy) the entry builds its plan from, their
    keywords, and that plan (``_banded_inputs``), which ``banded_plan``
    rebuilds from them."""
    _, (tp, tg) = _both(rf, b)
    s = np.random.default_rng(seed).random((W, W), np.float32)
    sample_y, plan, _ = trescan._banded_inputs(torch.from_numpy(s), tp, tg)
    d_in, d_out, pq = trescan._k1_windows(tp, tg)
    offsets2, weights = trescan._nufft_spread_tables(_offs(rf, b))
    kw = dict(wc=tg.canvas_shape[1], d_in=d_in, d_out=d_out, chunk=16,
              binning=b, spread_weights=weights, offsets2=offsets2)
    args = [sample_y,
            tp.brightness * effective_line_profile(W, tp, "cpu"),
            tpsf.detection_profile(W, tp.sigma_det, "cpu"),
            torch.zeros(W, dtype=torch.int32)]
    again = banded_plan(*args[1:], supports=plan.supports, **kw)
    for name in ("g_t", "ill_w", "sa_lo", "sa_hi", "m0", "cls", "taps"):
        assert torch.equal(getattr(again, name), getattr(plan, name)), name
    return [a.numpy() for a in args], kw, plan


def _k1(fn, args, kw):
    """``fn`` (K1's wrapper or its plain version) on the raw arguments
    ``args`` (numpy), through their plan (``banded_plan``)."""
    sample_y, *rest = map(torch.from_numpy, args)
    return fn(sample_y, banded_plan(*rest, **kw))


@pytest.mark.parametrize("rf,b", IRRATIONAL_CELLS, ids=CELL_IDS)
def test_plain_kernel_matches_jax_interpret(rf, b):
    args, kw, plan = _kernel_inputs(rf, b)
    assert plan.n_spread == 4 and plan.q == 2 and not plan.cls.any()
    # the JAX kernel convolves the whole windows; the port's band
    # (supports) leaves out only products below 1e-12 of the peak
    jkw = {k: (jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v)
           for k, v in kw.items()}
    want = j_banded(*map(jnp.asarray, args), interpret=True, **jkw)
    sample_y = torch.from_numpy(args[0])
    got = rescan_banded_fused_reference(sample_y, plan)
    assert got.shape == want.shape == (2, kw["wc"], W // b)
    assert _rel(got, want) <= 1e-5
    # a CPU tensor takes the plain version through the wrapper
    assert torch.equal(rescan_banded_fused(sample_y, plan), got)


@pytest.mark.parametrize("rf,b", IRRATIONAL_CELLS, ids=CELL_IDS)
def test_scan_matches_jax(rf, b):
    (jp, jg), (tp, tg) = _both(rf, b)
    want = J.imaging.rescanned_line_sted_image(
        jnp.asarray(SAMPLE), jp, jg, method="scan", use_pallas=True).image
    got = T.rescanned_line_sted_image(SAMPLE, tp, tg, method="scan",
                                      device="cpu").image
    assert got.shape == tg.canvas_shape and _rel(got, want) <= 1e-5


def test_scan_matches_analytic_irrational():
    """With zero x-margins the circular wrap carries nothing, so the NUFFT
    scan equals the closed-form canvas."""
    _, (tp, tg) = _both(1.0 + np.pi / 16, 1)
    s = SAMPLE.copy()
    s[:, :32] = 0
    s[:, -32:] = 0
    scan = T.rescanned_line_sted_image(s, tp, tg, method="scan",
                                       device="cpu").image
    ana = T.rescanned_line_sted_image(s, tp, tg, device="cpu").image
    assert _rel(scan, ana) <= 1e-5


def test_per_step_statistics():
    """Per-step noise on the NUFFT route (plain path): every total within
    5 sigma of the noise-free total (spreading and deconvolution keep the
    sum), and the seed-mean canvas converges like 1/n."""
    _, (tp, tg) = _both(1.0 + np.pi / 16, 1)
    clean = T.rescanned_line_sted_image(SAMPLE, tp, tg, method="scan",
                                        device="cpu").image.double()
    total = float(clean.sum())
    runs = [T.rescanned_line_sted_image(
        SAMPLE, tp, tg, torch.Generator().manual_seed(k), method="scan",
        noise_mode="per_step", device="cpu").image.double()
        for k in range(8)]
    for r in runs:
        assert abs(float(r.sum()) - total) <= 5 * np.sqrt(total)
    assert not torch.equal(runs[0], runs[1])
    err2 = float(((runs[0] - clean) ** 2).sum())
    err8 = float(((torch.stack(runs).mean(0) - clean) ** 2).sum())
    assert 0.06 <= err8 / err2 <= 0.25          # expected 1/8


def test_collapsed_noise_draws_once():
    """Collapsed noise on the NUFFT route: one Poisson draw of the
    (clamped) canvas, deterministic in the generator."""
    _, (tp, tg) = _both(1.6180339887, 1)
    clean = T.rescanned_line_sted_image(SAMPLE, tp, tg, method="scan",
                                        device="cpu").image
    noisy, again, other = (T.rescanned_line_sted_image(
        SAMPLE, tp, tg, torch.Generator().manual_seed(k), method="scan",
        device="cpu").image for k in (11, 11, 12))
    assert torch.equal(noisy, again) and not torch.equal(noisy, other)
    assert (noisy >= 0).all() and torch.equal(noisy, noisy.round())
    mu = float(clean.clamp_min(0).double().sum())
    assert abs(float(noisy.double().sum()) - mu) <= 5 * np.sqrt(mu)


@pytest.mark.parametrize("w,sigma_exc,sigma_det,rf,b", [
    (2048, 8.0, 3.0, 1.5, 1),               # wide windows, D_in = 256
    (2048, 3.0, 3.0, 1.0 + np.pi / 16, 1),  # the 2048^2 irrational cell
    (512, 12.0, 4.0, 1.0 + np.pi / 8, 2)])
def test_routing_helpers_match_jax(w, sigma_exc, sigma_det, rf, b):
    (jp, _), (tp, _) = _both(rf, b, sigma_exc=sigma_exc,
                             sigma_det=sigma_det)
    step = (rf - 1.0) / b
    for chunk in (8, 16, 32):
        assert trescan._illum_band(tp, w, chunk, b) == \
            jrescan._illum_band(jp, w, chunk, b)
        assert trescan._rational_step(step, chunk) == \
            jrescan._rational_step(step, chunk)
    if sigma_exc == 8.0:
        assert trescan._illum_band(tp, w, 32, b) == (256, 256)


def test_routing_picks_spreading_at_any_step():
    """Steps without a q <= 8 class structure take the NUFFT mode (two
    parity canvases, no classes); rational ones keep class placement."""
    for rf, spread, q in ((1.0 + np.pi / 16, True, 2),
                          (1.0 + 3 / 16, True, 2), (1.7, True, 2),
                          (1.5, False, 2), (2.0, False, 1)):
        _, (tp, tg) = _both(rf, 1)
        sample_y, plan, finish = trescan._banded_inputs(
            torch.from_numpy(SAMPLE), tp, tg)
        assert (plan.n_spread > 0) == spread, rf
        folded = rescan_banded_fused(sample_y, plan)
        assert folded.shape[0] == plan.q == q
        assert finish(folded).shape == tg.canvas_shape


def test_spread_guards():
    args, kw, _ = _kernel_inputs(1.0 + np.pi / 16, 1)
    with pytest.raises(ValueError, match="offsets2"):
        _k1(rescan_banded_fused_reference, args, {**kw, "offsets2": None})
    with pytest.raises(ValueError, match="offsets2 must be on the host"):
        _k1(rescan_banded_fused_reference, args,
            {**kw, "offsets2": kw["offsets2"].to("meta")})
    with pytest.raises(ValueError, match="class"):
        _k1(rescan_banded_fused_reference, args,
            {**kw, "classes": torch.zeros(W, dtype=torch.int32)})
    with pytest.raises(ValueError, match="wider than canvas"):
        _k1(rescan_banded_fused_reference, args, {**kw, "wc": 136})


def test_geometry_from_jax_irrational():
    jg = J.RescanGeometry(J.Grid(W, W), rescan_factor=1.0 + np.pi / 16,
                          binning=2, chunk=16)
    tg = geometry_from_jax(jg)
    assert tg.rescan_factor == float(jg.rescan_factor)
    assert tg.canvas_shape == tuple(jg.canvas_shape)
    assert trescan._rational_step((tg.rescan_factor - 1.0) / 2, 16) is None

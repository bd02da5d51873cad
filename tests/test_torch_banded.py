"""Port parity of the banded fused rescan scan (kernel K1).

The plain version ``rescan_banded_fused_reference`` (what the wrapper runs
on CPU tensors) is held against the JAX package's Pallas kernel in
interpret mode, on the same numpy inputs, on the four (q, b, R) cases of
the JAX package's own banded-kernel test. Noise-free agreement:
max|port - jax| / max|jax| <= 1e-5. The CUDA kernel is tested on the card
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rescan_line_sted_torch.kernels import _build
from rescan_line_sted_torch.kernels.rescan_banded_fused import (
    banded_plan,
    rescan_banded_fused,
    rescan_banded_fused_reference,
)
from rescan_line_sted_tpu.kernels.rescan_banded_fused import (
    rescan_banded_fused as j_banded,
)

torch.set_num_threads(1)
CASES = [(1, 1, 2.0), (1, 2, 3.0), (2, 1, 1.5), (4, 1, 2.25)]


def _profile(w, sigma):
    x = np.arange(w) - w // 2
    return np.exp(-0.5 * (x / sigma) ** 2).astype(np.float32)


def _case(q, binning, rf, seed=0):
    """Inputs of one (q, b, R) case at 64^2 (numpy) and the kernel kwargs."""
    rng = np.random.default_rng(5 + q + binning + seed)
    h = w = 64
    wc = int(round(rf * (w // binning)))
    p_n = int(round((rf - 1.0) / binning * q))
    pos = np.arange(w)
    arrays = dict(sample=rng.random((h, w), np.float32),
                  eff=_profile(w, 1.6), gx=_profile(w, 1.4),
                  offsets=((p_n * pos) // q).astype(np.int32),
                  classes=(pos % q).astype(np.int32))
    kw = dict(wc=wc, d_in=32, d_out=48 // binning * binning, chunk=8,
              binning=binning, q=q)
    return arrays, kw


def _torch_args(a, device="cpu"):
    return [torch.from_numpy(a[k]).to(device)
            for k in ("sample", "eff", "gx", "offsets", "classes")]


def _k1(fn, sample, eff, gx, offsets, generator=None, **kw):
    """``fn`` (K1's wrapper or its plain version) on ``sample`` with the
    plan of these raw arguments (``banded_plan``)."""
    return fn(sample, banded_plan(eff, gx, offsets, **kw),
              generator=generator)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("q,binning,rf", CASES)
def test_plain_matches_jax_interpret(q, binning, rf):
    a, kw = _case(q, binning, rf)
    want = j_banded(jnp.asarray(a["sample"]), jnp.asarray(a["eff"]),
                    jnp.asarray(a["gx"]), jnp.asarray(a["offsets"]),
                    classes=jnp.asarray(a["classes"]), interpret=True, **kw)
    s, e, g, o, c = _torch_args(a)
    got = _k1(rescan_banded_fused_reference, s, e, g, o, classes=c, **kw)
    assert got.shape == want.shape == (q, kw["wc"], 64 // binning)
    assert _rel(got, want) <= 1e-5
    # the wrapper takes the plain version for CPU tensors, launching nothing
    _build.reset_launches()
    assert torch.equal(_k1(rescan_banded_fused, s, e, g, o, classes=c, **kw),
                       got)
    assert _build.LAUNCHES["rescan_banded_fused"] == 0


@pytest.mark.parametrize("kw,match", [
    (dict(wc=128, d_in=32, d_out=None, chunk=8), "frame window"),
    (dict(wc=128, d_in=32, d_out=48, chunk=4), "multiple of 8"),
    (dict(wc=32, d_in=32, d_out=48, chunk=8), "wider than canvas"),
    (dict(wc=128, d_in=32, d_out=50, chunk=8, binning=2), "binning"),
    (dict(wc=128, d_in=64, d_out=48, chunk=8), "d_in < W"),
])
def test_guards(kw, match):
    """``banded_plan``, K1's one constructor, validates its arguments."""
    w = 64
    prof = torch.from_numpy(_profile(w, 1.5))
    with pytest.raises(ValueError, match=match):
        banded_plan(prof, prof, torch.zeros(w, dtype=torch.int32), **kw)


@pytest.mark.parametrize("fn,wrong,match", [
    (rescan_banded_fused, "width", "plan built for W = 64"),
    (rescan_banded_fused_reference, "width", "plan built for W = 64"),
    (rescan_banded_fused, "key", "generator or key words, not both")],
    ids=["wrapper-width", "reference-width", "wrapper-key"])
def test_k1_guards_what_it_receives(fn, wrong, match):
    """K1 checks what it takes beside its plan: a sample as wide as the
    plan's, and a generator or key words, not both."""
    a, kw = _case(2, 1, 1.5)
    s, e, g, o, c = _torch_args(a)
    plan = banded_plan(e, g, o, classes=c, **kw)
    with pytest.raises(ValueError, match=match):
        if wrong == "width":
            fn(s[:, :56], plan)
        else:
            fn(s, plan, generator=torch.Generator().manual_seed(0),
               key=(1, 2))


def test_class_range_guard():
    a, kw = _case(2, 1, 1.5)
    s, e, g, o, c = _torch_args(a)
    with pytest.raises(ValueError, match="classes"):
        banded_plan(e, g, o, classes=c + 1, **kw)


def test_plain_noise_statistics():
    """Noisy plain K1: integer non-negative class canvases whose total
    matches the noise-free total within shot noise; deterministic in the
    generator."""
    a, kw = _case(2, 1, 1.5)
    s, e, g, o, c = _torch_args(a)
    s, e = 50.0 * s, 40.0 * e
    clean = _k1(rescan_banded_fused_reference, s, e, g, o, classes=c, **kw)
    noisy = [_k1(rescan_banded_fused_reference, s, e, g, o, classes=c,
                 generator=torch.Generator().manual_seed(k), **kw)
             for k in (7, 7, 8)]
    assert torch.equal(noisy[0], noisy[1])
    assert not torch.equal(noisy[0], noisy[2])
    assert (noisy[0] >= 0).all() and torch.equal(noisy[0], noisy[0].round())
    tot, ref = float(noisy[0].double().sum()), float(clean.double().sum())
    assert abs(tot - ref) <= 5 * np.sqrt(ref)



# ---- K1's host bound: band windows beyond its shared memory -----------------

def _layout_bytes(d_in, dob, chunk, b, n_spread):
    """K1's generator layout (``csrc/rescan_banded_fused.cu``,
    ``banded_smem_bytes(gen=true)``): a ring of 2 x 512 frame rows and the
    sample window, 16 lanes each, the generator of b (dob - 1) + d_in
    values rounded to 4, the illumination window and the spreading taps."""
    gen = -(-(b * (dob - 1) + d_in) // 4) * 4
    return 4 * ((1024 + d_in) * 16 + gen + chunk * (d_in + 2 * n_spread))


@pytest.mark.parametrize("d_in,dob,chunk,b,n_spread,fits", [
    (128, 128, 32, 1, 0, True), (256, 256, 32, 1, 4, True),
    (768, 768, 32, 1, 0, True), (768, 896, 32, 1, 4, True),
    (896, 896, 32, 1, 0, False), (896, 1024, 32, 1, 4, False),
    (384, 384, 64, 1, 0, True), (512, 512, 64, 1, 0, False),
    (768, 384, 32, 2, 0, True), (1280, 640, 16, 2, 0, False),
    (832, 832, 32, 1, 0, True), (840, 840, 32, 1, 0, False)])
def test_banded_fits_layout_formula(d_in, dob, chunk, b, n_spread, fits):
    """``banded_fits`` against the generator layout's bytes, on both sides
    of Hopper's 232448-byte opt-in limit."""
    from rescan_line_sted_torch.kernels import rescan_banded_fused as k1

    want = _layout_bytes(d_in, dob, chunk, b, n_spread)
    assert k1.banded_smem_bytes(d_in, dob, chunk, b, n_spread) == want
    assert k1.banded_fits(d_in, dob, chunk, b, n_spread) == fits
    assert fits == (want <= 232448) == (want <= k1.SMEM_OPTIN)


def test_wide_excitation_leaves_k1_on_every_device():
    """sigma_exc = 64 at chunk 32 gives band windows D_in = 896 (beyond
    the bound): ``_banded_inputs`` declines them from the geometry alone,
    before any tensor work, so the route cannot depend on the device."""
    import rescan_line_sted_torch as T
    from rescan_line_sted_torch.imaging import rescan as trescan

    params = T.RescanParams.create(sigma_exc=64.0, depletion=4.0)
    geom = T.RescanGeometry(T.Grid(8, 2048), rescan_factor=1.5, chunk=32)
    d_in, d_out = trescan._illum_band(params, 2048, 32)
    assert d_out is not None and d_in == 896
    assert trescan._banded_inputs(torch.zeros(8, 2048), params, geom) is None
    narrow = T.RescanParams.create(sigma_exc=48.0, depletion=4.0)
    assert trescan._banded_inputs(torch.zeros(8, 2048), narrow,
                                  geom) is not None


@pytest.mark.parametrize("rf,b", [(2.0, 1), (1.5, 1), (1.0 + np.pi / 16, 1),
                                  (3.0, 2)])
def test_over_bound_windows_take_the_full_frame_scan(rf, b, monkeypatch):
    """With the bound patched to 0 every band window is over it: the scan
    takes ``_full_frame_scan`` (never K1's wrapper) and its noise-free
    image matches the JAX package's scan within 1e-5 (max relative)."""
    import rescan_line_sted_torch as T
    import rescan_line_sted_tpu as J
    from rescan_line_sted_torch.imaging import rescan as trescan
    from rescan_line_sted_torch.kernels import rescan_banded_fused as k1
    from rescan_line_sted_tpu.imaging import rescanned_line_sted_image

    kw = dict(sigma_exc=2.0, sigma_det=2.0, stripe_period=8.0,
              depletion=4.0, brightness=40.0)
    h, w = 32, 256
    s = np.random.default_rng(7).random((h, w), np.float32)
    tg = T.RescanGeometry(T.Grid(h, w), rescan_factor=rf, binning=b,
                          chunk=16)
    jg = J.RescanGeometry(J.Grid(h, w), rescan_factor=rf, binning=b,
                          chunk=16)
    tp = T.RescanParams.create(**kw)
    assert trescan._banded_inputs(torch.from_numpy(s), tp, tg) is not None
    monkeypatch.setattr(k1, "SMEM_OPTIN", 0)
    calls = []
    full = trescan._full_frame_scan
    monkeypatch.setattr(trescan, "_full_frame_scan",
                        lambda *a, **k: (calls.append(1), full(*a, **k))[1])
    monkeypatch.setattr(trescan, "rescan_banded_fused", None)  # never called
    # the entry's plan holds its route: no plan made under the real bound
    # may serve this call, nor this call's plan a later test
    trescan._image_plan.cache_clear()
    try:
        got = T.rescanned_line_sted_image(torch.from_numpy(s), tp, tg,
                                          method="scan", device="cpu").image
    finally:
        trescan._image_plan.cache_clear()
    want = rescanned_line_sted_image(
        jnp.asarray(s), J.RescanParams.create(**kw), jg, method="scan").image
    assert calls == [1]
    assert _rel(got, want) <= 1e-5


# ---- K1's three-pass TF32 engine and its host bound -------------------------

def _ffma_layout_bytes(d_in, dob, chunk, b, n_spread):
    """The bound the port held K1 to before its tensor-core engine: a
    ring of 2 x 512 frame rows and the binned sample window, 16 lanes
    each, the generator of b (dob - 1) + d_in values rounded to 4, the
    illumination window and the spreading taps."""
    gen = (b * (dob - 1) + d_in + 3) // 4 * 4
    return 4 * ((2 * 512 + d_in) * 16 + gen + chunk * (d_in + 2 * n_spread))


def test_banded_fits_admits_every_window_the_ffma_engine_admitted():
    """Over a grid of (d_in, dob, chunk, b, n_spread) that crosses the
    limit, every window the FFMA engine's formula admitted fits K1's
    smallest layout, and the three layouts are ordered resident >=
    generator >= synchronous generator."""
    from rescan_line_sted_torch.kernels import rescan_banded_fused as k1

    admitted = 0
    for d_in in range(32, 1345, 40):
        for dob in sorted({max(1, d_in // 4), d_in // 2 + 3, d_in,
                           d_in + 96, d_in + 131}):
            for chunk, b, n_spread in ((8, 1, 0), (32, 1, 0), (32, 1, 4),
                                       (16, 2, 0), (64, 1, 0), (8, 4, 4),
                                       (32, 3, 4)):
                if _ffma_layout_bytes(d_in, dob, chunk, b,
                                      n_spread) <= 232448:
                    admitted += 1
                    assert k1.banded_fits(d_in, dob, chunk, b, n_spread)
                res, gen, lean = k1.layout_smem_bytes(d_in, dob, chunk, b,
                                                      n_spread)
                assert res >= gen >= lean
    assert admitted > 500


@pytest.mark.parametrize("d_in,dob", [(128, 128), (256, 256)])
def test_three_pass_split_holds_the_parity_bar(d_in, dob):
    """K1's hi/lo split rule at the flagship's (D_in = dob = 128) and the
    wide layout's (256) shapes: one frame's [16 lanes, D_in] x [D_in, dob]
    product of a y-convolved star window scaled by the illumination and
    the binned detection window, against float64. Three passes stay far
    under 1e-5 (max relative); a single TF32 pass misses it."""
    from rescan_line_sted_torch.kernels.rescan_banded_fused import (
        tf32_split, three_pass_matmul)

    rng = np.random.default_rng(d_in)
    x = np.arange(d_in) - d_in // 2
    ill = np.exp(-0.5 * (x / (d_in / 10)) ** 2)
    win = rng.random((16, d_in)) * (1.0 + rng.random(d_in))
    a = torch.from_numpy((win * ill).astype(np.float32))
    r = np.arange(dob)[None, :] - np.arange(d_in)[:, None] \
        + (d_in - dob) // 2
    g = torch.from_numpy(np.exp(-0.5 * (r / 3.0) ** 2).astype(np.float32))
    exact = a.double() @ g.double()
    three = three_pass_matmul(a, g)
    single = tf32_split(a)[0] @ tf32_split(g)[0]
    assert _rel(three, exact) <= 1e-6
    assert _rel(single, exact) > 1e-5
    hi, lo = tf32_split(a)
    bits = torch.cat([hi, lo]).view(torch.int32) & 0x1FFF
    assert not bits.any()
    assert _rel(hi.double() + lo.double(), a.double()) <= 2.0 ** -20


# ---- K1's band: each frame only where illumination and detection reach ------

# (size, R, b, sigma_exc) of the scan's cells: the flagship, the irrational
# R (NUFFT spreading), binning 2 and the wide window (D_in = D_out = 256)
BAND_CELLS = {"flagship": (2048, 1.5, 1, 3.0),
              "irrational": (2048, 1.0 + np.pi / 16, 1, 3.0),
              "binning2": (512, 3.0, 2, 3.0),
              "wide": (2048, 1.5, 1, 8.0)}


def _band_cell(name, **changes):
    """The params and geometry of one band cell, and the entry's K1 tables
    for them."""
    import rescan_line_sted_torch as T
    from rescan_line_sted_torch.imaging import rescan as trescan

    size, rf, b, sigma_exc = BAND_CELLS[name]
    params = T.LineSTEDParams.create(
        sigma_exc=sigma_exc, sigma_det=3.0, stripe_period=12.0,
        depletion=8.0, slit_halfwidth=4.0, brightness=1.0).replace(**changes)
    geom = T.RescanGeometry(T.Grid(size, size), rescan_factor=rf, binning=b,
                            chunk=32)
    banded = trescan._banded_tables(
        params, geom, trescan._resolve_reassignment(geom, "auto"), "cpu")
    return params, geom, banded


def _float64(plan, **changes):
    import dataclasses

    return dataclasses.replace(plan, g0w=plan.g0w.double(),
                               ill_w=plan.ill_w.double(), **changes)


@pytest.mark.parametrize("name", sorted(BAND_CELLS))
def test_band_leaves_out_nothing_the_result_can_see(name):
    """The banded conv table (zero outside each frame's band) stays within
    1e-12 of the whole windows' table, in float64, relative to its peak;
    the band keeps work only where the table has some (no 8-column block
    of it is zero), so its count ``band_k_steps`` is the masked table's
    nonzero blocks."""
    from rescan_line_sted_torch.kernels.rescan_banded_fused import (
        banded_table)

    plan = _float64(_band_cell(name)[2].k1)
    band = banded_table(plan)
    whole = banded_table(_float64(plan, supports=None))
    assert float((band - whole).abs().max() / whole.abs().max()) <= 1e-12
    c, dob = plan.chunk, plan.d_out // plan.binning
    blocks = band.reshape(c, dob, -1, 8).ne(0).any(-1)         # [C, dob, Di/8]
    groups = torch.nn.functional.pad(
        blocks, (0, 0, 0, -dob % 32)).reshape(c, -1, 32, blocks.shape[-1])
    assert int(groups.any(2).sum()) == plan.band_k_steps
    whole_steps = c * -(-dob // 32) * -(-plan.d_in // 8)
    assert plan.band_share == plan.band_k_steps / whole_steps
    if name in ("flagship", "irrational"):      # 17.5 of 64 a position
        assert plan.band_k_steps == 560 and whole_steps == 2048


@pytest.mark.parametrize("exc,det", [(None, None), (20, 30)])
def test_banded_tables_pass_the_params_supports(exc, det):
    """The entry's K1 tables carry the supports ``_illum_band`` sizes the
    windows by: the params' own where set, else ``config._support`` of
    their widths; its plan's band is that one."""
    from rescan_line_sted_torch.config import _support

    params, _, banded = _band_cell("flagship", exc_support=exc,
                                   det_support=det)
    want = (_support(params.sigma_exc) if exc is None else exc,
            _support(params.sigma_det) if det is None else det)
    assert banded.k1.supports == want


@pytest.mark.parametrize("exc,det", [(None, None), (20, 30), (40, None)])
def test_one_support_rule(exc, det):
    """``_illum_band`` sizes the windows by ``_band_supports``, and the
    sharded engine's halo is the same detection support; only a fitted
    ``sigma_det`` without a set ``det_support`` has none."""
    import rescan_line_sted_torch as T
    from rescan_line_sted_torch.imaging import rescan as trescan
    from rescan_line_sted_torch.parallel.sharded_rescan import _det_support

    params = T.LineSTEDParams.create(sigma_exc=3.0, sigma_det=3.0).replace(
        exc_support=exc, det_support=det)
    s_exc, s_det = trescan._band_supports(params)
    assert (s_exc, s_det) == (24 if exc is None else exc,
                              24 if det is None else det)
    assert trescan._illum_band(params, 2048, 32) == (
        -(-(32 + 2 * s_exc) // 128) * 128,
        -(-(32 + 2 * (s_exc + s_det)) // 128) * 128)
    assert _det_support(params) == s_det
    fitted = params.replace(sigma_det=torch.tensor(3.0, requires_grad=True))
    assert _det_support(fitted) == det


def _indicator(w, half):
    x = np.abs(np.arange(w) - w // 2)
    return torch.from_numpy((x <= half).astype(np.float32))


@pytest.mark.parametrize("d_in,d_out,chunk,b,s_exc,s_det", [
    (128, 128, 32, 1, 24, 24), (128, 128, 32, 2, 24, 24),
    (60, 76, 8, 2, 5, 3), (44, 100, 16, 1, 0, 9), (320, 320, 32, 1, 83, 83),
    (36, 52, 8, 1, 30, 1), (128, 256, 32, 4, 2, 2)])
def test_band_runs_cover_every_product_of_the_supports(d_in, d_out, chunk, b,
                                                       s_exc, s_det):
    """With profiles that are 1 within their supports and 0 beyond, the
    plan's own tables say where a frame has products: each (position,
    32-row group)'s run of ``band_runs`` is the 8-aligned hull of the
    columns where its table is nonzero (``[0, 0)`` where it has none), so
    the band's table equals the whole windows' exactly."""
    from rescan_line_sted_torch.kernels.rescan_banded_fused import (
        band_runs, banded_table)

    w = 512
    plan = banded_plan(_indicator(w, s_exc), _indicator(w, s_det),
                       torch.zeros(w, dtype=torch.int32), wc=w + 64,
                       d_in=d_in, d_out=d_out, chunk=chunk, binning=b,
                       supports=(s_exc, s_det))
    whole = banded_table(_float64(plan, supports=None))
    assert torch.equal(banded_table(_float64(plan)), whole)
    dob = d_out // b
    runs = band_runs(d_in, dob, chunk, b, (s_exc, s_det))
    lit = whole.reshape(chunk, dob, d_in).ne(0)
    for c in range(chunk):
        for g in range(runs.shape[1]):
            cols = torch.nonzero(lit[c, 32 * g:32 * g + 32].any(0)).flatten()
            want = ((0, 0) if cols.numel() == 0 else
                    (int(cols[0]) // 8 * 8,
                     min(int(cols[-1]) // 8 * 8 + 8, d_in)))
            assert tuple(runs[c, g].tolist()) == want, (c, g)


def test_no_supports_convolve_the_whole_windows():
    """``supports=None`` keeps today's plain K1: its table is the windows'
    whole product, and its canvas equals, bit for bit, the one of a band
    that covers every window column; the band's own canvas stays within
    1e-5 of the JAX kernel, which has no band."""
    from rescan_line_sted_torch.kernels.rescan_banded_fused import (
        banded_table)

    a, kw = _case(2, 1, 1.5)
    s, e, g, o, c = _torch_args(a)
    plan = banded_plan(e, g, o, classes=c, **kw)
    b, dob = kw["binning"], kw["d_out"] // kw["binning"]
    assert plan.supports is None and plan.band_share == 1.0
    assert torch.equal(banded_table(plan), (plan.g0w[None] * plan.ill_w[
        :, None, :]).reshape(kw["chunk"] * dob, b, kw["d_in"]).sum(1))
    none = _k1(rescan_banded_fused_reference, s, e, g, o, classes=c, **kw)
    cover = _k1(rescan_banded_fused_reference, s, e, g, o, classes=c, **kw,
                supports=(64, 64))
    assert torch.equal(none, cover)
    tight = _k1(rescan_banded_fused_reference, s, e, g, o, classes=c, **kw,
                supports=(8, 8))
    want = j_banded(jnp.asarray(a["sample"]), jnp.asarray(a["eff"]),
                    jnp.asarray(a["gx"]), jnp.asarray(a["offsets"]),
                    classes=jnp.asarray(a["classes"]), interpret=True, **kw)
    assert not torch.equal(tight, none) and _rel(tight, want) <= 1e-5


# ---- K1's spreading placement: its threads' items ---------------------------

def _spread_plan(case):
    """K1's plan of one spreading case on the CPU: the irrational
    flagship's (R = 1 + pi/16, chunk 32) at 256^2 and 2048^2 and at
    binning 2 as the entry builds it, and the two card cases of
    ``test_banded_kernel_spread_matches_plain`` at 64 columns whose
    chunks wrap (step 0.618, chunk 16) or whose pass covers the whole
    64-row canvas (step 1.45)."""
    import rescan_line_sted_torch as T
    from rescan_line_sted_torch.imaging import rescan as trescan

    if case.startswith("flagship"):
        n, b = {"flagship_256": (256, 1), "flagship_2048": (2048, 1),
                "flagship_256_b2": (256, 2)}[case]
        params = T.LineSTEDParams.create(sigma_exc=3.0, sigma_det=3.0,
                                         stripe_period=12.0, depletion=8.0,
                                         slit_halfwidth=4.0, brightness=1.0)
        geom = T.RescanGeometry(T.Grid(n, n), binning=b, chunk=32,
                                rescan_factor=1.0 + b * np.pi / 16)
        return trescan._banded_tables(params, geom, "subpixel",
                                      torch.device("cpu")).k1
    step, chunk, wc = {"wrapping": (0.6180339887, 16, 104),
                       "whole_canvas": (1.45, 32, 64)}[case]
    w = 64
    offsets2, weights = trescan._nufft_spread_tables(
        step * np.arange(w, dtype=np.float64))
    return banded_plan(torch.from_numpy(_profile(w, 1.6)),
                       torch.from_numpy(_profile(w, 1.4)),
                       torch.zeros(w, dtype=torch.int32), wc=wc, d_in=32,
                       d_out=48, chunk=chunk, spread_weights=weights,
                       offsets2=offsets2)


def _busy_by_count(plan):
    """``spread_busy`` by brute force: in each 512-row pass of each chunk,
    the canvas rows of each parity that its frames' spread rows (dob +
    n_spread - 1 from each start) reach from their lo starts and, where
    the chunk wraps (m0 < dob), from their hi starts and not from the lo
    ones, as sets; each set in blocks of three rows, four lane quads a
    block, 512 threads."""
    dob = plan.d_out // plan.binning
    span, dobp = dob + plan.n_spread - 1, -(-dob // 32) * 32
    lo, hi = plan.sa_lo.tolist(), plan.sa_hi.tolist()
    shares = []
    for ic, split in enumerate(plan.m0.tolist()):
        p0 = ic * plan.chunk
        for first in range(0, plan.chunk * dobp, 512):
            end = min(first + 512, plan.chunk * dobp)
            frames = range(p0 + first // dobp, p0 + (end - 1) // dobp + 1)
            blocks = 0
            for pi in (0, 1):
                lo_rows = {(lo[pi][c] + k) % plan.wc for c in frames
                           for k in range(span)}
                hi_rows = {(hi[pi][c] + k) % plan.wc for c in frames
                           for k in range(span)} if split < dob else set()
                blocks += -(-len(lo_rows) // 3) - (-len(hi_rows - lo_rows)
                                                   // 3)
            shares.append(min(4 * blocks, 512) / 512)
    return sum(shares) / len(shares)


@pytest.mark.parametrize("case", ["flagship_256", "flagship_2048",
                                  "flagship_256_b2", "wrapping",
                                  "whole_canvas"])
def test_spread_busy_counts_the_kernels_items(case):
    """The plan's ``spread_busy`` (the host's copy of K1's item formula)
    equals a brute-force count of each pass's canvas rows; at the
    irrational flagship three quarters of the 512 threads place in a pass
    (one thread a row, a parity at a time, held ~132: 0.26)."""
    plan = _spread_plan(case)
    dob = plan.d_out // plan.binning
    assert plan.n_spread == 4 and bool((plan.m0 < dob).any())
    assert plan.spread_busy == pytest.approx(_busy_by_count(plan),
                                             rel=1e-12)
    assert 0.0 < plan.spread_busy < 1.0
    if case in ("flagship_256", "flagship_2048"):
        assert plan.spread_busy >= 0.7


def _parent_layout_bytes(d_in, dob, chunk, b, n_spread):
    """K1's three layouts' bytes before the spreading placement's frame
    table (``layout_smem_bytes`` as it was)."""
    gen = (b * (dob - 1) + d_in + 3) // 4 * 4
    g_res = d_in * (dob + (8 - dob % 32) % 32)
    ill, taps = chunk * d_in, chunk * 2 * n_spread
    staged = (2 * 512 * 20 + 2 * d_in * (16 * b + 8)
              + (d_in * 24 if b > 1 else 0) + 2 * (5 * chunk + 4) + 2 * taps)
    lean = 2 * 512 * 16 + d_in * 16 + gen + ill + taps
    return 4 * (staged + g_res + ill), 4 * (staged + gen + ill), 4 * lean


def test_class_placement_keeps_its_bytes_and_no_spread_items():
    """Without spreading, K1's layouts keep their bytes for every window
    and the plan counts no spreading items; with it, only the two
    asynchronous layouts add the two slots of the frame table (16 ints a
    frame a 512-row pass can hold), and the host bound is unchanged."""
    from rescan_line_sted_torch.kernels import rescan_banded_fused as k1

    for d_in in range(32, 1345, 40):
        for dob in sorted({max(1, d_in // 4), d_in // 2 + 3, d_in,
                           d_in + 131}):
            for chunk, b in ((8, 1), (32, 1), (16, 2), (32, 3)):
                want = _parent_layout_bytes(d_in, dob, chunk, b, 0)
                assert k1.layout_smem_bytes(d_in, dob, chunk, b, 0) == want
                res, gen, lean = _parent_layout_bytes(d_in, dob, chunk, b, 4)
                frames = min(chunk, 511 // (-(-dob // 32) * 32) + 2)
                assert k1.layout_smem_bytes(d_in, dob, chunk, b, 4) == (
                    res + 128 * frames, gen + 128 * frames, lean)
    a, kw = _case(2, 1, 1.5)
    s, e, g, o, c = _torch_args(a)
    assert banded_plan(e, g, o, classes=c, **kw).spread_busy == 0.0

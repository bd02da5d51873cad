"""Card tests of the port's CUDA kernels against their plain versions.

Every test carries the ``cuda`` marker and skips without a CUDA device.
This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

(``--noconftest`` skips ``tests/conftest.py``, which sets up JAX.)
"""

import numpy as np
import pytest
import torch

import rescan_line_sted_torch as T
from rescan_line_sted_torch.kernels import _build
from rescan_line_sted_torch.kernels.primitives import PLACE_CASES
from rescan_line_sted_torch.kernels.poisson import (
    poisson_flat,
    poisson_reference,
    poisson_rows_tiered,
    poisson_rows_tiered_reference,
)
from rescan_line_sted_torch.kernels.rescan_banded_fused import (
    banded_plan,
    rescan_banded_fused,
    rescan_banded_fused_reference,
)

pytestmark = pytest.mark.cuda
KERNELS = [poisson_rows_tiered, poisson_flat]
KERNEL_IDS = ["rows_tiered", "flat"]
# (q, b, R, chunk); chunk 16 and 32 give 768 and 1536 frame rows: kernel
# passes (512 rows) with frames straddling them
CASES = [(1, 1, 2.0, 8), (1, 2, 3.0, 8), (2, 1, 1.5, 8), (4, 1, 2.25, 8),
         (2, 1, 1.5, 16), (2, 1, 1.5, 32)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rel(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max())


def _host_key(generator):
    """The two Philox key words ``_build.key_words`` takes from
    ``generator``: by value from a CPU generator and, outside CUDA-graph
    capture, from a CUDA one."""
    s0, s1, keys = _build.key_words(generator, generator.device)
    assert keys is None
    return s0, s1


@pytest.mark.parametrize("kernel", KERNELS, ids=KERNEL_IDS)
@pytest.mark.parametrize("lam_val", [5e-4, 0.05, 0.3, 1.2, 7.0, 40.0])
def test_sampler_statistics(cuda, kernel, lam_val):
    n = 1 << 18
    lam = torch.full((512, n // 512), lam_val, device=cuda)
    before = sum(_build.LAUNCHES.values())
    x = kernel(lam, torch.Generator().manual_seed(3)).double().cpu().numpy()
    assert sum(_build.LAUNCHES.values()) == before + 1
    assert (x == np.round(x)).all() and (x >= 0).all()
    assert abs(x.mean() - lam_val) <= 5 * np.sqrt(lam_val / n)
    assert abs(x.var() - lam_val) <= 5 * np.sqrt((lam_val + 2 * lam_val ** 2)
                                                 / n)
    plain = poisson_reference(lam, torch.Generator(cuda).manual_seed(3))
    assert abs(x.mean() - float(plain.double().mean())) <= \
        5 * np.sqrt(2 * lam_val / n)


@pytest.mark.parametrize("kernel", KERNELS, ids=KERNEL_IDS)
def test_sampler_contract(cuda, kernel):
    lam = torch.full((64, 96), 3.0, device=cuda)
    lam[3, 5] = float("nan")
    lam[0, 0] = -1.0
    a = kernel(lam, torch.Generator().manual_seed(1)).nan_to_num(-1)
    b = kernel(lam, torch.Generator().manual_seed(1)).nan_to_num(-1)
    c = kernel(lam, torch.Generator().manual_seed(2)).nan_to_num(-1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a[3, 5]) == -1 and float(a[0, 0]) == 0
    with pytest.raises(ValueError, match="contiguous"):
        kernel(lam.T, torch.Generator())
    with pytest.raises(ValueError, match="float32"):
        kernel(lam.double(), torch.Generator())


@pytest.mark.parametrize("lam_val", [0.0, 5e-4, 0.05, 0.3, 0.7, 1.2, 5.0])
def test_rows_tiered_draw_for_draw(cuda, lam_val):
    """K2b against its host reference on the same Philox stream: equal
    counts, except at most a few off by one where a uniform sits on an f32
    CDF boundary. Rates vary across each warp (tier from the warp max) and
    the 1000 columns end in a partial warp."""
    lam = lam_val * (0.5 + 0.5 * torch.rand(
        (256, 1000), generator=torch.Generator().manual_seed(3)))
    got = poisson_rows_tiered(lam.to(cuda),
                              torch.Generator().manual_seed(21)).cpu()
    want = poisson_rows_tiered_reference(
        lam, _host_key(torch.Generator().manual_seed(21)))
    diff = (got - want).abs()
    assert float(diff.max()) <= 1 and int((diff > 0).sum()) <= 4


@pytest.mark.parametrize("cols,shift", [
    (1, 0), (3, 0), (5, 0), (130, 0), (2048, 0), (2048, 1), (130, 3)])
@pytest.mark.parametrize("on_card", [False, True])
def test_rows_tiered_ragged_draw_for_draw(cuda, cols, shift, on_card):
    """K2b (four columns and one Philox block per thread, a warp on 128
    columns of a row) against its host reference count by count: rows that
    end inside a Philox block or a warp, and views that do not start on 16
    bytes (scalar loads), with a CPU generator and a CUDA one (key words
    from its seed and offset)."""
    rows = 2048 // max(1, cols // 32)
    full = 1.4 * torch.rand(rows * cols + shift,
                            generator=torch.Generator().manual_seed(cols))
    lam, dev = full[shift:].reshape(rows, cols), \
        full.to(cuda)[shift:].reshape(rows, cols)
    assert (dev.data_ptr() % 16 == 0) == (shift == 0)
    gen = (lambda: torch.Generator(cuda).manual_seed(cols)) if on_card \
        else (lambda: torch.Generator().manual_seed(cols))
    got = poisson_rows_tiered(dev, gen()).cpu()
    want = poisson_rows_tiered_reference(lam, _host_key(gen()))
    diff = (got - want).abs()
    assert float(diff.max()) <= 1 and int((diff > 0).sum()) <= 4


def test_rows_tiered_cuda_generator_never_syncs(cuda):
    """K2b with a CUDA generator takes its key words on the host from the
    generator's seed and offset: no sync under sync-debug mode "error";
    its counts equal the host reference under the same words."""
    lam = 3.0 * torch.rand((96, 2048),
                           generator=torch.Generator().manual_seed(1))
    dev = lam.to(cuda)
    poisson_rows_tiered(dev, torch.Generator(cuda).manual_seed(0))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = poisson_rows_tiered(dev, torch.Generator(cuda).manual_seed(9))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = poisson_rows_tiered_reference(
        lam, _host_key(torch.Generator(cuda).manual_seed(9)))
    diff = (got.cpu() - want).abs()
    assert float(diff.max()) <= 1 and int((diff > 0).sum()) <= 4


def _card_key(monkeypatch, generator):
    """Make the kernels read from the card, as under CUDA-graph capture,
    the key words ``generator`` (a copy of its state is used) would give
    them by value."""
    copy = torch.Generator(generator.device)
    copy.set_state(generator.get_state())
    words = torch.tensor(_host_key(copy), dtype=torch.int64,
                         device=generator.device)
    monkeypatch.setattr(_build, "key_words",
                        lambda g, d, key=None: (0, 0, words)
                        if g is not None else (0, 0, None))


@pytest.mark.parametrize("kernel", ["k1", "k3", "k4"])
def test_key_words_on_card_match_by_value(cuda, kernel, monkeypatch):
    """K1, K3 and K4 take a CUDA generator's key words by value (its seed
    and offset); the same words left on the card for the kernel to read,
    as under CUDA-graph capture, give the same canvas."""
    from rescan_line_sted_torch.kernels.line_fused import line_sted_fused
    from rescan_line_sted_torch.kernels.rescan_fused import rescan_fused

    if kernel == "k1":
        args, kw = _case(2, 1, 1.5, 8, cuda)
        s, e, gx, offs = args

        def run(g):
            return _k1(rescan_banded_fused, 50.0 * s, 40.0 * e, gx, offs,
                       **kw, generator=g)
    elif kernel == "k3":
        s, eff, gx, slit = _line_inputs(64, 256, 4.0, cuda)

        def run(g):
            return line_sted_fused(5.0 * s, eff, gx, slit, g,
                                   slit_support=18)
    else:
        s, eff, gx = _k4_inputs(64, 256, cuda)
        offs = torch.arange(256, device=cuda).int()

        def run(g):
            return rescan_fused(3.0 * s, eff, gx, offs, 512, generator=g)
    gen = torch.Generator(cuda).manual_seed(12)
    state = gen.get_state()
    by_value = run(gen)
    gen.set_state(state)
    _card_key(monkeypatch, gen)
    on_card = run(gen)
    assert torch.equal(on_card, by_value) and on_card.sum() > 0


def test_banded_kernel_wide_windows_match_plain(cuda):
    """Band windows whose resident factors exceed the card's shared memory
    per block run K1 with G kept as its Toeplitz generator (the wide
    layout), integer and spreading placement, against the plain version."""
    w, d = 512, 320
    g = torch.Generator().manual_seed(6)
    args = (torch.rand((64, w), generator=g).to(cuda),
            _profile(w, 12.0, cuda), _profile(w, 12.0, cuda),
            torch.arange(w, device=cuda).int() // 2)
    for b in (1, 2):
        kw = dict(wc=w // b + 64, d_in=d, d_out=d, chunk=32, binning=b)
        want = _k1(rescan_banded_fused_reference, *args, **kw)
        before = _build.LAUNCHES["rescan_banded_fused_wide"]
        got = _k1(rescan_banded_fused, *args, **kw)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["rescan_banded_fused_wide"] == before + 1
        assert got.shape == want.shape and _rel(got, want) <= 1e-5
    kw = dict(wc=w + 96, d_in=d, d_out=d, chunk=32,
              **_spread(w, 0.29, 1, cuda))
    want = _k1(rescan_banded_fused_reference, *args, **kw)
    got = _k1(rescan_banded_fused, *args, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["rescan_banded_fused_spread_wide"] >= 1
    assert got.shape == want.shape == (2, w + 96, 64)
    assert _rel(got, want) <= 1e-5


def _spread(w, step, b, device):
    """NUFFT spreading kwargs for a placement step of ``step`` binned
    pixels per position."""
    from rescan_line_sted_torch.imaging.rescan import _nufft_spread_tables

    offsets2, weights = _nufft_spread_tables(
        step * np.arange(w, dtype=np.float64), device=device)
    return dict(spread_weights=weights, offsets2=offsets2, binning=b)


def _profile(w, sigma, device):
    x = torch.arange(w, device=device) - w // 2
    return torch.exp(-0.5 * (x / sigma) ** 2).float()


def _k1(fn, sample, eff, gx, offsets, *, generator=None, key=None, **kw):
    """``fn`` (K1's wrapper or its plain version) on ``sample`` with the
    plan of these raw arguments (``banded_plan``, on the sample's
    device); ``key`` goes to the wrapper."""
    plan = banded_plan(eff, gx, offsets, device=sample.device, **kw)
    if key is None:
        return fn(sample, plan, generator=generator)
    return fn(sample, plan, generator=generator, key=key)


def _case(q, binning, rf, chunk, device, h=64):
    w = 64
    g = torch.Generator().manual_seed(5 + q + binning)
    pos = torch.arange(w, device=device)
    p_n = int(round((rf - 1.0) / binning * q))
    args = (torch.rand((h, w), generator=g).to(device),
            _profile(w, 1.6, device), _profile(w, 1.4, device),
            ((p_n * pos) // q).int())
    kw = dict(wc=int(round(rf * (w // binning))), d_in=32,
              d_out=48 // binning * binning, chunk=chunk, binning=binning,
              classes=(pos % q).int(), q=q)
    return args, kw


@pytest.mark.parametrize("q,binning,rf,chunk", CASES)
def test_banded_kernel_matches_plain(cuda, q, binning, rf, chunk):
    args, kw = _case(q, binning, rf, chunk, cuda)
    want = _k1(rescan_banded_fused_reference, *args, **kw)
    before = _build.LAUNCHES["rescan_banded_fused"]
    got = _k1(rescan_banded_fused, *args, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["rescan_banded_fused"] == before + 1
    assert got.shape == want.shape and _rel(got, want) <= 1e-5


@pytest.mark.parametrize("h", [70, 72])
def test_banded_kernel_partial_lane_tile(cuda, h):
    """H/b not a multiple of the 16-lane CTA tile (and, at 70, not of the
    4-element Philox block): masked lanes, scalar canvas access."""
    args, kw = _case(2, 1, 1.5, 8, cuda, h=h)
    want = _k1(rescan_banded_fused_reference, *args, **kw)
    got = _k1(rescan_banded_fused, *args, **kw)
    assert got.shape == (2, kw["wc"], h) and _rel(got, want) <= 1e-5
    s, e, gx, offs = args
    noisy = [_k1(rescan_banded_fused, 50.0 * s, 40.0 * e, gx, offs, **kw,
                 generator=torch.Generator().manual_seed(4))
             for _ in range(2)]
    assert torch.equal(noisy[0], noisy[1]) and (noisy[0] >= 0).all()
    ref = float(_k1(rescan_banded_fused_reference, 50.0 * s, 40.0 * e, gx,
                    offs, **kw).double().sum())
    assert abs(float(noisy[0].double().sum()) - ref) <= 5 * np.sqrt(ref)


@pytest.mark.parametrize("h,b,wide,spread", [
    (18, 1, False, False), (74, 2, False, False), (40, 1, True, False),
    (70, 1, False, True), (54, 2, True, True), (65, 1, False, True)])
def test_banded_kernel_ragged_tiles_every_layout(cuda, h, b, wide, spread):
    """Lane tiles that end mid-tile (H/b off the 16-lane tile, and off the
    16-byte copies where H % 4 != 0) in each layout (resident; generator,
    or at b = 2 with D_in = 320 the synchronous one), integer and spreading
    placement, against the plain version; at H = 65 the last tile holds one
    lane past a whole quad (the spreading placement's items are quads)."""
    from rescan_line_sted_torch.kernels import rescan_banded_fused as k1

    w = 512 if wide else 64
    g = torch.Generator().manual_seed(h + b)
    args = (torch.rand((h, w), generator=g).to(cuda),
            _profile(w, 12.0 if wide else 1.6, cuda),
            _profile(w, 12.0 if wide else 1.4, cuda),
            torch.arange(w, device=cuda).int() // 2)
    d = 320 if wide else 32
    kw = dict(wc=w // b + 96, d_in=d, d_out=(d + 16) // (2 * b) * 2 * b,
              chunk=16, binning=b)
    if spread:
        kw.update(_spread(w, 0.29, b, cuda))
    want = _k1(rescan_banded_fused_reference, *args, **kw)
    got = _k1(rescan_banded_fused, *args, **kw)
    torch.cuda.synchronize()
    name = "rescan_banded_fused" + ("_spread" if spread else "") + (
        "_wide" if wide else "")
    fits = [v <= k1.SMEM_OPTIN for v in k1.layout_smem_bytes(
        d, kw["d_out"] // b, 16, b, 4 if spread else 0)]
    assert k1.LAUNCH_SHAPE[name]["layout"] == k1.LAYOUTS[fits.index(True)]
    assert (k1.LAUNCH_SHAPE[name]["layout"] == "resident") == (not wide)
    assert got.shape == want.shape and _rel(got, want) <= 1e-5


def test_banded_kernel_lean_layout_matches_plain(cuda):
    """Windows too wide for the double-buffered generator layout (D_in =
    dob = 640 at chunk 32) take the synchronous one, integer and
    spreading placement, against the plain version; its bytes are the
    host bound's."""
    from rescan_line_sted_torch.kernels import rescan_banded_fused as k1

    w, d = 1024, 640
    g = torch.Generator().manual_seed(9)
    args = (torch.rand((32, w), generator=g).to(cuda),
            _profile(w, 40.0, cuda), _profile(w, 30.0, cuda),
            torch.arange(w, device=cuda).int() // 2)
    for spread in (False, True):
        kw = dict(wc=w + 160, d_in=d, d_out=d, chunk=32)
        if spread:
            kw.update(_spread(w, 0.29, 1, cuda))
        want = _k1(rescan_banded_fused_reference, *args, **kw)
        got = _k1(rescan_banded_fused, *args, **kw)
        torch.cuda.synchronize()
        name = "rescan_banded_fused" + ("_spread" if spread else "") + "_wide"
        shape = k1.LAUNCH_SHAPE[name]
        assert shape["layout"] == "generator, synchronous staging"
        assert shape["smem_bytes"] == k1.banded_smem_bytes(
            d, d, 32, 1, 4 if spread else 0)
        assert got.shape == want.shape and _rel(got, want) <= 1e-5


@pytest.mark.parametrize("mode", ["class", "spread", "wide", "spread_wide",
                                  "lean"])
def test_banded_kernel_repeatable_in_every_mode(cuda, mode):
    """Two noisy launches with the same key give the same canvas bit for
    bit (no atomics, sums in a fixed order), in every mode and layout; a
    third with another key differs."""
    if mode == "class":
        args, kw = _case(2, 1, 1.5, 32, cuda)
    else:
        w, d = (1024, 640) if mode == "lean" else (512, 320)
        g = torch.Generator().manual_seed(10)
        args = (torch.rand((48, w), generator=g).to(cuda),
                _profile(w, 12.0, cuda), _profile(w, 12.0, cuda),
                torch.arange(w, device=cuda).int() // 2)
        kw = dict(wc=w + 160, d_in=d, d_out=d, chunk=32)
        if mode == "spread":
            kw.update(d_in=32, d_out=48)
        if "spread" in mode:
            kw.update(_spread(w, 0.29, 1, cuda))
    s, e, gx, offs = args
    runs = [_k1(rescan_banded_fused, 40.0 * s, 30.0 * e, gx, offs, **kw,
                generator=torch.Generator().manual_seed(k))
            for k in (5, 5, 6)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    assert torch.isfinite(runs[0]).all() and (runs[0] >= 0).all()


@pytest.mark.parametrize("kernel", ["k1", "k2c"])
@pytest.mark.parametrize("form", ["ints", "card"])
def test_key_argument_seeds_the_draws(cuda, kernel, form):
    """K1's and K2c's ``key`` (a rank's stream): the same words give the
    same counts, different words different ones, whether the words come by
    value or as an int64 pair on the card; the words a CUDA generator
    draws, passed as ``key``, give that generator's counts; K2c's counts
    follow its host reference for those words."""
    if kernel == "k1":
        args, kw = _case(2, 1, 1.5, 8, cuda)
        s, e, gx, offs = args
        name = "rescan_banded_fused"

        def run(**k):
            return _k1(rescan_banded_fused, 50.0 * s, 40.0 * e, gx, offs,
                       **kw, **k)
    else:
        lam = torch.full((256, 256), 2.0, device=cuda)
        name = "poisson_flat"

        def run(**k):
            return poisson_flat(lam, **k)

    def key(s1):
        return (7, s1) if form == "ints" else torch.tensor(
            [7, s1], dtype=torch.int64, device=cuda)
    before = _build.LAUNCHES[name]
    a, b, c = run(key=key(11)), run(key=key(11)), run(key=key(12))
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + 3
    assert torch.equal(a, b) and not torch.equal(a, c) and a.sum() > 0
    gen = torch.Generator(cuda).manual_seed(21)
    state = gen.get_state()
    drawn = _build.draw_key(gen, cuda)
    gen.set_state(state)
    assert torch.equal(run(key=drawn), run(generator=gen))
    if kernel == "k2c":
        want = poisson_rows_tiered_reference(lam, (7, 11), flat=True)
        diff = (a.cpu() - want).abs()
        assert float(diff.max()) <= 1 and int((diff > 0).sum()) <= 4


def test_rank_keys_on_card_give_independent_streams(cuda):
    """``sharded_rescan.rank_key`` on a CUDA generator: no sync (sync-debug
    mode "error") and no device work, the rank's words by value (rank 0's
    the unsharded call's) and distinct; two ranks' K2c counts on the same
    rates differ and are uncorrelated."""
    from rescan_line_sted_torch.parallel.sharded_rescan import rank_key

    lam = torch.full((512, 512), 5.0, device=cuda)
    draws, keys = [], []
    for rank in (0, 1):
        gen = torch.Generator(cuda).manual_seed(4)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            key = rank_key(gen, cuda, rank)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert isinstance(key, tuple) and all(
            isinstance(w, int) and 0 <= w < _build.KEY_MOD for w in key)
        keys.append(key)
        draws.append(poisson_flat(lam, key=key).double().cpu() - 5.0)
    assert keys[0] == _host_key(torch.Generator(cuda).manual_seed(4))
    assert keys[0] != keys[1]
    assert not torch.equal(draws[0], draws[1])
    corr = float(torch.corrcoef(torch.stack([d.ravel() for d in draws]))[0, 1])
    assert abs(corr) < 5.0 / 512


def test_banded_kernel_noise(cuda):
    args, kw = _case(2, 1, 1.5, 8, cuda)
    s, e, gx, offs = args
    s, e = 50.0 * s, 40.0 * e
    clean = _k1(rescan_banded_fused, s, e, gx, offs, **kw)
    runs = [_k1(rescan_banded_fused, s, e, gx, offs, **kw,
                generator=torch.Generator().manual_seed(k))
            for k in (7, 7, 8)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    assert (runs[0] >= 0).all() and torch.equal(runs[0], runs[0].round())
    tot, ref = float(runs[0].double().sum()), float(clean.double().sum())
    assert abs(tot - ref) <= 5 * np.sqrt(ref)


# K1 on its band (``supports``) against the banded plain version: case ->
# (binning, placement, window d, supports). d = 128 takes the resident
# layout, 320 a generator one (supports 83 = config._support(12)); the
# tight supports cut products the canvas shows, so K1's runs must be the
# host's ``band_runs`` to match
BAND_CASES = {
    "q1": (1, "q1", 128, (24, 24)), "q2": (1, "q2", 128, (24, 24)),
    "q2_b2": (2, "q2", 128, (24, 24)), "spread": (1, "spread", 128, (24, 24)),
    "spread_b2": (2, "spread", 128, (24, 24)),
    "wide_q2": (1, "q2", 320, (83, 83)),
    "wide_q1_b2": (2, "q1", 320, (83, 83)),
    "wide_spread": (1, "spread", 320, (83, 83)),
    "tight_q2": (1, "q2", 128, (6, 4)),
    "tight_spread_b2": (2, "spread", 128, (5, 9)),
    "tight_wide": (1, "q1", 320, (20, 11))}


def _band_case(case, device):
    b, placement, d, supports = BAND_CASES[case]
    w = 512
    sigma = 3.0 if d == 128 else 12.0
    g = torch.Generator().manual_seed(d + b)
    pos = torch.arange(w, device=device)
    args = (torch.rand((64, w), generator=g).to(device),
            _profile(w, sigma, device), _profile(w, sigma, device),
            (pos // 2).int())
    kw = dict(wc=w // b + 96, d_in=d, d_out=d, chunk=32, binning=b,
              supports=supports)
    if placement == "q2":
        kw.update(classes=(pos % 2).int(), q=2)
    if placement == "spread":
        kw.update(_spread(w, 0.29, b, device))
    return args, kw


@pytest.mark.parametrize("case", sorted(BAND_CASES))
def test_banded_kernel_band_matches_plain(cuda, case):
    """K1 on its band, in class, integer and spreading placement, at
    binning 1 and 2, resident and generator layouts, against the plain
    version on the same band (max relative): 1e-6 at D_in = 128; 2e-6 at
    320, where K1's three TF32 passes read 1.1-1.5e-6 with the whole
    windows as with the band (the float32 plain version itself 5.7-8.9e-7
    from float64). Its launch records the band's group-k-steps a chunk and
    their share, as the host counts them."""
    from rescan_line_sted_torch.kernels import rescan_banded_fused as k1

    args, kw = _band_case(case, cuda)
    want = _k1(rescan_banded_fused_reference, *args, **kw)
    got = _k1(rescan_banded_fused, *args, **kw)
    torch.cuda.synchronize()
    b, d = kw["binning"], kw["d_in"]
    assert got.shape == want.shape
    assert _rel(got, want) <= (1e-6 if d == 128 else 2e-6)
    name = "rescan_banded_fused" + ("_spread" if "offsets2" in kw else "") + (
        "_wide" if d > 128 else "")
    shape = k1.LAUNCH_SHAPE[name]
    assert (shape["layout"] == "resident") == (d == 128)
    steps, whole = k1.band_k_steps(d, d // b, 32, b, kw["supports"])
    assert shape["band_k_steps"] == steps < whole
    assert shape["band_share"] == steps / whole


@pytest.mark.parametrize("case", ["q2", "spread_b2", "wide_spread"])
def test_banded_kernel_band_repeatable(cuda, case):
    """A noisy call on the band gives the same canvas twice with one key,
    and another with another key."""
    args, kw = _band_case(case, cuda)
    s, e, gx, offs = args
    runs = [_k1(rescan_banded_fused, 40.0 * s, 30.0 * e, gx, offs, **kw,
                generator=torch.Generator().manual_seed(k))
            for k in (5, 5, 6)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    assert torch.isfinite(runs[0]).all()


@pytest.mark.parametrize("rf", [1.5, 1.0 + np.pi / 16])
def test_flagship_band_share(cuda, rf):
    """The flagship's K1 call, as the entry makes it (2048^2, chunk 32,
    supports 24 / 24, class placement at R = 1.5, NUFFT spreading at the
    irrational R), records the host's band: 560 of 2048 group-k-steps a
    chunk (17.5 of 64 a position); and the spreading placement's busy
    threads as the host counts them, 0.70 of the CTA's at the irrational
    R (one thread a row, a parity at a time, held 0.26), 0.0 in class
    mode."""
    from rescan_line_sted_torch.imaging.rescan import _banded_inputs
    from rescan_line_sted_torch.kernels import rescan_banded_fused as k1

    params = T.LineSTEDParams.create(sigma_exc=3.0, sigma_det=3.0,
                                     stripe_period=12.0, depletion=8.0,
                                     slit_halfwidth=4.0, brightness=1.0)
    geom = T.RescanGeometry(T.Grid(2048, 2048), rescan_factor=rf, chunk=32)
    sample_y, plan, _ = _banded_inputs(
        torch.rand((2048, 2048), device=cuda), params, geom)
    rescan_banded_fused(sample_y, plan)
    torch.cuda.synchronize()
    shape = k1.LAUNCH_SHAPE["rescan_banded_fused" + (
        "" if rf == 1.5 else "_spread")]
    steps, whole = k1.band_k_steps(plan.d_in, plan.d_out, 32, 1,
                                   plan.supports)
    assert plan.supports == (24, 24) and (steps, whole) == (560, 2048)
    assert shape["band_k_steps"] == steps
    assert shape["band_share"] == steps / whole
    assert shape["spread_busy"] == plan.spread_busy
    assert (shape["spread_busy"] >= 0.7 if plan.n_spread
            else shape["spread_busy"] == 0.0)


@pytest.mark.parametrize("step,b,chunk,wc", [
    (np.pi / 16, 1, 8, None), (0.6180339887, 1, 16, None),
    (np.pi / 16, 2, 8, None), (3 / 16, 1, 32, None),
    (1.45, 1, 32, 64)])          # a pass's rows span the whole canvas
def test_banded_kernel_spread_matches_plain(cuda, step, b, chunk, wc):
    """K1's NUFFT spreading mode against its plain version, noise-free,
    on frames that straddle 512-row passes and the camera wrap."""
    args, kw = _case(1, b, 1.0 + step * b, chunk, cuda)
    kw.pop("classes")
    kw.pop("q")
    kw.update(_spread(64, step, b, cuda))
    kw["wc"] = wc or max(kw["wc"], kw["d_out"] // b + 24)
    want = _k1(rescan_banded_fused_reference, *args, **kw)
    before = _build.LAUNCHES["rescan_banded_fused_spread"]
    got = _k1(rescan_banded_fused, *args, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["rescan_banded_fused_spread"] == before + 1
    assert got.shape == want.shape == (2, kw["wc"], 64 // b)
    assert _rel(got, want) <= 1e-5
    s, e, gx, offs = args
    noisy = [_k1(rescan_banded_fused, 50.0 * s, 40.0 * e, gx, offs, **kw,
                 generator=torch.Generator().manual_seed(k))
             for k in (4, 4, 5)]
    assert torch.equal(noisy[0], noisy[1])
    assert not torch.equal(noisy[0], noisy[2])
    ref = float(_k1(rescan_banded_fused_reference, 50.0 * s, 40.0 * e, gx,
                    offs, **kw).double().sum())
    assert abs(float(noisy[0].double().sum()) - ref) <= 5 * np.sqrt(ref)


@pytest.mark.parametrize("rf,b", [(2.0, 1), (1.5, 1), (3.0, 2),
                                  (1.0 + np.pi / 16, 1), (1.0 + np.pi / 8, 2)])
def test_slice_on_card_matches_cpu(cuda, rf, b):
    params = T.RescanParams.create(sigma_exc=2.0, sigma_det=2.0,
                                   stripe_period=8.0, depletion=4.0,
                                   brightness=40.0)
    geom = T.RescanGeometry(T.Grid(64, 256), rescan_factor=rf, binning=b,
                            chunk=16)
    s = torch.rand((64, 256), generator=torch.Generator().manual_seed(7))
    for method in ("scan", "analytic"):
        for boundary in ("circular", "padded", "apodized"):
            want = T.rescanned_line_sted_image(
                s, params, geom, method=method, boundary=boundary,
                device="cpu").image
            got = T.rescanned_line_sted_image(
                s.numpy(), params, geom, method=method,
                boundary=boundary).image
            assert got.is_cuda and _rel(got, want) <= 1e-5
    before = dict(_build.LAUNCHES)
    img = T.rescanned_line_sted_image(
        s.to(cuda), params, geom, torch.Generator().manual_seed(1),
        method="scan", noise_mode="per_step").image
    img2 = T.rescanned_line_sted_image(
        s.to(cuda), params, geom, torch.Generator().manual_seed(1)).image
    assert torch.isfinite(img).all() and torch.isfinite(img2).all()
    k1 = "rescan_banded_fused" + ("" if (rf - 1.0) / b * 8 % 1 == 0
                                  else "_spread")
    assert _build.LAUNCHES[k1] == before[k1] + 1
    assert _build.LAUNCHES["poisson_flat"] == before["poisson_flat"] + 1


def _line_inputs(h, w, hw, device, seed=8):
    from rescan_line_sted_torch.imaging.line_sted import (
        effective_line_profile)
    from rescan_line_sted_torch.physics import psf

    p = T.LineSTEDParams.create(sigma_exc=3.0, sigma_det=3.0, depletion=8.0,
                                slit_halfwidth=hw, brightness=40.0)
    ramp = torch.linspace(0.2, 2.0, w)[None, :]      # asymmetric along x
    s = torch.rand((h, w), generator=torch.Generator().manual_seed(seed))
    return ((s * ramp).to(device),
            40.0 * effective_line_profile(w, p, device),
            psf.detection_profile(w, p.sigma_det, device),
            psf.slit_profile(w, p.slit_halfwidth, device))


@pytest.mark.parametrize("h,w,hw,slit_support,shift", [
    (256, 512, 4.0, 18, 0), (64, 100, 4.0, 4, 0), (70, 300, 10.0, 12, 0),
    (40, 2048, 4.0, 18, 0), (48, 512, 4.0, 18, 250), (24, 40, 4.0, 18, 0)])
def test_line_fused_matches_plain(cuda, h, w, hw, slit_support, shift):
    """K3 against its plain version, noise-free: the default window, an
    undersized one (mean rows), a width off the 16-column grid over two
    position tiles with a ragged lane tile, the 2048-wide frame, a tap run
    that wraps past the last offset (eff and gx rolled off centre) and one
    that spans the whole frame."""
    from rescan_line_sted_torch.kernels.line_fused import (
        line_sted_fused, line_sted_fused_reference)

    s, eff, gx, slit = _line_inputs(h, w, hw, cuda)
    args = s, eff.roll(shift), gx.roll(shift), slit
    want = line_sted_fused_reference(*args, slit_support=slit_support)
    before = _build.LAUNCHES["line_sted_fused"]
    got = line_sted_fused(*args, slit_support=slit_support)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["line_sted_fused"] == before + 1
    assert got.shape == (h, w) and _rel(got, want) <= 1e-5


def test_line_fused_noise(cuda):
    """K3's per-frame draws at 256^2: the seed-mean matches the noise-free
    image and the per-pixel variance its mean (Poisson), as the JAX
    suite's hardware test holds the TPU kernel; same seed, same image."""
    from rescan_line_sted_torch.kernels.line_fused import line_sted_fused

    s, eff, gx, slit = _line_inputs(256, 256, 4.0, cuda)
    s = 5.0 * s
    mean = line_sted_fused(s, eff, gx, slit, slit_support=18)
    draws = torch.stack([line_sted_fused(
        s, eff, gx, slit, torch.Generator().manual_seed(k), slit_support=18)
        for k in range(24)]).double()
    assert torch.equal(draws, draws.round()) and (draws >= 0).all()
    sel = mean > 20.0
    rel = (draws.mean(0)[sel] - mean[sel]).abs().mean() / mean[sel].mean()
    ratio = (draws.var(0)[sel] / mean[sel]).mean()
    assert rel < 0.03 and 0.93 < float(ratio) < 1.07
    again = line_sted_fused(s, eff, gx, slit,
                            torch.Generator().manual_seed(0), slit_support=18)
    assert torch.equal(again.double(), draws[0])
    assert not torch.equal(draws[0], draws[1])


def test_line_fused_second_image_makes_no_sync(cuda):
    """The line engine caches K3's plan per params, width and window: a
    second per-step image on K3 (CUDA generator) makes no host-device sync
    under sync-debug mode "error", and equals K3 called without a plan."""
    from rescan_line_sted_torch.imaging import line_sted

    params, geom = _line(64, 256)
    s = torch.rand((64, 256), generator=torch.Generator().manual_seed(3)
                   ).to(cuda)

    def image(seed):
        return T.line_sted_image(s, params, geom,
                                 torch.Generator(cuda).manual_seed(seed),
                                 method="scan", noise_mode="per_step",
                                 use_pallas=True).image

    first = image(1)
    torch.cuda.synchronize()
    before = _build.LAUNCHES["line_sted_fused"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = image(1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["line_sted_fused"] == before + 1
    assert torch.equal(first, again)
    assert line_sted._k3_plan.cache_info().hits >= 1


@pytest.mark.parametrize("shift,h", [(250, 48), (-240, 30), (262, 8)])
def test_line_fused_wrapped_run_with_plan(cuda, shift, h):
    """K3 with a tap run that wraps past the last offset (eff and gx
    rolled), given its plan as the engine gives it, against the plain
    version noise-free; noisy, the same key gives the same image."""
    from rescan_line_sted_torch.kernels.line_fused import (
        line_plan, line_sted_fused, line_sted_fused_reference)

    s, eff, gx, slit = _line_inputs(h, 512, 4.0, cuda)
    args = s, eff.roll(shift), gx.roll(shift), slit
    plan = line_plan(*args[1:], 18)
    assert plan.j0 + plan.n_taps > 512
    want = line_sted_fused_reference(*args, slit_support=18)
    got = line_sted_fused(*args, slit_support=18, plan=plan)
    torch.cuda.synchronize()
    assert got.shape == (h, 512) and _rel(got, want) <= 1e-5
    noisy = [line_sted_fused(*args, torch.Generator().manual_seed(2),
                             slit_support=18, plan=plan) for _ in range(2)]
    assert torch.equal(noisy[0], noisy[1])


def test_line_fused_limits(cuda):
    """K3 takes the widest frame the line engine hands it; a tap run that
    overflows a block's shared memory, or a sample K3 cannot read,
    raises."""
    from rescan_line_sted_torch.kernels import line_fused

    args = _line_inputs(8, line_fused.MAX_WIDTH, 4.0, cuda)
    want = line_fused.line_sted_fused_reference(*args, slit_support=18)
    assert _rel(line_fused.line_sted_fused(*args, slit_support=18),
                want) <= 1e-5
    # flat profiles: every offset is a tap, a run too long for shared memory
    s, eff, gx, slit = _line_inputs(8, line_fused.MAX_WIDTH, 4.0, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        line_fused.line_sted_fused(s, torch.ones_like(eff),
                                   torch.ones_like(gx), slit)
    s, eff, gx, slit = _line_inputs(8, 64, 4.0, cuda)
    with pytest.raises(ValueError, match="float32"):
        line_fused.line_sted_fused(s.double(), eff, gx, slit)


def _point(h, w, chunk):
    return (T.PointSTEDParams.create(sigma_exc=3.0, sigma_det=3.0,
                                     sigma_dep=3.0, depletion=8.0,
                                     pinhole_radius=4.0, brightness=20.0),
            T.PointSTEDGeometry(T.Grid(h, w), chunk=chunk))


def _line(h, w, chunk=32):
    return (T.LineSTEDParams.create(sigma_exc=3.0, sigma_det=3.0,
                                    depletion=8.0, slit_halfwidth=4.0,
                                    brightness=20.0),
            T.LineSTEDGeometry(T.Grid(h, w), chunk=chunk))


@pytest.mark.parametrize("case,kernel", [
    ("line_128", "line_sted_fused"), ("line_512", "poisson_rows_tiered"),
    ("line_512_fused", "line_sted_fused"),
    ("point_256", "poisson_rows_tiered"), ("point_64", "poisson_rows_tiered")])
def test_descanned_routes_on_card(cuda, case, kernel):
    """Each per-step route launches its kernel (and only it); noise-free,
    every method and boundary on the card matches the CPU."""
    image = T.point_sted_image if case.startswith("point") else \
        T.line_sted_image
    n = int(case.split("_")[1])
    params, geom = _point(n, n, 64) if case.startswith("point") else \
        _line(n, n)
    kw = dict(use_pallas=True) if case.endswith("fused") else {}
    s = torch.rand((n, n), generator=torch.Generator().manual_seed(3))
    _build.reset_launches()
    img = image(s, params, geom, torch.Generator().manual_seed(1),
                method="scan", noise_mode="per_step", **kw).image
    torch.cuda.synchronize()
    assert {k for k, v in _build.LAUNCHES.items() if v} == {kernel}
    clean = image(s, params, geom, method="scan", **kw).image
    tot, ref = float(img.double().sum()), float(clean.double().sum())
    assert img.is_cuda and abs(tot - ref) <= 5 * np.sqrt(ref)
    for method in ("scan", "analytic"):
        for boundary in ("circular", "padded", "apodized"):
            want = image(s, params, geom, method=method, boundary=boundary,
                         device="cpu").image
            got = image(s.numpy(), params, geom, method=method,
                        boundary=boundary, **kw).image
            assert got.is_cuda and _rel(got, want) <= 1e-5


# ---- K4 (full-frame fused rescan scan) and K5 (scatter-add) ---------------

def _k4_inputs(h, w, device, run=None, roll=0, seed=9):
    """A ramped sample, a narrow eff and gx (short tap runs) or, with
    ``run="full"``, profiles without zeros; ``roll`` moves both off centre
    so their runs wrap past the last index."""
    g = torch.Generator().manual_seed(seed)
    ramp = torch.linspace(0.2, 2.0, w)[None, :]
    s = torch.rand((h, w), generator=g) * ramp
    if run == "full":
        eff = 0.5 + torch.rand(w, generator=g)
        gx = 0.5 + torch.rand(w, generator=g)
        gx = gx / gx.sum()
    else:
        eff = 40.0 * _profile(w, 3.0, "cpu")
        gx = _profile(w, 2.0, "cpu")
        gx = gx / gx.sum()
    return (s.to(device), eff.roll(roll).to(device), gx.roll(roll).to(device))


@pytest.mark.parametrize("h,w,b,rf,run,roll", [
    (64, 256, 1, 2.0, None, 0), (64, 256, 2, 3.0, None, 0),
    (48, 200, 2, 2.0, None, 90), (40, 96, 1, 1.5, "full", 0),
    (24, 64, 2, 2.0, "full", 0), (30, 96, 3, 2.0, None, 0),
    (16, 512, 1, 1.25, None, 230)])
def test_rescan_fused_matches_plain(cuda, h, w, b, rf, run, roll):
    """K4 against its plain version, noise-free: rounded offsets (random
    ones too, wrapping), binning, a tap run that wraps, a full-width run,
    ragged CTA row tiles."""
    from rescan_line_sted_torch.kernels.rescan_fused import (
        _run, rescan_fused, rescan_fused_reference)

    s, eff, gx = _k4_inputs(h, w, cuda, run, roll)
    wc = int(round(rf * w)) // b
    pos = torch.arange(w, device=cuda)
    if roll:
        e0, ne = _run(eff)
        assert e0 + ne > w                       # the eff run wraps
    for offsets in (torch.round((rf - 1.0) * pos / b).int(),
                    torch.randint(-3 * wc, 3 * wc, (w,),
                                  generator=torch.Generator().manual_seed(1)
                                  ).to(cuda)):
        want = rescan_fused_reference(s, eff, gx, offsets, wc, b)
        before = _build.LAUNCHES["rescan_fused"]
        got = rescan_fused(s, eff, gx, offsets, wc, b)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["rescan_fused"] == before + 1
        assert got.shape == (h // b, wc) and _rel(got, want) <= 1e-5


@pytest.mark.parametrize("b,roll", [(1, 0), (1, 100), (2, 0)])
def test_rescan_fused_wrapped_windows(cuda, b, roll):
    """K4 where frame windows wrap the camera columns in most chunks (the
    windows' heads and tails placed as two strips), noise-free against its
    plain version, at b = 1 and b = 2; its draws there are deterministic
    and their total within 5 sigma."""
    from rescan_line_sted_torch.kernels.rescan_fused import (
        chunk_paths, rescan_fused, rescan_fused_reference)

    h, w = 32, 256
    s, eff, gx = _k4_inputs(h, w, cuda, roll=roll)
    assert chunk_paths(w, b, eff, gx)["split"] > 0
    wc = 2 * w // b
    offs = torch.round(torch.arange(w, device=cuda) / b).int()
    want = rescan_fused_reference(s, eff, gx, offs, wc, b)
    got = rescan_fused(s, eff, gx, offs, wc, b)
    assert got.shape == (h // b, wc) and _rel(got, want) <= 1e-5
    noisy = [rescan_fused(4.0 * s, eff, gx, offs, wc, b,
                          generator=torch.Generator().manual_seed(3))
             for _ in range(2)]
    mu = 4.0 * float(want.double().sum())
    assert torch.equal(noisy[0], noisy[1])
    assert abs(float(noisy[0].double().sum()) - mu) <= 5 * np.sqrt(mu)


def test_rescan_fused_nonfinite_and_negative(cuda):
    """Negative samples give negative noise-free frames (as the plain
    version) and clamp to 0 when drawn; a NaN sample reaches only canvas
    elements the plain version also gives NaN, and no finite one differs."""
    from rescan_line_sted_torch.kernels.rescan_fused import (
        rescan_fused, rescan_fused_reference)

    s, eff, gx = _k4_inputs(32, 128, cuda)
    s = s - 0.6
    offs = torch.arange(128, device=cuda).int()
    want = rescan_fused_reference(s, eff, gx, offs, 256)
    got = rescan_fused(s, eff, gx, offs, 256)
    assert float(want.min()) < 0 and _rel(got, want) <= 1e-5
    noisy = rescan_fused(s, eff, gx, offs, 256,
                         generator=torch.Generator().manual_seed(2))
    assert (noisy >= 0).all() and torch.equal(noisy, noisy.round())
    s[5, 40] = float("nan")
    want = rescan_fused_reference(s, eff, gx, offs, 256)
    got = rescan_fused(s, eff, gx, offs, 256)
    nan_got, nan_want = torch.isnan(got), torch.isnan(want)
    assert nan_got.any() and not (nan_got & ~nan_want).any()
    fin = ~nan_want
    assert _rel(got[fin], want[fin]) <= 1e-5
    noisy = rescan_fused(s, eff, gx, offs, 256,
                         generator=torch.Generator().manual_seed(2))
    assert torch.equal(torch.isnan(noisy), nan_got)


def test_rescan_fused_draws(cuda):
    """K4's per-frame draws at 256^2 over 16 seeds: totals within 5 sigma,
    the seed-mean matches the noise-free canvas and the per-pixel variance
    its mean (R = 2 places each binned pixel whole, so every canvas pixel
    is Poisson); the same seed gives the same canvas."""
    from rescan_line_sted_torch.kernels.rescan_fused import rescan_fused

    s, eff, gx = _k4_inputs(256, 256, cuda)
    s = 3.0 * s
    offs = torch.arange(256, device=cuda).int()
    mean = rescan_fused(s, eff, gx, offs, 512)
    draws = torch.stack([rescan_fused(
        s, eff, gx, offs, 512, generator=torch.Generator().manual_seed(k))
        for k in range(16)]).double()
    assert torch.equal(draws, draws.round()) and (draws >= 0).all()
    mu = float(mean.double().sum())
    assert float((draws.sum((1, 2)) - mu).abs().max()) <= 5 * np.sqrt(mu)
    sel = mean > 20.0
    rel = (draws.mean(0)[sel] - mean[sel]).abs().mean() / mean[sel].mean()
    ratio = (draws.var(0)[sel] / mean[sel]).mean()
    assert rel < 0.03 and 0.9 < float(ratio) < 1.1
    again = rescan_fused(s, eff, gx, offs, 512,
                         generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.double(), draws[0])
    assert not torch.equal(draws[0], draws[1])
    # scattered offsets: each position placed on its own (no canvas strip)
    offs = torch.randperm(512, generator=torch.Generator().manual_seed(3))[
        :256].int().to(cuda)
    mu = float(rescan_fused(s, eff, gx, offs, 512).double().sum())
    noisy = [rescan_fused(s, eff, gx, offs, 512,
                          generator=torch.Generator().manual_seed(k))
             for k in (5, 5)]
    assert torch.equal(noisy[0], noisy[1])
    assert torch.equal(noisy[0], noisy[0].round()) and (noisy[0] >= 0).all()
    assert abs(float(noisy[0].double().sum()) - mu) <= 5 * np.sqrt(mu)


def test_rescan_fused_limits(cuda):
    """Tap runs whose convolution overflows a block's shared memory even
    at one canvas row per block (a flat excitation 4096 columns wide)
    raise and name the limit; a sample K4 cannot read raises too."""
    from rescan_line_sted_torch.kernels.rescan_fused import rescan_fused

    s, eff, gx = _k4_inputs(8, 4096, cuda, run="full")
    with pytest.raises(ValueError, match="shared memory"):
        rescan_fused(s, eff, gx, torch.arange(4096, device=cuda), 8192)
    s, eff, gx = _k4_inputs(8, 64, cuda)
    with pytest.raises(ValueError, match="float32"):
        rescan_fused(s.double(), eff, gx, torch.arange(64, device=cuda), 128)


@pytest.mark.parametrize("n,h,w,wc", [
    (32, 64, 128, 256), (20, 16, 64, 64), (8, 24, 100, 40), (5, 8, 300, 37)])
def test_rescan_accumulate_matches_plain(cuda, n, h, w, wc):
    """K5 against its plain version: duplicate offsets, offsets beyond the
    canvas and negative ones, frames as wide as the canvas and wider (w >
    wc: heavy wrap, where the TPU wrapper gave way to XLA)."""
    from rescan_line_sted_torch.kernels.rescan_accumulate import (
        rescan_accumulate, rescan_accumulate_reference)

    g = torch.Generator().manual_seed(n)
    canvas = torch.rand((h, wc), generator=g).to(cuda)
    frames = torch.rand((n, h, w), generator=g).to(cuda)
    offsets = torch.randint(-2 * wc, 3 * wc, (n,), generator=g)
    offsets[1] = offsets[0]                      # a duplicate
    offsets = offsets.to(cuda)
    want = rescan_accumulate_reference(canvas, frames, offsets)
    before = _build.LAUNCHES["rescan_accumulate"]
    got = rescan_accumulate(canvas, frames, offsets)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["rescan_accumulate"] == before + 1
    assert got.shape == (h, wc) and _rel(got, want) <= 1e-5
    assert torch.equal(got, rescan_accumulate(canvas, frames, offsets))


class _WideExcModel:
    """No ``gaussian_excitation``: a flat excitation (full tap run)."""

    def excitation(self, width, params, device=None):
        return torch.ones(width, device=device)

    def depletion(self, width, params, device=None):
        return torch.zeros(width, device=device)


# (rf, b, use_pallas, kernel): the kernel each per-step route must launch
NO_BAND_ROUTES = [
    (2.0, 1, None, "rescan_fused"), (3.0, 2, True, "rescan_fused"),
    (2.0, 1, False, "rescan_accumulate"),
    (1.5, 1, None, "poisson_rows_tiered"), (1.5, 2, False, "poisson_flat"),
    (1.0 + np.pi / 16, 1, True, "poisson_rows_tiered")]


@pytest.mark.parametrize("rf,b,use_pallas,kernel", NO_BAND_ROUTES)
def test_no_band_routes_on_card(cuda, rf, b, use_pallas, kernel):
    """Each route without band windows launches its kernels on CUDA
    tensors and matches the CPU noise-free; collapsed noise launches K2c
    (after K4 with use_pallas=True)."""
    params = T.RescanParams.create(sigma_exc=2.0, sigma_det=2.0,
                                   stripe_period=8.0, depletion=4.0,
                                   brightness=40.0, model=_WideExcModel())
    geom = T.RescanGeometry(T.Grid(64, 96), rescan_factor=rf, binning=b,
                            chunk=16)
    s = torch.rand((64, 96), generator=torch.Generator().manual_seed(4))
    _build.reset_launches()
    img = T.rescanned_line_sted_image(
        s, params, geom, torch.Generator().manual_seed(1), method="scan",
        noise_mode="per_step", use_pallas=use_pallas).image
    torch.cuda.synchronize()
    launched = {k for k, v in _build.LAUNCHES.items() if v}
    want = {kernel} | ({"poisson_flat"} if kernel == "rescan_accumulate"
                       else set())
    assert launched == want, launched
    for up in (use_pallas, True, False):
        got = T.rescanned_line_sted_image(s, params, geom, method="scan",
                                          use_pallas=up).image
        ref = T.rescanned_line_sted_image(s, params, geom, method="scan",
                                          use_pallas=up, device="cpu").image
        assert got.is_cuda and _rel(got, ref) <= 1e-5
    ref = float(T.rescanned_line_sted_image(
        s, params, geom, method="scan", device="cpu").image.double().sum())
    assert abs(float(img.double().sum()) - ref) <= 5 * np.sqrt(ref)
    _build.reset_launches()
    T.rescanned_line_sted_image(s, params, geom,
                                torch.Generator().manual_seed(2),
                                method="scan", use_pallas=True)
    want = {"poisson_flat"} | ({"rescan_fused"} if (rf - 1) / b % 1 == 0
                               else set())
    assert {k for k, v in _build.LAUNCHES.items() if v} == want


def test_rounded_runs_beyond_k4_take_the_hybrid(cuda):
    """A flat excitation 4096 columns wide at b = 1 (tap runs beyond K4's
    bound ``runs_fit``), rounded per-step: the scan returns an image
    through the W-major K2b route, K4 untouched; its total lies within 5
    sigma of the noise-free CPU canvas's."""
    from rescan_line_sted_torch.kernels.rescan_fused import runs_fit

    params = T.RescanParams.create(sigma_exc=2.0, sigma_det=2.0,
                                   stripe_period=8.0, depletion=4.0,
                                   brightness=40.0, model=_WideExcModel())
    geom = T.RescanGeometry(T.Grid(8, 4096), rescan_factor=2.0, chunk=32)
    assert not runs_fit(torch.ones(4096), torch.ones(64))
    s = torch.rand((8, 4096), generator=torch.Generator().manual_seed(3))
    _build.reset_launches()
    img = T.rescanned_line_sted_image(
        s, params, geom, torch.Generator().manual_seed(1), method="scan",
        noise_mode="per_step").image
    torch.cuda.synchronize()
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == \
        {"poisson_rows_tiered": 4096 // 32}
    ref = float(T.rescanned_line_sted_image(
        s, params, geom, method="scan", device="cpu").image.double().sum())
    assert img.shape == (8, 8192) and torch.isfinite(img).all()
    assert abs(float(img.double().sum()) - ref) <= 5 * np.sqrt(ref)


# ---- ISM (rescanned point-STED) -------------------------------------------

def _ism(n, rf, b, chunk=64):
    return (T.PointSTEDParams.create(sigma_exc=3.0, sigma_det=3.0,
                                     sigma_dep=3.0, depletion=8.0,
                                     brightness=20.0),
            T.RescanPointGeometry(T.Grid(n, n), rescan_factor=rf, binning=b,
                                  chunk=chunk))


@pytest.mark.parametrize("rf,b", [(2.0, 1), (1.5, 1), (2.0, 2)])
def test_ism_on_card_matches_cpu(cuda, rf, b, monkeypatch):
    """ISM per-step noise launches K2b once per chunk of raster positions
    and nothing else; collapsed and analytic noise K2c once; with the draws
    replaced by the identity, and noise-free for every method and boundary,
    the card matches the CPU (1e-5)."""
    from rescan_line_sted_torch.imaging import rescan_point

    params, geom = _ism(64, rf, b)
    s = torch.rand((64, 64), generator=torch.Generator().manual_seed(5))
    _build.reset_launches()
    img = T.rescanned_point_sted_image(
        s, params, geom, torch.Generator().manual_seed(1), method="scan",
        noise_mode="per_step").image
    torch.cuda.synchronize()
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == \
        {"poisson_rows_tiered": 64 * 64 // 64}
    clean = T.rescanned_point_sted_image(s, params, geom, method="scan",
                                         device="cpu").image
    ref = float(clean.double().sum())
    assert img.is_cuda and abs(float(img.double().sum()) - ref) <= \
        5 * np.sqrt(ref)
    _build.reset_launches()
    for method in ("scan", "analytic"):
        T.rescanned_point_sted_image(s, params, geom,
                                     torch.Generator().manual_seed(2),
                                     method=method)
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == \
        {"poisson_flat": 2}
    for method in ("scan", "analytic"):
        for boundary in ("circular", "padded", "apodized"):
            want = T.rescanned_point_sted_image(
                s, params, geom, method=method, boundary=boundary,
                device="cpu").image
            got = T.rescanned_point_sted_image(
                s.numpy(), params, geom, method=method,
                boundary=boundary).image
            assert got.is_cuda and _rel(got, want) <= 1e-5
    monkeypatch.setattr(rescan_point, "poisson_rows_tiered",
                        lambda lam, g: lam.clamp_min(0))
    got = T.rescanned_point_sted_image(
        s, params, geom, torch.Generator().manual_seed(0), method="scan",
        noise_mode="per_step").image
    assert _rel(got, clean) <= 1e-5


# ---- K6 (the card's primitive rates) --------------------------------------

@pytest.mark.parametrize("name", ["fma", "uniform", "uniform_block", "exp",
                                  "inv_term", "knuth_round", "place_add",
                                  "sgemm", "tf32x3"])
def test_primitive_matches_plain(cuda, name):
    """Each K6 microkernel against its plain version at the reps, constants
    and tolerances of ``primitives.CHECKS`` (where one rep more or less
    moves the result past the tolerance); one launch each."""
    from rescan_line_sted_torch.kernels import primitives as prim

    n, key = 3000, (99, 12345)
    reps, tol = prim.CHECKS[name]
    chains = {"fma": (), "uniform": (key,), "uniform_block": (key,),
              "exp": (prim.CHECK_EXP_SCALE,),
              "inv_term": (key, prim.CHECK_INV_LAM), "knuth_round": (key,)}
    if name in chains:
        extra = chains[name]
        run = lambda: getattr(prim, name)(torch.empty(n, device=cuda), reps,
                                          *extra)
        want = getattr(prim, f"{name}_reference")(n, reps, *extra)
    elif name == "place_add":
        canvas = torch.rand((3, prim.CANVAS_ROWS, prim.COLS),
                            generator=torch.Generator().manual_seed(1))
        window = torch.rand((prim.WIN_ROWS, prim.COLS),
                            generator=torch.Generator().manual_seed(2))
        offsets = torch.tensor([0, 2944, 7, 7, 1000, 2943])
        want = prim.place_add_reference(canvas, window, offsets)
        run = lambda: prim.place_add(canvas.to(cuda), window.to(cuda),
                                     offsets.to(cuda))
    else:
        g = torch.Generator().manual_seed(3)
        a = torch.randint(0, 8, (256, 64), generator=g) / 8
        b = torch.randint(0, 8, (64, 128), generator=g) / 8
        want = prim.sgemm_reference(a, b, reps)
        run = lambda: getattr(prim, name)(a.to(cuda), b.to(cuda), reps)
    before = _build.LAUNCHES[f"primitives_{name}"]
    got = run()
    torch.cuda.synchronize()
    assert _build.LAUNCHES[f"primitives_{name}"] == before + 1
    assert got.shape == want.shape and _rel(got, want) <= tol


@pytest.mark.parametrize("case", range(len(PLACE_CASES)))
def test_place_add_bit_for_bit(cuda, case):
    """place_add on ``primitives.PLACE_CASES`` (1 and 33 canvases,
    offsets 0 and 2944, repeated and one row apart, 1, 7 and 4099 reps)
    bit for bit against the in-order adds of its plain version, one
    launch each."""
    from rescan_line_sted_torch.kernels import primitives as prim

    name, canvas, offsets = prim.place_add_case(case, cuda)
    window = torch.rand((prim.WIN_ROWS, prim.COLS),
                        generator=torch.Generator().manual_seed(7)).to(cuda)
    want = prim.place_add_reference(canvas, window, offsets)
    before = _build.LAUNCHES["primitives_place_add"]
    got = prim.place_add(canvas, window, offsets)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["primitives_place_add"] == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), name


def test_place_add_refuses_offsets_and_misalignment(cuda):
    """Offsets outside [0, 2944] raise on the card as on the CPU, before
    any launch; so do canvases off a 16-byte boundary (the TMA copies)."""
    from rescan_line_sted_torch.kernels import primitives as prim

    window = torch.ones((prim.WIN_ROWS, prim.COLS), device=cuda)
    canvas = torch.zeros((1, prim.CANVAS_ROWS, prim.COLS), device=cuda)
    before = _build.LAUNCHES["primitives_place_add"]
    for bad in ([0, 2945], [-1]):
        with pytest.raises(ValueError, match="offsets"):
            prim.place_add(canvas, window, torch.tensor(bad, device=cuda))
    flat = torch.zeros(prim.CANVAS_ROWS * prim.COLS + 1, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        prim.place_add(flat[1:].view(1, prim.CANVAS_ROWS, prim.COLS), window,
                       torch.tensor([0], device=cuda))
    assert _build.LAUNCHES["primitives_place_add"] == before


@pytest.mark.parametrize("reps", [1, 3])
@pytest.mark.parametrize("shape", [(4096, 128, 512), (256, 64, 128)])
def test_products_on_normal_operands(cuda, shape, reps):
    """sgemm and tf32x3 on seeded standard-normal operands
    (``primitives.normal_operands``, values TF32's high part does not
    hold) within ``NORMAL_TOL`` of the float64 product, one launch each;
    one TF32 pass (hi * hi alone, the plain helper) misses that bar on the
    same inputs, so a tf32x3 with wrong or missing lo passes fails here."""
    from rescan_line_sted_torch.kernels import primitives as prim

    m, k, n = shape
    a, b = prim.normal_operands(m, k, n)
    want = prim.product_float64(a, b, reps)
    assert _rel(prim.tf32_passes_reference(a, b, reps, passes=1),
                want) > prim.NORMAL_TOL
    for name in ("sgemm", "tf32x3"):
        before = _build.LAUNCHES[f"primitives_{name}"]
        got = getattr(prim, name)(a.to(cuda), b.to(cuda), reps)
        torch.cuda.synchronize()
        assert _build.LAUNCHES[f"primitives_{name}"] == before + 1
        assert got.shape == (m, n) and _rel(got, want) <= prim.NORMAL_TOL


def test_products_refuse_misaligned_operands(cuda):
    """The product kernels read 16-byte vectors (sgemm) and TMA boxes
    (tf32x3): an operand that starts off a 16-byte boundary raises."""
    from rescan_line_sted_torch.kernels import primitives as prim

    b = torch.ones((128, 128), device=cuda)
    a = torch.ones(128 * 128 + 1, device=cuda)[1:].view(128, 128)
    for name in ("sgemm", "tf32x3"):
        with pytest.raises(ValueError, match="aligned"):
            getattr(prim, name)(a, b, 1)


def test_primitive_rates_and_bound(cuda):
    """Every rate is positive and finite; the composite bound of a count
    set is the sum of its terms."""
    from rescan_line_sted_torch.kernels import primitives as prim

    rates = prim.primitive_rates(cuda)
    assert set(rates) == set(prim.NAMES)
    assert all(np.isfinite(r["rate"]) and r["rate"] > 0
               for r in rates.values())
    t = prim.composite_bound({"conv_fma": 1e9, "exps": 1e7,
                              "philox_blocks": 1e6, "windows": 10}, rates)
    assert t["total_ms"] == pytest.approx(
        t["conv_ms"] + t["sampler_ms"] + t["placement_ms"])


# ---- K1's host bound -------------------------------------------------------

def test_banded_fits_matches_the_kernel_layout(cuda):
    """``banded_fits`` against the C entry's own byte counts of K1's
    layouts, over a grid of band windows that crosses Hopper's opt-in
    limit (every argument of the formula varied)."""
    from rescan_line_sted_torch.kernels import rescan_banded_fused as k1

    crossed = set()
    for d_in in range(128, 1281, 64):
        for extra in (0, 128):
            for chunk, b, n_spread in ((32, 1, 0), (32, 1, 4), (16, 2, 0),
                                       (64, 1, 0), (8, 4, 4)):
                dob = (d_in + extra) // b
                layouts = k1.kernel_smem_bytes(d_in, dob, chunk, b, n_spread)
                assert layouts == k1.layout_smem_bytes(d_in, dob, chunk, b,
                                                       n_spread)
                resident, gen, lean = layouts
                assert lean == k1.banded_smem_bytes(d_in, dob, chunk, b,
                                                    n_spread)
                assert lean <= gen <= resident
                fits = k1.banded_fits(d_in, dob, chunk, b, n_spread)
                assert fits == (lean <= k1.SMEM_OPTIN)
                crossed.add(fits)
    assert crossed == {True, False}
    assert torch.cuda.get_device_properties(0).shared_memory_per_block_optin \
        >= k1.SMEM_OPTIN


def test_over_bound_windows_give_an_image_without_k1(cuda):
    """sigma_exc = 64 gives band windows D_in = 896 at chunk 32, beyond
    K1's bound: the card takes the same route as the CPU (no K1 launch, no
    NotImplementedError), its noise-free image within 1e-5 of the CPU's,
    and per-step noise gives a finite image."""
    params = T.RescanParams.create(sigma_exc=64.0, sigma_det=3.0,
                                   depletion=4.0, brightness=1.0)
    geom = T.RescanGeometry(T.Grid(16, 1024), rescan_factor=1.5, chunk=32)
    s = torch.rand((16, 1024), generator=torch.Generator().manual_seed(4))
    k1 = ("rescan_banded_fused", "rescan_banded_fused_spread",
          "rescan_banded_fused_wide", "rescan_banded_fused_spread_wide")
    before = dict(_build.LAUNCHES)
    want = T.rescanned_line_sted_image(s, params, geom, method="scan",
                                       device="cpu").image
    got = T.rescanned_line_sted_image(s, params, geom, method="scan").image
    noisy = T.rescanned_line_sted_image(
        s, params, geom, torch.Generator().manual_seed(2), method="scan",
        noise_mode="per_step").image
    torch.cuda.synchronize()
    assert got.is_cuda and _rel(got, want) <= 1e-5
    assert noisy.shape == geom.canvas_shape and torch.isfinite(noisy).all()
    assert all(_build.LAUNCHES[k] == before[k] for k in k1)


# ---- K2c: tiers per warp of 128 rates, settled bright draws ------------------

def _flat_rates(n, seed, scale, bright_every=0):
    """Rates varying over each warp of 128; every ``bright_every``-th warp
    gets one rate of 12 (the bright tier)."""
    lam = scale * torch.rand(n, generator=torch.Generator().manual_seed(seed))
    lam[:: 97] = 0.0
    if bright_every:
        lam[5::128 * bright_every] = 12.0
    return lam


@pytest.mark.parametrize("n,scale,misalign", [
    (1 << 18, 0.5, 0), (1 << 18, 8.0, 0), (1 << 18 | 77, 1.2, 0),
    (100003, 4.0, 1), (4099, 0.02, 3)])
def test_flat_draw_for_draw(cuda, n, scale, misalign):
    """K2c against ``poisson_rows_tiered_reference(flat=True)`` on the same
    Philox stream, count by count, on every warp below the bright tier
    (some warps are bright and are left out): ragged ends, and views whose
    data does not start on 16 bytes (the scalar path)."""
    from rescan_line_sted_torch.kernels.poisson import _CUT, warp_tiers

    full = _flat_rates(n + misalign, n, scale, bright_every=7)
    lam, dev = full[misalign:], full.to(cuda)[misalign:]
    assert (dev.data_ptr() % 16 == 0) == (misalign == 0)
    got = poisson_flat(dev, torch.Generator().manual_seed(n)).cpu()
    key = _host_key(torch.Generator().manual_seed(n))
    bright = warp_tiers(lam, flat=True) >= _CUT
    want = poisson_rows_tiered_reference(torch.where(bright, 0.0, lam), key,
                                         flat=True)
    diff = torch.where(bright, 0.0, (got - want).abs())
    assert bool(bright.any()) and bool((~bright).any())
    assert float(diff.max()) <= 1 and int((diff > 0).sum()) <= 4
    assert (got[lam == 0] == 0).all()


@pytest.mark.parametrize("lam_val,with_bright", [
    (7.0, True), (2.5, True), (12.0, False), (40.0, False), (300.0, False)])
def test_flat_bright_tier_statistics(cuda, lam_val, with_bright):
    """The bright tier with its loops ended once settled: Knuth (rates
    under 10 in a warp whose max is 10) and PTRS, moments and chi-square
    against the Poisson pmf (Knuth's 24 rounds put their tail mass on
    24)."""
    from scipy import stats

    n = 1 << 19
    lam = torch.full((n,), lam_val)
    if with_bright:
        lam[::128] = 10.0
    x = poisson_flat(lam.to(cuda), torch.Generator().manual_seed(17)).cpu()
    v = x.double().numpy()
    if with_bright:
        v = np.delete(v, np.arange(0, n, 128))
    m = v.size
    assert (v == np.round(v)).all() and (v >= 0).all()
    assert abs(v.mean() - lam_val) <= 5 * np.sqrt(lam_val / m)
    assert abs(v.var() - lam_val) <= 5 * np.sqrt((lam_val + 2 * lam_val ** 2)
                                                 / m)
    kmax = 24 if lam_val < 10 else int(lam_val + 8 * np.sqrt(lam_val) + 10)
    pmf = stats.poisson.pmf(np.arange(kmax + 1), lam_val)
    pmf[-1] += stats.poisson.sf(kmax, lam_val)
    obs = np.bincount(v.astype(np.int64), minlength=kmax + 1)[:kmax + 1]
    exp = pmf * m
    keep = exp > 5
    chi2 = ((obs[keep] - exp[keep]) ** 2 / exp[keep]).sum()
    assert stats.chi2.sf(chi2, max(int(keep.sum()) - 1, 1)) > 1e-6


def test_flat_cuda_generator_never_syncs(cuda, monkeypatch):
    """With a CUDA generator K2c takes its key words on the host from the
    generator's seed and offset: the call raises under sync-debug mode
    "error" if anything synchronises, and taking the words launches no
    kernel (no ``torch.randint``, and the profiler sees no device work)
    and advances the offset by 4. Its counts equal the host reference
    under the words that ``_build.key_words`` takes from the same
    generator state."""
    from torch.profiler import ProfilerActivity, profile

    lam = _flat_rates(1 << 16, 3, 3.0).to(cuda)
    poisson_flat(lam, torch.Generator(cuda).manual_seed(0))   # build, warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = poisson_flat(lam, torch.Generator(cuda).manual_seed(9))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    key = _host_key(torch.Generator(cuda).manual_seed(9))
    want = poisson_rows_tiered_reference(lam, key, flat=True)
    diff = (got.cpu() - want).abs()
    assert float(diff.max()) <= 1 and int((diff > 0).sum()) <= 4
    with pytest.raises(ValueError, match="generator"):
        _build.key_words(torch.Generator(cuda), torch.device("cpu"))
    gen = torch.Generator(cuda).manual_seed(9)
    torch.cuda.synchronize()
    monkeypatch.setattr(torch, "randint", None)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = _build.key_words(gen, cuda)
        torch.cuda.synchronize()
    assert got == (*key, None) and gen.get_offset() == 4
    assert not [e for e in prof.events() if e.device_type ==
                torch.autograd.DeviceType.CUDA]


def _layout_rates(case):
    """Rates for K2c's two layouts: every group bright (Knuth under 10,
    PTRS above), mixed tiers with bright groups, a ragged length, NaN and
    negative rates, and a size above the one-per-thread threshold."""
    g = torch.Generator().manual_seed(7)
    if case == "bright":
        return 15.0 * torch.rand((256, 256), generator=g)
    if case == "mixed":
        return _flat_rates(1 << 18, 5, 8.0, bright_every=3)
    if case == "ragged":
        return _flat_rates((1 << 16) + 77, 6, 1.2, bright_every=5)
    if case == "nan_negative":
        lam = 4.0 * torch.rand(100003, generator=g) - 1.0
        lam[::1013] = float("nan")
        lam[4096:8192] = -0.5
        return lam
    return _flat_rates(3 << 21, 8, 3.0, bright_every=11)


@pytest.mark.parametrize("case", ["bright", "mixed", "ragged", "nan_negative",
                                  "large"])
@pytest.mark.parametrize("misalign", [0, 1])
def test_flat_layouts_give_identical_counts(cuda, case, misalign):
    """K2c's one-element-per-thread layout and its four-element one give
    identical counts under one key, the bright tier included (each element
    keeps its single-draw word and its multi-draw stream), on aligned and
    misaligned views; the default layout is one of them; NaN rates give
    NaN and negative ones 0."""
    lam = _layout_rates(case)
    full = torch.cat([torch.zeros(misalign), lam.reshape(-1)]).to(cuda)
    dev = full[misalign:].reshape(lam.shape)
    one = poisson_flat(dev, key=(123, 456), _per_thread=1)
    four = poisson_flat(dev, key=(123, 456), _per_thread=4)
    default = poisson_flat(dev, key=(123, 456))
    assert torch.equal(one.nan_to_num(-1), four.nan_to_num(-1))
    assert torch.equal(default.nan_to_num(-1), one.nan_to_num(-1))
    assert torch.equal(torch.isnan(one), torch.isnan(dev))
    assert (one[dev <= 0] == 0).all() and float(one.nansum()) > 0


@pytest.mark.parametrize("kernel", KERNELS, ids=KERNEL_IDS)
def test_cuda_generator_counts_match_reference(cuda, kernel):
    """K2b and K2c on one CUDA generator: each call's counts equal the
    host reference under the words ``_host_key`` takes from a generator
    in the same state (below the bright cut), and consecutive calls take
    new words and give new counts."""
    flat = kernel is poisson_flat
    lam = 1.4 * torch.rand((96, 2048),
                           generator=torch.Generator().manual_seed(5))
    dev = lam.to(cuda)
    gen = torch.Generator(cuda).manual_seed(31)
    twin = torch.Generator(cuda).manual_seed(31)
    runs = []
    for _ in range(3):
        got = kernel(dev, gen).cpu()
        want = poisson_rows_tiered_reference(lam, _host_key(twin), flat)
        diff = (got - want).abs()
        assert float(diff.max()) <= 1 and int((diff > 0).sum()) <= 4
        runs.append(got)
    assert not torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[1], runs[2])


def test_flat_under_graph_capture_draws_anew_per_replay(cuda):
    """K2c captured in a CUDA graph with the card's default generator: its
    key words are drawn on the card inside the graph, so two replays give
    different counts, each with the Poisson mean and dispersion."""
    gen = torch.cuda.default_generators[cuda.index]
    lam = torch.full((512, 512), 5.0, device=cuda)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        poisson_flat(lam, gen)
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = _build.LAUNCHES["poisson_flat"]
    with torch.cuda.graph(graph):
        out = poisson_flat(lam, gen)
    assert _build.LAUNCHES["poisson_flat"] == before + 1
    runs = []
    for _ in range(2):
        graph.replay()
        runs.append(out.double().cpu())
    assert not torch.equal(runs[0], runs[1])
    n = lam.numel()
    for x in runs:
        assert (x == x.round()).all() and (x >= 0).all()
        assert abs(float(x.mean()) - 5.0) <= 5 * np.sqrt(5.0 / n)
        disp = float(((x - 5.0) ** 2 / 5.0).mean())
        assert abs(disp - 1.0) <= 5 * np.sqrt((2.0 + 1.0 / 5.0) / n)


# ---- K5: loads in flight, missed frames skipped, the sum order kept ----------

@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n,h,w,wc", [
    (32, 512, 512, 1024), (20, 16, 64, 64), (37, 9, 100, 333),
    (3000, 5, 40, 700)])
def test_rescan_accumulate_bitwise_in_order(cuda, dtype, n, h, w, wc):
    """K5 (w <= wc) bitwise equal to an in-order loop of per-frame adds on
    the card (``canvas[:, cols_n] += frames[n]``, n = 0, 1, ...: the canvas
    value first, then each frame), and over repeated calls; offsets of
    either integer type, negative and beyond wc, duplicated; more frames
    than one pass of staged offsets (3000)."""
    from rescan_line_sted_torch.kernels.rescan_accumulate import (
        rescan_accumulate, rescan_accumulate_reference)

    g = torch.Generator().manual_seed(n + w)
    canvas = torch.rand((h, wc), generator=g).to(cuda)
    frames = torch.rand((n, h, w), generator=g).to(cuda)
    offsets = torch.randint(-2 * wc, 3 * wc, (n,), generator=g)
    offsets[1::4] = offsets[::4][: len(offsets[1::4])]
    offsets = offsets.to(cuda, dtype)
    want = canvas.clone()
    x = torch.arange(w, device=cuda)
    for k in range(n):
        cols = torch.remainder(offsets[k].long() + x, wc)
        want[:, cols] += frames[k]
    before = _build.LAUNCHES["rescan_accumulate"]
    got = rescan_accumulate(canvas, frames, offsets)
    again = rescan_accumulate(canvas, frames, offsets)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["rescan_accumulate"] == before + 2
    assert torch.equal(got, want) and torch.equal(got, again)
    assert _rel(got, rescan_accumulate_reference(canvas, frames,
                                                 offsets)) <= 1e-5


# ---- the dose-matched sweep and FRC on the card --------------------------------

def _sweep_args(size=64):
    from rescan_line_sted_torch.data import siemens_star

    grid = T.Grid(size, size)
    return dict(
        sample=siemens_star((size, size), spokes=8, device="cpu"),
        point_base=T.PointSTEDParams.create(
            sigma_exc=2.0, sigma_det=2.0, sigma_dep=2.0, pinhole_radius=2.5,
            brightness=1.0),
        line_base=T.LineSTEDParams.create(
            sigma_exc=2.0, sigma_det=2.0, stripe_period=8.0,
            slit_halfwidth=2.5, brightness=1.0),
        point_geom=T.PointSTEDGeometry(grid), line_geom=T.LineSTEDGeometry(grid),
        depletion_powers=[0.0, 2.0, 8.0], orientations=2,
        rescan_geom=T.RescanGeometry(grid, rescan_factor=1.5),
        ism_geom=T.RescanPointGeometry(grid, rescan_factor=2.0))


def _sweep_columns(res):
    from rescan_line_sted_torch.sweeps.dose import ARMS

    for arm in ARMS:
        for col in ("image", "fwhm_x", "fwhm_y", "emitted_signal",
                    "exposure", "num_steps", "frc_resolution",
                    "frc_resolution_x", "frc_resolution_y"):
            yield f"{arm}.{col}", getattr(getattr(res, arm), col)


def test_sweep_on_card_matches_cpu(cuda):
    """The noise-free sweep, all four arms, on the card against the same
    sweep with ``device="cpu"``: every column within 1e-5."""
    from rescan_line_sted_torch.sweeps import dose_matched_sweep

    args = _sweep_args()
    got = dose_matched_sweep(dose_budget=100.0, device=cuda, **args)
    want = dose_matched_sweep(dose_budget=100.0, device="cpu", **args)
    for (name, g), (_, w) in zip(_sweep_columns(got), _sweep_columns(want)):
        if w is None:
            assert g is None, name
            continue
        assert g.is_cuda and g.shape == w.shape, name
        assert _rel(g, w) <= 1e-5, name


def test_noisy_sweep_launches_k2c(cuda):
    """A noisy sweep with ``frc=True`` on the card draws every image on K2c
    (two per arm and point), none on the plain sampler; one CUDA
    generator state gives one sweep bit for bit; totals within 5 sigma of
    the noise-free means."""
    from rescan_line_sted_torch.sweeps import dose_matched_sweep

    args = _sweep_args()
    clean = dose_matched_sweep(dose_budget=5000.0, device=cuda, **args)
    _build.reset_launches()
    got = dose_matched_sweep(dose_budget=5000.0, device=cuda, frc=True,
                             generator=torch.Generator(cuda).manual_seed(3),
                             **args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["poisson_flat"] == 4 * 3 * 2
    assert all(v == 0 for k, v in _build.LAUNCHES.items()
               if k != "poisson_flat")
    again = dose_matched_sweep(dose_budget=5000.0, device=cuda, frc=True,
                               generator=torch.Generator(cuda).manual_seed(3),
                               **args)
    for (name, g), (_, w) in zip(_sweep_columns(got), _sweep_columns(again)):
        assert (g is None and w is None) or torch.equal(g, w), name
    for arm in ("point", "line", "rescan", "ism"):
        imgs, means = getattr(got, arm).image, getattr(clean, arm).image
        for img, mean in zip(imgs, means):
            mu = float(mean.clamp_min(0).double().sum())
            assert abs(float(img.double().sum()) - mu) <= 5 * np.sqrt(mu)
    for col in (got.point.frc_resolution, got.line.frc_resolution,
                got.ism.frc_resolution, got.rescan.frc_resolution_x,
                got.rescan.frc_resolution_y):
        assert torch.isfinite(col).all()


def test_frc_on_card_matches_cpu(cuda):
    """FRC curve, radial and sectored resolutions on the card against the
    CPU within 1e-5, and the same bits on a repeated call."""
    from rescan_line_sted_torch.algorithms.frc import (
        frc_curve, frc_resolution, frc_sectored_resolution)
    from rescan_line_sted_torch.data import siemens_star

    g = torch.Generator().manual_seed(12)
    mean = 50.0 * siemens_star((96, 160), device="cpu")
    a = torch.poisson(mean, generator=g)
    b = torch.poisson(mean, generator=g)
    ac, bc = a.to(cuda), b.to(cuda)
    fw, cw = frc_curve(a, b)
    fg, cg = frc_curve(ac, bc)
    assert torch.equal(fg.cpu(), fw) and _rel(cg, cw) <= 1e-5
    assert torch.equal(frc_curve(ac, bc)[1], cg)
    for got, want in ((frc_resolution(ac, bc), frc_resolution(a, b)),
                      *zip(frc_sectored_resolution(ac, bc),
                           frc_sectored_resolution(a, b))):
        assert got.is_cuda
        if torch.isnan(want):
            assert torch.isnan(got).item()
        else:
            assert _rel(got, want) <= 1e-5


# ---- rotation, multi-orientation line-STED and the FOV sweep on the card ------

def _fov_params():
    return T.LineSTEDParams.create(depletion=8.0, brightness=200.0)


def test_rotate_on_card_matches_cpu(cuda):
    """512^2 rotations at four angles, batched, on the card against the
    CPU within 1e-5 (cos and sin come from the host on both)."""
    from rescan_line_sted_torch.data import siemens_star, sparse_points
    from rescan_line_sted_torch.utils import rotate_image

    img = (siemens_star((512, 512), device="cpu")
           + sparse_points((512, 512), device="cpu"))
    angles = torch.tensor([np.pi / 7, -np.pi / 3, np.pi / 4, 2 * np.pi])
    got = rotate_image(img.to(cuda), angles)
    want = rotate_image(img, angles)
    assert got.is_cuda and got.shape == (4, 512, 512)
    assert _rel(got, want) <= 1e-5


def test_noisy_orientations_launch_k2c_once(cuda):
    """A noisy analytic multi-orientation call draws its four views in ONE
    K2c launch and launches nothing else; totals within 5 sigma."""
    from rescan_line_sted_torch.data import siemens_star
    from rescan_line_sted_torch.imaging.orientations import (
        multi_orientation_line_sted)

    params = _fov_params()
    geom = T.LineSTEDGeometry(T.Grid(128, 128), chunk=32)
    sample = siemens_star((128, 128), device=cuda) + 0.05
    angles = torch.arange(4, dtype=torch.float32) * (np.pi / 4)
    clean, _ = multi_orientation_line_sted(sample, params, geom, angles)
    _build.reset_launches()
    views, kernels = multi_orientation_line_sted(
        sample, params, geom, angles,
        generator=torch.Generator(cuda).manual_seed(2))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["poisson_flat"] == 1
    assert all(v == 0 for k, v in _build.LAUNCHES.items()
               if k != "poisson_flat")
    assert views.is_cuda and views.shape == kernels.shape == (4, 128, 128)
    for view, mean in zip(views, clean):
        mu = float(mean.clamp_min(0).double().sum())
        assert abs(float(view.double().sum()) - mu) <= 5 * np.sqrt(mu)


def test_fov_sweep_on_card_matches_cpu(cuda):
    """The noise-free FOV sweep at 64^2 (four angles, 40 RL iterations) on
    the card against ``device="cpu"``: every record column but the times
    within 1e-5."""
    from rescan_line_sted_torch.sweeps import resolution_fov_sweep

    got = resolution_fov_sweep((64,), _fov_params(), device=cuda)
    want = resolution_fov_sweep((64,), _fov_params(), device="cpu")
    for col in ("fov", "scan_steps", "fused_fwhm_y", "fused_fwhm_x",
                "view_kernel_fwhm_y", "view_kernel_fwhm_x"):
        g, w = got[0][col], want[0][col]
        assert np.isfinite(w) and abs(g - w) <= 1e-5 * abs(w), col


# ---- operator fusion and the fused dose sweep on the card ---------------------

def _fusion_setup(size, rescan_factor=2.0, binning=1):
    return (T.LineSTEDParams.create(depletion=8.0, sigma_exc=3.0,
                                    sigma_det=3.0, stripe_period=12.0,
                                    slit_halfwidth=4.0, brightness=1.0),
            T.RescanGeometry(T.Grid(size, size), rescan_factor=rescan_factor,
                             binning=binning, chunk=32))


def test_rescan_operator_adjoint_on_card(cuda):
    """<A x, y> = <x, A^T y> at 512^2 with a rotation, R = 1.5 and binning
    2 on the card (the adjoint's scatter runs on atomics), and the forward
    and adjoint maps against the CPU's within 1e-5."""
    from rescan_line_sted_torch.algorithms import rescan_operator

    params, geom = _fusion_setup(512, 1.5, 2)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(size=(512, 512)).astype(np.float32))
    y = torch.from_numpy(rng.uniform(size=geom.canvas_shape)
                         .astype(np.float32))
    fwd, adj = rescan_operator(geom, params, angle=0.7)
    ax, aty = fwd(x.to(cuda)), adj(y.to(cuda))
    assert ax.is_cuda and aty.is_cuda
    lhs = float((ax.double() * y.to(cuda).double()).sum())
    rhs = float((x.to(cuda).double() * aty.double()).sum())
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)
    cpu_fwd, cpu_adj = rescan_operator(geom, params, angle=0.7, device="cpu")
    assert _rel(ax, cpu_fwd(x)) <= 1e-5
    assert _rel(aty, cpu_adj(y)) <= 1e-5


def test_canvas_placement_routes_agree_on_card(cuda, monkeypatch):
    """The fusion cell's four-view canvas map (the star rotated by v pi /
    4, R = 2) at 512^2 on the card, forward and autograd adjoint, against
    the same map in float64 with the placement as the exact phase table
    (complex128): the FFT placement within 1e-6 of the maximum, and no
    further from it than the phase-table product in complex64, forced
    (its float32 sums over 512 columns read ~1.1e-6 on an H100)."""
    from rescan_line_sted_torch.data import siemens_star
    from rescan_line_sted_torch.imaging import analytic
    from rescan_line_sted_torch.utils import rotate_image

    params, geom = _fusion_setup(512)
    n = 512
    hc, wc = geom.canvas_shape
    x = rotate_image(siemens_star((n, n), device=cuda),
                     -torch.arange(4) * (np.pi / 4))
    y = torch.rand((4, hc, wc),
                   generator=torch.Generator().manual_seed(6)).to(cuda)

    def apply(canvas, x, y):
        xg = x.clone().requires_grad_()
        out = canvas(xg)
        return out.detach(), torch.autograd.grad(out, xg, y)[0]

    analytic._canvas_constants.cache_clear()
    try:
        assert analytic._fft_placement(geom)
        fft = apply(analytic._canvas_map(params, geom, cuda), x, y)
        gy_t, h_hat, pm = analytic._canvas_constants(params, geom, cuda)
        assert pm is None
        monkeypatch.setattr(analytic, "_fft_placement", lambda g: False)
        analytic._canvas_constants.cache_clear()
        gemm = apply(analytic._canvas_map(params, geom, cuda), x, y)
    finally:
        analytic._canvas_constants.cache_clear()

    k = np.arange(wc // 2 + 1)
    table = torch.from_numpy(np.exp(-2j * np.pi * k[None, :]
                                    * geom.rescan_factor
                                    * np.arange(n)[:, None] / wc)).to(cuda)

    def exact(s):
        s_ph = (gy_t.double() @ s).reshape(4, hc, n, 1).movedim(-1, -3)
        rfft = ((s_ph.to(torch.complex128) @ table)
                * h_hat.to(torch.complex128)).sum(-3)
        return params.brightness * torch.fft.irfft(rfft, n=wc, dim=-1)

    want = apply(exact, x.double(), y.double())
    for got, prod, ref in zip(fft, gemm, want):
        assert got.is_cuda and _rel(got, ref) <= 1e-6
        assert _rel(got, ref) <= _rel(prod, ref)


@pytest.mark.parametrize("accelerate,num_iter", [(False, 30), (True, 15)],
                         ids=["plain", "accelerate"])
def test_rescan_fusion_on_card_matches_cpu(cuda, accelerate, num_iter):
    """Two noise-free canvases of a 128^2 star (R = 2) fused by RL on the
    card against the CPU within 1e-5 (not bit for bit: the adjoint's
    scatter uses atomics). The accelerated loop amplifies those float32
    differences, past 1e-5 by 30 iterations (2.2e-5 on an H100), as it
    does the CPU's against the JAX package's (1.5e-5 at 40), so it is held
    at 15."""
    from rescan_line_sted_torch.algorithms import (
        multi_orientation_rescan, rescan_fusion)
    from rescan_line_sted_torch.data import siemens_star

    params, geom = _fusion_setup(128)
    sample = siemens_star((128, 128), device="cpu")
    angles = (0.0, np.pi / 2)
    canv = multi_orientation_rescan(sample, params, geom, angles,
                                    device="cpu")
    got_canv = multi_orientation_rescan(sample, params, geom, angles)
    assert _rel(got_canv, canv) <= 1e-5
    got = rescan_fusion(got_canv, params, geom, angles, num_iter,
                        accelerate=accelerate)
    want = rescan_fusion(canv, params, geom, angles, num_iter,
                         accelerate=accelerate)
    assert got.is_cuda and _rel(got, want) <= 1e-5


@pytest.mark.parametrize("method,launches", [
    ("analytic", {"poisson_flat": 1}),
    ("scan", {"rescan_banded_fused": 2, "poisson_flat": 2})])
def test_noisy_multi_orientation_rescan_launches(cuda, method, launches):
    """A noisy analytic call draws both views in ONE K2c launch; a noisy
    scan call runs K1 once per view, noise-free, then K2c once per view
    (collapsed draws); nothing else launches. Totals within 5 sigma."""
    from rescan_line_sted_torch.algorithms import multi_orientation_rescan
    from rescan_line_sted_torch.data import siemens_star

    params, geom = _fusion_setup(256, 1.5)
    sample = siemens_star((256, 256), device=cuda)
    angles = (0.0, np.pi / 2)
    clean = multi_orientation_rescan(sample, params, geom, angles,
                                     method=method)
    _build.reset_launches()
    noisy = multi_orientation_rescan(
        sample, params, geom, angles, torch.Generator(cuda).manual_seed(4),
        method=method)
    torch.cuda.synchronize()
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == launches
    assert noisy.shape == (2,) + geom.canvas_shape
    for img, mean in zip(noisy, clean):
        mu = float(mean.clamp_min(0).double().sum())
        assert abs(float(img.double().sum()) - mu) <= 5 * np.sqrt(mu)


def test_fused_sweep_on_card_matches_cpu(cuda):
    """The noise-free fused sweep at 64^2 (all four arms, two orientations,
    rescan R = 2, 10 RL iterations) on the card against ``device="cpu"``:
    every column within 1e-5; a noisy one launches K2c once per arm and
    point and nothing else."""
    from rescan_line_sted_torch.sweeps import dose_matched_sweep

    args = dict(_sweep_args(), rescan_geom=T.RescanGeometry(
        T.Grid(64, 64), rescan_factor=2.0), fuse_orientations=True,
        fusion_iters=10)
    got = dose_matched_sweep(dose_budget=100.0, device=cuda, **args)
    want = dose_matched_sweep(dose_budget=100.0, device="cpu", **args)
    for (name, g), (_, w) in zip(_sweep_columns(got), _sweep_columns(want)):
        if w is None:
            assert g is None, name
            continue
        assert g.is_cuda and g.shape == w.shape, name
        assert _rel(g, w) <= 1e-5, name
    _build.reset_launches()
    dose_matched_sweep(dose_budget=100.0, device=cuda,
                       generator=torch.Generator(cuda).manual_seed(3), **args)
    torch.cuda.synchronize()
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        "poisson_flat": 4 * 3}


def _cli_json(capsys, argv) -> dict:
    """The last stdout line of ``rescan_line_sted_torch``'s CLI, as strict
    JSON (NaN and Infinity refused)."""
    import json

    from rescan_line_sted_torch.cli import main

    main(argv)

    def no_const(c):
        raise ValueError(f"non-RFC JSON constant: {c}")

    return json.loads(capsys.readouterr().out.strip().splitlines()[-1],
                      parse_constant=no_const)


@pytest.mark.parametrize("figure,k2c", [
    (["comparison"], 2 * 2),                 # two arms x two powers
    (["sweep", "--num-powers", "2"], 3 * 4),  # three arms x one chunk of 4
], ids=["comparison", "sweep"])
def test_cli_figure_on_card_matches_cpu(cuda, tmp_path, capsys, figure, k2c):
    """A figure at 64^2 on the card (the CLI's default device) against
    ``--platform cpu``: every noise-free metric within 1e-5 relative; K2c
    launched as predicted and nothing else."""
    args = ["figure", *figure, "--size", "64"]
    _build.reset_launches()
    card = _cli_json(capsys, [*args, "--out", str(tmp_path / "card")])
    torch.cuda.synchronize()
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        "poisson_flat": k2c}
    cpu = _cli_json(capsys, ["--platform", "cpu", *args, "--out",
                             str(tmp_path / "cpu")])
    assert set(card) == set(cpu)
    for k, v in cpu.items():
        if isinstance(v, float):
            assert abs(card[k] - v) <= 1e-5 * abs(v), k
        else:
            assert card[k] == v, k
    assert sorted(p.name for p in (tmp_path / "card").iterdir()) == sorted(
        p.name for p in (tmp_path / "cpu").iterdir())


def test_html_report_on_card(cuda, tmp_path):
    """The report at 48^2 on the card: one data URI per frame, three
    sliders; K2c once per arm, draw and power of the sweep (4 x 2 x 2),
    then once each for the camera frames, the scan image and the views."""
    from rescan_line_sted_torch.pipelines import html_report

    _build.reset_launches()
    m = html_report(str(tmp_path), size=48, num_powers=2, num_angles=2,
                    rl_iters=5, scan_frames=3)
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        "poisson_flat": 16 + 3}
    html = (tmp_path / "index.html").read_text()
    assert html.count("data:image/") == m["frames"] == 8
    assert html.count('<input type="range"') == 3 and "wire(" in html


def test_native_tiff_codec_bytes(tmp_path):
    """The native codec builds with g++ and writes the pure-Python
    writer's bytes for a [16, 256, 256] float32 stack."""
    from rescan_line_sted_torch.io import array_to_tif
    from rescan_line_sted_torch.io.native import native_available

    assert native_available()
    arr = np.random.default_rng(0).random((16, 256, 256), np.float32)
    array_to_tif(arr, str(tmp_path / "n.tif"), use_native=True)
    array_to_tif(arr, str(tmp_path / "p.tif"), use_native=False)
    assert (tmp_path / "n.tif").read_bytes() == (tmp_path / "p.tif").read_bytes()


def test_line_fit_on_card_matches_cpu_and_never_syncs(cuda):
    """The 2048^2 line fit's loss and gradient at its start (the softplus
    parameterisation of ``algorithms/calibration.py``) on the card against
    the CPU's (1e-4 relative), and 20 steps of the fit under sync-debug
    mode "error": the loop reads nothing back."""
    from rescan_line_sted_torch.algorithms import fit_line_sted_params
    from rescan_line_sted_torch.data import sparse_points

    n, fields = 2048, ("sigma_det", "depletion")
    geom = T.LineSTEDGeometry(T.Grid(n, n), chunk=32)
    true = T.LineSTEDParams.create(sigma_exc=2.5, sigma_det=3.0,
                                   stripe_period=10.0, depletion=5.0,
                                   slit_halfwidth=3.0, brightness=100.0)
    init = true.replace(sigma_det=2.0, depletion=1.0)
    sample = sparse_points((n, n), spacing=16, device=cuda)
    data = T.line_sted_image(sample, true, geom).image
    got = {}
    for dev in (cuda, torch.device("cpu")):
        theta = {f: torch.log(torch.expm1(torch.tensor(
            getattr(init, f), device=dev))).requires_grad_() for f in fields}
        p = init.replace(**{f: torch.nn.functional.softplus(t)
                            for f, t in theta.items()})
        loss = torch.mean(torch.square(T.line_sted_image(
            sample.to(dev), p, geom, device=dev).image - data.to(dev)))
        loss.backward()
        got[dev.type] = [float(loss.detach())] + [float(theta[f].grad)
                                                 for f in fields]
    for a, b in zip(got["cuda"], got["cpu"]):
        assert abs(a - b) <= 1e-4 * abs(b), got
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fitted, losses = fit_line_sted_params(data, sample, init, geom,
                                              num_steps=20)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert losses.is_cuda and fitted.sigma_det.is_cuda
    assert bool(torch.isfinite(losses).all()) and losses[-1] < losses[0]


def test_port_spans_share_the_cards_clock_and_count_every_read(cuda,
                                                               tmp_path):
    """A profiled per-step call at the flagship's shapes (2048^2, R = 1.5,
    K1 class mode), then K1 called as an outside caller calls it, its plan
    built with classes and no ``class_bounds``: each K1
    ``cudaLaunchKernel`` lies inside ``rls.k1`` and its kernel starts
    after the span opens (one clock for the port's spans and the card),
    and every device-to-host copy and runtime wait in the calls' stretch
    outside the harness-style ``bench.sync`` lies inside ``rls.read_back``
    (the outside plan's class check; the entry reads nothing back), one
    copy to a read, so the counter misses no sync."""
    import json

    from torch.profiler import ProfilerActivity, profile, record_function

    n = 2048
    params = T.LineSTEDParams.create(sigma_exc=3.0, sigma_det=3.0,
                                     stripe_period=12.0, depletion=8.0,
                                     slit_halfwidth=4.0, brightness=1.0)
    geom = T.RescanGeometry(T.Grid(n, n), rescan_factor=1.5, chunk=32)
    sample = torch.rand((n, n), device=cuda)
    gen = torch.Generator(cuda).manual_seed(3)

    args, kw = _case(2, 1, 1.5, 8, cuda)

    def call():
        image = T.rescanned_line_sted_image(
            sample, params, geom, generator=gen, method="scan",
            noise_mode="per_step", device=cuda).image
        _k1(rescan_banded_fused, *args, **kw)
        return image

    call()
    torch.cuda.synchronize()
    calls = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            with record_function("bench.call"):
                out = call()
                with record_function("bench.sync"):
                    torch.cuda.synchronize()
            del out
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    xs = [e for e in json.loads(path.read_text())["traceEvents"]
          if e.get("ph") == "X" and "dur" in e]

    def spans(name):
        return [(e["ts"], e["ts"] + e["dur"]) for e in xs
                if e.get("cat") == "user_annotation" and e["name"] == name]

    def inside(ts, ivs):
        return any(a <= ts <= b for a, b in ivs)

    k1, reads, syncs = spans("rls.k1"), spans("rls.read_back"), \
        spans("bench.sync")
    # the stretch of the calls (the profiler's own stop syncs after it)
    t0, t1 = min(a for a, _ in spans("bench.call")), \
        max(b for _, b in spans("bench.call"))
    assert len(k1) == 2 * calls and len(reads) == calls
    runtime = {e["args"]["correlation"]: e for e in xs
               if e.get("cat") == "cuda_runtime" and "correlation" in
               e.get("args", {})}
    kernels = [e for e in xs if e.get("cat") == "kernel"
               and "rescan_banded_fused" in e["name"]]
    assert len(kernels) == 2 * calls
    for kern in kernels:
        launch = runtime[kern["args"]["correlation"]]
        assert launch["name"] == "cudaLaunchKernel"
        opened = [a for a, b in k1 if a <= launch["ts"] <= b]
        assert opened, "K1's launch outside rls.k1"
        assert kern["ts"] >= opened[0]
    waits = [e for e in xs if e.get("cat") == "cuda_runtime" and e["name"]
             in ("cudaDeviceSynchronize", "cudaStreamSynchronize",
                 "cudaEventSynchronize", "cudaMemcpy")
             and t0 <= e["ts"] < t1 and not inside(e["ts"], syncs)]
    # each device-to-host copy by the runtime call that issued it
    copies = [runtime[e["args"]["correlation"]]["ts"] for e in xs
              if e.get("cat") == "gpu_memcpy" and "DtoH" in e["name"]]
    copies = [ts for ts in copies
              if t0 <= ts < t1 and not inside(ts, syncs)]
    stray = [(e["name"], e["ts"]) for e in waits
             if not inside(e["ts"], reads)]
    assert waits and not stray, (len(waits), stray, reads)
    assert len(copies) == len(reads), (copies, reads)
    assert all(inside(ts, reads) for ts in copies), (copies, reads)


@pytest.mark.parametrize("route", ["per_step", "nufft", "analytic"])
def test_second_entry_call_reads_nothing_back(cuda, route, monkeypatch):
    """The rescan entry keeps its tables in a plan per (params, geometry,
    placement, device): at 256 x 1024 with the flagship's params, the
    second call of the per-step (K1 class mode, R = 1.5), NUFFT (R = 1 +
    pi/16) and closed-form entries opens no ``rls.read_back``,
    ``rls.host_table`` or ``rls.plan_build`` span and makes no host-device
    sync (sync-debug mode "error"); K1 launches once a K1 call; and the
    images, noise-free and drawn from a same-seeded CUDA generator, equal
    an uncached build's bit for bit."""
    from torch.profiler import ProfilerActivity, profile

    from rescan_line_sted_torch import device as device_mod
    from rescan_line_sted_torch.imaging import analytic, rescan

    params = T.LineSTEDParams.create(sigma_exc=3.0, sigma_det=3.0,
                                     stripe_period=12.0, depletion=8.0,
                                     slit_halfwidth=4.0, brightness=1.0)
    rf = 1.0 + np.pi / 16 if route == "nufft" else 1.5
    geom = T.RescanGeometry(T.Grid(256, 1024), rescan_factor=rf, chunk=32)
    method = "analytic" if route == "analytic" else "scan"
    sample = torch.rand((256, 1024), generator=torch.Generator().manual_seed(
        5)).to(cuda)
    rescan._image_plan.cache_clear()
    analytic._canvas_constants.cache_clear()

    def call(seed):
        gen = (None if seed is None
               else torch.Generator(cuda).manual_seed(seed))
        return T.rescanned_line_sted_image(
            sample, params, geom, generator=gen, method=method,
            noise_mode="per_step" if method == "scan" else "collapsed",
            device=cuda).image

    call(1)                                        # builds the plans
    torch.cuda.synchronize()
    k1 = "rescan_banded_fused" + ("_spread" if route == "nufft" else "")
    before = _build.LAUNCHES[k1]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            noisy, clean = call(1), call(None)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    opened = {e.name for e in prof.events()}
    assert "rls.image" in opened
    assert not opened & {"rls.read_back", "rls.host_table",
                         "rls.plan_build"}, opened
    runs_k1 = method == "scan"
    assert _build.LAUNCHES[k1] == before + 2 * runs_k1
    monkeypatch.setattr(device_mod, "cache_key_ok", lambda _: False)
    assert torch.equal(noisy, call(1)) and torch.equal(clean, call(None))
    torch.cuda.synchronize()
    assert _build.LAUNCHES[k1] == before + 4 * runs_k1

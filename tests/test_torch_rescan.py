"""The rescanned line-STED slice end to end: ``rescan_line_sted_torch``
against the JAX package on the same numpy samples.

Noise-free agreement: max|port - jax| / max|jax| <= 1e-5. The scan method
is compared with the JAX package's banded Pallas kernel in interpret mode
(``use_pallas=True``). Off the TPU the JAX package never routes per-step
noise to that kernel, so noise is checked statistically: over seeds the
noisy canvases average to the noise-free one with the Poisson variance.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rescan_line_sted_torch as T
import rescan_line_sted_tpu as J
from rescan_line_sted_torch.convert import geometry_from_jax, params_from_jax
from rescan_line_sted_torch.data import siemens_star
from rescan_line_sted_torch.imaging import rescan as trescan
from rescan_line_sted_torch.kernels import _build
from rescan_line_sted_tpu.imaging import rescan as jrescan

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
H, W = 64, 256           # the banded route needs W > its 128-column window
KW = dict(sigma_exc=2.0, sigma_det=2.0, stripe_period=8.0, depletion=4.0,
          brightness=40.0)


def _sample(seed=0, margin=0):
    s = np.random.default_rng(seed).random((H, W), np.float32)
    if margin:
        s[:, :margin] = 0
        s[:, -margin:] = 0
    return s


def _both(rf, b=1, chunk=16, **kw):
    params = {**KW, **kw}
    return ((J.RescanParams.create(**params),
             J.RescanGeometry(J.Grid(H, W), rescan_factor=rf, binning=b,
                              chunk=chunk)),
            (T.RescanParams.create(**params),
             T.RescanGeometry(T.Grid(H, W), rescan_factor=rf, binning=b,
                              chunk=chunk)))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _port(sample, p, g, **kw):
    return T.rescanned_line_sted_image(torch.from_numpy(sample), p, g,
                                       device="cpu", **kw)


@pytest.mark.parametrize("rf,b", [(2.0, 1), (1.5, 1), (3.0, 2), (1.25, 2)])
def test_analytic_matches_jax(rf, b):
    (jp, jg), (tp, tg) = _both(rf, b)
    s = _sample(1)
    want = J.imaging.rescanned_line_sted_image(jnp.asarray(s), jp, jg).image
    got = _port(s, tp, tg).image
    assert got.shape == tg.canvas_shape
    assert _rel(got, want) <= 1e-5


# (R, b) of the closed form's placement: an FFT where R * (W/b) == Wc,
# the phase-table product elsewhere
PLACEMENTS = {"r1.5_b1": (1.5, 1), "r1.5_b2": (1.5, 2), "r2_b1": (2.0, 1),
              "r2_b2": (2.0, 2), "r3_b1": (3.0, 1), "r3_b2": (3.0, 2),
              "r1+pi/16_b1": (1.0 + np.pi / 16, 1)}


@pytest.mark.parametrize("case", list(PLACEMENTS))
def test_canvas_placement_routes(case, monkeypatch):
    """The closed form's placement route on four views at 64^2: decided
    once per plan from the geometry; where ``R * (W/b) == Wc`` an FFT
    equal to the phase-table product (forced here) within 1e-6 of the
    canvas's maximum, elsewhere that product itself; either route's
    autograd adjoint satisfies <A x, y> = <x, A^T y> to 1e-5."""
    from rescan_line_sted_torch.imaging import analytic

    rf, b = PLACEMENTS[case]
    n = 64
    params = T.LineSTEDParams.create(**KW)
    geom = T.RescanGeometry(T.Grid(n, n), rescan_factor=rf, binning=b)
    wc = geom.canvas_shape[1]
    fft = case != "r1+pi/16_b1"
    assert analytic._fft_placement(geom) == fft
    assert (rf * (n // b) == wc) == fft
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.random((4, n, n), np.float32))
    y = torch.from_numpy(rng.random((4,) + geom.canvas_shape, np.float32))
    decide = analytic._fft_placement
    decisions = []

    def counted(g):
        decisions.append(g)
        return decide(g)

    monkeypatch.setattr(analytic, "_fft_placement", counted)
    analytic._canvas_constants.cache_clear()
    try:
        canvas = analytic._canvas_map(params, geom, "cpu")
        got = canvas(x)
        assert torch.equal(analytic._canvas_map(params, geom, "cpu")(x), got)
        assert len(decisions) == 1
        assert (analytic._canvas_constants(params, geom, torch.device(
            "cpu"))[2] is None) == fft

        xg = x.clone().requires_grad_()
        aty = torch.autograd.grad(canvas(xg), xg, y)[0]
        lhs = float((got.double() * y.double()).sum())
        rhs = float((x.double() * aty.double()).sum())
        assert abs(lhs - rhs) <= 1e-5 * abs(lhs)

        monkeypatch.setattr(analytic, "_fft_placement", lambda g: False)
        analytic._canvas_constants.cache_clear()
        want = analytic._canvas_map(params, geom, "cpu")(x)
    finally:
        analytic._canvas_constants.cache_clear()
    if fft:
        assert _rel(got, want) <= 1e-6
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("rf,b,reassignment", [
    (2.0, 1, "auto"), (1.5, 1, "auto"), (3.0, 2, "auto"),
    (1.5, 1, "rounded"), (2.0, 2, "subpixel")])
def test_scan_matches_jax_banded(rf, b, reassignment):
    (jp, jg), (tp, tg) = _both(rf, b)
    s = _sample(2)
    want = J.imaging.rescanned_line_sted_image(
        jnp.asarray(s), jp, jg, method="scan", use_pallas=True,
        reassignment=reassignment).image
    got = _port(s, tp, tg, method="scan", reassignment=reassignment).image
    assert _rel(got, want) <= 1e-5


def test_scan_matches_analytic_with_zero_margins():
    _, (tp, tg) = _both(1.5)
    s = _sample(3, margin=32)
    scan = _port(s, tp, tg, method="scan").image
    ana = _port(s, tp, tg).image
    assert _rel(scan, ana) <= 1e-5


@pytest.mark.parametrize("rf", [1.5, 2.0])
def test_dose_matches_jax(rf):
    (jp, jg), (tp, tg) = _both(rf)
    want = J.imaging.rescanned_line_sted_image(
        jnp.asarray(_sample()), jp, jg).dose
    got = _port(_sample(), tp, tg).dose
    for f in ("excitation_dose", "depletion_dose",
              "emission_per_unit_sample", "num_steps"):
        assert _rel(getattr(got, f), getattr(want, f)) <= 1e-5, f


@pytest.mark.parametrize("depletion,tolerance,snap", [
    (0.0, 0.05, 8), (8.0, 0.05, 8), (8.0, 0.1, None), (16.0, 0.02, 4)])
def test_rescan_factor_helpers(depletion, tolerance, snap):
    kw = dict(KW, depletion=depletion)
    jp, tp = J.RescanParams.create(**kw), T.RescanParams.create(**kw)
    pairs = [
        (trescan.practical_rescan_factor(tp, 128, tolerance, snap=snap),
         jrescan.practical_rescan_factor(jp, 128, tolerance, snap=snap)),
        (trescan.optimal_rescan_factor(tp, 128),
         jrescan.optimal_rescan_factor(jp, 128)),
        (trescan.rescan_kernel_sigma(tp, 128, [1.0, 1.5, 2.0, 4.0]),
         jrescan.rescan_kernel_sigma(jp, 128, jnp.asarray([1.0, 1.5, 2.0,
                                                           4.0]))),
        (trescan.practical_factor_from_sigmas(1.3, 2.0, tolerance, 3.0, snap),
         jrescan.practical_factor_from_sigmas(jnp.float32(1.3),
                                              jnp.float32(2.0), tolerance,
                                              3.0, snap)),
    ]
    for got, want in pairs:
        assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("rf,b", [(2.0, 1), (1.5, 1), (3.0, 2)])
def test_routing_helpers_match_jax(rf, b):
    (jp, _), (tp, _) = _both(rf, b)
    for chunk in (8, 16, 32):
        assert trescan._illum_band(tp, W, chunk, b) == \
            jrescan._illum_band(jp, W, chunk, b)
        step = (rf - 1.0) / b
        assert trescan._rational_step(step, chunk) == \
            jrescan._rational_step(step, chunk)
    cam = np.random.default_rng(0).random((3, 8, 12), np.float32)
    assert _rel(trescan._rebin(torch.from_numpy(cam), 2),
                jrescan._rebin(jnp.asarray(cam), 2)) <= 1e-6
    folded = np.random.default_rng(1).random((2, 96, 16), np.float32)
    assert _rel(trescan._residue_finish([0.0, 0.5], 96, "cpu")(
                    torch.from_numpy(folded)),
                jrescan._apply_class_residues(jnp.asarray(folded),
                                              [0.0, 0.5], 96)) <= 1e-5


@pytest.mark.parametrize("noise_mode", ["per_step", "collapsed"])
def test_noise_statistics_integer_placement(noise_mode):
    """R = 2 places every camera pixel on ONE canvas pixel, so each canvas
    pixel is exactly Poisson in the noise-free mean, per-step or collapsed:
    the seed-mean matches the mean and the squared error matches the
    variance (sum of means / n_seeds) within 25%."""
    _, (tp, tg) = _both(2.0)
    s = torch.from_numpy(_sample(4))
    clean = T.rescanned_line_sted_image(s, tp, tg, method="scan",
                                         device="cpu").image
    n = 6
    runs = torch.stack([T.rescanned_line_sted_image(
        s, tp, tg, torch.Generator().manual_seed(k), method="scan",
        noise_mode=noise_mode, device="cpu").image
        for k in range(n)]).double()
    assert torch.equal(runs, runs.round()) and (runs >= 0).all()
    total = float(clean.double().sum())
    assert abs(float(runs.mean(0).sum()) - total) <= 5 * np.sqrt(total / n)
    sq = float(((runs.mean(0) - clean.double()) ** 2).sum())
    assert 0.75 <= sq / (total / n) <= 1.25


def test_per_step_subpixel_statistics():
    """R = 1.5 (two half-pixel classes): per-step totals match the
    noise-free total within shot noise, and the seed-mean canvas converges
    to the noise-free one (its error shrinks like 1/sqrt(n))."""
    _, (tp, tg) = _both(1.5)
    s = torch.from_numpy(_sample(5))
    clean = T.rescanned_line_sted_image(s, tp, tg, method="scan",
                                         device="cpu").image
    total = float(clean.double().sum())
    runs = [T.rescanned_line_sted_image(
        s, tp, tg, torch.Generator().manual_seed(k), method="scan",
        noise_mode="per_step", device="cpu").image.double()
        for k in range(8)]
    for r in runs:
        assert abs(float(r.sum()) - total) <= 5 * np.sqrt(total)
    err2 = float(((runs[0] - clean) ** 2).sum())
    err8 = float(((torch.stack(runs).mean(0) - clean) ** 2).sum())
    assert 0.06 <= err8 / err2 <= 0.25          # expected 1/8


@pytest.mark.parametrize("case", ["custom_model", "no_band"])
def test_unported_configurations_raise(case):
    """The two configurations that raised before K4 and the models were
    ported now run and match the JAX package (max relative <= 1e-5): a
    custom depletion model (the enveloped stripe keeps the band windows,
    K1's route) and a grid no wider than the band window (the full-frame
    routes; the JAX package runs its K4 in interpret mode for
    ``use_pallas=True``)."""
    (jp, jg), (tp, tg) = _both(2.0)
    s = _sample()
    if case == "custom_model":
        jp = jp.replace(model=J.physics.models.EnvelopedStripeModel())
        tp = params_from_jax(jp)
    else:
        jg = J.RescanGeometry(J.Grid(H, 32), rescan_factor=2.0, chunk=16)
        tg = T.RescanGeometry(T.Grid(H, 32), rescan_factor=2.0, chunk=16)
        s = s[:, :32].copy()
    for use_pallas in (True, False):
        want = J.imaging.rescanned_line_sted_image(
            jnp.asarray(s), jp, jg, method="scan",
            use_pallas=use_pallas).image
        got = _port(s, tp, tg, method="scan", use_pallas=use_pallas).image
        assert _rel(got, want) <= 1e-5


def test_no_card_without_device_raises(monkeypatch):
    """The entry point runs on the card by default and never falls back to
    the CPU quietly: with no card visible and no ``device`` it raises and
    says how to ask for the CPU."""
    _, (tp, tg) = _both(2.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        T.rescanned_line_sted_image(_sample(), tp, tg)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        siemens_star((16, 16))
    assert siemens_star((16, 16), device="cpu").device.type == "cpu"


def test_unknown_arguments_raise():
    _, (tp, tg) = _both(2.0)
    s = torch.from_numpy(_sample())
    for kw in (dict(method="nope"), dict(boundary="mirror"),
               dict(method="scan", noise_mode="nope"),
               dict(method="scan", reassignment="nope")):
        with pytest.raises(ValueError):
            T.rescanned_line_sted_image(s, tp, tg, device="cpu", **kw)
    with pytest.raises(ValueError, match="grid"):
        T.rescanned_line_sted_image(s[:, :128], tp, tg, device="cpu")


def test_sample_taken_as_float32():
    """numpy and float64 samples are imaged as float32, as JAX does."""
    _, (tp, tg) = _both(1.5)
    s = _sample(8)
    want = _port(s, tp, tg, method="scan").image
    for other in (s.astype(np.float64), torch.from_numpy(s).double()):
        got = T.rescanned_line_sted_image(other, tp, tg, method="scan",
                                          device="cpu").image
        assert got.dtype == torch.float32 and torch.equal(got, want)


def test_convert_round_trip():
    jp = J.RescanParams.create(sigma_exc=1.6, sigma_det=2.3, depletion=5.0,
                               stripe_period=7.5, brightness=12.5)
    jg = J.RescanGeometry(J.Grid(H, W), rescan_factor=1.5, binning=2, chunk=8)
    tp, tg = params_from_jax(jp), geometry_from_jax(jg)
    assert tp == T.RescanParams.create(sigma_exc=1.6, sigma_det=2.3,
                                       depletion=5.0, stripe_period=7.5,
                                       brightness=12.5)
    assert tg == T.RescanGeometry(T.Grid(H, W), rescan_factor=1.5,
                                  binning=2, chunk=8)
    s = _sample(6)
    want = J.imaging.rescanned_line_sted_image(jnp.asarray(s), jp, jg).image
    assert _rel(_port(s, tp, tg).image, want) <= 1e-5
    jm = J.physics.models.EnvelopedStripeModel(envelope_sigmas=2.5)
    assert params_from_jax(jp.replace(model=jm)) == T.RescanParams.create(
        sigma_exc=1.6, sigma_det=2.3, depletion=5.0, stripe_period=7.5,
        brightness=12.5,
        model=T.physics.models.EnvelopedStripeModel(envelope_sigmas=2.5))
    # the descanned modalities' geometries and point params round-trip
    assert geometry_from_jax(J.LineSTEDGeometry(J.Grid(H, W), chunk=16)) \
        == T.LineSTEDGeometry(T.Grid(H, W), chunk=16)
    assert geometry_from_jax(J.PointSTEDGeometry(J.Grid(H, W), chunk=8)) \
        == T.PointSTEDGeometry(T.Grid(H, W), chunk=8)
    kw = dict(sigma_exc=1.6, sigma_dep=2.1, pinhole_radius=3.5,
              depletion=5.0, brightness=12.5)
    assert params_from_jax(J.PointSTEDParams.create(**kw)) == \
        T.PointSTEDParams.create(**kw)
    assert params_from_jax(J.PointSTEDParams.create(
        **kw, model=J.physics.models.PupilDonutModel(charge=2))) == \
        T.PointSTEDParams.create(
            **kw, model=T.physics.models.PupilDonutModel(charge=2))
    assert geometry_from_jax(J.RescanPointGeometry(
        J.Grid(H, W), rescan_factor=1.5, binning=2, chunk=16)) == \
        T.RescanPointGeometry(T.Grid(H, W), rescan_factor=1.5, binning=2,
                              chunk=16)


def test_import_leaves_jax_out():
    code = ("import sys, rescan_line_sted_torch, rescan_line_sted_torch."
            "convert, rescan_line_sted_torch.data, rescan_line_sted_torch."
            "imaging.line_sted, rescan_line_sted_torch.imaging.point_sted, "
            "rescan_line_sted_torch.kernels.line_fused, "
            "rescan_line_sted_torch.kernels.rescan_fused, "
            "rescan_line_sted_torch.kernels.rescan_accumulate, "
            "rescan_line_sted_torch.imaging.frames, "
            "rescan_line_sted_torch.imaging.rescan_point, "
            "rescan_line_sted_torch.kernels.primitives, "
            "rescan_line_sted_torch.algorithms.metrics, "
            "rescan_line_sted_torch.algorithms.frc, "
            "rescan_line_sted_torch.sweeps.dose, "
            "rescan_line_sted_torch.data.samples, "
            "rescan_line_sted_torch.utils.rotate, "
            "rescan_line_sted_torch.imaging.orientations, "
            "rescan_line_sted_torch.algorithms.richardson_lucy, "
            "rescan_line_sted_torch.algorithms.fusion, "
            "rescan_line_sted_torch.algorithms.map_deconv, "
            "rescan_line_sted_torch.sweeps.fov; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'rescan_line_sted_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_cpu_path_launches_no_kernel():
    _, (tp, tg) = _both(1.5)
    _build.reset_launches()
    _port(_sample(), tp, tg, method="scan", noise_mode="per_step",
          generator=torch.Generator().manual_seed(0))
    _port(_sample(), tp, tg, generator=torch.Generator().manual_seed(0))
    assert all(v == 0 for v in _build.LAUNCHES.values())


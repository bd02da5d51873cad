"""Port parity: the dose-matched sweep (``rescan_line_sted_torch.sweeps``)
against the JAX package's on the CPU.

Noise-free (``generator=None``): every column of every arm (image, FWHMs,
emitted signal, exposure, scan steps) within max|port - jax| / max|jax|
<= 1e-5, over cases covering orientations 1, 2 and 3, the rescan arm at
(R, b) = (2, 2) and (1.5, 1) and the ISM arm at R = 2; and the same for
the fused protocol (``fuse_orientations=True``) at the JAX tests' 48^2
(``tests/test_sweeps.py:102-165``): all four arms at 25 plain iterations,
and at 10 accelerated ones with three orientations and the rescan arm at
R = 3. Noisy: totals within 5 sigma of the JAX noise-free
means (fused: RL keeps each iteration's total at the views' mean total,
so the fused totals are held to it; the rescan arm's canvases are drawn
again from its generator and their fusion is the arm's image), one
generator state gives one sweep bit for bit, the FRC columns at budget
5000, and the refusal.
"""

import dataclasses
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rescan_line_sted_torch as T
import rescan_line_sted_tpu as J
from rescan_line_sted_torch.convert import geometry_from_jax, params_from_jax
from rescan_line_sted_torch.sweeps import dose as tdose
from rescan_line_sted_tpu.data import samples
from rescan_line_sted_tpu.sweeps import dose_matched_sweep as jax_sweep

torch.set_num_threads(1)
TOL = 1e-5
POWERS = [0.0, 2.0, 8.0]                 # tests/test_sweeps.py:27
COLUMNS = ("image", "fwhm_x", "fwhm_y", "emitted_signal", "exposure",
           "num_steps")
# name: (shape, orientations, rescan (R, b) or None, ISM R or None)
CASES = {"o1_rescan_r2_b2": ((32, 32), 1, (2.0, 2), None),
         "o2_rescan_r1.5_b1_ism_r2": ((48, 48), 2, (1.5, 1), 2.0),
         "o3_point_line_48x64": ((48, 64), 3, None, None)}
# the fused protocol: name: (shape, orientations, rescan, ISM R,
# fusion_iters, fusion_accelerate). Not binned or fractional R: those
# canvases ring
# below zero and the operator RL's guard flips on pixels within rounding
# of it, so two float32 runs part by 1e-4 (tests/test_torch_fusion.py)
FUSED = {"fused_o2_rescan_r2_ism_r2": ((48, 48), 2, (2.0, 1), 2.0, 25, False),
         "fused_accel_o3_rescan_r3": ((48, 48), 3, (3.0, 1), None, 10, True)}


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _fusion(case) -> dict:
    if case not in FUSED:
        return {}
    return dict(fuse_orientations=True, fusion_iters=FUSED[case][4],
                fusion_accelerate=FUSED[case][5])


@functools.lru_cache(maxsize=None)
def _setup(case):
    shape, orientations, rescan, ism = (CASES[case] if case in CASES
                                        else FUSED[case][:4])
    grid = J.Grid(*shape)
    jax_args = dict(
        sample=samples.siemens_star(shape, spokes=8),
        point_base=J.PointSTEDParams.create(
            sigma_exc=2.0, sigma_det=2.0, sigma_dep=2.0, pinhole_radius=2.5,
            brightness=1.0),
        line_base=J.LineSTEDParams.create(
            sigma_exc=2.0, sigma_det=2.0, stripe_period=8.0,
            slit_halfwidth=2.5, brightness=1.0),
        point_geom=J.PointSTEDGeometry(grid, chunk=shape[1]),
        line_geom=J.LineSTEDGeometry(grid, chunk=16),
        orientations=orientations,
        rescan_geom=(None if rescan is None else J.RescanGeometry(
            grid, rescan_factor=rescan[0], binning=rescan[1])),
        ism_geom=(None if ism is None else J.RescanPointGeometry(
            grid, rescan_factor=ism, chunk=shape[1])))
    port_args = {k: (np.array(v) if k == "sample" else
                     v if k == "orientations" or v is None else
                     params_from_jax(v) if k.endswith("base") else
                     geometry_from_jax(v))
                 for k, v in jax_args.items()}
    return jax_args, port_args


@functools.lru_cache(maxsize=None)
def _jax(case, budget=100.0):
    jax_args, _ = _setup(case)
    return jax_sweep(depletion_powers=jnp.asarray(POWERS),
                     dose_budget=budget, **jax_args, **_fusion(case))


def _port(case, budget=100.0, **kw):
    _, port_args = _setup(case)
    return tdose.dose_matched_sweep(depletion_powers=POWERS,
                                    dose_budget=budget, device="cpu",
                                    **port_args, **_fusion(case), **kw)


@functools.lru_cache(maxsize=None)
def _port_clean(case):
    return _port(case)


def _arms(case):
    _, orientations, rescan, ism = (CASES[case] if case in CASES
                                    else FUSED[case][:4])
    return (["point", "line"] + (["rescan"] if rescan else [])
            + (["ism"] if ism else []))


ARM_CASES = [(c, a) for c in CASES for a in _arms(c)]
FUSED_ARM_CASES = [(c, a) for c in FUSED for a in _arms(c)]


@pytest.mark.parametrize("case,arm", ARM_CASES,
                         ids=[f"{c}-{a}" for c, a in ARM_CASES])
def test_noise_free_sweep_matches_jax(case, arm):
    want, got = getattr(_jax(case), arm), getattr(_port_clean(case), arm)
    assert isinstance(got, tdose.ModalitySweep)
    for col in COLUMNS:
        w, g = np.asarray(getattr(want, col)), getattr(got, col)
        assert g.dtype == torch.float32 and g.shape[0] == len(POWERS)
        assert np.isfinite(w).all()
        assert rel(g, w) <= TOL, col
    for col in ("frc_resolution", "frc_resolution_x", "frc_resolution_y"):
        assert getattr(want, col) is None and getattr(got, col) is None


@pytest.mark.parametrize("case,arm", FUSED_ARM_CASES,
                         ids=[f"{c}-{a}" for c, a in FUSED_ARM_CASES])
def test_noise_free_fused_sweep_matches_jax(case, arm):
    """Every column of every arm of the fused protocol: RL-fused images
    (the ISM canvas deconvolved, the rescan canvases fused onto the sample
    grid) and the FWHMs of the RL-restored point responses."""
    want, got = getattr(_jax(case), arm), getattr(_port_clean(case), arm)
    shape = FUSED[case][0]
    r_ism = FUSED[case][3]
    assert got.image.shape[1:] == (
        tuple(int(r_ism * n) for n in shape) if arm == "ism" else shape)
    for col in COLUMNS:
        w, g = np.asarray(getattr(want, col)), getattr(got, col)
        assert g.dtype == torch.float32 and g.shape[0] == len(POWERS)
        assert np.isfinite(w).all()
        assert rel(g, w) <= TOL, col
    for col in ("frc_resolution", "frc_resolution_x", "frc_resolution_y"):
        assert getattr(want, col) is None and getattr(got, col) is None


@pytest.mark.parametrize("case", list(CASES) + list(FUSED))
def test_noise_free_sweep_header_and_absent_arms(case):
    want, got = _jax(case), _port_clean(case)
    assert rel(got.depletion_powers, want.depletion_powers) == 0.0
    assert got.dose_budget.shape == () and float(got.dose_budget) == 100.0
    for arm in ("rescan", "ism"):
        assert (getattr(got, arm) is None) == (getattr(want, arm) is None)


def _poisson_z(img, mean):
    mu = float(np.clip(np.asarray(mean, np.float64), 0, None).sum())
    return (float(img.double().sum()) - mu) / math.sqrt(mu)


NOISY = "o2_rescan_r1.5_b1_ism_r2"


@functools.lru_cache(maxsize=None)
def _port_noisy(seed, frc=False, budget=100.0):
    return _port(NOISY, budget=budget, frc=frc,
                 generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("arm", _arms(NOISY))
def test_noisy_totals_within_5_sigma(arm):
    """Every noisy image's total against its JAX noise-free mean; counts
    are non-negative integers."""
    want, got = getattr(_jax(NOISY), arm), getattr(_port_noisy(5), arm)
    for i in range(len(POWERS)):
        img = got.image[i]
        assert (img >= 0).all() and torch.equal(img, img.round())
        assert abs(_poisson_z(img, want.image[i])) <= 5
    for col in COLUMNS[1:]:
        assert rel(getattr(got, col), getattr(want, col)) <= TOL


def _columns(res):
    for arm in tdose.ARMS:
        sweep = getattr(res, arm)
        if sweep is not None:
            for f in dataclasses.fields(sweep):
                yield f"{arm}.{f.name}", getattr(sweep, f.name)


def test_same_generator_state_gives_the_same_sweep():
    a, b = _port_noisy(5), _port(NOISY, generator=torch.Generator()
                                 .manual_seed(5))
    for (name, x), (_, y) in zip(_columns(a), _columns(b)):
        assert (x is None and y is None) or torch.equal(x, y), name
    c = _port_noisy(6)
    for arm in tdose.ARMS:
        assert not torch.equal(getattr(a, arm).image, getattr(c, arm).image)


def test_draws_are_independent_across_arms_and_points():
    """The derived generators: one per arm x point x draw, all seeded
    apart; an arm's images do not depend on ``frc`` or on other arms."""
    gens = tdose.arm_generators(torch.Generator().manual_seed(1), 3)
    seeds = [g.initial_seed() for arm in gens for pt in arm for g in pt]
    assert len(seeds) == 4 * 3 * 2 == len(set(seeds))
    with_frc = _port_noisy(5, frc=True)
    only_two = tdose.dose_matched_sweep(
        depletion_powers=POWERS, dose_budget=100.0, device="cpu",
        generator=torch.Generator().manual_seed(5),
        **{k: v for k, v in _setup(NOISY)[1].items()
           if k not in ("rescan_geom", "ism_geom")})
    for arm in tdose.ARMS:
        assert torch.equal(getattr(with_frc, arm).image,
                           getattr(_port_noisy(5), arm).image)
    assert torch.equal(only_two.point.image, with_frc.point.image)
    assert torch.equal(only_two.line.image, with_frc.line.image)


def test_frc_columns():
    """``frc=True`` at budget 5000 (``tests/test_sweeps.py:175-177``):
    finite radial resolutions >= 2 for the point, line and ISM arms; the
    rescan arm's radial column is None and its per-axis ones finite."""
    res = _port_noisy(0, frc=True, budget=5000.0)
    for arm in ("point", "line", "ism"):
        col = getattr(res, arm).frc_resolution
        assert col.shape == (len(POWERS),)
        assert torch.isfinite(col).all() and (col >= 2.0).all(), arm
        assert getattr(res, arm).frc_resolution_x is None
    assert res.rescan.frc_resolution is None
    for col in (res.rescan.frc_resolution_x, res.rescan.frc_resolution_y):
        assert col.shape == (len(POWERS),) and torch.isfinite(col).all()
    plain = _port_noisy(0)
    for arm in tdose.ARMS:
        sweep = getattr(plain, arm)
        assert sweep.frc_resolution is None
        assert sweep.frc_resolution_x is None
        assert sweep.frc_resolution_y is None


def test_refusals():
    with pytest.raises(ValueError, match="generator"):
        _port(NOISY, frc=True)


FUSED_NOISY = "fused_o2_rescan_r2_ism_r2"


@functools.lru_cache(maxsize=None)
def _port_fused_noisy(seed, frc=False):
    return _port(FUSED_NOISY, frc=frc,
                 generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("arm", ["point", "line", "ism"])
def test_noisy_fused_totals_within_5_sigma(arm):
    """RL's update keeps each iteration's total at the views' mean total
    (``sum(est * corr(d / pred, psf)) = sum(d)``), so a fused image's total
    is its views' mean noisy total: the point arm's one image, the line
    arm's mean over V views (variance mean / V), ISM's canvas over the
    kernel sum S (variance mean / S). Each against the JAX noise-free
    fused total, which is the views' mean total."""
    from rescan_line_sted_torch.imaging import rescan_point_system_kernel

    want, got = getattr(_jax(FUSED_NOISY), arm), getattr(
        _port_fused_noisy(5), arm)
    _, port_args = _setup(FUSED_NOISY)
    for i, s in enumerate(POWERS):
        mu = float(np.asarray(want.image[i], np.float64).sum())
        var = mu
        if arm == "line":
            var = mu / port_args["orientations"]
        elif arm == "ism":
            pp = port_args["point_base"].replace(depletion=s)
            var = mu / float(rescan_point_system_kernel(
                port_args["ism_geom"], pp, "cpu").double().sum())
        z = (float(got.image[i].double().sum()) - mu) / math.sqrt(var)
        assert abs(z) <= 5, (i, z)
        assert torch.isfinite(got.image[i]).all()
    for col in COLUMNS[1:]:
        assert rel(getattr(got, col), getattr(want, col)) <= TOL


def test_noisy_fused_rescan_arm():
    """The rescan arm's noisy image is the operator fusion of its canvases,
    drawn again from its own generator (arm 2, draw 0), and those canvases'
    totals lie within 5 sigma of their noise-free means."""
    from rescan_line_sted_torch.algorithms import (
        multi_orientation_rescan,
        rescan_fusion,
    )

    got = _port_fused_noisy(5).rescan
    _, port_args = _setup(FUSED_NOISY)
    geom, base = port_args["rescan_geom"], port_args["line_base"]
    orientations, iters = port_args["orientations"], FUSED[FUSED_NOISY][4]
    gens = tdose.arm_generators(torch.Generator().manual_seed(5),
                                len(POWERS))
    angles = torch.arange(orientations, dtype=torch.float32) * (
        math.pi / orientations)
    static = tuple(v * math.pi / orientations for v in range(orientations))
    for i, s in enumerate(POWERS):
        params = base.replace(depletion=s,
                              brightness=float(got.exposure[i]))
        canvases = multi_orientation_rescan(
            port_args["sample"], params, geom, angles, gens[2][i][0],
            device="cpu")
        clean = multi_orientation_rescan(port_args["sample"], params, geom,
                                         angles, device="cpu")
        for img, mean in zip(canvases, clean):
            assert abs(_poisson_z(img, mean)) <= 5
        assert torch.equal(got.image[i], rescan_fusion(
            canvases, params, geom, static, iters))


def test_noisy_fused_frc_and_reproducibility():
    """``frc=True`` with fusion: the draws of the images do not change, and
    every arm reports a finite radial FRC column (the fused rescan image
    lies on the sample grid, so no per-axis columns)."""
    a, b = _port_fused_noisy(5), _port_fused_noisy(5, frc=True)
    for arm in ("point", "line", "rescan", "ism"):
        assert torch.equal(getattr(a, arm).image, getattr(b, arm).image)
        col = getattr(b, arm).frc_resolution
        assert col.shape == (len(POWERS),) and torch.isfinite(col).all()
        assert getattr(b, arm).frc_resolution_x is None
        assert getattr(a, arm).frc_resolution is None


def test_cpu_fused_sweep_launches_no_kernel():
    from rescan_line_sted_torch.kernels import _build

    _build.reset_launches()
    _port(FUSED_NOISY, frc=True,
          generator=torch.Generator().manual_seed(8))
    assert all(v == 0 for v in _build.LAUNCHES.values())


def test_sweep_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, port_args = _setup(NOISY)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        T.sweeps.dose_matched_sweep(depletion_powers=POWERS,
                                    dose_budget=100.0, **port_args)


def test_cpu_sweep_launches_no_kernel():
    from rescan_line_sted_torch.kernels import _build

    _build.reset_launches()
    _port_noisy(7, frc=True)
    assert all(v == 0 for v in _build.LAUNCHES.values())

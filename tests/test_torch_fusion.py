"""Port parity: operator-form Richardson-Lucy and rescanned-view fusion
(``rescan_line_sted_torch.algorithms.fusion``) against the JAX package on
the CPU, on the same numpy inputs.

The cases of ``tests/test_rescan_fusion.py``, ``tests/test_rescan_point.py``
(``ism_deconvolve``) and the single-device half of
``tests/test_mesh.py::test_spatially_sharded_rescan_fusion`` run on the
port. Parity is max|port - jax| / max|jax| <= 1e-5: the operator's
forward and adjoint, the noise-free canvases, the fused estimates (plain
up to 150 iterations, accelerated at 20), ``ism_deconvolve`` and operator
RL over plain convolutions. The adjoint satisfies <Ax, y> = <x, A^T y> to
1e-5 with and without rotation, at fractional R and binning 2. Noisy
canvases are held by their totals (5 sigma), never bit for bit.
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rescan_line_sted_torch.algorithms import fusion as tf
from rescan_line_sted_torch.algorithms import richardson_lucy_views
from rescan_line_sted_torch.convert import geometry_from_jax, params_from_jax
from rescan_line_sted_torch.imaging import rescanned_line_sted_image
from rescan_line_sted_torch.kernels import _build
from rescan_line_sted_torch.kernels import fftconv as tfft
from rescan_line_sted_tpu.algorithms import fusion as jf
from rescan_line_sted_tpu.config import (
    Grid,
    PointSTEDParams,
    RescanGeometry,
    RescanParams,
    RescanPointGeometry,
)
from rescan_line_sted_tpu.data import samples
from rescan_line_sted_tpu.imaging import rescan_point_canvas_mean
from rescan_line_sted_tpu.kernels import fftconv as jfft
from rescan_line_sted_tpu.physics import psf as jpsf

torch.set_num_threads(1)
TOL = 1e-5
SHAPE = (48, 48)                     # tests/test_rescan_fusion.py:16-19
GEOM = RescanGeometry(Grid(*SHAPE), rescan_factor=2.0, binning=1, chunk=16)
PARAMS = RescanParams.create(sigma_exc=2.0, sigma_det=2.0, stripe_period=8.0,
                             depletion=6.0, brightness=100.0)
ANGLES = (0.0, math.pi / 2)
# adjointness cases: (size, R, binning, angle); :28 and :98 of the JAX file
OPERATORS = {"r2_b1": (48, 2.0, 1, None),
             "r1.5_b2_angle0.7": (32, 1.5, 2, 0.7),
             "r2_b1_angle_pi/2": (48, 2.0, 1, math.pi / 2),
             "r1.5_b1_angle-1.1": (48, 1.5, 1, -1.1)}


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def port(geom, params):
    return geometry_from_jax(geom), params_from_jax(params)


def masked_sample() -> np.ndarray:
    """Zero x-margins, so the analytic model is exact (JAX file :22-25)."""
    mask = (np.arange(SHAPE[1]) >= 10) & (np.arange(SHAPE[1]) < 38)
    return np.array(samples.rings(SHAPE, period=12.0)) * mask[None, :]


def disk_sample() -> np.ndarray:
    """Rings zero outside a radius of 13 px: every rotation of it keeps
    zero margins on all four edges."""
    y, x = np.mgrid[:SHAPE[0], :SHAPE[1]] - SHAPE[0] // 2
    return np.array(samples.rings(SHAPE, period=12.0)) * (
        np.hypot(y, x) < 13)


@functools.lru_cache(maxsize=None)
def _operator_case(case):
    n, r, b, angle = OPERATORS[case]
    geom = RescanGeometry(Grid(n, n), rescan_factor=r, binning=b, chunk=16)
    params = RescanParams.create(sigma_exc=2.0, sigma_det=2.0,
                                 stripe_period=8.0, depletion=4.0,
                                 brightness=20.0)
    rng = np.random.default_rng(3)
    x = rng.uniform(size=(n, n)).astype(np.float32)
    y = rng.uniform(size=geom.canvas_shape).astype(np.float32)
    fwd, adj = jf.rescan_operator(geom, params, angle=angle)
    return (geom, params, angle, x, y, np.asarray(fwd(jnp.asarray(x))),
            np.asarray(adj(jnp.asarray(y))))


@pytest.mark.parametrize("case", list(OPERATORS))
def test_rescan_operator_adjointness(case):
    """<A x, y> == <x, A^T y> for random x, y (JAX file :28, :98)."""
    geom, params, angle, x, y, _, _ = _operator_case(case)
    fwd, adj = tf.rescan_operator(*port(geom, params), angle=angle,
                                  device="cpu")
    ax, aty = fwd(t(x)), adj(t(y))
    assert ax.shape == geom.canvas_shape and aty.shape == x.shape
    lhs = float(np.vdot(ax.double().numpy(), y.astype(np.float64)))
    rhs = float(np.vdot(x.astype(np.float64), aty.double().numpy()))
    assert abs(lhs - rhs) <= TOL * abs(lhs)


@pytest.mark.parametrize("case", list(OPERATORS))
def test_rescan_operator_matches_jax(case):
    """The forward map and its exact transpose against ``jax.
    linear_transpose``'s, also when the caller is under ``no_grad``."""
    geom, params, angle, x, y, want_fwd, want_adj = _operator_case(case)
    op = tf.rescan_operator(*port(geom, params), angle=angle, device="cpu")
    assert rel(op[0](t(x)), want_fwd) <= TOL
    assert rel(op[1](t(y)), want_adj) <= TOL
    with torch.no_grad():
        pred, pull = op.vjp(t(x))
        assert torch.equal(pred, op[0](t(x)))
        assert rel(pull(t(y)), want_adj) <= TOL
        assert rel(op[1](t(y)), want_adj) <= TOL


def test_adjoint_is_the_scatter_not_the_inverse_rotation():
    """The transpose of the bilinear rotation is its scatter adjoint: the
    adjoint differs from rotating the back-projection by +angle."""
    from rescan_line_sted_torch.utils import rotate_image

    geom, params, angle, x, y, _, want_adj = _operator_case(
        "r1.5_b2_angle0.7")
    tg, tp = port(geom, params)
    unrotated = tf.rescan_operator(tg, tp, device="cpu")
    inverse = rotate_image(unrotated[1](t(y)), angle)
    assert rel(inverse, want_adj) > 1e-3


def test_forward_op_matches_engine():
    """JAX file :40: the operator's forward map is the engine's analytic
    canvas (relative L2 <= 1e-6), and the JAX engine's at 1e-5."""
    from rescan_line_sted_tpu.imaging import (
        rescanned_line_sted_image as jax_image,
    )

    sample = masked_sample()
    tg, tp = port(GEOM, PARAMS)
    fwd, _ = tf.rescan_operator(tg, tp, device="cpu")
    got = fwd(t(sample).float())
    want = rescanned_line_sted_image(sample, tp, tg, device="cpu").image
    assert float((got - want).norm() / want.norm()) < 1e-6
    assert rel(got, jax_image(jnp.asarray(sample), PARAMS, GEOM,
                              method="analytic").image) <= TOL


def _conv_problem():
    true = np.array(samples.rings(SHAPE)) + 0.05
    psf = np.array(jpsf.detection_psf(SHAPE, 1.5))
    data = np.array(jfft.fft_convolve(jnp.asarray(true), jnp.asarray(psf)))
    return data, psf


@pytest.mark.parametrize("adjoint", ["explicit", "autograd"])
def test_operator_rl_matches_view_rl_for_plain_convolution(adjoint):
    """JAX file :52: with plain convolution operators, operator RL is
    kernel RL (the JAX file's 1e-4), and matches the JAX package's
    operator RL at 1e-5, with the adjoint given or taken by autograd."""
    data, psf = _conv_problem()
    otf = jfft.kernel_to_otf(jnp.asarray(psf))
    jops = [(lambda e: jfft.convolve_otf(e, otf),
             lambda y: jfft.correlate_otf(y, otf))]
    want = jf.richardson_lucy_operator(
        [jnp.asarray(data)], jops, 30, jnp.full(SHAPE, data.mean()))
    totf = tfft.kernel_to_otf(t(psf))

    def conv(e):
        return tfft.convolve_otf(e, totf)

    op = ((conv, lambda y: tfft.correlate_otf(y, totf))
          if adjoint == "explicit" else tf.LinearOperator(conv, SHAPE))
    init = t(data).mean().expand(SHAPE).clone()
    got = tf.richardson_lucy_operator([t(data)], [op], 30, init)
    views = richardson_lucy_views(t(data)[None], t(psf)[None], 30)
    assert float((got - views).norm() / views.norm()) < 1e-4
    assert rel(got, want) <= TOL


@functools.lru_cache(maxsize=None)
def _canvases():
    """The JAX package's noise-free canvases of the masked sample at 0 and
    pi/2, the fusion cases' common input."""
    return np.array(jf.multi_orientation_rescan(
        jnp.asarray(masked_sample()), PARAMS, GEOM, list(ANGLES)))


FUSION = [(10, False), (30, False), (80, False), (150, False), (20, True)]


@pytest.mark.parametrize("num_iter,accelerate", FUSION,
                         ids=[f"{n}-{'accel' if a else 'plain'}"
                              for n, a in FUSION])
def test_rescan_fusion_matches_jax(num_iter, accelerate):
    canvases = _canvases()
    want = jf.rescan_fusion(jnp.asarray(canvases), PARAMS, GEOM, ANGLES,
                            num_iter=num_iter, accelerate=accelerate)
    got = tf.rescan_fusion(t(canvases), *port(GEOM, PARAMS)[::-1], ANGLES,
                           num_iter=num_iter, accelerate=accelerate)
    assert got.shape == SHAPE and got.dtype == torch.float32
    assert rel(got, want) <= TOL


def test_rescan_fusion_given_init_matches_jax():
    canvases = _canvases()
    init = (0.5 + np.random.default_rng(4).random(SHAPE)).astype(np.float32)
    want = jf.rescan_fusion(jnp.asarray(canvases), PARAMS, GEOM, ANGLES, 20,
                            init=jnp.asarray(init))
    got = tf.rescan_fusion(t(canvases), *port(GEOM, PARAMS)[::-1], ANGLES,
                           20, init=t(init))
    assert rel(got, want) <= TOL


def test_rescan_fusion_recovers_sample():
    """JAX file :68: noise-free two-orientation fusion converges to the
    sample (interior correlation > 0.95 after 150 iterations)."""
    tg, tp = port(GEOM, PARAMS)
    sample = masked_sample()
    canvases = tf.multi_orientation_rescan(sample, tp, tg, ANGLES,
                                           device="cpu")
    est = tf.rescan_fusion(canvases, tp, tg, ANGLES, num_iter=150).numpy()
    sl = (slice(12, 36), slice(12, 36))
    assert np.corrcoef(est[sl].ravel(), sample[sl].ravel())[0, 1] > 0.95
    assert np.isfinite(est).all() and (est >= 0).all()


def test_operator_rl_accelerated_converges_faster():
    """JAX file :141: 40 accelerated iterations reach the restoration
    error of 80 plain ones (5% slack)."""
    tg, tp = port(GEOM, PARAMS)
    sample = masked_sample()
    canvases = t(_canvases())
    sl = (slice(12, 36), slice(12, 36))

    def err(est):
        e = est.numpy()[sl] - sample[sl]
        return float(np.linalg.norm(e) / np.linalg.norm(sample[sl]))

    plain = tf.rescan_fusion(canvases, tp, tg, ANGLES, num_iter=80)
    accel = tf.rescan_fusion(canvases, tp, tg, ANGLES, num_iter=40,
                             accelerate=True)
    assert torch.isfinite(accel).all() and (accel >= 0).all()
    assert err(accel) <= err(plain) * 1.05


def _binned_case():
    """JAX file :118: binning 2, R = 1.5, a grid of lines."""
    geom = RescanGeometry(Grid(48, 48), rescan_factor=1.5, binning=2,
                          chunk=16)
    params = RescanParams.create(sigma_exc=2.0, sigma_det=2.0,
                                 stripe_period=8.0, depletion=6.0,
                                 brightness=50.0)
    sample = np.zeros((48, 48), np.float32)
    sample[10:38:6, 10:38] = 1.0
    sample[10:38, 10:38:6] += 1.0
    return geom, params, sample


def test_rescan_fusion_with_binning_and_fractional_r():
    """The canvases against the JAX package's at 1e-5 and the JAX file's
    properties of the fused estimate. The estimate itself is not held to
    the JAX package's: subpixel placement rings the canvases below zero
    (to -0.06 of a 113 maximum), and where the forward model lies within
    rounding of the guard ``tiny`` the ratio switches between 0 and data /
    tiny, so two float32 runs part by 4e-4 after five iterations."""
    geom, params, sample = _binned_case()
    tg, tp = port(geom, params)
    canvases = tf.multi_orientation_rescan(sample, tp, tg, ANGLES,
                                           device="cpu")
    want_canv = jf.multi_orientation_rescan(jnp.asarray(sample), params,
                                            geom, jnp.asarray(ANGLES))
    assert canvases.shape == (2,) + geom.canvas_shape
    assert rel(canvases, want_canv) <= TOL
    est = tf.rescan_fusion(canvases, tp, tg, ANGLES, num_iter=40)
    assert torch.isfinite(est).all()
    assert np.corrcoef(est.numpy().ravel(), sample.ravel())[0, 1] > 0.7


def test_single_device_rescan_fusion_matches_jax():
    """``tests/test_mesh.py:221-242`` without the mesh: default params at
    depletion 4, brightness 100, R = 2, 10 iterations on the mesh test's
    sample."""
    sample = np.array(samples.siemens_star(SHAPE, spokes=8))
    geom = RescanGeometry(Grid(*SHAPE), rescan_factor=2.0, chunk=16)
    params = RescanParams.create(depletion=4.0, brightness=100.0)
    canv = jf.multi_orientation_rescan(jnp.asarray(sample), params, geom,
                                       list(ANGLES))
    want = jf.rescan_fusion(canv, params, geom, ANGLES, num_iter=10)
    tg, tp = port(geom, params)
    got_canv = tf.multi_orientation_rescan(sample, tp, tg, list(ANGLES),
                                           device="cpu")
    assert rel(got_canv, canv) <= TOL
    assert rel(tf.rescan_fusion(got_canv, tp, tg, ANGLES, 10), want) <= TOL


VIEW_CASES = {"r2_b1_two": (GEOM, PARAMS, ANGLES),
              "r1.5_b2_three": (_binned_case()[0], _binned_case()[1],
                                (0.0, math.pi / 3, 2 * math.pi / 3))}


@pytest.mark.parametrize("case", list(VIEW_CASES))
def test_multi_orientation_rescan_matches_jax(case):
    """Noise-free canvases, the angles as float32 as the JAX function
    takes them."""
    geom, params, angles = VIEW_CASES[case]
    sample = masked_sample()
    angles32 = np.asarray(angles, np.float32)
    want = jf.multi_orientation_rescan(jnp.asarray(sample), params, geom,
                                       jnp.asarray(angles32))
    got = tf.multi_orientation_rescan(sample, *port(geom, params)[::-1],
                                      angles32, device="cpu")
    assert got.shape == (len(angles),) + geom.canvas_shape
    assert rel(got, want) <= TOL


def test_scan_canvases_match_analytic():
    """The scan method (K1's plain version on the CPU) against the
    analytic canvases, on a sample zero near every edge at any angle
    (relative L2 <= 1e-5)."""
    tg, tp = port(GEOM, PARAMS)
    angles = (0.0, 0.7, math.pi / 2)
    scan = tf.multi_orientation_rescan(disk_sample(), tp, tg, angles,
                                       method="scan", device="cpu")
    ana = tf.multi_orientation_rescan(disk_sample(), tp, tg, angles,
                                      device="cpu")
    assert float((scan - ana).norm() / ana.norm()) <= TOL


@pytest.mark.parametrize("method", ["analytic", "scan"])
def test_noisy_canvases(method):
    """Every noisy canvas's total within 5 sigma of its noise-free mean,
    non-negative counts; one generator state gives the same canvases, the
    next state others; the CPU path launches no kernel."""
    tg, tp = port(GEOM, PARAMS)
    sample = disk_sample()
    clean = tf.multi_orientation_rescan(sample, tp, tg, ANGLES,
                                        method=method, device="cpu")
    _build.reset_launches()
    gen = torch.Generator().manual_seed(9)
    noisy = tf.multi_orientation_rescan(sample, tp, tg, ANGLES, gen,
                                        method=method, device="cpu")
    again = tf.multi_orientation_rescan(sample, tp, tg, ANGLES,
                                        torch.Generator().manual_seed(9),
                                        method=method, device="cpu")
    later = tf.multi_orientation_rescan(sample, tp, tg, ANGLES, gen,
                                        method=method, device="cpu")
    assert all(v == 0 for v in _build.LAUNCHES.values())
    assert torch.equal(noisy, again) and not torch.equal(noisy, later)
    for img, mean in zip(noisy, clean):
        assert (img >= 0).all() and torch.equal(img, img.round())
        mu = float(mean.clamp_min(0).double().sum())
        assert abs(float(img.double().sum()) - mu) <= 5 * math.sqrt(mu)
    assert not torch.equal(noisy[0], noisy[1])


def test_unknown_method_and_default_device(monkeypatch):
    tg, tp = port(GEOM, PARAMS)
    with pytest.raises(ValueError, match="method"):
        tf.multi_orientation_rescan(masked_sample(), tp, tg, ANGLES,
                                    method="nope", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tf.multi_orientation_rescan(masked_sample(), tp, tg, ANGLES)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tf.rescan_operator(tg, tp)


ISM_PARAMS = PointSTEDParams.create(sigma_exc=2.0, sigma_det=2.5,
                                    sigma_dep=2.0, depletion=4.0,
                                    brightness=1.0)
ISM_GEOM = RescanPointGeometry(Grid(32, 32), rescan_factor=2.0, chunk=32)


@functools.lru_cache(maxsize=None)
def _ism_canvas():
    """``tests/test_rescan_point.py:176-196``: two emitters."""
    sample = jnp.zeros((32, 32)).at[12, 14].set(1.0).at[20, 18].set(0.7)
    return np.array(rescan_point_canvas_mean(sample, ISM_PARAMS, ISM_GEOM))


ISM = [(30, False), (100, False), (300, False), (30, True)]


@pytest.mark.parametrize("num_iter,accelerate", ISM,
                         ids=[f"{n}-{'accel' if a else 'plain'}"
                              for n, a in ISM])
def test_ism_deconvolve_matches_jax(num_iter, accelerate):
    canvas = _ism_canvas()
    want = jf.ism_deconvolve(jnp.asarray(canvas), ISM_PARAMS, ISM_GEOM,
                             num_iter=num_iter, accelerate=accelerate)
    got = tf.ism_deconvolve(t(canvas), params_from_jax(ISM_PARAMS),
                            geometry_from_jax(ISM_GEOM), num_iter=num_iter,
                            accelerate=accelerate)
    assert rel(got, want) <= TOL


def test_ism_deconvolve_sharpens_and_converges():
    """``tests/test_rescan_point.py:176-196`` on the port: the re-blurred
    estimate converges to the canvas, more iterations keep improving, and
    the emitters re-localise at R times their positions."""
    from rescan_line_sted_torch.imaging import rescan_point_system_kernel

    canvas = t(_ism_canvas())
    tp, tg = params_from_jax(ISM_PARAMS), geometry_from_jax(ISM_GEOM)
    kern = rescan_point_system_kernel(tg, tp, "cpu")

    def resid(est):
        return float((tfft.fft_convolve(est, kern) - canvas).norm()
                     / canvas.norm())

    est = tf.ism_deconvolve(canvas, tp, tg, num_iter=100)
    assert resid(est) < 0.10
    assert resid(tf.ism_deconvolve(canvas, tp, tg, num_iter=300)) \
        < resid(est)
    e = est.numpy()
    assert np.unravel_index(e.argmax(), e.shape) == (24, 28)
    assert e[40, 36] > 0.4 * e.max()

"""Port parity: image rotation (``utils/rotate.py``) and multi-orientation
line-STED (``imaging/orientations.py``) against the JAX package on the
CPU, on the same numpy inputs.

Noise-free agreement: max|port - jax| / max|jax| <= 1e-5 per array. The
512^2 rotations are the ones a rotation through ``grid_sample`` misses
(its [-1, 1] round trip moves coordinates by ~(W-1)/2 * 6e-8 px). The
port's rotation coordinates are float64, the JAX package's float32, which
at 512^2 lie ~3e-5 of the image's maximum off the exact rotation: there
the port's rotations are held to the float64 bilinear rotation of
``benchmark/reference/report_sweep.py`` instead, at the same 1e-5. Noisy
views are drawn by one generator in order where the JAX package splits
one key per view, so they are held to statistics and to the cases of
``tests/test_orientations.py`` on the port alone.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rescan_line_sted_torch as T
from benchmark.reference import plain, report_sweep
from rescan_line_sted_torch.algorithms import richardson_lucy_views
from rescan_line_sted_torch.algorithms.metrics import fwhm_2d
from rescan_line_sted_torch.convert import geometry_from_jax, params_from_jax
from rescan_line_sted_torch.data import samples as ts
from rescan_line_sted_torch.imaging import orientations as torient
from rescan_line_sted_torch.utils import rotate_image
from rescan_line_sted_tpu.config import Grid, LineSTEDGeometry, LineSTEDParams
from rescan_line_sted_tpu.data import samples as js
from rescan_line_sted_tpu.imaging import orientations as jorient
from rescan_line_sted_tpu.utils.rotate import rotate_image as j_rotate

torch.set_num_threads(1)
TOL = 1e-5
SHAPE = (64, 64)                    # tests/test_orientations.py:17-20
JPARAMS = LineSTEDParams.create(sigma_exc=2.5, sigma_det=2.5,
                                stripe_period=10.0, depletion=8.0,
                                slit_halfwidth=3.0, brightness=100.0)
JGEOM = LineSTEDGeometry(Grid(*SHAPE), chunk=16)
PARAMS = params_from_jax(JPARAMS)
GEOM = geometry_from_jax(JGEOM)
ANGLES = [0.0, math.pi / 7, -math.pi / 3, math.pi / 2, 2 * math.pi]
VIEW_ANGLES = [0.0, math.pi / 3, 2 * math.pi / 3]


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _image(shape, seed=0):
    """Lattice points on an asymmetric random ramp: a mirrored or shifted
    rotation fails where a symmetric image would pass."""
    rng = np.random.default_rng(seed)
    ramp = np.linspace(0.2, 1.0, shape[1], dtype=np.float32)[None, :]
    pts = np.asarray(js.sparse_points(shape, spacing=12))
    return (pts + rng.random(shape, np.float32) * ramp).astype(np.float32)


# the shapes at which the JAX package's float32 angles and rotation
# coordinates miss the exact rotation by more than 1e-5
EXACT_SHAPES = [(512, 512)]


def _exact_rotation(img, theta) -> np.ndarray:
    """The float64 bilinear rotation of ``img`` by ``theta``."""
    h, w = img.shape
    rot = report_sweep.Rotation(h, w, theta, "cpu", plain.Precision("float64"))
    return rot(torch.from_numpy(img)).numpy()


@pytest.mark.parametrize("theta", ANGLES,
                         ids=["0", "pi/7", "-pi/3", "pi/2", "2pi"])
@pytest.mark.parametrize("shape", [(64, 64), (512, 512), (48, 64), (63, 65)],
                         ids=["64", "512", "48x64", "63x65"])
def test_rotate_matches_jax(shape, theta):
    img = _image(shape)
    jax_img = np.asarray(j_rotate(jnp.asarray(img), jnp.float32(theta)))
    got = rotate_image(torch.from_numpy(img), theta)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    if shape in EXACT_SHAPES and theta != 0.0:
        # no rotation is within 1e-5 of both the JAX package's float32
        # coordinates and the exact ones here: the port keeps the exact
        assert rel(got, _exact_rotation(img, theta)) <= TOL
        if theta == math.pi / 7:
            assert rel(jax_img, _exact_rotation(
                img, float(np.float32(theta)))) > TOL
    else:
        assert rel(got, jax_img) <= TOL


def test_rotate_batches_angles():
    """[H, W] by [V] angles gives the V single rotations; [V, H, W] by [V]
    rotates each image by its own angle."""
    img = torch.from_numpy(_image((48, 64)))
    angles = torch.tensor(ANGLES, dtype=torch.float32)
    many = rotate_image(img, angles)
    assert many.shape == (len(ANGLES), 48, 64)
    for view, theta in zip(many, angles):
        assert torch.equal(view, rotate_image(img, theta))
    back = rotate_image(many, -angles)
    for view, rotated, theta in zip(back, many, angles):
        assert torch.equal(view, rotate_image(rotated, -theta))


def test_rotate_identity_and_periodicity():
    """``tests/test_orientations.py:24-29`` on the port."""
    img = ts.rings(SHAPE, device="cpu")
    np.testing.assert_allclose(rotate_image(img, 0.0).numpy(), img.numpy(),
                               atol=1e-6)
    full = rotate_image(img, math.pi * 2)
    assert (full - img).abs().max() < 1e-4


def test_orientation_kernels_match_jax():
    angles = [0.0, math.pi / 5, math.pi / 2, 2 * math.pi / 3]
    want = jorient.orientation_kernels(SHAPE, JPARAMS, jnp.asarray(angles))
    got = torient.orientation_kernels(SHAPE, PARAMS, angles, device="cpu")
    assert got.shape == (4, *SHAPE)
    assert rel(got, want) <= TOL


def test_orientation_kernel_rotates_anisotropy():
    """``tests/test_orientations.py:45-52``: a 90-degree rotation swaps
    the sharp and wide axes."""
    ks = torient.orientation_kernels(SHAPE, PARAMS, [0.0, math.pi / 2],
                                     device="cpu")
    f0y, f0x = fwhm_2d(ks[0])
    f90y, f90x = fwhm_2d(ks[1])
    assert abs(float(f0x) - float(f90y)) < 0.3
    assert abs(float(f0y) - float(f90x)) < 0.3


@pytest.mark.parametrize("method", ["analytic", "scan"])
def test_noise_free_views_match_jax(method):
    sample = np.asarray(js.siemens_star(SHAPE, spokes=6)) + _image(SHAPE)
    jv, jk = jorient.multi_orientation_line_sted(
        jnp.asarray(sample), JPARAMS, JGEOM, jnp.asarray(VIEW_ANGLES),
        method=method)
    views, kernels = torient.multi_orientation_line_sted(
        sample, PARAMS, GEOM, VIEW_ANGLES, method=method, device="cpu")
    assert views.shape == kernels.shape == (3, *SHAPE)
    assert views.device.type == "cpu"
    assert rel(views, jv) <= TOL
    assert rel(kernels, jk) <= TOL


def test_zero_angle_view_equals_line_sted_image():
    """``tests/test_orientations.py:32-42``: the theta = 0 view through
    rotate-acquire-derotate is the direct image."""
    sample = ts.siemens_star(SHAPE, spokes=6, device="cpu")
    views, _ = torient.multi_orientation_line_sted(
        sample, PARAMS, GEOM, [0.0], device="cpu")
    direct = T.line_sted_image(sample, PARAMS, GEOM, device="cpu").image
    err = (views[0] - direct).norm() / direct.norm()
    assert float(err) < 1e-5


@pytest.mark.parametrize("method", ["analytic", "scan"])
def test_noisy_view_totals(method):
    """Every noisy view's total within 5 sigma of its noise-free mean;
    counts are non-negative integers before the derotation, so each view
    is compared against the derotated noise-free view's total."""
    sample = ts.siemens_star(SHAPE, spokes=6, device="cpu") + 0.05
    clean, _ = torient.multi_orientation_line_sted(
        sample, PARAMS, GEOM, VIEW_ANGLES, method=method, device="cpu")
    noisy, _ = torient.multi_orientation_line_sted(
        sample, PARAMS, GEOM, VIEW_ANGLES, method=method, device="cpu",
        generator=torch.Generator().manual_seed(5))
    assert torch.isfinite(noisy).all() and (noisy >= 0).all()
    for view, mean in zip(noisy, clean):
        mu = float(mean.clamp_min(0).double().sum())
        assert abs(float(view.double().sum()) - mu) <= 5 * math.sqrt(mu)
    assert not torch.equal(noisy[1], clean[1])


@pytest.mark.parametrize("method", ["analytic", "scan"])
def test_one_generator_state_gives_one_set_of_views(method):
    sample = ts.siemens_star(SHAPE, spokes=6, device="cpu")

    def views(seed):
        return torient.multi_orientation_line_sted(
            sample, PARAMS, GEOM, VIEW_ANGLES, method=method, device="cpu",
            generator=torch.Generator().manual_seed(seed))[0]

    a, b = views(7), views(7)
    assert torch.equal(a, b)
    assert not torch.equal(a, views(8))


def test_fusion_recovers_isotropic_resolution():
    """``tests/test_orientations.py:55-69`` on the port: two orthogonal
    anisotropic views fuse into a sharper, roughly isotropic point."""
    sample = ts.sparse_points(SHAPE, spacing=32, device="cpu")
    views, kernels = torient.multi_orientation_line_sted(
        sample, PARAMS, GEOM, [0.0, math.pi / 2], device="cpu")
    fused = richardson_lucy_views(views, kernels, num_iter=100)
    py, px = fwhm_2d(fused[8:24, 8:24])
    ky, _ = fwhm_2d(kernels[0])
    assert float(py) < 0.7 * float(ky)
    assert 0.6 < float(py) / float(px) < 1.7


def test_noisy_fusion_runs_and_is_positive():
    """``tests/test_orientations.py:72-81`` on the port."""
    sample = ts.siemens_star(SHAPE, spokes=6, device="cpu") + 0.01
    views, kernels = torient.multi_orientation_line_sted(
        sample, PARAMS, GEOM, VIEW_ANGLES, device="cpu",
        generator=torch.Generator().manual_seed(1))
    fused = richardson_lucy_views(views, kernels, num_iter=10)
    assert torch.isfinite(fused).all()
    assert (fused >= 0).all()


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="method"):
        torient.multi_orientation_line_sted(
            np.zeros(SHAPE, np.float32), PARAMS, GEOM, [0.0],
            method="nope", device="cpu")

"""Port parity: Fourier Ring Correlation of ``rescan_line_sted_torch``
(``algorithms/frc.py``) against the JAX package on the same numpy inputs:
seeded noisy pairs of siemens-star acquisitions (the noise-free image from
the JAX line engine, the counts drawn with numpy), identical images (NaN),
independent noise (2.0), and a sectored case on an anisotropic image.
Curves agree to max|port - jax| / max|jax| <= 1e-5; resolutions to the
same bar, NaN where JAX gives NaN. A resolution is compared only where no
ring's FRC lies within 1e-4 of the threshold, so a crossing index cannot
flip on rounding; each test asserts that of its data."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rescan_line_sted_tpu as J
from rescan_line_sted_torch.algorithms import frc as tf
from rescan_line_sted_tpu.algorithms import frc as jf
from rescan_line_sted_tpu.data import samples
from rescan_line_sted_tpu.imaging import line_sted_image

torch.set_num_threads(1)
TOL = 1e-5
MARGIN = 1e-4
THRESHOLD = 1.0 / 7.0


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    if nan.all():
        return 0.0
    return float(np.abs(got - want)[~nan].max()
                 / max(np.abs(want[~nan]).max(), 1e-30))


def _one_hot(ring, n_rings):
    m = np.zeros((n_rings, ring.size), np.float32)
    on = ring >= 0
    m[ring[on], np.arange(ring.size)[on]] = 1.0
    return m


@pytest.mark.parametrize("shape", [(64, 64), (48, 80), (33, 50), (96, 192)])
@pytest.mark.parametrize("sector", [None, ("x", 30.0), ("y", 30.0),
                                    ("x", 15.0)])
def test_ring_index_is_the_jax_ring_matrix(shape, sector):
    """Each bin's kept ring (DC and empty rings dropped) and the rings'
    mean frequencies equal the JAX one-hot matrices' rows, exactly."""
    if sector is None:
        want, wf = jf._ring_matrix(shape, 64)
        ring, freqs = tf._ring_index(shape, 64)
    else:
        want, wf = jf._sector_ring_matrix(shape, 48, *sector)
        ring, freqs = tf._sector_ring_index(shape, 48, *sector)
    assert np.array_equal(_one_hot(ring, freqs.size), np.asarray(want))
    assert np.array_equal(freqs, np.asarray(wf))


def _acquisitions(size, depletion, brightness, seed, shape=None):
    """Two independent Poisson draws (numpy, ``seed``) of the JAX line
    engine's noise-free siemens-star image."""
    shape = shape or (size, size)
    geom = J.LineSTEDGeometry(J.Grid(*shape), chunk=16)
    params = J.LineSTEDParams.create(depletion=depletion,
                                     brightness=brightness,
                                     sigma_exc=2.0, sigma_det=2.0)
    mean = np.asarray(line_sted_image(samples.siemens_star(shape), params,
                                      geom).image, np.float64)
    rng = np.random.default_rng(seed)
    return (rng.poisson(np.maximum(mean, 0)).astype(np.float32),
            rng.poisson(np.maximum(mean, 0)).astype(np.float32))


def _jax_sector_curve(a, b, num_rings, axis, half_angle):
    """The sectored curve as the JAX ``frc_sectored_resolution`` forms it."""
    f1 = jnp.fft.rfft2(a - jnp.mean(a))
    f2 = jnp.fft.rfft2(b - jnp.mean(b))
    cross = jnp.real(f1 * jnp.conj(f2)).reshape(-1)
    p1 = jnp.abs(f1).reshape(-1) ** 2
    p2 = jnp.abs(f2).reshape(-1) ** 2
    rings, _ = jf._sector_ring_matrix(a.shape, num_rings, axis, half_angle)
    return np.asarray((rings @ cross)
                      / jnp.maximum(jnp.sqrt((rings @ p1) * (rings @ p2)),
                                    1e-30))


def _clear_of_threshold(curve):
    gap = float(np.abs(np.asarray(curve, np.float64) - THRESHOLD).min())
    assert gap > MARGIN, f"a ring's FRC lies {gap:.1e} from the threshold"


PAIRS = [(64, 0.0, 200.0, 1), (64, 8.0, 50.0, 2), (96, 4.0, 2000.0, 3),
         (96, 12.0, 5.0, 4), (48, 2.0, 500.0, 5)]


@pytest.mark.parametrize("size,depletion,brightness,seed", PAIRS)
def test_frc_curve_and_resolution(size, depletion, brightness, seed):
    a, b = _acquisitions(size, depletion, brightness, seed)
    wf, wc = jf.frc_curve(jnp.asarray(a), jnp.asarray(b))
    gf, gc = tf.frc_curve(torch.from_numpy(a), torch.from_numpy(b))
    assert np.array_equal(gf.numpy(), np.asarray(wf))
    assert rel(gc, wc) <= TOL
    _clear_of_threshold(wc)
    want = jf.frc_resolution(jnp.asarray(a), jnp.asarray(b))
    got = tf.frc_resolution(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == () and rel(got, want) <= TOL


@pytest.mark.parametrize("size,depletion,brightness,seed", PAIRS)
def test_frc_sectored_resolution(size, depletion, brightness, seed):
    a, b = _acquisitions(size, depletion, brightness, seed)
    for axis in ("x", "y"):
        _clear_of_threshold(_jax_sector_curve(jnp.asarray(a), jnp.asarray(b),
                                              48, axis, 30.0))
    want = jf.frc_sectored_resolution(jnp.asarray(a), jnp.asarray(b))
    got = tf.frc_sectored_resolution(torch.from_numpy(a), torch.from_numpy(b))
    for g, w in zip(got, want):
        assert rel(g, w) <= TOL


@pytest.mark.parametrize("shape,seed", [((48, 96), 6), ((64, 128), 7),
                                        ((96, 48), 8)])
def test_sectored_on_an_anisotropic_image(shape, seed):
    """An anisotropic canvas (x stretched, as the rescan canvas is): each
    column of a line image repeated twice along x; the two axes'
    resolutions differ, and each matches JAX."""
    a, b = _acquisitions(None, 6.0, 1000.0, seed,
                         shape=(shape[0], shape[1] // 2))
    a, b = (np.repeat(x, 2, axis=1) for x in (a, b))
    for axis in ("x", "y"):
        _clear_of_threshold(_jax_sector_curve(jnp.asarray(a), jnp.asarray(b),
                                              48, axis, 30.0))
    want = jf.frc_sectored_resolution(jnp.asarray(a), jnp.asarray(b))
    got = tf.frc_sectored_resolution(torch.from_numpy(a), torch.from_numpy(b))
    assert np.isfinite(float(want[0])) and np.isfinite(float(want[1]))
    assert float(want[0]) != float(want[1])
    for g, w in zip(got, want):
        assert rel(g, w) <= TOL


@pytest.mark.parametrize("shape", [(64, 64), (48, 80)])
def test_identical_images_give_nan(shape):
    img = np.array(samples.siemens_star(shape))
    wf, wc = jf.frc_curve(jnp.asarray(img), jnp.asarray(img))
    gf, gc = tf.frc_curve(torch.from_numpy(img), torch.from_numpy(img))
    assert rel(gc, wc) <= TOL
    np.testing.assert_allclose(gc.numpy(), 1.0, atol=1e-4)
    got = tf.frc_resolution(torch.from_numpy(img), torch.from_numpy(img))
    assert np.isnan(float(jf.frc_resolution(jnp.asarray(img),
                                            jnp.asarray(img))))
    assert np.isnan(float(got))
    for g in tf.frc_sectored_resolution(torch.from_numpy(img),
                                        torch.from_numpy(img)):
        assert np.isnan(float(g))


@pytest.mark.parametrize("seed", [0, 1, 3])
def test_independent_noise(seed):
    """Two independent normal fields: the curves agree, and where JAX's
    curve starts below the threshold (asserted clear of it, as below)
    both give 2.0 (Nyquist)."""
    k1, k2 = jax.random.split(jax.random.key(seed))
    a = np.array(jax.random.normal(k1, (64, 64)))
    b = np.array(jax.random.normal(k2, (64, 64)))
    _, wc = jf.frc_curve(jnp.asarray(a), jnp.asarray(b))
    _, gc = tf.frc_curve(torch.from_numpy(a), torch.from_numpy(b))
    assert rel(gc, wc) <= TOL
    assert np.abs(gc.numpy()).mean() < 0.2
    _clear_of_threshold(wc)
    want = float(jf.frc_resolution(jnp.asarray(a), jnp.asarray(b)))
    got = float(tf.frc_resolution(torch.from_numpy(a), torch.from_numpy(b)))
    assert rel(got, want) <= TOL
    if float(wc[0]) < THRESHOLD:
        assert got == want == 2.0


def test_anticorrelated_noise_gives_nyquist():
    """Anti-correlated noise starts below the threshold in every ring:
    2.0 in both packages, radial and sectored."""
    rng = np.random.default_rng(9)
    a = rng.standard_normal((64, 64)).astype(np.float32)
    b = (-a + 0.1 * rng.standard_normal((64, 64))).astype(np.float32)
    assert float(tf.frc_resolution(torch.from_numpy(a),
                                   torch.from_numpy(b))) == 2.0
    assert float(jf.frc_resolution(jnp.asarray(a), jnp.asarray(b))) == 2.0
    for g, w in zip(tf.frc_sectored_resolution(torch.from_numpy(a),
                                               torch.from_numpy(b)),
                    jf.frc_sectored_resolution(jnp.asarray(a),
                                               jnp.asarray(b))):
        assert float(g) == float(w) == 2.0


def test_repeat_calls_give_the_same_bits():
    a, b = _acquisitions(64, 4.0, 300.0, 11)
    first = tf.frc_curve(torch.from_numpy(a), torch.from_numpy(b))[1]
    for _ in range(3):
        assert torch.equal(
            tf.frc_curve(torch.from_numpy(a), torch.from_numpy(b))[1], first)

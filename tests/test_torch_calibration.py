"""Port parity of instrument calibration (``algorithms/calibration.py``)
and of the engines' gradients in their physics fields.

The loss of the fit (mean squared error of a noise-free forward against
data) and its gradient in every fitted field, at the fit's starting point
(the softplus parameterisation), against ``jax.value_and_grad`` on the
same numpy-seeded inputs: loss within 1e-5 relative, each gradient within
1e-4. The forwards: the line and point analytic engines, the rescanned
line engine's analytic method (the rescan canvas mean) at (R, b) = (2, 2)
and (1.5, 1), the ISM engine's (the ISM canvas mean) at R = 2 and every
non-default illumination model. Then: tensor fields give the
images float fields give (1e-7); the first 20 Adam steps against optax;
the JAX suite's three calibration tests on the port; the fit's refusals
(no gradient path, a field the model never reads) and host reads; and no
params-keyed cache takes params that hold a tensor.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import rescan_line_sted_torch as T
import rescan_line_sted_tpu as J
from rescan_line_sted_torch.algorithms import (
    fit_acquisition_params,
    fit_line_sted_params,
    fit_point_sted_params,
)
from rescan_line_sted_torch.config import cache_key_ok
from rescan_line_sted_torch.convert import geometry_from_jax, params_from_jax
from rescan_line_sted_torch.data import samples as tsamples
from rescan_line_sted_torch.imaging import analytic as tanalytic
from rescan_line_sted_torch.imaging import line_sted as tline
from rescan_line_sted_torch.imaging import rescan_point as tpoint
from rescan_line_sted_torch.physics import models as tmodels
from rescan_line_sted_tpu import imaging as jimaging
from rescan_line_sted_tpu.algorithms import calibration as jcal
from rescan_line_sted_tpu.physics import models as jmodels

torch.set_num_threads(1)
LINE_FIELDS = ("sigma_exc", "sigma_det", "stripe_period", "depletion",
               "brightness")
POINT_FIELDS = ("sigma_exc", "sigma_det", "sigma_dep", "depletion",
                "brightness")
LINE_TRUE = dict(sigma_exc=2.5, sigma_det=3.0, stripe_period=10.0,
                 depletion=5.0, slit_halfwidth=3.0, brightness=100.0)
LINE_INIT = dict(sigma_exc=2.2, sigma_det=2.0, stripe_period=11.5,
                 depletion=1.0, brightness=80.0)
POINT_TRUE = dict(sigma_exc=2.0, sigma_det=2.2, sigma_dep=2.0,
                  depletion=3.0, pinhole_radius=3.0, brightness=1.0)
POINT_INIT = dict(sigma_exc=1.7, sigma_det=3.2, sigma_dep=2.4,
                  depletion=1.0, brightness=1.3)


def _engine(name):
    """``(jax forward, port forward)`` of ``sample, params, geom``."""
    if name == "line":
        return (lambda s, p, g: jimaging.line_sted_image(s, p, g).image,
                lambda s, p, g: T.line_sted_image(s, p, g,
                                                  device="cpu").image)
    if name == "point":
        return (lambda s, p, g: jimaging.point_sted_image(s, p, g).image,
                lambda s, p, g: T.point_sted_image(s, p, g,
                                                   device="cpu").image)
    if name == "rescan":     # the analytic method: rescan_canvas_mean
        return (lambda s, p, g: jimaging.rescanned_line_sted_image(
                    s, p, g).image,
                lambda s, p, g: T.rescanned_line_sted_image(
                    s, p, g, device="cpu").image)
    return (lambda s, p, g: jimaging.rescanned_point_sted_image(
                s, p, g).image,
            lambda s, p, g: T.rescanned_point_sted_image(
                s, p, g, device="cpu").image)


# name: (engine, geometry, illumination model, fitted fields)
CASES = {
    "line_48": ("line", J.LineSTEDGeometry(J.Grid(48, 48), chunk=16), None,
                LINE_FIELDS),
    "point_32": ("point", J.PointSTEDGeometry(J.Grid(32, 32), chunk=32),
                 None, POINT_FIELDS),
    "rescan_R2_b2": ("rescan", J.RescanGeometry(J.Grid(48, 48),
                                                rescan_factor=2.0, binning=2),
                     None, LINE_FIELDS),
    "rescan_R1.5_b1": ("rescan", J.RescanGeometry(J.Grid(48, 48),
                                                  rescan_factor=1.5),
                       None, LINE_FIELDS),
    "ism_R2": ("ism", J.RescanPointGeometry(J.Grid(32, 32),
                                            rescan_factor=2.0),
               None, POINT_FIELDS),
    # the pupil donut reads sigma_dep through its hard aperture alone
    "pupil_donut": ("point", J.PointSTEDGeometry(J.Grid(32, 32), chunk=32),
                    jmodels.PupilDonutModel(),
                    ("sigma_exc", "sigma_det", "depletion", "brightness")),
    "vectorial_donut": ("point",
                        J.PointSTEDGeometry(J.Grid(32, 32), chunk=32),
                        jmodels.VectorialDonutModel(), POINT_FIELDS),
    "enveloped_stripe": ("line", J.LineSTEDGeometry(J.Grid(48, 48),
                                                    chunk=16),
                         jmodels.EnvelopedStripeModel(), LINE_FIELDS),
    "interference_s": ("line", J.LineSTEDGeometry(J.Grid(48, 48), chunk=16),
                       jmodels.InterferenceStripeModel("s"), LINE_FIELDS),
    "interference_p": ("line", J.LineSTEDGeometry(J.Grid(48, 48), chunk=16),
                       jmodels.InterferenceStripeModel("p"), LINE_FIELDS),
}


def _setup(name):
    """The case's JAX forward, port forward, JAX true and initial params,
    port geometry, fields, numpy sample and the JAX data."""
    engine, jgeom, model, fields = CASES[name]
    point = engine in ("point", "ism")
    cls = J.PointSTEDParams if point else J.LineSTEDParams
    jtrue = cls.create(**(POINT_TRUE if point else LINE_TRUE), model=model)
    jinit = jtrue.replace(**{f: jnp.float32(v) for f, v in (
        POINT_INIT if point else LINE_INIT).items() if f in fields})
    rng = np.random.default_rng(sum(map(ord, name)))
    shape = jgeom.grid.shape
    sample = (rng.random(shape) * (rng.random(shape) < 0.15)
              + 0.1 * rng.random(shape)).astype(np.float32)
    jfwd, tfwd = _engine(engine)
    data = np.array(jfwd(jnp.asarray(sample), jtrue, jgeom))
    return (jfwd, tfwd, jtrue, jinit, jgeom, geometry_from_jax(jgeom),
            fields, sample, data)


def _jax_value_and_grad(jfwd, jinit, jgeom, fields, sample, data):
    """The JAX fit's loss and gradient at its starting point
    (``calibration.py:50-62``)."""
    theta0 = {f: jnp.log(jnp.expm1(jnp.maximum(
        jnp.asarray(getattr(jinit, f), jnp.float32), 1e-4))) for f in fields}

    def loss_fn(theta):
        p = jinit.replace(**{f: jax.nn.softplus(t) for f, t in theta.items()})
        return jnp.mean(jnp.square(jfwd(jnp.asarray(sample), p, jgeom)
                                   - jnp.asarray(data)))

    loss, grad = jax.value_and_grad(loss_fn)(theta0)
    return float(loss), {f: float(g) for f, g in grad.items()}


def _port_value_and_grad(tfwd, tinit, tgeom, fields, sample, data):
    """The same loss and gradient through the port's engines and
    autograd, the fields as 0-d tensors as the port's fit sets them."""
    theta = {f: torch.log(torch.expm1(torch.clamp_min(
        torch.tensor(getattr(tinit, f)), 1e-4))).requires_grad_()
        for f in fields}
    p = tinit.replace(**{f: torch.nn.functional.softplus(t)
                         for f, t in theta.items()})
    loss = torch.mean(torch.square(
        tfwd(torch.from_numpy(sample), p, tgeom) - torch.from_numpy(data)))
    loss.backward()
    return float(loss.detach()), {f: float(t.grad) for f, t in theta.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_gradient_match_jax(name):
    jfwd, tfwd, _, jinit, jgeom, tgeom, fields, sample, data = _setup(name)
    want_loss, want = _jax_value_and_grad(jfwd, jinit, jgeom, fields,
                                          sample, data)
    got_loss, got = _port_value_and_grad(tfwd, params_from_jax(jinit),
                                         tgeom, fields, sample, data)
    assert want_loss > 0
    assert abs(got_loss - want_loss) <= 1e-5 * want_loss, (got_loss,
                                                          want_loss)
    for f in fields:
        assert want[f] != 0.0, f
        assert abs(got[f] - want[f]) <= 1e-4 * abs(want[f]), (f, got[f],
                                                              want[f])


@pytest.mark.parametrize("name", list(CASES))
def test_tensor_fields_give_the_float_fields_images(name):
    _, tfwd, jtrue, _, _, tgeom, fields, sample, _ = _setup(name)
    floats = params_from_jax(jtrue)
    tensors = floats.replace(**{f: torch.tensor(getattr(floats, f))
                                for f in fields})
    assert tensors.exc_support == floats.exc_support
    s = torch.from_numpy(sample)
    want = tfwd(s, floats, tgeom)
    got = tfwd(s, tensors, tgeom)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-7 * float(want.abs().max())


def test_first_adam_steps_match_optax():
    """20 steps of the port's fit (``torch.optim.Adam``) against the JAX
    fit (``optax.adam``) from the same start: losses and fields."""
    jfwd, tfwd, _, jinit, jgeom, tgeom, fields, sample, data = \
        _setup("line_48")
    jfit, jlosses = jcal.fit_acquisition_params(
        lambda p: jfwd(jnp.asarray(sample), p, jgeom), jnp.asarray(data),
        jinit, fields, num_steps=20)
    s = torch.from_numpy(sample)
    tfit, tlosses = fit_acquisition_params(
        lambda p: tfwd(s, p, tgeom), torch.from_numpy(data),
        params_from_jax(jinit), fields, num_steps=20)
    want = np.asarray(jlosses, np.float64)
    got = tlosses.double().numpy()
    assert got.shape == (20,)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    for f in fields:
        w = float(getattr(jfit, f))
        g = getattr(tfit, f)
        assert isinstance(g, torch.Tensor) and not g.requires_grad
        assert abs(float(g) - w) <= 1e-4 * abs(w), (f, float(g), w)


# ---- the JAX suite's calibration tests (tests/test_calibration.py) --------

def test_recovers_sigma_det_and_depletion():
    shape = (48, 48)
    sample = tsamples.sparse_points(shape, spacing=16, device="cpu")
    geom = T.LineSTEDGeometry(T.Grid(*shape), chunk=16)
    true = T.LineSTEDParams.create(**LINE_TRUE)
    data = T.line_sted_image(sample, true, geom, device="cpu").image

    init = true.replace(sigma_det=torch.tensor(2.0),
                        depletion=torch.tensor(1.0))
    fitted, losses = fit_line_sted_params(
        data, sample, init, geom, fit_fields=("sigma_det", "depletion"),
        num_steps=400, learning_rate=5e-2)
    l = losses.numpy()
    assert l[-1] < 1e-2 * l[0]
    assert abs(float(fitted.sigma_det) - 3.0) < 0.1
    assert abs(float(fitted.depletion) - 5.0) < 0.3


class _HostReads(TorchDispatchMode):
    """Counts the tensor-to-number reads (``aten._local_scalar_dense``:
    ``.item()``, ``float()``, ``bool()``) made outside ``torch.optim``,
    whose Adam reads its own CPU step counters."""

    def __init__(self):
        super().__init__()
        self.reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            import traceback

            optim = os.sep + os.path.join("torch", "optim") + os.sep
            if not any(optim in fr.filename
                       for fr in traceback.extract_stack()):
                self.reads += 1
        return func(*args, **(kwargs or {}))


def test_fit_reads_nothing_back():
    """The counterpart of the JAX suite's ``test_fit_is_jittable``: the fit
    runs with no read of a tensor into a number (on the card, under
    sync-debug mode "error": ``tests/test_torch_cuda.py``)."""
    shape = (32, 32)
    sample = tsamples.rings(shape, period=10.0, device="cpu")
    geom = T.LineSTEDGeometry(T.Grid(*shape), chunk=16)
    true = T.LineSTEDParams.create(depletion=3.0)
    data = T.line_sted_image(sample, true, geom, device="cpu").image
    with _HostReads() as mode:
        fitted, losses = fit_line_sted_params(
            data, sample, true.replace(depletion=torch.tensor(1.0)), geom,
            fit_fields=("depletion",), num_steps=50)
    assert mode.reads == 0
    assert np.isfinite(float(fitted.depletion))
    assert torch.isfinite(losses).all()


def test_recovers_point_params_and_generic_ism_forward():
    n = 32
    sample = tsamples.siemens_star((n, n), spokes=6, device="cpu")
    geom = T.PointSTEDGeometry(T.Grid(n, n), chunk=32)
    true = T.PointSTEDParams.create(**POINT_TRUE)
    data = T.point_sted_image(sample, true, geom, device="cpu").image
    init = true.replace(sigma_det=torch.tensor(3.2),
                        depletion=torch.tensor(1.0))
    fit, losses = fit_point_sted_params(data, sample, init, geom,
                                        num_steps=500, learning_rate=1e-1)
    assert losses[-1] < losses[0] * 1e-2
    assert abs(float(fit.sigma_det) - 2.2) < 0.1
    assert abs(float(fit.depletion) - 3.0) < 0.3

    igeom = T.RescanPointGeometry(T.Grid(n, n), rescan_factor=2.0)
    idata = tpoint.rescan_point_canvas_mean(sample, true, igeom)
    ifit, ilosses = fit_acquisition_params(
        lambda p: tpoint.rescan_point_canvas_mean(sample, p, igeom), idata,
        init, ("sigma_det", "depletion"), num_steps=500, learning_rate=1e-1)
    assert ilosses[-1] < ilosses[0] * 1e-2
    assert abs(float(ifit.sigma_det) - 2.2) < 0.1


# ---- refusals and caches ---------------------------------------------------

def _line(n=32):
    geom = T.LineSTEDGeometry(T.Grid(n, n), chunk=16)
    sample = tsamples.sparse_points((n, n), spacing=8, device="cpu")
    true = T.LineSTEDParams.create(depletion=3.0)
    return geom, sample, true, T.line_sted_image(sample, true, geom,
                                                 device="cpu").image


def test_fit_refuses_a_forward_without_a_gradient():
    """A noisy forward (a Poisson draw has no gradient, as a CUDA kernel
    without a backward has none) raises before the first step."""
    geom, sample, true, data = _line()
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="no gradient"):
        fit_acquisition_params(
            lambda p: T.line_sted_image(sample, p, geom, generator=gen,
                                        device="cpu").image,
            data, true, ("sigma_det", "depletion"), num_steps=3)


def test_fit_refuses_a_field_the_model_never_reads():
    """The rescan canvas never reads ``slit_halfwidth``: the fit names
    it rather than stepping on a zero gradient."""
    geom = T.RescanGeometry(T.Grid(32, 32), rescan_factor=2.0)
    sample = tsamples.sparse_points((32, 32), spacing=8, device="cpu")
    true = T.LineSTEDParams.create(depletion=3.0)
    data = tanalytic.rescan_canvas_mean(sample, true, geom)
    with pytest.raises(ValueError, match="'slit_halfwidth'"):
        fit_acquisition_params(
            lambda p: tanalytic.rescan_canvas_mean(sample, p, geom), data,
            true, ("sigma_det", "slit_halfwidth"), num_steps=3)


class _UnhashableStripe(tmodels.GaussianStripeModel):
    __hash__ = None


@pytest.mark.parametrize("cls,change,ok", [
    (T.LineSTEDParams, {}, True),
    (T.PointSTEDParams, {}, True),
    (T.LineSTEDParams, {"depletion": 2.0}, True),
    (T.LineSTEDParams, {"depletion": torch.tensor(2.0)}, False),
    (T.PointSTEDParams, {"sigma_det": torch.tensor(2.0)}, False),
    (T.LineSTEDParams, {"model": _UnhashableStripe()}, False),
], ids=["line", "point", "line_float", "line_tensor", "point_tensor",
        "unhashable_model"])
def test_cache_key_ok(cls, change, ok):
    """Numbers key a params cache; a tensor field (hashed by identity, with
    its autograd graph) or a model without a hash does not."""
    assert cache_key_ok(cls.create().replace(**change)) is ok


def test_no_params_keyed_cache_takes_tensor_fields():
    """K3's plan cache is keyed on params: tensor fields hash by identity,
    so a fit would miss on every step and keep every step's graph; the
    engine skips the cache for them. The phase-table caches are keyed on
    geometry alone and hit."""
    geom, sample, true, _ = _line()
    per_step = dict(generator=torch.Generator().manual_seed(1),
                    method="scan", noise_mode="per_step", use_pallas=True,
                    device="cpu")
    T.line_sted_image(sample, true, geom, **per_step)
    before = tline._k3_plan.cache_info()
    T.line_sted_image(sample, true, geom, **per_step)
    assert tline._k3_plan.cache_info().hits == before.hits + 1
    before = tline._k3_plan.cache_info()
    for depletion in (2.0, 2.5):
        T.line_sted_image(sample, true.replace(
            depletion=torch.tensor(depletion)), geom, **per_step)
    assert tline._k3_plan.cache_info() == before

    rgeom = T.RescanGeometry(T.Grid(32, 32), rescan_factor=2.0)
    tanalytic.rescan_canvas_mean(sample, true, rgeom)
    before = tanalytic._phase_tables.cache_info()
    for depletion in (2.0, 2.5):
        tanalytic.rescan_canvas_mean(sample, true.replace(
            depletion=torch.tensor(depletion)), rgeom)
    after = tanalytic._phase_tables.cache_info()
    assert after.misses == before.misses and after.hits > before.hits
    assert after.currsize == before.currsize

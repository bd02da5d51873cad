"""Port parity of the illumination models (``physics/models.py``) and of
``convert.params_from_jax``'s model carrying, against the JAX package.

Every model's profiles at 64^2 (point models) and width 256 (line models)
agree with the JAX package's to max|port - jax| / max|jax| <= 1e-5; then
one model runs through each engine, noise-free, against the JAX engine:
a pupil donut through the point scan's banded per-step route (its
sampler replaced by the identity), an enveloped stripe through the
descanned line scan and through the rescan scan on K1's banded route.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rescan_line_sted_torch as T
import rescan_line_sted_tpu as J
from rescan_line_sted_torch.convert import model_from_jax, params_from_jax
from rescan_line_sted_torch.imaging import point_sted as tpoint
from rescan_line_sted_torch.imaging import rescan as trescan
from rescan_line_sted_torch.physics import models as tmodels
from rescan_line_sted_tpu import imaging as jimaging
from rescan_line_sted_tpu.physics import models as jmodels

torch.set_num_threads(1)
LINE_KW = dict(sigma_exc=2.0, sigma_det=2.0, stripe_period=8.0,
               depletion=4.0, brightness=40.0)
POINT_KW = dict(sigma_exc=1.5, sigma_det=1.5, sigma_dep=1.5, depletion=4.0,
                pinhole_radius=2.5, brightness=50.0)
POINT_MODELS = [
    jmodels.GaussianDonutModel(), jmodels.PupilDonutModel(),
    jmodels.PupilDonutModel(charge=2),
    *(jmodels.VectorialDonutModel(polarization=p) for p in (
        "circular+", "circular-", "linear-x", "linear-y")),
    jmodels.VectorialDonutModel(charge=2, na=0.6)]
LINE_MODELS = [
    jmodels.GaussianStripeModel(), jmodels.EnvelopedStripeModel(),
    jmodels.EnvelopedStripeModel(envelope_sigmas=1.5),
    jmodels.InterferenceStripeModel(), jmodels.InterferenceStripeModel("p"),
    jmodels.InterferenceStripeModel("p", wavelength_px=12.0)]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _ids(ms):
    return [f"{type(m).__name__}-{i}" for i, m in enumerate(ms)]


@pytest.mark.parametrize("jm", POINT_MODELS, ids=_ids(POINT_MODELS))
def test_point_models_match_jax(jm):
    jp = J.PointSTEDParams.create(**{**POINT_KW, "sigma_dep": 2.5}, model=jm)
    tp = params_from_jax(jp)
    assert type(tp.model).__name__ == type(jm).__name__
    assert tp.model.gaussian_excitation
    for part in ("excitation", "depletion"):
        want = getattr(jm, part)((64, 64), jp)
        got = getattr(tp.model, part)((64, 64), tp, "cpu")
        assert got.dtype == torch.float32 and _rel(got, want) <= 1e-5, part
    assert _rel(tmodels.effective_point_psf((64, 64), tp),
                jmodels.effective_point_psf((64, 64), jp)) <= 1e-5


@pytest.mark.parametrize("jm", LINE_MODELS, ids=_ids(LINE_MODELS))
def test_line_models_match_jax(jm):
    jp = J.LineSTEDParams.create(**LINE_KW, model=jm)
    tp = params_from_jax(jp)
    assert tp.model.gaussian_excitation
    for part in ("excitation", "depletion"):
        want = getattr(jm, part)(256, jp)
        got = getattr(tp.model, part)(256, tp)
        assert got.dtype == torch.float32 and _rel(got, want) <= 1e-5, part
    assert _rel(tmodels.effective_line_profile(256, tp),
                jmodels.effective_line_profile(256, jp)) <= 1e-5


def test_unknown_polarization_raises():
    p = T.PointSTEDParams.create(**POINT_KW)
    with pytest.raises(ValueError, match="polarization"):
        tmodels.VectorialDonutModel(polarization="radial").depletion(
            (16, 16), p)
    lp = T.LineSTEDParams.create(**LINE_KW)
    with pytest.raises(ValueError, match="polarization"):
        tmodels.InterferenceStripeModel("q").depletion(32, lp)


def _both_point(model, h=64, w=64, chunk=16):
    jp = J.PointSTEDParams.create(**POINT_KW, model=model)
    return ((jp, J.PointSTEDGeometry(J.Grid(h, w), chunk=chunk)),
            (params_from_jax(jp), T.PointSTEDGeometry(T.Grid(h, w),
                                                      chunk=chunk)))


def _sample(h, w, seed=0):
    rng = np.random.default_rng(seed)
    ramp = np.linspace(0.2, 2.0, w, dtype=np.float32)[None, :]
    return (rng.random((h, w), np.float32) * ramp).astype(np.float32)


def test_pupil_donut_through_point_banded_route(monkeypatch):
    """The point scan's banded per-step route (a model with Gaussian
    excitation keeps the band windows), its sampler replaced by the
    identity, against the JAX collapsed scan of the same model."""
    (jp, jg), (tp, tg) = _both_point(jmodels.PupilDonutModel())
    assert tpoint._point_band(tp, 64, 64, 16) is not None
    s = _sample(64, 64, 1)
    calls = []

    def identity(lam, generator):
        calls.append(tuple(lam.shape))
        return lam.clamp_min(0.0)

    monkeypatch.setattr(tpoint, "poisson_rows_tiered", identity)
    got = T.point_sted_image(s, tp, tg, torch.Generator().manual_seed(0),
                             method="scan", noise_mode="per_step",
                             device="cpu").image
    want = jimaging.point_sted_image(jnp.asarray(s), jp, jg,
                                      method="scan").image
    assert calls and _rel(got, want) <= 1e-5
    for method in ("analytic", "scan"):
        want = jimaging.point_sted_image(jnp.asarray(s), jp, jg,
                                          method=method).image
        got = T.point_sted_image(s, tp, tg, method=method,
                                 device="cpu").image
        assert _rel(got, want) <= 1e-5, method


def _line_params(model):
    jp = J.LineSTEDParams.create(**LINE_KW, model=model)
    return jp, params_from_jax(jp)


@pytest.mark.parametrize("method", ["analytic", "scan"])
def test_enveloped_stripe_through_line_engine(method):
    jp, tp = _line_params(jmodels.EnvelopedStripeModel(2.0))
    s = _sample(40, 64, 2)
    want = jimaging.line_sted_image(
        jnp.asarray(s), jp, J.LineSTEDGeometry(J.Grid(40, 64), chunk=16),
        method=method)
    got = T.line_sted_image(s, tp, T.LineSTEDGeometry(T.Grid(40, 64),
                                                      chunk=16),
                            method=method, device="cpu")
    assert _rel(got.image, want.image) <= 1e-5
    assert _rel(got.dose.depletion_dose, want.dose.depletion_dose) <= 1e-5


@pytest.mark.parametrize("rf", [2.0, 1.5])
def test_enveloped_stripe_through_rescan_k1(rf):
    """The rescan scan on K1's banded route (the model keeps its Gaussian
    excitation, so the band windows stay) against the JAX banded kernel in
    interpret mode."""
    jp, tp = _line_params(jmodels.EnvelopedStripeModel(2.0))
    jg = J.RescanGeometry(J.Grid(64, 256), rescan_factor=rf, chunk=16)
    tg = T.RescanGeometry(T.Grid(64, 256), rescan_factor=rf, chunk=16)
    assert trescan._illum_band(tp, 256, 16)[1] is not None
    s = _sample(64, 256, 3)
    want = jimaging.rescanned_line_sted_image(
        jnp.asarray(s), jp, jg, method="scan", use_pallas=True).image
    got = T.rescanned_line_sted_image(s, tp, tg, method="scan",
                                      device="cpu").image
    assert _rel(got, want) <= 1e-5


def test_convert_carries_every_shipped_model():
    for jm in POINT_MODELS + LINE_MODELS:
        tm = model_from_jax(jm)
        assert type(tm).__module__ == tmodels.__name__
        assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    assert model_from_jax(None) is None

    class UserModel:
        def excitation(self, width, params):
            return jnp.ones((width,), jnp.float32)

        depletion = excitation

    with pytest.raises(TypeError, match="UserModel"):
        params_from_jax(J.LineSTEDParams.create(model=UserModel()))


def test_jax_model_on_port_params_raises():
    """A JAX model object returns JAX arrays: placed on the port's params
    it raises and names params_from_jax, on every engine and the dose."""
    p = T.LineSTEDParams.create(**LINE_KW,
                                model=jmodels.EnvelopedStripeModel())
    g = T.LineSTEDGeometry(T.Grid(16, 32), chunk=16)
    with pytest.raises(TypeError, match="params_from_jax"):
        T.line_sted_image(np.zeros((16, 32), np.float32), p, g,
                          device="cpu")
    with pytest.raises(TypeError, match="params_from_jax"):
        tmodels.effective_line_profile(32, p)

    class JaxLike:              # a user's own model returning JAX arrays
        def excitation(self, width, params, device=None):
            return jnp.ones((width,), jnp.float32)

        depletion = excitation

    with pytest.raises(TypeError, match="params_from_jax"):
        tmodels.effective_line_profile(
            32, dataclasses.replace(p, model=JaxLike()))

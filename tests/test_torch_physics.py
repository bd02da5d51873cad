"""Port parity: PSF profiles, illumination model, dose, fftconv, shifts and
fwhm_1d of ``rescan_line_sted_torch`` against the JAX package, on the same
numpy inputs. Noise-free agreement: max|port - jax| / max|jax| <= 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rescan_line_sted_torch import config as tcfg
from rescan_line_sted_torch.algorithms.metrics import fwhm_1d as t_fwhm
from rescan_line_sted_torch.imaging import shifts as tshifts
from rescan_line_sted_torch.kernels import fftconv as tfft
from rescan_line_sted_torch.physics import dose as tdose
from rescan_line_sted_torch.physics import models as tmodels
from rescan_line_sted_torch.physics import psf as tpsf
from rescan_line_sted_tpu import config as jcfg
from rescan_line_sted_tpu.algorithms.metrics import fwhm_1d as j_fwhm
from rescan_line_sted_tpu.imaging import shifts as jshifts
from rescan_line_sted_tpu.kernels import fftconv as jfft
from rescan_line_sted_tpu.physics import dose as jdose
from rescan_line_sted_tpu.physics import models as jmodels
from rescan_line_sted_tpu.physics import psf as jpsf

torch.set_num_threads(1)
TOL = 1e-5


def rel(got, want) -> float:
    got = np.asarray(got, np.complex128)
    want = np.asarray(want, np.complex128)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("name,args", [
    ("line_excitation_profile", (64, 2.5)),
    ("line_excitation_profile", (65, 1.6)),
    ("stripe_depletion_profile", (64, 9.0)),
    ("stripe_depletion_profile", (97, 12.0)),
    ("detection_profile", (64, 3.0)),
    ("detection_profile", (33, 1.7)),
])
def test_psf_profiles(name, args):
    n, p = args
    want = getattr(jpsf, name)(n, jnp.float32(p))
    got = getattr(tpsf, name)(n, np.float32(p))
    assert got.dtype == torch.float32
    assert rel(got, want) <= TOL


@pytest.mark.parametrize("depletion", [0.0, 4.0, 8.0])
def test_effective_profile_and_model(depletion):
    kw = dict(sigma_exc=2.0, sigma_det=2.5, stripe_period=9.0,
              depletion=depletion, brightness=50.0)
    jp, tp = jcfg.LineSTEDParams.create(**kw), tcfg.LineSTEDParams.create(**kw)
    assert rel(tmodels.effective_line_profile(96, tp),
               jmodels.effective_line_profile(96, jp)) <= TOL
    rng = np.random.default_rng(3)
    exc, dep = rng.random(50, np.float32), rng.random(50, np.float32)
    assert rel(tpsf.effective_psf(_t(exc), _t(dep), depletion),
               jpsf.effective_psf(exc, dep, jnp.float32(depletion))) <= TOL


def test_params_and_supports_match():
    kw = dict(sigma_exc=1.6, sigma_det=2.3, stripe_period=7.5,
              depletion=3.0, slit_halfwidth=3.5, brightness=12.5)
    jp, tp = jcfg.LineSTEDParams.create(**kw), tcfg.LineSTEDParams.create(**kw)
    for f in ("sigma_exc", "sigma_det", "stripe_period", "depletion",
              "slit_halfwidth", "brightness"):
        assert getattr(tp, f) == float(getattr(jp, f))
    for f in ("exc_support", "det_support", "slit_support_px"):
        assert getattr(tp, f) == getattr(jp, f)
    g = tcfg.RescanGeometry(tcfg.Grid(64, 96), rescan_factor=1.5, binning=2)
    jg = jcfg.RescanGeometry(jcfg.Grid(64, 96), rescan_factor=1.5, binning=2)
    assert g.canvas_shape == jg.canvas_shape and g.num_steps == jg.num_steps
    with pytest.raises(ValueError, match="binning"):
        tcfg.RescanGeometry(tcfg.Grid(63, 96), binning=2)
    with pytest.raises(ValueError, match="rescan_factor"):
        tcfg.RescanGeometry(tcfg.Grid(64, 96), rescan_factor=0.5)


@pytest.mark.parametrize("rescan_factor,depletion", [(2.0, 0.0), (1.5, 8.0)])
def test_line_sted_dose(rescan_factor, depletion):
    kw = dict(sigma_exc=3.0, sigma_det=3.0, stripe_period=12.0,
              depletion=depletion, brightness=1.0)
    jg = jcfg.RescanGeometry(jcfg.Grid(32, 128), rescan_factor=rescan_factor)
    tg = tcfg.RescanGeometry(tcfg.Grid(32, 128), rescan_factor=rescan_factor)
    want = jdose.line_sted_dose(jcfg.LineSTEDParams.create(**kw), jg)
    got = tdose.line_sted_dose(tcfg.LineSTEDParams.create(**kw), tg)
    for f in ("excitation_dose", "depletion_dose",
              "emission_per_unit_sample", "num_steps", "total_dose",
              "signal_per_dose"):
        assert rel(getattr(got, f), getattr(want, f)) <= TOL, f


def _profile(n, sigma):
    return np.asarray(jpsf.detection_profile(n, jnp.float32(sigma)))


@pytest.mark.parametrize("case", [
    "otf1d", "convolve_rows", "convolve_cols", "circulant_matrix",
    "circulant_window", "window_is_slice"])
def test_fftconv(case):
    rng = np.random.default_rng(7)
    img = rng.random((48, 40), np.float32)
    p = _profile(40, 1.8)
    if case == "otf1d":
        got, want = tfft.profile_to_otf1d(_t(p)), jfft.profile_to_otf1d(p)
    elif case == "convolve_rows":
        q = _profile(48, 2.2)
        got = tfft.convolve_otf1d(_t(img), tfft.profile_to_otf1d(_t(q)),
                                  axis=-2, n=48)
        want = jfft.convolve_otf1d(img, jfft.profile_to_otf1d(q), axis=-2,
                                   n=48)
    elif case == "convolve_cols":
        got = tfft.convolve_otf1d(_t(img), tfft.profile_to_otf1d(_t(p)),
                                  axis=-1, n=40)
        want = jfft.convolve_otf1d(img, jfft.profile_to_otf1d(p), axis=-1,
                                   n=40)
    elif case == "circulant_matrix":
        got, want = tfft.circulant_matrix(_t(p)), jfft.circulant_matrix(p)
    elif case == "circulant_window":
        got = tfft.circulant_window(_t(p), 24, 16, 6, 2)
        want = jfft.circulant_window(p, 24, 16, 6, 2)
    else:
        # the window is a row/column slice of the transposed circulant
        w = 40
        got = tfft.circulant_window(_t(p), 24, 16, 6, 2)
        full = tfft.circulant_matrix(_t(p)).T
        rows = (torch.arange(24) - 6) % w
        cols = (torch.arange(16) - 2) % w
        want = full[rows][:, cols]
        assert torch.equal(got, want)
    assert rel(got, want) <= TOL


@pytest.mark.parametrize("n", [31, 32])
def test_shifts(n):
    rng = np.random.default_rng(n)
    prof = rng.random(n, np.float32)
    pos = np.array([0, 3, n - 1, n // 2], np.int64)
    assert rel(tshifts.shifted_profiles(_t(prof), _t(pos)),
               jshifts.shifted_profiles(prof, pos)) == 0.0
    img = rng.random((n, n + 1), np.float32)
    assert rel(tshifts.flip_centered(_t(prof)),
               jshifts.flip_centered(prof)) == 0.0
    assert rel(tshifts.flip_centered(_t(img)),
               jshifts.flip_centered(img)) == 0.0


@pytest.mark.parametrize("kind", ["gauss", "narrow", "depleted", "two_lobes",
                                  "flat", "edge"])
def test_fwhm_1d(kind):
    x = np.arange(128, dtype=np.float32) - 64
    if kind == "gauss":
        p = np.exp(-x ** 2 / (2 * 5.0 ** 2))
    elif kind == "narrow":
        p = np.exp(-x ** 2 / (2 * 0.9 ** 2))
    elif kind == "depleted":
        p = np.asarray(jmodels.effective_line_profile(
            128, jcfg.LineSTEDParams.create(depletion=8.0)))
    elif kind == "two_lobes":
        p = np.exp(-(x - 20) ** 2 / 8) + np.exp(-(x + 20) ** 2 / 8)
    elif kind == "flat":
        p = np.ones_like(x)
    else:
        p = np.exp(-(x + 64) ** 2 / 50)          # half max never crossed left
    p = p.astype(np.float32)
    got, want = float(t_fwhm(_t(p))), float(j_fwhm(p))
    if np.isnan(want):
        assert np.isnan(got)
    else:
        assert abs(got - want) <= TOL * abs(want)

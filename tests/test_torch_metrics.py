"""Port parity: the sweep's measures and the procedural samples of
``rescan_line_sted_torch`` against the JAX package, on the same numpy
inputs (``fwhm_2d``, ``system_resolution_report``, ``fwhm_1d``'s NaN
contract, ``rescan_system_kernel``, ``upsample_x``, ``rings``,
``line_pairs``, ``sparse_points``). Noise-free agreement: max|port - jax|
/ max|jax| <= 1e-5 per array, NaN where JAX gives NaN."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rescan_line_sted_torch as T
import rescan_line_sted_tpu as J
from rescan_line_sted_torch.algorithms import metrics as tm
from rescan_line_sted_torch.convert import geometry_from_jax, params_from_jax
from rescan_line_sted_torch.data import samples as ts
from rescan_line_sted_torch.imaging import analytic as ta
from rescan_line_sted_tpu.algorithms import metrics as jm
from rescan_line_sted_tpu.data import samples as js
from rescan_line_sted_tpu.imaging import analytic as ja

torch.set_num_threads(1)
TOL = 1e-5


def rel(got, want) -> float:
    """max|got - want| / max|want| over the finite entries; NaN must sit
    where ``want`` has NaN."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    if nan.all():
        return 0.0
    return float(np.abs(got - want)[~nan].max()
                 / max(np.abs(want[~nan]).max(), 1e-30))


def _gauss(shape, sy, sx, cy=0.0, cx=0.0):
    y = np.arange(shape[0])[:, None] - shape[0] // 2 - cy
    x = np.arange(shape[1])[None, :] - shape[1] // 2 - cx
    return np.exp(-y**2 / (2 * sy**2) - x**2 / (2 * sx**2)).astype(
        np.float32)


@pytest.mark.parametrize("shape,sy,sx,cy,cx", [
    ((65, 65), 4.0, 2.0, 0.0, 0.0),
    ((64, 48), 1.3, 3.7, 0.0, 0.0),
    ((33, 96), 2.5, 2.5, 0.3, -0.4),
    ((48, 48), 0.6, 5.0, 0.0, 0.0),
])
def test_fwhm_2d_gaussians(shape, sy, sx, cy, cx):
    k = _gauss(shape, sy, sx, cy, cx)
    want = jm.fwhm_2d(jnp.asarray(k))
    got = tm.fwhm_2d(torch.from_numpy(k))
    for g, w in zip(got, want):
        assert rel(g, w) <= TOL


POINT = [dict(depletion=0.0), dict(depletion=8.0, sigma_dep=2.0),
         dict(depletion=3.0, sigma_exc=2.2, pinhole_radius=2.5)]
LINE = [dict(depletion=0.0), dict(depletion=8.0),
        dict(depletion=4.0, stripe_period=9.0, slit_halfwidth=2.5)]
KINDS = ([("point", kw) for kw in POINT] + [("line", kw) for kw in LINE])


def _params(kind, kw):
    cls = J.PointSTEDParams if kind == "point" else J.LineSTEDParams
    jp = cls.create(**kw)
    return jp, params_from_jax(jp)


@pytest.mark.parametrize("kind,kw", KINDS)
@pytest.mark.parametrize("shape", [(64, 64), (48, 80)])
def test_fwhm_2d_of_system_kernels(kind, kw, shape):
    jp, tp = _params(kind, kw)
    jfn, tfn = ((ja.point_system_kernel, ta.point_system_kernel)
                if kind == "point" else
                (ja.line_system_kernel, ta.line_system_kernel))
    want = jm.fwhm_2d(jfn(shape, jp))
    got = tm.fwhm_2d(tfn(shape, tp))
    for g, w in zip(got, want):
        assert np.isfinite(float(w))
        assert rel(g, w) <= TOL


@pytest.mark.parametrize("kind,kw", KINDS)
def test_system_resolution_report(kind, kw):
    jp, tp = _params(kind, kw)
    want = jm.system_resolution_report((64, 64), jp)
    got = tm.system_resolution_report((64, 64), tp, device="cpu")
    assert isinstance(got, tm.ResolutionReport)
    assert rel(got.fwhm_x, want.fwhm_x) <= TOL
    assert rel(got.fwhm_y, want.fwhm_y) <= TOL
    assert got.replace(fwhm_x=got.fwhm_y).fwhm_x is got.fwhm_y


def _profiles():
    x = np.arange(64, dtype=np.float32)
    return {
        "two_lobes": (np.exp(-0.5 * ((x - 20) / 2) ** 2)
                      + 0.9 * np.exp(-0.5 * ((x - 44) / 2) ** 2)),
        "ones": np.ones(64), "zeros": np.zeros(64), "minus_ones": -np.ones(64),
        "single": np.exp(-0.5 * ((x - 32) / 3.0) ** 2),
        "edge_lobe": np.exp(-0.5 * ((x - 1) / 3.0) ** 2),
        "never_crosses_right": np.clip(x / 40.0, 0, 1),
    }


@pytest.mark.parametrize("name", list(_profiles()))
def test_fwhm_contract_cases(name):
    """The NaN contract (JAX ``tests/test_metrics.py:51``): multi-lobed,
    flat, non-positive or one-sided profiles give NaN in both packages;
    in 2D through the peak row and column too."""
    p = _profiles()[name].astype(np.float32)
    assert rel(tm.fwhm_1d(torch.from_numpy(p)), jm.fwhm_1d(jnp.asarray(p))) \
        <= TOL
    k = np.outer(p, p).astype(np.float32)
    for g, w in zip(tm.fwhm_2d(torch.from_numpy(k)),
                    jm.fwhm_2d(jnp.asarray(k))):
        assert rel(g, w) <= TOL


@pytest.mark.parametrize("rf,b,size", [
    (1.5, 1, 32), (2.0, 1, 48), (1.5, 2, 64), (3.0, 2, 32),
    (1.0 + math.pi / 16, 1, 64)])
def test_rescan_system_kernel(rf, b, size):
    jg = J.RescanGeometry(J.Grid(size, size), rescan_factor=rf, binning=b)
    jp = J.LineSTEDParams.create(depletion=6.0, sigma_exc=2.0, sigma_det=2.0,
                                 stripe_period=8.0)
    want = np.asarray(ja.rescan_system_kernel(jg, jp))
    got = ta.rescan_system_kernel(geometry_from_jax(jg), params_from_jax(jp))
    assert got.shape == want.shape == geometry_from_jax(jg).canvas_shape
    assert rel(got, want) <= TOL
    # its FWHMs, as the sweep's rescan arm reads them
    for g, w in zip(tm.fwhm_2d(got), jm.fwhm_2d(jnp.asarray(want))):
        assert rel(g, w) <= TOL


@pytest.mark.parametrize("shape,factor,out_width", [
    ((8, 16), 2, 32), ((3, 5, 7), 3, 21), ((4, 9), 2, 13), ((5, 6), 4, 19)])
def test_upsample_x(shape, factor, out_width):
    x = np.random.default_rng(sum(shape)).random(shape).astype(np.float32)
    want = ja.upsample_x(jnp.asarray(x), factor, out_width)
    got = ta.upsample_x(torch.from_numpy(x), factor, out_width)
    assert rel(got, want) <= TOL


@pytest.mark.parametrize("name,kw", [
    ("rings", {}), ("rings", dict(period=7.5)),
    ("line_pairs", {}), ("line_pairs", dict(min_period=3, max_period=20)),
    ("sparse_points", {}), ("sparse_points", dict(spacing=7))])
@pytest.mark.parametrize("shape", [(64, 64), (48, 80), (33, 32)])
def test_samples(name, kw, shape):
    want = np.asarray(getattr(js, name)(shape, **kw))
    got = getattr(ts, name)(shape, device="cpu", **kw)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert rel(got, want) <= TOL


@pytest.mark.parametrize("name", ["rings", "line_pairs", "sparse_points"])
def test_samples_default_to_the_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        getattr(T.data, name)((16, 16))


def test_fwhm_batched_as_under_vmap():
    """Leading dimensions are a batch: each profile measured alone, as the
    JAX function under ``jax.vmap`` (the sweep measures its points in one
    call), NaN cases included."""
    import jax

    profs = np.stack([p.astype(np.float32) for p in _profiles().values()])
    want = jax.vmap(jm.fwhm_1d)(jnp.asarray(profs))
    got = tm.fwhm_1d(torch.from_numpy(profs))
    assert rel(got, want) <= TOL
    kernels = np.stack([_gauss((48, 64), sy, sx) for sy, sx in
                        ((1.0, 3.0), (2.5, 2.5), (4.0, 0.8))])
    want = jax.vmap(jm.fwhm_2d)(jnp.asarray(kernels))
    got = tm.fwhm_2d(torch.from_numpy(kernels).reshape(3, 1, 48, 64))
    for g, w in zip(got, want):
        assert rel(g.reshape(3), w) <= TOL

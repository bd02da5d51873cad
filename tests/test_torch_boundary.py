"""Port parity of the padded and apodized boundaries
(``imaging/boundary.py``) against the JAX package on the same numpy
inputs: the helpers, and ``rescanned_line_sted_image`` with
``boundary="padded"`` / ``"apodized"`` at integer, class and irrational
rescan factors, with and without binning. The JAX scan is called with
``use_pallas=True`` (its banded kernel in interpret mode). Noise-free
agreement: max|port - jax| / max|jax| <= 1e-5.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import rescan_line_sted_torch as T
import rescan_line_sted_tpu as J
from rescan_line_sted_torch.imaging import boundary as tb
from rescan_line_sted_tpu.imaging import boundary as jb

torch.set_num_threads(1)
H, W = 48, 192           # the padded grid keeps 128-column band windows
KW = dict(sigma_exc=1.2, sigma_det=1.2, stripe_period=8.0, depletion=4.0,
          brightness=50.0)
# (R, b): integer, class (q = 2), irrational, binned integer, binned
# irrational, and a class step whose default margin gives R*m integral
CELLS = [(2.0, 1), (1.5, 1), (1.0 + np.pi / 16, 1), (3.0, 2),
         (1.0 + np.pi / 8, 2), (1.625, 1)]
CELL_IDS = ["int", "class", "irr", "int_b2", "irr_b2", "class8"]


def _both(rf, b, h=H, w=W, chunk=16):
    return ((J.RescanParams.create(**KW),
             J.RescanGeometry(J.Grid(h, w), rescan_factor=rf, binning=b,
                              chunk=chunk)),
            (T.RescanParams.create(**KW),
             T.RescanGeometry(T.Grid(h, w), rescan_factor=rf, binning=b,
                              chunk=chunk)))


def _sample(seed=0, h=H, w=W):
    return np.random.default_rng(seed).random((h, w), np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("rf,b", CELLS + [(1.25, 4), (2.5, 2)])
def test_default_margin_matches_jax(rf, b):
    (_, jg), (_, tg) = _both(rf, b, h=64, w=256)
    assert tb.default_margin(tg) == jb.default_margin(jg)
    line = J.LineSTEDGeometry(J.Grid(40, 96))
    assert tb.default_margin(
        types.SimpleNamespace(grid=T.Grid(40, 96))) == jb.default_margin(line)


@pytest.mark.parametrize("margin", [0, 5, 16])
def test_pad_and_apodize_match_jax(margin):
    s = _sample(1, 40, 56)
    got = tb.pad_sample(torch.from_numpy(s), margin)
    assert got.shape == (40 + 2 * margin, 56 + 2 * margin)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jb.pad_sample(jnp.asarray(s), margin)))
    got = tb.apodize_sample(torch.from_numpy(s), margin)
    want = jb.apodize_sample(jnp.asarray(s), margin)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-6
    with pytest.raises(ValueError, match="margin"):
        tb.apodize_sample(torch.from_numpy(s), -1)


@pytest.mark.parametrize("chunk,margin", [(16, 8), (32, 20), (12, 3)])
def test_padded_geometry_matches_jax(chunk, margin):
    (_, jg), (_, tg) = _both(1.5, 1, w=192, chunk=chunk)
    jp, tp = jb.padded_geometry(jg, margin), tb.padded_geometry(tg, margin)
    assert tp.grid.shape == tuple(jp.grid.shape)
    assert (tp.chunk, tp.rescan_factor, tp.binning) == \
        (jp.chunk, jp.rescan_factor, jp.binning)


@pytest.mark.parametrize("method", ["analytic", "scan"])
@pytest.mark.parametrize("rf,b", CELLS, ids=CELL_IDS)
def test_padded_matches_jax(rf, b, method):
    (jp, jg), (tp, tg) = _both(rf, b)
    s = _sample(2)
    want = J.imaging.rescanned_line_sted_image(
        jnp.asarray(s), jp, jg, method=method, use_pallas=True,
        boundary="padded").image
    got = T.rescanned_line_sted_image(s, tp, tg, method=method,
                                      boundary="padded", device="cpu").image
    assert got.shape == tg.canvas_shape and _rel(got, want) <= 1e-5


@pytest.mark.parametrize("method", ["analytic", "scan"])
@pytest.mark.parametrize("rf,b", CELLS[1:5], ids=CELL_IDS[1:5])
def test_apodized_matches_jax(rf, b, method):
    (jp, jg), (tp, tg) = _both(rf, b)
    s = _sample(3)
    want = J.imaging.rescanned_line_sted_image(
        jnp.asarray(s), jp, jg, method=method, use_pallas=True,
        boundary="apodized", margin=12).image
    got = T.rescanned_line_sted_image(s, tp, tg, method=method,
                                      boundary="apodized", margin=12,
                                      device="cpu").image
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("method", ["analytic", "scan"])
def test_fractional_margin_subpixel_crop_matches_jax(method):
    """R * margin not integral (1.625 * 12 = 19.5): the crop shifts the
    canvas band-limitedly before it cuts, in both packages alike."""
    (jp, jg), (tp, tg) = _both(1.625, 1, chunk=8)
    s = _sample(4)
    want = J.imaging.rescanned_line_sted_image(
        jnp.asarray(s), jp, jg, method=method, use_pallas=True,
        boundary="padded", margin=12).image
    got = T.rescanned_line_sted_image(s, tp, tg, method=method,
                                      boundary="padded", margin=12,
                                      device="cpu").image
    assert _rel(got, want) <= 1e-5


def test_padded_kills_wrap_and_reports_field_dose():
    """An emitter on the x edge wraps to the far canvas edge circularly,
    not padded; the padded dose is the requested field's."""
    _, (tp, tg) = _both(2.0, 1)
    s = np.zeros((H, W), np.float32)
    s[H // 2, 0] = 1.0
    circ = T.rescanned_line_sted_image(s, tp, tg, method="scan",
                                       device="cpu")
    pad = T.rescanned_line_sted_image(s, tp, tg, method="scan",
                                      boundary="padded", margin=16,
                                      device="cpu")
    assert pad.image.shape == tg.canvas_shape
    far = float(pad.image[:, -3:].abs().sum())
    assert float(circ.image[:, -3:].sum()) > 1e5 * max(far, 1e-12)
    for f in ("excitation_dose", "depletion_dose", "num_steps"):
        assert torch.equal(getattr(pad.dose, f), getattr(circ.dose, f)), f


def test_padded_guards():
    _, (tp, tg) = _both(3.0, 2)
    s = _sample(5)
    with pytest.raises(ValueError, match="margin"):
        T.rescanned_line_sted_image(s, tp, tg, method="scan",
                                    boundary="padded", margin=15,
                                    device="cpu")
    # 2D pixel reassignment crops both rescanned axes at R * margin / b,
    # and its margin must be divisible by the binning too
    from rescan_line_sted_torch.imaging.point_sted import AcquisitionResult

    point = T.RescanPointGeometry(T.Grid(16, 16), rescan_factor=2.0)
    seen = []

    def engine(s, g):
        seen.append(g)
        n = g.canvas_shape[0] * g.canvas_shape[1]
        return AcquisitionResult(
            image=torch.arange(n, dtype=torch.float32).reshape(
                g.canvas_shape), dose=None)

    img = tb.acquire_padded(engine, torch.zeros(16, 16), point, 4).image
    full = engine(None, seen[0]).image
    assert seen[0].grid.shape == (24, 24) and seen[0].chunk == 64
    assert torch.equal(img, full[8:40, 8:40])
    with pytest.raises(ValueError, match="margin"):
        tb.acquire_padded(engine, torch.zeros(16, 16), T.RescanPointGeometry(
            T.Grid(16, 16), binning=2), 3)

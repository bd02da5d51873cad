"""The rescan entry's plans: the tables a call takes from (params, geometry,
placement, device) alone, built once and reused (``imaging/rescan.
_image_plan``, ``imaging/analytic._canvas_constants``, K1's
``banded_plan``; ``device.plan_cache``).

On the CPU at 64 x 256 (the banded route needs a field wider than K1's
128-column windows), over the entry's four cached routes: K1 with class
placement (R = 1.5), with rounded placement, with NUFFT spreading (R = 1 +
pi/16) and the closed form. A cached call gives the image an uncached
build gives, bit for bit; a plan is rebuilt when its key changes and not
otherwise; params that cannot key a cache and a plan first built under
inference mode still serve autograd; a result's dose is its own.
"""

import numpy as np
import pytest
import torch

import rescan_line_sted_torch as T
from rescan_line_sted_torch import device as device_mod
from rescan_line_sted_torch.imaging import analytic
from rescan_line_sted_torch.imaging import rescan as trescan
from rescan_line_sted_torch.kernels.rescan_banded_fused import banded_plan

torch.set_num_threads(1)

# route: (rescan factor, method, reassignment)
ROUTES = {
    "class": (1.5, "scan", "auto"),
    "rounded": (1.5, "scan", "rounded"),
    "nufft": (1.0 + np.pi / 16, "scan", "auto"),
    "analytic": (1.5, "analytic", "auto"),
}
SHAPE = (64, 256)


def _params(**changes):
    kw = dict(sigma_exc=3.0, sigma_det=3.0, stripe_period=12.0,
              depletion=8.0, slit_halfwidth=4.0, brightness=1.0)
    kw.update(changes)
    return T.LineSTEDParams.create(**kw)


def _geom(rf):
    return T.RescanGeometry(T.Grid(*SHAPE), rescan_factor=rf, chunk=32)


def _sample(seed):
    return torch.rand(SHAPE, generator=torch.Generator().manual_seed(seed))


def _image(route, sample, params=None, seed=None, rf=None,
           reassignment=None):
    """One entry call of ``route``: per-step draws on the scan routes,
    collapsed ones on the closed form, from a generator seeded ``seed``
    (None: noise-free)."""
    r, method, placement = ROUTES[route]
    return T.rescanned_line_sted_image(
        sample, params or _params(), _geom(rf or r),
        generator=None if seed is None else torch.Generator().manual_seed(
            seed),
        method=method,
        noise_mode="per_step" if method == "scan" else "collapsed",
        reassignment=reassignment or placement, device="cpu")


def _builds(fn):
    """``rls.plan_build`` spans while ``fn()`` runs."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sum(1 for e in prof.events() if e.name == "rls.plan_build")


def _caches():
    return (trescan._image_plan.cache_info(),
            analytic._canvas_constants.cache_info())


@pytest.fixture(autouse=True)
def empty_caches():
    trescan._image_plan.cache_clear()
    analytic._canvas_constants.cache_clear()
    yield
    trescan._image_plan.cache_clear()
    analytic._canvas_constants.cache_clear()


def _uncached(monkeypatch):
    """Every plan built anew, by the same builders, for the rest of the
    test (as for params that cannot key a cache)."""
    monkeypatch.setattr(device_mod, "cache_key_ok", lambda _: False)


def _same_result(a, b):
    assert torch.equal(a.image, b.image)
    for name in ("excitation_dose", "depletion_dose",
                 "emission_per_unit_sample", "num_steps"):
        assert torch.equal(getattr(a.dose, name), getattr(b.dose, name))


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_cached_images_equal_uncached_bit_for_bit(route, monkeypatch):
    """Noise-free and with a same-seeded generator, a call served by the
    cache equals one whose plan is built anew."""
    s = _sample(1)
    _image(route, s)                                   # builds the plans
    hits = trescan._image_plan.cache_info().hits
    cached = (_image(route, s), _image(route, s, seed=5))
    assert trescan._image_plan.cache_info().hits == hits + 2
    _uncached(monkeypatch)
    before = _caches()
    fresh = (_image(route, s), _image(route, s, seed=5))
    assert _caches() == before                         # no cache touched
    for a, b in zip(cached, fresh):
        _same_result(a, b)
    # two calls with one generator draw differently, cached or not
    gen = torch.Generator().manual_seed(9)
    r, method, placement = ROUTES[route]
    two = [T.rescanned_line_sted_image(
        s, _params(), _geom(r), generator=gen, method=method,
        noise_mode="per_step" if method == "scan" else "collapsed",
        reassignment=placement, device="cpu").image for _ in range(2)]
    assert not torch.equal(*two)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_second_sample_matches_a_fresh_build(route, monkeypatch):
    """A plan built for one sample serves another of the same geometry:
    its image equals an uncached call's."""
    _image(route, _sample(1), seed=3)
    other = _sample(2)
    assert _builds(lambda: _image(route, other)) == 0
    cached = (_image(route, other), _image(route, other, seed=4))
    _uncached(monkeypatch)
    for a, b in zip(cached, (_image(route, other),
                             _image(route, other, seed=4))):
        _same_result(a, b)


@pytest.mark.parametrize("change", ["sigma_det", "rescan_factor",
                                    "reassignment"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_a_changed_key_rebuilds_the_plan(route, change):
    """Changing ``sigma_det``, the rescan factor or the placement builds
    the scan routes' one plan anew, once; the closed form builds its entry
    plan and its constants for a new sigma or factor, and ignores the
    placement. An unchanged call builds nothing."""
    s = _sample(1)
    _image(route, s)
    assert _builds(lambda: _image(route, s)) == 0
    r, method, placement = ROUTES[route]
    kw = {"sigma_det": dict(params=_params(sigma_det=2.5)),
          "rescan_factor": dict(rf=r + 0.25),
          "reassignment": dict(reassignment="subpixel"
                               if route == "rounded" else "rounded")}[change]
    want = 2 if method == "analytic" else 1
    if method == "analytic" and change == "reassignment":
        want = 0
    assert _builds(lambda: _image(route, s, **kw)) == want
    assert _builds(lambda: _image(route, s, **kw)) == 0


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_tensor_params_are_not_cached_and_keep_their_gradient(route):
    """Params with a tensor field (calibration's) cannot key a cache: each
    call builds its plan anew, without touching the caches, and the
    gradient of the image reaches the tensor."""
    s = _sample(1)
    sigma = torch.tensor(3.0, requires_grad=True)
    params = _params().replace(sigma_det=sigma)
    before = _caches()
    assert _builds(lambda: _image(route, s, params=params)) >= 1
    image = _image(route, s, params=params).image
    assert _caches() == before
    (image * torch.linspace(0.0, 1.0, image.shape[-1])).sum().backward()
    assert sigma.grad is not None and torch.isfinite(sigma.grad)
    assert float(sigma.grad) != 0.0
    # the same values as floats: the cached plan gives the same image
    floats = _image(route, s).image
    assert float((image.detach() - floats).abs().max()) <= 1e-5 * float(
        floats.abs().max())


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_plan_built_under_inference_mode_serves_autograd(route):
    """A plan first built inside ``torch.inference_mode`` holds ordinary
    tensors: a later call with a sample that requires a gradient (the
    fusion operators' VJP through ``_canvas_map`` on the closed form) is
    served by it and differentiates."""
    s = _sample(1)
    with torch.inference_mode():
        _image(route, s)
    x = s.clone().requires_grad_()
    hits = _caches()
    image = _image(route, x).image
    assert trescan._image_plan.cache_info().hits == hits[0].hits + 1
    image.sum().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())
    if route == "analytic":
        canvas = analytic._canvas_map(_params(), _geom(1.5), "cpu")
        assert analytic._canvas_constants.cache_info().hits >= 1
        y = s.clone().requires_grad_()
        canvas(y).sum().backward()
        assert y.grad is not None and bool(torch.isfinite(y.grad).all())


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_a_results_dose_is_its_own(route):
    """An in-place edit of one result's dose reaches neither the plan nor
    the next result."""
    s = _sample(1)
    first = _image(route, s)
    want = {k: v.clone() for k, v in vars(first.dose).items()}
    for v in vars(first.dose).values():
        v.add_(1.0)
    again = _image(route, s)
    for k, v in vars(again.dose).items():
        assert torch.equal(v, want[k]), k
        assert v.data_ptr() != getattr(first.dose, k).data_ptr()


def _class_inputs():
    """Raw arguments of K1's plan on the class route (R = 1.5: q = 2), as
    the entry makes them."""
    from rescan_line_sted_torch.imaging.line_sted import (
        effective_line_profile)
    from rescan_line_sted_torch.physics.psf import detection_profile

    params, geom = _params(), _geom(1.5)
    d_in, d_out, (p, q) = trescan._k1_windows(params, geom)
    assert q == 2
    w = SHAPE[1]
    pos = torch.arange(w)
    args = (params.brightness * effective_line_profile(w, params, "cpu"),
            detection_profile(w, params.sigma_det, "cpu"),
            torch.div(p * pos, q, rounding_mode="floor").to(torch.int32))
    kw = dict(wc=geom.canvas_shape[1], d_in=d_in, d_out=d_out,
              chunk=geom.chunk, classes=(pos % q).to(torch.int32), q=q)
    return args, kw


@pytest.mark.parametrize("shift", [2, -3])
def test_k1_without_a_plan_refuses_classes_out_of_range(shift):
    """``banded_plan`` without ``class_bounds`` reads the classes back
    once and refuses any outside ``[0, q)``; given the bounds (the entry,
    which makes the classes), it checks them on the host."""
    from torch.profiler import ProfilerActivity, profile

    args, kw = _class_inputs()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        banded_plan(*args, **kw)
    assert sum(e.name == "rls.read_back" for e in prof.events()) == 1
    bad = {**kw, "classes": kw["classes"] + shift}
    with pytest.raises(ValueError, match=r"classes must lie in \[0, 2\)"):
        banded_plan(*args, **bad)
    with pytest.raises(ValueError, match=r"classes must lie in \[0, 2\)"):
        banded_plan(*args, **{**kw, "class_bounds": (shift, shift + 1)})

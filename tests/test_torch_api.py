"""The port's public names against the JAX package's, and ``replace``.

Every name that an ``__init__`` file of the JAX package exports (its
``from ... import`` names and module-level assignments) resolves in the
same package of the port, as a class where the JAX name is a class and as
a callable where it is a function, except the names whose code is still
queued (``QUEUED``, ROADMAP.md queue 1). The port's frozen dataclasses
carry ``replace(**changes)`` as flax's ``struct.dataclass`` does.
"""

import ast
import dataclasses
import importlib
import inspect
import pathlib

import numpy as np
import pytest
import torch

import rescan_line_sted_torch as T
import rescan_line_sted_tpu as J
from rescan_line_sted_torch.convert import geometry_from_jax, params_from_jax
from rescan_line_sted_torch.algorithms.metrics import ResolutionReport
from rescan_line_sted_torch.imaging.point_sted import AcquisitionResult
from rescan_line_sted_torch.physics.dose import DoseReport
from rescan_line_sted_torch.sweeps.dose import (
    DoseMatchedComparison,
    ModalitySweep,
)

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGES = ("", "imaging", "physics", "kernels", "data", "algorithms",
            "sweeps", "utils", "io", "pipelines")
# names whose code is still queued (ROADMAP.md queue 1): none
QUEUED: dict[str, set[str]] = {}
# the port's own names for renamed functions
ALIASES = {"poisson_pallas": "poisson_flat"}


def _exported(pkg: str) -> list[str]:
    """The names the JAX ``__init__`` file of ``pkg`` binds."""
    path = ROOT / "rescan_line_sted_tpu" / pkg / "__init__.py"
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
    return names


def _module(root: str, pkg: str):
    return importlib.import_module(f"{root}.{pkg}" if pkg else root)


NAMES = [(pkg, name) for pkg in PACKAGES for name in _exported(pkg)
         if name not in QUEUED.get(pkg, ())]


@pytest.mark.parametrize("pkg,name", NAMES,
                         ids=[f"{p or 'top'}.{n}" for p, n in NAMES])
def test_jax_public_name_resolves(pkg, name):
    want = getattr(_module("rescan_line_sted_tpu", pkg), name)
    got = getattr(_module("rescan_line_sted_torch", pkg), name)
    assert inspect.isclass(got) == inspect.isclass(want)
    assert callable(got) == callable(want)
    if inspect.isfunction(want) or inspect.isclass(want):
        assert got.__name__ == ALIASES.get(name, want.__name__)


def _all_of(pkg: str) -> list[str]:
    return getattr(_module("rescan_line_sted_torch", pkg), "__all__", [])


@pytest.mark.parametrize("pkg", [p for p in PACKAGES if p])
def test_public_names_listed_in_all(pkg):
    """Each subpackage's ``__all__`` lists every JAX name it carries."""
    want = {n for n in _exported(pkg) if n not in QUEUED.get(pkg, ())}
    assert want <= set(_all_of(pkg))


@pytest.mark.parametrize("pkg,name", sorted(
    (p, n) for p, names in QUEUED.items() for n in names))
def test_queued_names_still_missing(pkg, name):
    """A queued name is a JAX name without port code yet; once ported it
    leaves ``QUEUED``."""
    assert name in _exported(pkg)
    assert not hasattr(_module("rescan_line_sted_torch", pkg), name)


def test_poisson_pallas_is_the_flat_sampler():
    from rescan_line_sted_torch.kernels import poisson_flat, poisson_pallas

    assert poisson_pallas is poisson_flat
    lam = torch.full((8, 8), 2.0)
    a = poisson_pallas(lam, torch.Generator().manual_seed(1))
    b = poisson_flat(lam, torch.Generator().manual_seed(1))
    assert torch.equal(a, b)


def _sweep():
    col = torch.zeros(2)
    return ModalitySweep(torch.zeros(2, 4, 4), col, col, col, col, col)


def _dose():
    one = torch.tensor(1.0)
    return DoseReport(one, 2 * one, 3 * one, 4 * one)


INSTANCES = {
    "Grid": (lambda: T.Grid(8, 16), dict(width=32)),
    "PointSTEDGeometry": (lambda: T.PointSTEDGeometry(T.Grid(8, 8)),
                          dict(chunk=16)),
    "LineSTEDGeometry": (lambda: T.LineSTEDGeometry(T.Grid(8, 8)),
                         dict(chunk=8)),
    "RescanGeometry": (lambda: T.RescanGeometry(T.Grid(8, 8)),
                       dict(rescan_factor=1.5)),
    "RescanPointGeometry": (lambda: T.RescanPointGeometry(T.Grid(8, 8)),
                            dict(binning=2)),
    "PointSTEDParams": (lambda: T.PointSTEDParams.create(),
                        dict(depletion=4.0)),
    "LineSTEDParams": (lambda: T.LineSTEDParams.create(),
                       dict(brightness=2.5, depletion=8.0)),
    "AcquisitionResult": (lambda: AcquisitionResult(torch.zeros(2, 2),
                                                    _dose()),
                          dict(image=torch.ones(2, 2))),
    "DoseReport": (_dose, dict(num_steps=torch.tensor(9.0))),
    "ResolutionReport": (lambda: ResolutionReport(torch.tensor(2.0),
                                                  torch.tensor(1.0)),
                         dict(fwhm_x=torch.tensor(3.0))),
    "ModalitySweep": (lambda: _sweep(), dict(exposure=torch.ones(2))),
    "DoseMatchedComparison": (
        lambda: DoseMatchedComparison(torch.zeros(2), torch.tensor(1.0),
                                      _sweep(), _sweep()),
        dict(rescan=_sweep())),
}


@pytest.mark.parametrize("cls", list(INSTANCES))
def test_replace_returns_a_new_frozen_instance(cls):
    make, changes = INSTANCES[cls]
    old = make()
    before = {f.name: getattr(old, f.name) for f in dataclasses.fields(old)}
    new = old.replace(**changes)
    assert type(new) is type(old) and new is not old
    for k, v in before.items():
        assert getattr(old, k) is v
        assert getattr(new, k) is changes.get(k, v)
    with pytest.raises(dataclasses.FrozenInstanceError):
        setattr(new, next(iter(changes)), None)
    with pytest.raises(TypeError):
        old.replace(no_such_field=1)


def test_replace_validates_as_the_constructor_does():
    geom = T.RescanGeometry(T.Grid(8, 8))
    with pytest.raises(ValueError, match="rescan_factor"):
        geom.replace(rescan_factor=0.5)
    with pytest.raises(ValueError, match="binning"):
        T.RescanPointGeometry(T.Grid(8, 8)).replace(binning=3)


@pytest.mark.parametrize("kind", ["point", "line"])
def test_replace_matches_flax(kind):
    """The sweep's use (``sweeps/dose.py:160-167``): replace the depletion,
    then scale the brightness; converted, the JAX params equal the
    port's."""
    jcls, tcls = ((J.PointSTEDParams, T.PointSTEDParams) if kind == "point"
                  else (J.LineSTEDParams, T.LineSTEDParams))
    jp = jcls.create(depletion=2.0).replace(depletion=6.0)
    jp = jp.replace(brightness=jp.brightness * 0.5)
    tp = tcls.create(depletion=2.0).replace(depletion=6.0)
    tp = tp.replace(brightness=tp.brightness * 0.5)
    assert params_from_jax(jp) == tp
    jg = J.RescanGeometry(J.Grid(16, 16))
    assert geometry_from_jax(dataclasses.replace(jg, binning=2)) == \
        T.RescanGeometry(T.Grid(16, 16)).replace(binning=2)


def test_replaced_result_feeds_the_engine():
    """An engine's result, its image replaced, keeps its dose (the JAX
    boundary helper's use, ``imaging/boundary.py:145``)."""
    params = T.LineSTEDParams.create(depletion=4.0)
    geom = T.LineSTEDGeometry(T.Grid(16, 16), chunk=8)
    sample = np.random.default_rng(0).random((16, 16), np.float32)
    res = T.line_sted_image(sample, params, geom, device="cpu")
    out = res.replace(image=res.image[2:-2, 2:-2])
    assert out.image.shape == (12, 12) and out.dose is res.dose

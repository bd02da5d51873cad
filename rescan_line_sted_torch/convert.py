"""Carry the JAX package's params and geometry across to the port.

Reads attributes with ``getattr`` and values with ``numpy.asarray``, and
dispatches on type names, so this module needs no ``import jax``: it
accepts anything shaped like the JAX package's ``LineSTEDParams`` /
``PointSTEDParams`` (with any shipped illumination model) and
``LineSTEDGeometry`` / ``PointSTEDGeometry`` / ``RescanGeometry`` /
``RescanPointGeometry``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from rescan_line_sted_torch.config import (
    Grid,
    LineSTEDGeometry,
    LineSTEDParams,
    PointSTEDGeometry,
    PointSTEDParams,
    RescanGeometry,
    RescanPointGeometry,
)
from rescan_line_sted_torch.physics import models

# per params class: (port class, its float fields, its static supports)
_PARAMS = {
    "LineSTEDParams": (
        LineSTEDParams,
        ("sigma_exc", "sigma_det", "stripe_period", "depletion",
         "slit_halfwidth", "brightness"),
        ("exc_support", "det_support", "slit_support_px")),
    "PointSTEDParams": (
        PointSTEDParams,
        ("sigma_exc", "sigma_det", "sigma_dep", "depletion",
         "pinhole_radius", "brightness"),
        ("exc_support", "det_support", "pin_support")),
}
# the shipped illumination models, by class name, with their fields
_MODELS = {cls.__name__: cls for cls in (
    models.GaussianStripeModel, models.GaussianDonutModel,
    models.PupilDonutModel, models.VectorialDonutModel,
    models.EnvelopedStripeModel, models.InterferenceStripeModel)}


def model_from_jax(m):
    """The port's model of the same class name and field values as the
    JAX model ``m`` (None stays None). Raises ``TypeError`` for a class
    the port does not ship: a user's JAX model returns JAX arrays and
    cannot be carried across."""
    if m is None:
        return None
    cls = _MODELS.get(type(m).__name__)
    if cls is None:
        raise TypeError(
            f"illumination model {type(m).__name__} is not one the port "
            f"ships ({', '.join(_MODELS)}); write it for torch and set it "
            "on the port's params")
    return cls(**{f.name: getattr(m, f.name)
                  for f in dataclasses.fields(cls)})


def params_from_jax(p):
    """The port's ``LineSTEDParams`` or ``PointSTEDParams`` holding the same
    f32 values, static supports and illumination model as the JAX params
    ``p``."""
    name = type(p).__name__
    if name not in _PARAMS:
        raise NotImplementedError(f"{name} is not ported yet")
    cls, fields, supports = _PARAMS[name]
    vals = {f: float(np.asarray(getattr(p, f), np.float32)) for f in fields}
    return cls(**vals, model=model_from_jax(getattr(p, "model", None)),
               **{f: getattr(p, f, None) for f in supports})


def geometry_from_jax(g):
    """The port's geometry equal to the JAX geometry ``g`` (line, point,
    rescanned line or rescanned point). Raises on any other geometry."""
    name = type(g).__name__
    grid = Grid(int(g.grid.height), int(g.grid.width))
    if name == "RescanGeometry" and not getattr(g, "model", None):
        return RescanGeometry(grid, rescan_factor=float(g.rescan_factor),
                              binning=int(g.binning), chunk=int(g.chunk))
    if name == "LineSTEDGeometry":
        return LineSTEDGeometry(grid, chunk=int(g.chunk))
    if name == "PointSTEDGeometry":
        return PointSTEDGeometry(grid, chunk=int(g.chunk))
    if name == "RescanPointGeometry":
        return RescanPointGeometry(grid, rescan_factor=float(g.rescan_factor),
                                   binning=int(g.binning), chunk=int(g.chunk))
    raise NotImplementedError(f"{name} is not ported yet")

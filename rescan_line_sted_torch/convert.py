"""Carry the JAX package's params and geometry across to the port.

Reads attributes with ``getattr`` and values with ``numpy.asarray``, and
dispatches on type names, so this module needs no ``import jax``: it
accepts anything shaped like the JAX package's ``LineSTEDParams`` /
``PointSTEDParams`` and ``LineSTEDGeometry`` / ``PointSTEDGeometry`` /
``RescanGeometry``.
"""

from __future__ import annotations

import numpy as np

from rescan_line_sted_torch.config import (
    Grid,
    LineSTEDGeometry,
    LineSTEDParams,
    PointSTEDGeometry,
    PointSTEDParams,
    RescanGeometry,
)

# per params class: (port class, its float fields, its static supports,
# the one illumination model the port has for it)
_PARAMS = {
    "LineSTEDParams": (
        LineSTEDParams,
        ("sigma_exc", "sigma_det", "stripe_period", "depletion",
         "slit_halfwidth", "brightness"),
        ("exc_support", "det_support", "slit_support_px"),
        "GaussianStripeModel"),
    "PointSTEDParams": (
        PointSTEDParams,
        ("sigma_exc", "sigma_det", "sigma_dep", "depletion",
         "pinhole_radius", "brightness"),
        ("exc_support", "det_support", "pin_support"),
        "GaussianDonutModel"),
}


def params_from_jax(p):
    """The port's ``LineSTEDParams`` or ``PointSTEDParams`` holding the same
    f32 values and static supports as the JAX params ``p``. Raises on a
    non-default model."""
    name = type(p).__name__
    if name not in _PARAMS:
        raise NotImplementedError(f"{name} is not ported yet")
    cls, fields, supports, default_model = _PARAMS[name]
    m = getattr(p, "model", None)
    if m is not None and type(m).__name__ != default_model:
        raise NotImplementedError(
            f"illumination model {type(m).__name__} is not ported yet "
            "(ROADMAP.md open item 11: physics/models.py)")
    vals = {f: float(np.asarray(getattr(p, f), np.float32)) for f in fields}
    return cls(**vals, **{f: getattr(p, f, None) for f in supports})


def geometry_from_jax(g):
    """The port's geometry equal to the JAX geometry ``g`` (line, point or
    rescanned line). Raises on geometries of unported modalities."""
    name = type(g).__name__
    grid = Grid(int(g.grid.height), int(g.grid.width))
    if name == "RescanGeometry" and not getattr(g, "model", None):
        return RescanGeometry(grid, rescan_factor=float(g.rescan_factor),
                              binning=int(g.binning), chunk=int(g.chunk))
    if name == "LineSTEDGeometry":
        return LineSTEDGeometry(grid, chunk=int(g.chunk))
    if name == "PointSTEDGeometry":
        return PointSTEDGeometry(grid, chunk=int(g.chunk))
    raise NotImplementedError(
        f"{name} is not ported yet (ROADMAP.md open item 11)")

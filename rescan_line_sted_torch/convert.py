"""Carry the JAX package's params and geometry across to the port.

Reads attributes with ``getattr`` and values with ``numpy.asarray``, so this
module needs no ``import jax``: it accepts anything shaped like the JAX
package's ``LineSTEDParams`` / ``RescanGeometry``.
"""

from __future__ import annotations

import numpy as np

from rescan_line_sted_torch.config import Grid, LineSTEDParams, RescanGeometry

_PARAM_FIELDS = ("sigma_exc", "sigma_det", "stripe_period", "depletion",
                 "slit_halfwidth", "brightness")
_SUPPORT_FIELDS = ("exc_support", "det_support", "slit_support_px")


def params_from_jax(p) -> LineSTEDParams:
    """The port's ``LineSTEDParams`` holding the same f32 values and static
    supports as the JAX params ``p``. Raises on a non-default model."""
    m = getattr(p, "model", None)
    if m is not None and type(m).__name__ != "GaussianStripeModel":
        raise NotImplementedError(
            f"illumination model {type(m).__name__} is not ported yet "
            "(ROADMAP.md open item 11: physics/models.py)")
    vals = {f: float(np.asarray(getattr(p, f), np.float32))
            for f in _PARAM_FIELDS}
    supports = {f: getattr(p, f, None) for f in _SUPPORT_FIELDS}
    return LineSTEDParams(**vals, **supports)


def geometry_from_jax(g) -> RescanGeometry:
    """The port's ``RescanGeometry`` equal to the JAX geometry ``g``.
    Raises on geometries of other modalities or with a model attached."""
    if type(g).__name__ != "RescanGeometry" or getattr(g, "model", None):
        raise NotImplementedError(
            f"{type(g).__name__} is not ported yet (ROADMAP.md open item 8)")
    return RescanGeometry(Grid(int(g.grid.height), int(g.grid.width)),
                          rescan_factor=float(g.rescan_factor),
                          binning=int(g.binning), chunk=int(g.chunk))

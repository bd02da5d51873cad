"""Configuration dataclasses (PyTorch port of ``rescan_line_sted_tpu.config``).

* **Geometry** (frozen dataclasses): grid size, scan chunking, rescan
  factor, detector binning -- the facts that fix tensor shapes.
* **Params** (frozen dataclasses of Python floats): PSF widths, depletion
  saturation ``s``, brightness, slit or pinhole size. Each value is rounded to float32
  on creation, as the JAX package stores them as f32 scalars, so both
  packages compute from the same numbers. The static ``*_support`` fields
  bound the PSF supports; the banded scan windows are built from them.
  ``replace`` also takes a 0-d float32 tensor for any float field (the
  calibration fit's differentiable parameters, ``algorithms/
  calibration.py``): the noise-free engines then compute with torch ops on
  it, so autograd sees it, and the supports keep the values ``create``
  gave them, as in the JAX package.

Every class has ``replace(**changes)``, as the JAX package's params carry
flax's.

The port computes in float32 throughout; ``rescan_line_sted_torch``
disables TF32 at import (a 10-bit mantissa would miss the 1e-5 parity bar).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


class Replaceable:
    """``replace(**changes)``: a new frozen instance with ``changes``
    applied (``dataclasses.replace``), as flax's ``struct.dataclass``
    gives the JAX package's params and results."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class Grid(Replaceable):
    """Simulation pixel grid. Convolutions are circular on this grid."""

    height: int
    width: int

    @property
    def shape(self) -> tuple[int, int]:
        return (self.height, self.width)


@dataclasses.dataclass(frozen=True)
class PointSTEDGeometry(Replaceable):
    """Static geometry of a 2D point-scanning STED acquisition: the scan
    visits every pixel, ``height * width`` positions, ``chunk`` at a time
    (``chunk`` must divide ``height * width``)."""

    grid: Grid
    chunk: int = 64

    @property
    def num_steps(self) -> int:
        return self.grid.height * self.grid.width


@dataclasses.dataclass(frozen=True)
class LineSTEDGeometry(Replaceable):
    """Static geometry of a descanned line-STED acquisition: the line runs
    along y and is scanned along x, ``width`` positions with one image
    column each (``chunk`` must divide ``width``)."""

    grid: Grid
    chunk: int = 32

    @property
    def num_steps(self) -> int:
        return self.grid.width


@dataclasses.dataclass(frozen=True)
class RescanGeometry(Replaceable):
    """Static geometry of a rescanned line-STED acquisition.

    The (re-binned) camera frame captured at scan position ``x0`` is
    accumulated into the canvas at rescan position ``R * x0``: camera
    column ``x`` lands at ``u = R*x0 + (x - x0)``, wrapped circularly on a
    canvas of width ``round(R*width)``.

    * ``rescan_factor`` -- R (>= 1).
    * ``binning`` -- detector re-binning factor b; must divide the grid.
    * ``chunk`` -- scan positions per conv-table tile; must divide width.
    """

    grid: Grid
    rescan_factor: float = 2.0
    binning: int = 1
    chunk: int = 32

    def __post_init__(self):
        if self.grid.height % self.binning or self.grid.width % self.binning:
            raise ValueError("binning must divide the grid shape")
        if self.rescan_factor < 1.0:
            raise ValueError("rescan_factor must be >= 1 (canvas must hold "
                             "a full camera frame)")

    @property
    def num_steps(self) -> int:
        return self.grid.width

    @property
    def canvas_shape(self) -> tuple[int, int]:
        h = self.grid.height // self.binning
        w = int(round(self.rescan_factor * self.grid.width)) // self.binning
        return (h, w)


@dataclasses.dataclass(frozen=True)
class RescanPointGeometry(Replaceable):
    """Static geometry of a rescanned point-STED acquisition (2D pixel
    reassignment, ISM).

    The scan visits every pixel; the (re-binned) camera frame captured at
    scan position ``p = (y0, x0)`` is accumulated into the canvas at
    ``R * p`` (camera pixel ``x`` lands at ``u = R*p + (x - p)``), wrapping
    circularly on the ``round(R*H)/b x round(R*W)/b`` canvas. ``chunk``
    scan positions (raster order) are processed per loop step and must
    divide ``height * width``.
    """

    grid: Grid
    rescan_factor: float = 2.0
    binning: int = 1
    chunk: int = 64

    def __post_init__(self):
        if self.grid.height % self.binning or self.grid.width % self.binning:
            raise ValueError("binning must divide the grid shape")
        if self.rescan_factor < 1.0:
            raise ValueError("rescan_factor must be >= 1 (canvas must hold "
                             "a full camera frame)")

    @property
    def num_steps(self) -> int:
        return self.grid.height * self.grid.width

    @property
    def canvas_shape(self) -> tuple[int, int]:
        h = int(round(self.rescan_factor * self.grid.height)) // self.binning
        w = int(round(self.rescan_factor * self.grid.width)) // self.binning
        return (h, w)


def _f(x) -> float:
    """A Python float holding the float32 value of ``x``."""
    return float(np.float32(x))


def cache_key_ok(params) -> bool:
    """Whether ``params`` may key a cache: no field is a tensor (a tensor
    hashes by identity and carries an autograd graph) and the params hash
    (a model field may not)."""
    if any(isinstance(getattr(params, f.name), torch.Tensor)
           for f in dataclasses.fields(params)):
        return False
    try:
        hash(params)
    except TypeError:
        return False
    return True


def _support(sigma, pad: int = 5) -> int:
    """Static support half-width (px) bounding a Gaussian of width
    ``sigma``: < 4e-10 of peak beyond ``6.5 sigma``."""
    return int(6.5 * float(sigma)) + pad


def _aperture_support(radius, pad: int = 2) -> int:
    """Static half-width (px) bounding a hard aperture (slit half-width)."""
    return int(float(radius)) + pad


@dataclasses.dataclass(frozen=True)
class PointSTEDParams(Replaceable):
    """Physics of a point-STED acquisition.

    * ``sigma_exc`` / ``sigma_det``  Gaussian excitation / detection PSF
                         widths (px).
    * ``sigma_dep``      donut scale: peak intensity ring at
                         ``r = sigma_dep * sqrt(2)``.
    * ``depletion``      saturation factor ``s``: surviving emission is
                         ``exp(-s * dep)``.
    * ``pinhole_radius`` descanned pinhole radius (px).
    * ``brightness``     expected detected photons scale per scan step.
    * ``model``          illumination model; ``None`` = Gaussian excitation
                         + ``u e^{1-u}`` donut (``physics/models.py``).
    * ``exc_support`` / ``det_support`` / ``pin_support``  half-widths (px)
                         bounding the excitation and detection PSFs and the
                         pinhole; ``create`` fills them.
    """

    sigma_exc: float
    sigma_det: float
    sigma_dep: float
    depletion: float
    pinhole_radius: float
    brightness: float
    model: object = None
    exc_support: int | None = None
    det_support: int | None = None
    pin_support: int | None = None

    @classmethod
    def create(cls, sigma_exc=3.0, sigma_det=3.0, sigma_dep=3.0,
               depletion=0.0, pinhole_radius=4.0, brightness=100.0,
               model=None):
        return cls(_f(sigma_exc), _f(sigma_det), _f(sigma_dep),
                   _f(depletion), _f(pinhole_radius), _f(brightness),
                   model=model,
                   exc_support=_support(sigma_exc),
                   det_support=_support(sigma_det),
                   pin_support=_aperture_support(pinhole_radius))


@dataclasses.dataclass(frozen=True)
class LineSTEDParams(Replaceable):
    """Physics of a (de/re)scanned line-STED acquisition.

    * ``sigma_exc``      Gaussian width of the excitation line profile (px).
    * ``sigma_det``      Gaussian detection PSF width (px).
    * ``stripe_period``  period of the ``sin^2(pi x / period)`` depletion
                         stripe pattern.
    * ``depletion``      saturation factor ``s``: surviving emission is
                         ``exp(-s * dep)``.
    * ``slit_halfwidth`` descanned slit half-width (px); unused by rescan.
    * ``brightness``     expected detected photons scale per scan step.
    * ``model``          illumination model; ``None`` = Gaussian line +
                         ``sin^2`` stripe (``physics/models.py``).
    * ``exc_support`` / ``det_support`` / ``slit_support_px``  half-widths
                         (px) bounding the excitation line, detection PSF
                         and slit; ``create`` fills them. A stale bound that
                         is too small truncates signal.
    """

    sigma_exc: float
    sigma_det: float
    stripe_period: float
    depletion: float
    slit_halfwidth: float
    brightness: float
    model: object = None
    exc_support: int | None = None
    det_support: int | None = None
    slit_support_px: int | None = None

    @classmethod
    def create(cls, sigma_exc=3.0, sigma_det=3.0, stripe_period=12.0,
               depletion=0.0, slit_halfwidth=4.0, brightness=100.0,
               model=None):
        return cls(_f(sigma_exc), _f(sigma_det), _f(stripe_period),
                   _f(depletion), _f(slit_halfwidth), _f(brightness),
                   model=model,
                   exc_support=_support(sigma_exc),
                   det_support=_support(sigma_det),
                   slit_support_px=_aperture_support(slit_halfwidth))


# The rescanned engine shares the line physics; alias for API clarity.
RescanParams = LineSTEDParams

"""Driver of BASELINE config 5's rescanned fusion, the path
``pipelines/figures.fusion_pipeline(modality="rescan")`` runs:
``algorithms.multi_orientation_rescan`` (the analytic method: the sample
rotated to each of the configuration's orientations, the closed form, one
K2c draw for every view), then ``algorithms.rescan_fusion`` (operator-form
Richardson-Lucy (RL) from its default start, whose adjoint is autograd's).

One call acquires the four canvases of the frozen sample and fuses them
into one image; its shot noise comes from a ``torch.Generator`` on the
card seeded from ``--seed`` and advanced call by call. It returns
``(canvases, fused)``. Compared after the window (``check``):

* ``canvas_err``: the noise-free call's canvases against the plain
  reference's float64 canvases, largest gap over the largest value, worst
  view;
* ``image_err``: the noise-free call's fused image against the
  reference's fusion of its own float64 canvases, largest gap over the
  largest value;
* ``kept_err``: each kept call's fused image against the reference's
  float64 fusion of that call's own noisy canvases (the timed path's
  outputs, exactly);
* ``total_z`` and ``dispersion_z`` on each kept call's canvases, worst
  view: a canvas's total, and the Poisson dispersion of its 4 x 4 tiles'
  sums (each canvas pixel is one draw), against the reference's mean.
"""

from __future__ import annotations

import math

import torch

from benchmark import compare, samples
from benchmark.drivers.dose_sweep import _worst
from rescan_line_sted_torch import Grid, LineSTEDParams, RescanGeometry
from rescan_line_sted_torch.algorithms import fusion
from rescan_line_sted_torch.algorithms.fusion import (
    LinearOperator,
    multi_orientation_rescan,
    rescan_fusion,
)
from rescan_line_sted_torch.utils import rotate_image

# the Poisson dispersion of 4 x 4 tiles' sums, as the analytic rescan cell
BLOCK = 4


def fuse(sample, params, geom, angles, num_iter, generator, method,
         accelerate, device):
    """The port's normal path: the views at ``angles`` (numbers) acquired,
    then fused; ``(canvases, fused)``."""
    canvases = multi_orientation_rescan(
        sample, params, geom, torch.tensor(angles, dtype=torch.float32),
        generator, method=method, device=device)
    return canvases, rescan_fusion(canvases, params, geom, angles, num_iter,
                                   accelerate=accelerate)


class Cell:
    def __init__(self, config: dict, workload: dict, seed: int, device):
        self.config = config
        self.device = torch.device(device)
        self.sample = samples.siemens_star(tuple(config["field"]),
                                           self.device)
        self.params = LineSTEDParams.create(depletion=config["depletion"],
                                            **config["line"])
        self.geom = RescanGeometry(Grid(*config["field"]), **config["rescan"])
        v = config["orientations"]
        self.angles = tuple(u * math.pi / v for u in range(v))
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.work = {"sweeps": 1}
        self.entry = fuse

    def _fuse(self, generator):
        return self.entry(self.sample, self.params, self.geom, self.angles,
                          num_iter=self.config["fusion_iters"],
                          generator=generator, method=self.config["method"],
                          accelerate=self.config["fusion_accelerate"],
                          device=self.device)

    def warm(self) -> None:
        """Every shape the window uses: two noisy calls."""
        for _ in range(2):
            self._fuse(self.generator)

    def call(self):
        return self._fuse(self.generator)

    def clean(self):
        return self._fuse(None)

    def check(self, kept, clean, reference) -> list[dict]:
        """One row for the noise-free call and one for each kept call."""
        ref = reference.Fusion(self.sample, self.config)
        mean = ref.canvases()
        rows = [{"canvas_err": _worst_view(clean[0], mean),
                 "image_err": compare.rel_err(clean[1], ref.restore(mean))}]
        for canvases, fused in kept:
            c = canvases.to(mean.device, torch.float64)
            row = {"kept_err": compare.rel_err(fused, ref.restore(c)),
                   "total_z": 0.0, "dispersion_z": 0.0}
            for view, m in zip(c, mean):
                row["total_z"] = _worst(row["total_z"],
                                        compare.total_z(view, m))
                row["dispersion_z"] = _worst(row["dispersion_z"],
                                             compare.dispersion_z(
                    compare.block_sums(view, BLOCK),
                    compare.block_sums(m, BLOCK)))
            rows.append(row)
        return rows

    def control(self, reference) -> list[dict]:
        """The noise-free comparison with the reference put in the
        program's place, one step below the configuration's precision
        (``plain.Precision("tf32")``): its canvases and its fusion of them
        (the noise numbers are left out: it draws nothing)."""
        ref = reference.Fusion(self.sample, self.config)
        low = reference.Fusion(self.sample, self.config, "tf32")
        mean, canvases = ref.canvases(), low.canvases()
        return [{"canvas_err": _worst_view(canvases, mean),
                 "image_err": compare.rel_err(low.restore(canvases),
                                              ref.restore(mean))}]


def _worst_view(got, want) -> float:
    if tuple(got.shape) != tuple(want.shape):
        return math.nan
    err = 0.0
    for g, w in zip(got, want):
        err = _worst(err, compare.rel_err(g, w))
    return err


def _half_batch(entry):
    """Every other view left out, each kept one standing for the next."""
    def call(sample, params, geom, angles, num_iter, **kw):
        canvases, _ = entry(sample, params, geom, angles[::2], 0, **kw)
        canvases = canvases[torch.arange(len(angles)) // 2]
        return canvases, rescan_fusion(canvases, params, geom, angles,
                                       num_iter, accelerate=kw["accelerate"])
    return call


def _alter(entry):
    """One value of the fused image altered where it is produced."""
    def call(*args, **kw):
        canvases, fused = entry(*args, **kw)
        out = fused.clone()
        out[out.shape[0] // 2, out.shape[1] // 3] += 0.01 * out.abs().max()
        return canvases, out
    return call


def _adjoint_rotated(entry):
    """The fusion's adjoint with its rotation replaced by a rotation by
    the opposite angle, the mistake ``algorithms/fusion.py``'s docstring
    warns of: the forward map is the port's, and each view's
    back-projection (the canvas map's transpose) is rotated by
    ``+angle`` instead of scattered back through the gather."""
    sound_views = fusion._views_operator

    def views(canvas, geom, angles, device):
        forward = sound_views(canvas, geom, angles, device)[0]
        back = LinearOperator(canvas, (len(angles), *geom.grid.shape))[1]
        turn = torch.tensor(angles, dtype=torch.float32)
        return forward, lambda y: rotate_image(back(y), turn).sum(0)

    def call(*args, **kw):
        fusion._views_operator = views
        try:
            return entry(*args, **kw)
        finally:
            fusion._views_operator = sound_views
    return call


# Faults planted under the timed path (``Cell.entry``), each of which the
# comparison has to catch: the fused image left at its start; every other
# view left out, each kept one standing for the next; one value of the
# fused image altered; the draws left out (the means returned); one RL
# iteration left out; the adjoint's rotation by the opposite angle.
FAULTS = {
    "unchanged": lambda entry: (
        lambda *a, num_iter, **kw: entry(*a, num_iter=0, **kw)),
    "half_batch": _half_batch,
    "altered": _alter,
    "no_draws": lambda entry: (
        lambda *a, generator=None, **kw: entry(*a, generator=None, **kw)),
    "rl_short": lambda entry: (
        lambda *a, num_iter, **kw: entry(*a, num_iter=num_iter - 1, **kw)),
    "adjoint_rotated": _adjoint_rotated,
}

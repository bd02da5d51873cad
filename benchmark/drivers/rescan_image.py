"""Driver of the rescanned line-STED entry, ``rescanned_line_sted_image``.

One call is one image of the configuration's field with the traffic's
method, noise mode and rescan factor, its shot noise drawn from a
``torch.Generator`` on the card seeded from ``--seed`` and advanced call by
call. Compared after the window (``check``):

* ``mean_err``: the same entry and kernels at the timed sizes, noise-free
  (no generator), against the plain reference's float64 canvas: largest
  gap over the reference's largest value. It covers the convolution, the
  placement (class residues or NUFFT spreading and its deconvolution)
  and the routing's band windows, or the closed form's products.
* ``total_z``, ``dispersion_z`` and ``tile_z`` on each canvas the window
  kept: its total; the Poisson dispersion of its row sums (per-step draws:
  each row sum is a sum of the per-frame counts of that row, whatever the
  placement) or of its 4 x 4 tiles' sums (collapsed draws: each pixel is
  one draw); and the dispersion of its 8 x 16 tiles' sums, which sees
  counts moved along a row (a band-limited placement spreads a count over
  a few columns, so a tile of 16 keeps nearly all of it), each against
  the reference's mean.
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark import compare, samples
from rescan_line_sted_torch import (
    Grid,
    LineSTEDParams,
    RescanGeometry,
    rescanned_line_sted_image,
)

# collapsed draws: the dispersion of 4 x 4 tiles' sums, so that the dim
# canvas's tiles hold a few counts each
BLOCK = 4
# every canvas: 8 x 16 tiles, of the shapes tried the one that reads
# counts moved a column or two along the rows highest (PERF.md)
TILE = (8, 16)
PARAMS = ("sigma_exc", "sigma_det", "stripe_period", "depletion",
          "slit_halfwidth", "brightness")


class Cell:
    def __init__(self, config: dict, workload: dict, seed: int, device):
        self.config, self.traffic = config, workload["traffic"]
        self.device = torch.device(device)
        self.sample = samples.siemens_star(tuple(config["field"]),
                                           self.device)
        self.params = LineSTEDParams.create(**{k: config[k] for k in PARAMS})
        self.geom = RescanGeometry(
            Grid(*config["field"]),
            rescan_factor=float(self.traffic["rescan_factor"]),
            binning=config["binning"], chunk=config["chunk"])
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.work = {"steps": self.geom.num_steps}
        self.entry = rescanned_line_sted_image

    def _image(self, generator):
        return self.entry(
            self.sample, self.params, self.geom, generator=generator,
            method=self.traffic["method"],
            noise_mode=self.traffic["noise_mode"],
            reassignment=self.traffic["reassignment"],
            boundary=self.config["boundary"], device=self.device).image

    def warm(self) -> None:
        """Every shape the window uses: two noisy calls."""
        for _ in range(2):
            self._image(self.generator)

    def call(self):
        return self._image(self.generator)

    def clean(self):
        return self._image(None)

    def check(self, kept, clean, reference) -> list[dict]:
        """One row of compared numbers for the noise-free call and one for
        each kept canvas."""
        mean = reference.canvas_mean(self.sample, self.config, self.traffic)
        rows = [{"mean_err": compare.rel_err(clean, mean)}]
        per_step = self.traffic["noise_mode"] == "per_step"
        for canvas in kept:
            c = canvas.to(mean.device, torch.float64)
            if per_step:
                disp = compare.dispersion_z(c.sum(-1), mean.sum(-1))
            else:
                disp = compare.dispersion_z(compare.block_sums(c, BLOCK),
                                            compare.block_sums(mean, BLOCK))
            rows.append({"total_z": compare.total_z(c, mean),
                         "dispersion_z": disp,
                         "tile_z": compare.dispersion_z(
                             compare.block_sums(c, TILE),
                             compare.block_sums(mean, TILE))})
        return rows

    def control(self, reference) -> list[dict]:
        """The noise-free comparison with the reference put in the
        program's place, one step below the configuration's precision
        (``plain.Precision("tf32")``)."""
        return self.check([], reference.canvas_mean(
            self.sample, self.config, self.traffic, precision="tf32"),
            reference)


def _image_map(fn):
    """An entry whose image ``fn`` rewrites where it is produced."""
    def broken(entry):
        def call(*args, **kw):
            res = entry(*args, **kw)
            return dataclasses.replace(res, image=fn(res.image))
        return call
    return broken


def _halve(sample):
    """Every other column left out, the rest doubled (the mean over them)."""
    out = sample.clone()
    out[:, 1::2] = 0.0
    out[:, ::2] *= 2.0
    return out


def _moved(entry):
    """An entry whose noisy canvases have every row's counts moved two
    columns along x (a placement off by two in the draws' branch alone);
    its noise-free canvas is untouched."""
    def call(*args, generator=None, **kw):
        res = entry(*args, generator=generator, **kw)
        if generator is None:
            return res
        return dataclasses.replace(res, image=torch.roll(res.image, 2, -1))
    return call


def _alter(image):
    out = image.clone()
    out[out.shape[0] // 2, out.shape[1] // 3] += 0.01 * out.abs().max()
    return out


# Faults planted under the timed path (``Cell.entry``), each of which the
# comparison has to catch: the canvas left as it started; half of the
# scan's input left out and the mean taken over the rest; one canvas value
# altered where it is produced; the draws left out (the mean returned);
# the noisy canvases' counts moved along their rows.
FAULTS = {
    "unchanged": _image_map(torch.zeros_like),
    "half_batch": lambda entry: (
        lambda sample, *a, **kw: entry(_halve(sample), *a, **kw)),
    "altered": _image_map(_alter),
    "no_draws": lambda entry: (
        lambda *a, generator=None, **kw: entry(*a, generator=None, **kw)),
    "moved": _moved,
}

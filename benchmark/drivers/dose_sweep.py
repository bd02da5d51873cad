"""Driver of the dose-matched comparison, ``sweeps.dose_matched_sweep``.

One call is one sweep of the configuration's depletion powers through
its arms (point and line, unfused), its shot noise from a
``torch.Generator`` on the card seeded from ``--seed`` and advanced call
by call. Compared after the window (``check``):

* ``image_err``: the same sweep noise-free (no generator) against the
  plain reference's float64 mean images, largest gap over the image's
  largest value, worst power and arm;
* ``ledger_err``: each kept sweep's exposure, emitted signal and scan
  steps against the reference's, worst relative gap;
* ``fwhm_err``: each kept sweep's FWHM columns, worst gap in pixels;
* ``total_z`` and ``dispersion_z``: each kept sweep's noisy images, their
  totals and the Poisson dispersion of their 8 x 8 tiles' sums against
  the reference's means, worst image.
"""

from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import compare, samples
from rescan_line_sted_torch import (
    Grid,
    LineSTEDGeometry,
    LineSTEDParams,
    PointSTEDGeometry,
    PointSTEDParams,
)
from rescan_line_sted_torch.sweeps import dose_matched_sweep

ARMS = ("point", "line")
LEDGER = ("exposure", "emitted_signal", "num_steps")
# the dispersion of 8 x 8 tiles' sums: at the highest powers the point
# arm's pixels hold ~0.04 counts each
BLOCK = 8


def powers(config: dict) -> list[float]:
    """The sweep's depletion powers as float32 values (the type the
    configuration states), handed alike to the program and reference."""
    p = config["depletion_powers"]
    return np.linspace(p["start"], p["stop"], p["num"]).astype(
        np.float32).tolist()


class Cell:
    def __init__(self, config: dict, workload: dict, seed: int, device):
        self.config = config
        self.device = torch.device(device)
        grid = Grid(*config["field"])
        self.sample = samples.siemens_star(tuple(config["field"]),
                                           self.device)
        self.args = dict(
            point_base=PointSTEDParams.create(**config["point"]),
            line_base=LineSTEDParams.create(**config["line"]),
            point_geom=PointSTEDGeometry(grid),
            line_geom=LineSTEDGeometry(grid),
            depletion_powers=powers(config),
            dose_budget=config["dose_budget"])
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.work = {"sweeps": 1}
        self.entry = dose_matched_sweep

    def _sweep(self, generator):
        return self.entry(self.sample, **self.args, generator=generator,
                          device=self.device)

    def warm(self) -> None:
        for _ in range(2):
            self._sweep(self.generator)

    def call(self):
        return self._sweep(self.generator)

    def clean(self):
        return self._sweep(None)

    def check(self, kept, clean, reference) -> list[dict]:
        ref = reference.sweep(self.sample, self.config, powers(self.config))
        image_err = 0.0
        for arm in ARMS:
            for img, mean in zip(getattr(clean, arm).image, ref[arm]["image"]):
                image_err = _worst(image_err, compare.rel_err(img, mean))
        rows = [{"image_err": image_err}]
        for out in kept:
            row = {"ledger_err": 0.0, "fwhm_err": 0.0, "total_z": 0.0,
                   "dispersion_z": 0.0}
            for arm in ARMS:
                got, want = getattr(out, arm), ref[arm]
                for col in LEDGER:
                    row["ledger_err"] = _worst(row["ledger_err"], compare.rel_err(
                        getattr(got, col), want[col]))
                for col in ("fwhm_x", "fwhm_y"):
                    gap = (getattr(got, col).to(want[col]) - want[col]).abs()
                    row["fwhm_err"] = _worst(row["fwhm_err"], float(gap.max()))
                for img, mean in zip(got.image, want["image"]):
                    row["total_z"] = _worst(row["total_z"],
                                            compare.total_z(img, mean))
                    row["dispersion_z"] = _worst(
                        row["dispersion_z"], compare.dispersion_z(
                            compare.block_sums(img, BLOCK),
                            compare.block_sums(mean, BLOCK)))
            rows.append(row)
        return rows


    def control(self, reference) -> list[dict]:
        """The comparison with the reference put in the program's place,
        one step below the configuration's precision
        (``plain.Precision("tf32")``): its mean images as the noise-free
        sweep, and its ledgers and FWHMs as a kept one (their noise
        numbers are left out: it draws nothing)."""
        ref = reference.sweep(self.sample, self.config, powers(self.config),
                              precision="tf32")
        out = SimpleNamespace(**{arm: SimpleNamespace(**ref[arm])
                                 for arm in ARMS})
        rows = self.check([out], out, reference)
        return [{k: v for k, v in row.items() if not k.endswith("_z")}
                for row in rows]


def _arms_map(fn):
    """An entry whose arms ``fn`` rewrites where they are produced."""
    def broken(entry):
        def call(*args, **kw):
            res = entry(*args, **kw)
            return dataclasses.replace(
                res, **{arm: fn(getattr(res, arm)) for arm in ARMS})
        return call
    return broken


def _half_batch(entry):
    """Every other power left out, each kept one standing for the next."""
    def call(*args, depletion_powers, **kw):
        res = entry(*args, depletion_powers=depletion_powers[::2], **kw)
        idx = torch.arange(len(depletion_powers)) // 2

        def spread(arm):
            return dataclasses.replace(arm, **{
                f.name: getattr(arm, f.name)[idx.to(getattr(arm, f.name).device)]
                for f in dataclasses.fields(arm)
                if getattr(arm, f.name) is not None})
        return dataclasses.replace(res, **{a: spread(getattr(res, a))
                                           for a in ARMS})
    return call


def _alter(arm):
    exposure = arm.exposure.clone()
    exposure[0] *= 1.001
    return dataclasses.replace(arm, exposure=exposure)


# Faults planted under the timed path (``Cell.entry``), each of which the
# comparison has to catch: the images left as they started; half of the
# powers left out, each kept one standing for the next; one exposure
# altered where it is produced; the draws left out (the means returned).
FAULTS = {
    "unchanged": _arms_map(
        lambda arm: dataclasses.replace(arm, image=torch.zeros_like(arm.image))),
    "half_batch": _half_batch,
    "altered": _arms_map(_alter),
    "no_draws": lambda entry: (
        lambda *a, generator=None, **kw: entry(*a, generator=None, **kw)),
}


def _worst(a: float, b: float) -> float:
    """The larger of two magnitudes; NaN wins."""
    return math.nan if math.isnan(a) or math.isnan(b) else max(a, b)

"""Driver of the report's four-arm fused dose-matched sweep,
``sweeps.dose_matched_sweep`` with the arguments
``pipelines/report.html_report`` passes it.

One call is one sweep of the configuration's depletion powers through the
point, line, rescan and ISM arms, the line and rescan arms acquired at the
configuration's orientations and fused by Richardson-Lucy (RL), the point
arm RL-restored, the ISM canvas deconvolved, and each arm's FRC taken
from a second independent acquisition; its shot noise from a
``torch.Generator`` on the card seeded from ``--seed`` and advanced call
by call. Compared after the window (``check``):

* ``image_err``: the same sweep noise-free (no generator, no FRC) against
  the plain reference's float64 restored means, largest gap over the
  image's largest value, worst arm and power;
* ``ledger_err``: each sweep's exposure, emitted signal and scan
  steps against the reference's, worst relative gap;
* ``fwhm_err``: each sweep's FWHM columns (the RL-restored point
  responses', ISM's divided by R), worst gap in pixels;
* ``total_z``: each sweep's fused images, their totals against the
  reference's restored means in standard deviations of a Poisson total
  (RL keeps the data's total), worst image;
* ``frc_gap``: the sweeps' FRC columns against the reference's FRC
  of ``REF_PAIRS`` pairs of its own Poisson draws of its means per arm
  and power, restored alike. One pair's resolution scatters by up to 50%
  at low counts, so each arm is compared as a two-sample test on log
  resolution (a curve that never falls below 1/7 read as Nyquist): the
  gap of the two sets' means, averaged over the powers, in standard
  errors of that average (each power's spread pooled over both sets);
  worst arm. A resolution scaled by R (ISM's division left out) reads
  ~30, a sound sweep under ~3;
* ``frc_err``: the program's FRC and the reference's, both applied to the
  same pairs of sweeps' images (two independent acquisitions of one
  field at one power): how far, in pixels, the program's resolution lies
  outside the span of the reference's, computed in float64 and in the
  configuration's float32, each at the thresholds ``1/7`` and ``1/7 +-
  FRC_TAU``; worst over arms and powers. A resolution is a first
  crossing, so where the curve meets 1/7 at a shallow angle or grazes it
  a small error in the curve moves it far: the span holds any curve error
  up to ``FRC_TAU`` at the crossing's rings, and float32's own, which
  near Nyquist, where a restored image keeps ~1e-7 of its power, reaches
  0.03. The program's FRC is the one the timed path computes with
  (``entry.frc`` where a fault replaced it).

The window keeps the workload's ``keep`` sweeps; the check acquires more
through the same path, to ``SWEEPS``.

No Poisson dispersion test is applied: RL correlates neighbouring pixels.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import compare, samples
from benchmark.drivers.dose_sweep import _worst, powers
from rescan_line_sted_torch import (
    Grid,
    LineSTEDGeometry,
    LineSTEDParams,
    PointSTEDGeometry,
    PointSTEDParams,
    RescanGeometry,
)
from rescan_line_sted_torch.algorithms.frc import frc_resolution
from rescan_line_sted_torch.config import RescanPointGeometry
from rescan_line_sted_torch.sweeps import dose, dose_matched_sweep

ARMS = ("point", "line", "rescan", "ism")
LEDGER = ("exposure", "emitted_signal", "num_steps")
NYQUIST = 2.0    # px: FRC's reading where its curve starts below 1/7
RINGS = 64       # FRC's rings, the port's and the reference's default
# the curve error frc_err leaves to the crossing's conditioning: 1000x
# the float32 ring sums' (~1e-6), 10x the TF32 control's (~1e-4)
FRC_TAU = 1e-3
# frc_gap's two sets: six of the program's sweeps (the kept ones and more
# through the same path) and eight of the reference's pairs per arm and
# power; on an H100 a sound sweep's worst arm reads under 3 standard
# errors and ISM's resolution scaled by R above 33 (three and four: under
# 2.5 and above 26; PERF.md section 2)
SWEEPS = 6
REF_PAIRS = 8
SE_FLOOR = 1e-3  # log units: the error of sets that read alike throughout


class Cell:
    def __init__(self, config: dict, workload: dict, seed: int, device):
        self.config = config
        self.device = torch.device(device)
        self.seed = seed
        grid = Grid(*config["field"])
        self.sample = samples.siemens_star(tuple(config["field"]),
                                           self.device)
        self.args = dict(
            point_base=PointSTEDParams.create(**config["point"]),
            line_base=LineSTEDParams.create(**config["line"]),
            point_geom=PointSTEDGeometry(grid),
            line_geom=LineSTEDGeometry(grid),
            depletion_powers=powers(config),
            dose_budget=config["dose_budget"],
            orientations=config["orientations"],
            rescan_geom=RescanGeometry(grid, **config["rescan"]),
            ism_geom=RescanPointGeometry(grid, **config["ism"]),
            fuse_orientations=config["fuse_orientations"],
            fusion_iters=config["fusion_iters"],
            fusion_accelerate=config["fusion_accelerate"])
        self.frc = config["frc"]
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.work = {"sweeps": 1}
        self.entry = dose_matched_sweep

    def _sweep(self, generator, frc):
        return self.entry(self.sample, **self.args, generator=generator,
                          frc=frc, device=self.device)

    def warm(self) -> None:
        for _ in range(2):
            self.call()

    def call(self):
        return self._sweep(self.generator, self.frc)

    def clean(self):
        return self._sweep(None, False)

    def _reference(self, reference, **kw):
        return reference.sweep(self.sample, self.config, powers(self.config),
                               **kw)

    def check(self, kept, clean, reference) -> list[dict]:
        # the reference's own draws, from a generator seeded from the seed
        draws = torch.Generator(self.device).manual_seed(self.seed)
        ref = self._reference(reference, generator=draws, pairs=REF_PAIRS)
        sweeps = kept + [self.call() for _ in range(SWEEPS - len(kept))]
        rows = [{"image_err": _image_err(clean, ref)}]
        for out in sweeps:
            row = _noise_free_numbers(out, ref)
            row["total_z"] = 0.0
            for arm in ARMS:
                for img, mean in zip(getattr(out, arm).image,
                                     ref[arm]["image"]):
                    row["total_z"] = _worst(row["total_z"],
                                            compare.total_z(img, mean))
            rows.append(row)
        gap = 0.0
        for arm in ARMS:
            got = torch.stack([getattr(out, arm).frc_resolution.cpu()
                               for out in sweeps]).double().numpy()
            want = ref[arm]["frc_resolution"].T.cpu().numpy()
            gap = _worst(gap, _log_gap_z(got, want,
                                         NYQUIST / _scale(self.config, arm)))
        rows.append({"frc_gap": gap})
        frc = getattr(self.entry, "frc", frc_resolution)
        for a, b in zip(sweeps, sweeps[1:]):
            err = 0.0
            for arm in ARMS:
                for x, y in zip(getattr(a, arm).image, getattr(b, arm).image):
                    err = _worst(err, _outside_px(
                        float(frc(x, y)), x, y, reference,
                        self.config["precision"]))
            rows.append({"frc_err": err})
        return rows

    def control(self, reference) -> list[dict]:
        """The comparison with the reference put in the program's place,
        one step below the configuration's precision
        (``plain.Precision("tf32")``): its restored means as the
        noise-free sweep, its ledgers and FWHMs as a kept one, and its FRC
        on the reference's first pair of draws per arm and power (the
        noise numbers are left out: it draws nothing)."""
        control = self._reference(reference, precision="tf32")
        out = SimpleNamespace(**{arm: SimpleNamespace(**control[arm])
                                 for arm in ARMS})
        draws = torch.Generator(self.device).manual_seed(self.seed)
        ref = self._reference(reference, generator=draws)
        err = 0.0
        for arm in ARMS:
            for x, y in ref[arm]["frc_pairs"]:
                err = _worst(err, _outside_px(reference.frc_resolution(
                    x, y, precision="tf32"), x, y, reference,
                    self.config["precision"]))
        return [{"image_err": _image_err(out, ref)},
                _noise_free_numbers(out, ref), {"frc_err": err}]


def _image_err(sweep, ref) -> float:
    err = 0.0
    for arm in ARMS:
        for img, mean in zip(getattr(sweep, arm).image, ref[arm]["image"]):
            err = _worst(err, compare.rel_err(img, mean))
    return err


def _noise_free_numbers(out, ref) -> dict:
    """A sweep's ledgers (worst relative gap) and FWHMs (worst gap in
    pixels) against the reference's."""
    row = {"ledger_err": 0.0, "fwhm_err": 0.0}
    for arm in ARMS:
        got, want = getattr(out, arm), ref[arm]
        for col in LEDGER:
            row["ledger_err"] = _worst(row["ledger_err"], compare.rel_err(
                getattr(got, col), want[col]))
        for col in ("fwhm_x", "fwhm_y"):
            gap = (getattr(got, col).to(want[col]) - want[col]).abs()
            row["fwhm_err"] = _worst(row["fwhm_err"], float(gap.max()))
    return row


def _scale(config: dict, arm: str) -> float:
    """How many image pixels make one sample pixel in the arm's FRC
    column (ISM's canvas is magnified by R)."""
    return float(config["ism"]["rescan_factor"]) if arm == "ism" else 1.0


def _nan_as(res: float, nyquist: float) -> float:
    return nyquist if math.isnan(res) else res


def _outside_px(got: float, x, y, reference, precision: str) -> float:
    """How far ``got`` lies outside the span of the reference's FRC
    resolutions of ``x`` and ``y``, in float64 and in ``precision``, at 1/7
    and 1/7 +- ``FRC_TAU`` (px; NaN read as Nyquist)."""
    span = []
    for prec in ("float64", precision):
        freqs, curve = reference.frc_curve(x, y, precision=prec)
        span += [_nan_as(reference.resolution_of(
            freqs, curve, reference.THRESHOLD + d), NYQUIST)
            for d in (-FRC_TAU, 0.0, FRC_TAU)]
    res = _nan_as(got, NYQUIST)
    return max(0.0, min(span) - res, res - max(span))


def _log_gap_z(got: np.ndarray, want: np.ndarray, nyquist: float) -> float:
    """Two sets of one arm's FRC resolutions, ``got`` [K, B] and ``want``
    [J, B] over its B powers: the gap of their mean log resolutions (NaN
    read as Nyquist), averaged over the powers, in standard errors of that
    average, each power's variance pooled over both sets."""
    x = np.log(np.where(np.isnan(got), nyquist, got))
    y = np.log(np.where(np.isnan(want), nyquist, want))
    k, j = len(x), len(y)
    gap = x.mean(0) - y.mean(0)
    var = (((x - x.mean(0)) ** 2).sum(0)
           + ((y - y.mean(0)) ** 2).sum(0)) / (k + j - 2)
    se = math.sqrt(float((var * (1.0 / k + 1.0 / j)).sum())) / gap.size
    return abs(float(gap.mean())) / max(se, SE_FLOOR)


def _arms_map(fn):
    """An entry whose arms ``fn`` rewrites where they are produced
    (``fn(arm_name, arm)``)."""
    def broken(entry):
        def call(*args, **kw):
            res = entry(*args, **kw)
            return dataclasses.replace(
                res, **{a: fn(a, getattr(res, a)) for a in ARMS})
        return call
    return broken


def _half_batch(entry):
    """Every other power left out, each kept one standing for the next."""
    def call(*args, depletion_powers, **kw):
        res = entry(*args, depletion_powers=depletion_powers[::2], **kw)
        idx = torch.arange(len(depletion_powers)) // 2

        def spread(arm):
            cols = {f.name: getattr(arm, f.name)
                    for f in dataclasses.fields(arm)}
            return dataclasses.replace(arm, **{
                k: v[idx.to(v.device)] for k, v in cols.items()
                if v is not None})
        return dataclasses.replace(res, **{a: spread(getattr(res, a))
                                           for a in ARMS})
    return call


def _alter(_, arm):
    exposure = arm.exposure.clone()
    exposure[0] *= 1.001
    return dataclasses.replace(arm, exposure=exposure)


def _self_frc(entry, generator_kept: bool):
    """An entry that acquires each arm once and reports the FRC of that
    acquisition against itself; the draws kept or left out."""
    def call(*args, generator=None, frc=False, ism_geom, **kw):
        res = entry(*args, generator=generator if generator_kept else None,
                    frc=False, ism_geom=ism_geom, **kw)
        if not frc:
            return res

        def self_frc(name, arm):
            scale = ism_geom.rescan_factor if name == "ism" else 1.0
            col = torch.stack([frc_resolution(img, img)
                               for img in arm.image]) / scale
            return dataclasses.replace(arm, frc_resolution=col)
        return dataclasses.replace(res, **{a: self_frc(a, getattr(res, a))
                                           for a in ARMS})
    return call


def _frc_unscaled(entry):
    """ISM's FRC column left in canvas pixels (not divided by R)."""
    def call(*args, ism_geom, **kw):
        res = entry(*args, ism_geom=ism_geom, **kw)
        col = res.ism.frc_resolution
        if col is None:
            return res
        return dataclasses.replace(res, ism=dataclasses.replace(
            res.ism, frc_resolution=col * ism_geom.rescan_factor))
    return call


def _frc_rings(entry):
    """FRC taken at one ring fewer than the criterion's 64, in the sweep
    (the name ``sweeps/dose.py`` calls) and as ``call.frc``, the FRC the
    check applies to its pairs."""
    broken = functools.partial(frc_resolution, num_rings=RINGS - 1)

    def call(*args, **kw):
        sound, dose.frc_resolution = dose.frc_resolution, broken
        try:
            return entry(*args, **kw)
        finally:
            dose.frc_resolution = sound
    call.frc = broken
    return call


# Faults planted under the timed path (``Cell.entry``), each of which the
# comparison has to catch: the images left as they started; half of the
# powers left out, each kept one standing for the next; one exposure
# altered where it is produced; the draws left out (the means returned,
# each FRC taken of a mean against itself); one of the RL iterations left
# out; the FRC taken of the first acquisition against itself; ISM's FRC
# not divided by R; the FRC at 63 rings.
FAULTS = {
    "unchanged": _arms_map(lambda _, arm: dataclasses.replace(
        arm, image=torch.zeros_like(arm.image))),
    "half_batch": _half_batch,
    "altered": _arms_map(_alter),
    "no_draws": lambda entry: _self_frc(entry, generator_kept=False),
    "rl_short": lambda entry: (
        lambda *a, fusion_iters, **kw: entry(
            *a, fusion_iters=fusion_iters - 1, **kw)),
    "frc_one_draw": lambda entry: _self_frc(entry, generator_kept=True),
    "frc_unscaled": _frc_unscaled,
    "frc_rings": _frc_rings,
}

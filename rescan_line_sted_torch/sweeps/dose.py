"""Dose-matched point-vs-line STED comparison sweep (port of the JAX
package's ``sweeps/dose.py``; BASELINE config 4), with its fusion
protocol (``fuse_orientations=True``).

The sweep runs each depletion power ``s`` through every arm while holding
the total per-pixel photodose (excitation + depletion, the photodamage
proxy) at a fixed budget, and reports resolution, emitted signal and scan
steps. For each power and modality the exposure (dwell-time scale) is
``budget / (exc_dose + dep_dose(s))``; the line arms' exposure is further
divided by the number of orientations, so the summed line dose meets the
same budget.

**Batching.** The JAX package vmaps one sweep point over the powers, its
params traced. The port's params hold Python floats and its engines
launch kernels, so it loops over the powers and stacks each column into a
``[B]`` tensor (images ``[B, H, W]``). The loop reads nothing back from
the card: each point's work is queued behind the last.

**Where the exposure comes from.** ``replace(brightness=...)`` needs a
Python float. It comes from the dose ledgers ``point_sted_dose`` /
``line_sted_dose`` computed on the CPU (``device="cpu"``, the models'
profiles built once per sweep: they do not depend on the depletion
power), in float32 as the JAX package computes it, so no point reads the
card. The host columns (exposure, scan steps, the emitted signal's
factor) reach the card once, as one table each. The FWHMs are measured
after the loop, one batched call per arm and axis on the centre columns
and rows of the system kernels (or, fused, of the RL-restored point
responses).

**Generators.** ``jax.random.split(key, 4)``, ``split(k, B)`` and
``fold_in(k, 1)`` become one draw from the caller's generator: a table
of seeds ``[4 arms (point, line, rescan, ism), B points, 2 draws]``
(``torch.randint`` on the generator's device), and one generator on that
device for each entry, seeded from it. Draw 0 is the arm's image; draw 1
is its second, independent acquisition for FRC. The table is drawn whole
whatever arms and options run, so a given generator state gives the same
sweep, bit for bit on one device, and an arm's images do not depend on
which other arms or ``frc`` ran. A CPU generator's table is read on the
host for free; a CUDA generator's table is read back once per sweep (one
sync, before any point runs), never once per point.

Every noisy arm draws through ``physics.noise.maybe_poisson`` (the point,
line and rescan engines' analytic method, ISM's canvas, and fused, the
line and rescan views, all views of an arm in one call): on the card
that is the flat sampler kernel K2c, with no fallback. The fused
protocol's RL loops (``algorithms/richardson_lucy.py`` and
``algorithms/fusion.py``) read nothing back either.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from rescan_line_sted_torch.algorithms.frc import (
    frc_resolution,
    frc_sectored_resolution,
)
from rescan_line_sted_torch.algorithms.fusion import (
    ism_deconvolve,
    multi_orientation_rescan,
    rescan_fusion,
)
from rescan_line_sted_torch.algorithms.metrics import fwhm_1d
from rescan_line_sted_torch.algorithms.richardson_lucy import (
    richardson_lucy_views,
)
from rescan_line_sted_torch.config import Replaceable
from rescan_line_sted_torch.device import as_sample, host_table
from rescan_line_sted_torch.imaging import analytic
from rescan_line_sted_torch.imaging.line_sted import line_sted_image
from rescan_line_sted_torch.imaging.orientations import (
    multi_orientation_line_sted,
)
from rescan_line_sted_torch.imaging.point_sted import point_sted_image
from rescan_line_sted_torch.imaging.rescan import rescanned_line_sted_image
from rescan_line_sted_torch.imaging.rescan_point import (
    rescan_point_canvas_mean,
    rescan_point_system_kernel,
)
from rescan_line_sted_torch.imaging.shifts import flip_centered
from rescan_line_sted_torch.physics import models
from rescan_line_sted_torch.physics.dose import line_sted_dose, point_sted_dose
from rescan_line_sted_torch.physics.noise import (
    derived_generators,
    maybe_poisson,
)
from rescan_line_sted_torch.utils.observability import span

ARMS = ("point", "line", "rescan", "ism")


@dataclasses.dataclass(frozen=True)
class ModalitySweep(Replaceable):
    """Per-sweep-point results for one modality (leading dim = sweep)."""

    image: torch.Tensor           # [B, H, W] dose-matched acquisition
    fwhm_x: torch.Tensor          # [B] system-kernel FWHM, scan axis
    fwhm_y: torch.Tensor          # [B]
    emitted_signal: torch.Tensor  # [B] expected emitted photons (image)
    exposure: torch.Tensor        # [B] dwell scale that meets the budget
    num_steps: torch.Tensor       # [B] scan positions per acquisition
    # [B] resolution (sample px) from two-acquisition FRC (1/7
    # criterion); None unless the sweep ran with frc=True
    frc_resolution: torch.Tensor | None = None
    # [B] per-axis sectored-FRC resolutions (sample px) of the
    # anisotropic rescan canvas; None elsewhere and when frc=False
    frc_resolution_x: torch.Tensor | None = None
    frc_resolution_y: torch.Tensor | None = None


@dataclasses.dataclass(frozen=True)
class DoseMatchedComparison(Replaceable):
    depletion_powers: torch.Tensor  # [B]
    dose_budget: torch.Tensor       # scalar (per-pixel total dose)
    point: ModalitySweep
    line: ModalitySweep             # descanned line-STED
    rescan: ModalitySweep | None = None  # rescanned line-STED
    ism: ModalitySweep | None = None     # rescanned point-STED


@span("rls.sweep.generators")
def arm_generators(generator: torch.Generator | None, points: int):
    """The sweep's generators ``[arm][point][draw]`` (arms in ``ARMS``
    order, draws 0 and 1) derived from ``generator`` (module doc); None
    for a noise-free sweep."""
    if generator is None:
        return None
    return derived_generators(generator, (len(ARMS), points, 2))


def _f32(x) -> np.float32:
    return np.float32(float(x))


def _stack(rows: list[dict], key: str, device):
    """Column ``key`` of the per-point rows: tensors stacked on the card,
    host floats sent in one table; None where the rows hold None."""
    vals = [r[key] for r in rows]
    if vals[0] is None:
        return None
    if isinstance(vals[0], torch.Tensor):
        return torch.stack(vals)
    return host_table(np.array(vals, np.float32), device)


def _centre(kernel: torch.Tensor):
    """A centred kernel's column and row through its peak (``fwhm_2d``'s
    profiles), copied so that the kernel itself can go."""
    h, w = kernel.shape[-2:]
    return kernel[:, w // 2].clone(), kernel[h // 2, :].clone()


def _sweep(rows: list[dict], device, sample_sum, scale) -> ModalitySweep:
    """One arm's columns: the FWHMs of the stacked kernel profiles in one
    batched call each, rescaled to sample pixels by ``scale``; the emitted
    signal's host factor times the sample's sum, on the card."""
    cols = {f.name: _stack(rows, f.name, device)
            for f in dataclasses.fields(ModalitySweep)
            if f.name not in ("emitted_signal", "fwhm_x", "fwhm_y")}
    fy, fx = (fwhm_1d(torch.stack([r["profiles"][k] for r in rows]))
              for k in (0, 1))
    cols["fwhm_y"], cols["fwhm_x"] = scale(fy, fx)
    cols["emitted_signal"] = _stack(rows, "signal", device) * sample_sum
    return ModalitySweep(**cols)


@span("rls.sweep")
def dose_matched_sweep(
    sample,
    point_base,
    line_base,
    point_geom,
    line_geom,
    depletion_powers,
    dose_budget,
    generator: torch.Generator | None = None,
    orientations: int = 1,
    rescan_geom=None,
    fuse_orientations: bool = False,
    fusion_iters: int = 30,
    ism_geom=None,
    fusion_accelerate: bool = False,
    frc: bool = False,
    device=None,
) -> DoseMatchedComparison:
    """Run the dose-matched comparison over ``depletion_powers`` [B].

    ``sample`` is taken as the engines take it, on ``device``: None means
    the CUDA card (a CUDA ``sample`` stays on its card), and raises
    without one; pass ``device="cpu"`` for the plain PyTorch versions.
    ``generator=None`` gives noise-free expected images. A
    ``RescanGeometry`` adds the rescanned line-STED arm at the line arm's
    illumination and dose; a ``RescanPointGeometry`` (``ism_geom``,
    binning 1) adds rescanned point-STED (ISM) at the point arm's. ISM
    images live on the R-magnified canvas; its resolution columns are in
    sample pixels (canvas FWHM / R), as are the rescan arm's (canvas x
    scaled by b/R, y by b).

    ``frc=True`` (needs ``generator``) acquires a second independent noisy
    image per arm and reports the two-acquisition FRC resolution in
    ``frc_resolution`` (ISM's divided by R); the anisotropic rescan canvas
    reports per-axis sectored FRC in ``frc_resolution_x/_y`` instead.

    ``fuse_orientations=True`` runs the paper's protocol: the line arm
    acquires ``orientations`` rotated views at the matched total dose and
    reports their multi-view RL fusion; the rescan arm fuses its rotated
    canvases onto the sample grid through operator-form RL
    (``algorithms/fusion.py``); the point arm is RL-deconvolved and the
    ISM canvas deconvolved with its system kernel, each with
    ``fusion_iters`` iterations (Biggs-Andrews extrapolated with
    ``fusion_accelerate``). The FWHM columns then report each arm's
    achieved resolution: the FWHM of its RL-restored point response by
    the same protocol, in sample pixels (ISM's divided by R), and the
    rescan arm's FRC is the radial one of its fused image.
    """
    if frc and generator is None:
        raise ValueError("frc=True needs a generator (two noisy draws)")
    shape = point_geom.grid.shape
    sample = as_sample(sample, shape, device)
    dev = sample.device
    powers = torch.as_tensor(depletion_powers, dtype=torch.float32).cpu()
    budget = _f32(dose_budget)
    sample_sum = sample.sum()
    gens = arm_generators(generator, powers.numel())
    orient = np.float32(orientations)
    r_ism = ism_geom.rescan_factor if ism_geom is not None else None
    if rescan_geom is not None:
        b, r = rescan_geom.binning, rescan_geom.rescan_factor
    if fuse_orientations:
        # the JAX package's float32 angles for the acquisitions, and its
        # Python-float ones for the rescan operators
        angles = torch.arange(orientations, dtype=torch.float32) * (
            math.pi / orientations)
        angles_static = tuple(v * math.pi / orientations
                              for v in range(orientations))
        delta = torch.zeros(shape, device=dev)
        delta[shape[0] // 2, shape[1] // 2] = 1.0

        def restore(img, kernels):
            return richardson_lucy_views(img, kernels, fusion_iters,
                                         accelerate=fusion_accelerate)

        def fused_response(kernels):
            """The RL restoration of a centred point source's noise-free
            views ``corr(delta, K) = flip(K)``: the achieved resolution."""
            return restore(torch.stack([flip_centered(k) for k in kernels]),
                           kernels)

    with span("rls.sweep.ledgers"):
        p_prof = models.profiles(models.point_model(point_base), shape,
                                 point_base, "cpu")
        l_prof = models.profiles(models.line_model(line_base),
                                 line_geom.grid.width, line_base, "cpu")

    def draw(arm, i, k):
        return None if gens is None else gens[ARMS.index(arm)][i][k]

    rows = {arm: [] for arm in ARMS}
    for i, s in enumerate(powers.tolist()):
        with span("rls.sweep.ledgers"):
            pp = point_base.replace(depletion=s)
            lp = line_base.replace(depletion=s)
            pdose = point_sted_dose(pp, point_geom, "cpu", p_prof)
            ldose = line_sted_dose(lp, line_geom, "cpu", l_prof)
            exp_p = budget / _f32(pdose.total_dose)
            exp_l = budget / (_f32(ldose.total_dose) * orient)
            p_bright = _f32(pp.brightness) * exp_p
            l_bright = _f32(lp.brightness) * exp_l
            pp_run = pp.replace(brightness=float(p_bright))
            lp_run = lp.replace(brightness=float(l_bright))
            p_steps = _f32(pdose.num_steps)
            l_steps = _f32(ldose.num_steps) * orient

        def point_image(k):
            img = point_sted_image(sample, pp_run, point_geom,
                                   draw("point", i, k), device=dev).image
            return restore(img[None], pkern[None]) if fuse_orientations \
                else img

        def line_image(k):
            if fuse_orientations:
                views, kernels = multi_orientation_line_sted(
                    sample, lp_run, line_geom, angles, draw("line", i, k),
                    device=dev)
                return restore(views, kernels), kernels
            return line_sted_image(sample, lp_run, line_geom,
                                   draw("line", i, k), device=dev).image, None

        # each arm's system kernel and engine calls (the arms draw from
        # generators of their own, so their order changes no draw)
        with span("rls.sweep.point"):
            pkern = analytic.point_system_kernel(shape, pp, dev)
            pimg = point_image(0)
            p_resp = (fused_response(pkern[None]) if fuse_orientations
                      else pkern)
            point = dict(
                image=pimg, profiles=_centre(p_resp),
                signal=p_bright * _f32(pdose.emission_per_unit_sample),
                exposure=exp_p, num_steps=p_steps,
                frc_resolution=(frc_resolution(pimg, point_image(1)) if frc
                                else None),
                frc_resolution_x=None, frc_resolution_y=None)
            rows["point"].append(point)
        with span("rls.sweep.line"):
            limg, lkernels = line_image(0)
            l_resp = (fused_response(lkernels) if fuse_orientations
                      else analytic.line_system_kernel(shape, lp, dev))
            rows["line"].append(dict(
                image=limg, profiles=_centre(l_resp),
                signal=(l_bright * orient
                        * _f32(ldose.emission_per_unit_sample)),
                exposure=exp_l, num_steps=l_steps,
                frc_resolution=(frc_resolution(limg, line_image(1)[0])
                                if frc else None),
                frc_resolution_x=None, frc_resolution_y=None))

        if ism_geom is not None:
            def ism_image(k):
                img = maybe_poisson(draw("ism", i, k), mean)
                if fuse_orientations:
                    # one isotropic view: deconvolve with the same count
                    img = ism_deconvolve(img, pp_run, ism_geom, fusion_iters,
                                         accelerate=fusion_accelerate)
                return img

            with span("rls.sweep.ism"):
                mean = rescan_point_canvas_mean(sample, pp_run, ism_geom)
                iimg = ism_image(0)
                if fuse_orientations:
                    i_resp = ism_deconvolve(
                        rescan_point_canvas_mean(delta, pp, ism_geom), pp,
                        ism_geom, fusion_iters, accelerate=fusion_accelerate)
                else:
                    i_resp = rescan_point_system_kernel(ism_geom, pp, dev)
                rows["ism"].append(dict(
                    point, image=iimg, profiles=_centre(i_resp),
                    frc_resolution=(frc_resolution(iimg, ism_image(1))
                                    / r_ism if frc else None)))

        if rescan_geom is not None and fuse_orientations:
            def rescan_image(k):
                canvases = multi_orientation_rescan(
                    sample, lp_run, rescan_geom, angles,
                    draw("rescan", i, k), device=dev)
                return rescan_fusion(canvases, lp_run, rescan_geom,
                                     angles_static, fusion_iters,
                                     accelerate=fusion_accelerate)

            with span("rls.sweep.rescan"):
                rimg = rescan_image(0)
                # the achieved resolution: a point source's canvases
                # restored by the same operator RL (on the sample grid
                # already)
                r_resp = rescan_fusion(
                    multi_orientation_rescan(delta, lp_run, rescan_geom,
                                             angles, device=dev),
                    lp_run, rescan_geom, angles_static, fusion_iters,
                    accelerate=fusion_accelerate)
                rows["rescan"].append(dict(
                    rows["line"][-1], image=rimg, profiles=_centre(r_resp),
                    frc_resolution=(frc_resolution(rimg, rescan_image(1))
                                    if frc else None)))
        elif rescan_geom is not None:
            def rescan_image(k):
                return rescanned_line_sted_image(
                    sample, lp_run, rescan_geom, draw("rescan", i, k),
                    device=dev).image

            with span("rls.sweep.rescan"):
                rimg = rescan_image(0)
                cx = cy = None
                if frc:
                    # the canvas is anisotropic (x magnified R/b, y shrunk
                    # b): per-axis sectored FRC, each rescaled by its factor
                    cx, cy = frc_sectored_resolution(rimg, rescan_image(1))
                    cx, cy = cx * b / r, cy * b
                rows["rescan"].append(dict(
                    rows["line"][-1], image=rimg,
                    profiles=_centre(analytic.rescan_system_kernel(
                        rescan_geom, lp, dev)), frc_resolution=None,
                    frc_resolution_x=cx, frc_resolution_y=cy))

    # sample pixels: ISM's canvas is magnified by R; the rescan canvas's x
    # by R/b, its y shrunk by b (the fused rescan image is on the sample
    # grid)
    scales = {"ism": lambda fy, fx: (fy / r_ism, fx / r_ism)}
    if not fuse_orientations:
        scales["rescan"] = lambda fy, fx: (fy * b, fx * b / r)

    def arm(name):
        if not rows[name]:
            return None
        return _sweep(rows[name], dev, sample_sum,
                      scales.get(name, lambda fy, fx: (fy, fx)))

    with span("rls.sweep.columns"):
        return DoseMatchedComparison(
            depletion_powers=host_table(powers.numpy(), dev),
            dose_budget=host_table(np.asarray(budget), dev),
            point=arm("point"), line=arm("line"), rescan=arm("rescan"),
            ism=arm("ism"))

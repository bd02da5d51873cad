"""Figure-equivalent end-to-end pipelines (port of the JAX package's
``pipelines/figures.py``; components C14/L3).

Each pipeline is a library function: the engines compute tensors on
``device`` (None: the CUDA card, raising without one; ``device="cpu"``
runs the plain PyTorch versions), each result is copied to the host once
(``io.checkpoint.to_numpy``), and the host writes TIFF (``io/tiff.py``) and,
where matplotlib is installed, PNG artifacts and returns a metrics dict
(SURVEY.md section 6, observability). The JAX package jits each pipeline's
work into one program; the port runs the same calls eagerly.

Generators stand for the JAX keys. Where the JAX pipeline uses
``jax.random.key(seed)`` as it is, the port seeds one generator with
``seed`` on the pipeline's device; where it splits the key, over the dose
sweep's chunks or over one pipeline's calls, the port gives chunk or call
``i`` its own generator, seeded from ``(seed, i)`` alone
(``derived_generator``), so a chunk draws the same whichever chunks a
resume loaded from disk.

Pipelines:

* ``comparison_pipeline``  -- point vs line STED at matched dose (fig-1/2
  class): acquisitions at several depletion powers, side by side.
* ``dose_sweep_pipeline``  -- the dose-matched resolution/signal tradeoff
  curves (call stack 4.4), with chunked checkpoint/resume.
* ``fusion_pipeline``      -- multi-orientation line-STED + Richardson-Lucy
  isotropic fusion (call stack 4.5).
* ``rescan_pipeline``      -- rescanned line-STED canvas formation and
  descan-vs-rescan comparison (call stack 4.3).
* ``ism_pipeline``         -- rescanned POINT-STED (2D pixel reassignment /
  ISM; beyond-reference modality, ``imaging/rescan_point.py``).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from rescan_line_sted_torch.algorithms import richardson_lucy_views
from rescan_line_sted_torch.algorithms.metrics import fwhm_2d
from rescan_line_sted_torch.config import (
    Grid,
    LineSTEDGeometry,
    LineSTEDParams,
    PointSTEDGeometry,
    PointSTEDParams,
    RescanGeometry,
)
from rescan_line_sted_torch.data import samples
from rescan_line_sted_torch.device import resolve
from rescan_line_sted_torch.imaging import (
    line_sted_image,
    rescanned_line_sted_image,
)
from rescan_line_sted_torch.imaging.orientations import (
    multi_orientation_line_sted,
)
from rescan_line_sted_torch.io import SweepCheckpoint, array_to_tif
from rescan_line_sted_torch.io.checkpoint import flatten, rebuild, to_numpy
from rescan_line_sted_torch.sweeps import dose_matched_sweep
from rescan_line_sted_torch.utils.observability import emit_metrics


def derived_generator(seed: int, index: int, device) -> torch.Generator:
    """The generator of chunk or call ``index`` of a pipeline run with
    ``seed``, on ``device``: seeded from ``(seed, index)`` alone, through
    numpy's ``SeedSequence``."""
    state = np.random.SeedSequence([seed % 2**64, index]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device).manual_seed(int(state) >> 1)


def _default_sample(size: int, device) -> torch.Tensor:
    return samples.siemens_star((size, size), device=device)


def _save_panels(out_dir: str, name: str, panels: dict):
    os.makedirs(out_dir, exist_ok=True)
    panels = {k: to_numpy(v).astype(np.float32, copy=False)
              for k, v in panels.items()}
    for key, img in panels.items():
        array_to_tif(img, os.path.join(out_dir, f"{name}_{key}.tif"))
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    n = len(panels)
    fig, axes = plt.subplots(1, n, figsize=(4 * n, 4))
    if n == 1:
        axes = [axes]
    for ax, (key, img) in zip(axes, panels.items()):
        ax.imshow(img, cmap="magma")
        ax.set_title(key)
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, f"{name}.png"), dpi=120)
    plt.close(fig)


def comparison_pipeline(out_dir: str, size: int = 256, depletion: float = 8.0,
                        dose_budget: float = 100.0, seed: int = 0,
                        device=None) -> dict:
    """Point vs line STED at equal photodose, confocal baseline included."""
    dev = resolve(device)
    grid = Grid(size, size)
    sample = _default_sample(size, dev)
    pgeom, lgeom = PointSTEDGeometry(grid), LineSTEDGeometry(grid)
    pbase = PointSTEDParams.create(brightness=1.0)
    lbase = LineSTEDParams.create(brightness=1.0)
    res = to_numpy(dose_matched_sweep(
        sample, pbase, lbase, pgeom, lgeom, [0.0, depletion], dose_budget,
        generator=torch.Generator(dev).manual_seed(seed), device=dev))
    panels = {
        "sample": sample,
        "point_confocal": res.point.image[0],
        "point_sted": res.point.image[1],
        "line_confocal": res.line.image[0],
        "line_sted": res.line.image[1],
    }
    _save_panels(out_dir, "comparison", panels)
    metrics = {
        "pipeline": "comparison",
        "point_fwhm_x": float(res.point.fwhm_x[1]),
        "line_fwhm_x": float(res.line.fwhm_x[1]),
        "point_steps": float(res.point.num_steps[1]),
        "line_steps": float(res.line.num_steps[1]),
        "point_signal": float(res.point.emitted_signal[1]),
        "line_signal": float(res.line.emitted_signal[1]),
    }
    emit_metrics(metrics, os.path.join(out_dir, "metrics.jsonl"))
    return metrics


def _merge(results: list, num_powers: int):
    """The chunks' results concatenated along the sweep and trimmed to
    ``num_powers``; 0-d leaves taken from the first chunk."""
    leaves = [flatten(r)[1] for r in results]
    return rebuild(results[0], {
        k: np.concatenate([lv[k] for lv in leaves])[:num_powers]
        if np.ndim(v) else v for k, v in leaves[0].items()})


def dose_sweep_pipeline(out_dir: str, size: int = 256, num_powers: int = 16,
                        max_power: float = 16.0, dose_budget: float = 100.0,
                        seed: int = 0, chunk: int = 4,
                        orientations: int = 2,
                        fuse_orientations: bool = True,
                        fusion_iters: int = 30,
                        boundary: str = "circular",
                        include_ism: bool = False,
                        frc: bool = False, device=None) -> dict:
    """Full dose-matched sweep with per-chunk checkpoint/resume.

    ``fuse_orientations`` (default on, the paper's protocol) reports the
    N-orientation RL-fused line/rescan arms and achieved post-fusion
    resolutions; see ``dose_matched_sweep``. ``boundary="padded"`` runs the
    whole sweep open-boundary (pad-acquire-crop). ``include_ism`` adds the
    beyond-reference rescanned-point (2D pixel reassignment) arm at the
    point arm's dose; prefer ``boundary="padded"`` or ``"apodized"`` with
    it -- the ISM arm's analytic canvas mean unwraps camera indices
    (exact for edge-zero samples), so under the default circular world
    the default siemens star's edge-touching spokes make its seam region
    deviate from a faithful wrapping scan (``imaging/rescan_point``
    module doc; the interior, where the resolution metrics are read, is
    unaffected). ``frc=True`` adds a second independent acquisition
    per arm and reports the achieved-with-noise FRC resolution curves
    (``*_frc_resolution`` in the curves npz and the resolution panel).

    Each chunk of ``chunk`` powers is one sweep call with its own derived
    generator (module doc); a ragged last chunk is padded with the last
    power and the merged results trimmed back to ``num_powers``. A chunk
    already on disk is loaded, its shapes taken from the file.
    """
    if boundary not in ("circular", "padded", "apodized"):
        raise ValueError(f"unknown boundary {boundary!r}")
    dev = resolve(device)
    margin = 0
    if boundary == "padded":
        from rescan_line_sted_torch.imaging.boundary import default_margin

        margin = default_margin(LineSTEDGeometry(Grid(size, size)))
    run_size = size + 2 * margin
    grid = Grid(run_size, run_size)
    sample = torch.nn.functional.pad(_default_sample(size, dev),
                                     (margin, margin, margin, margin))
    if boundary == "apodized":
        from rescan_line_sted_torch.imaging.boundary import (
            apodize_sample,
            default_margin,
        )

        sample = apodize_sample(
            sample, default_margin(LineSTEDGeometry(grid)))
    pgeom, lgeom = PointSTEDGeometry(grid), LineSTEDGeometry(grid)
    pbase = PointSTEDParams.create(brightness=1.0)
    lbase = LineSTEDParams.create(brightness=1.0)
    powers = torch.linspace(0.0, max_power, num_powers)

    rgeom = RescanGeometry(grid, rescan_factor=2.0)
    igeom = None
    if include_ism:
        from rescan_line_sted_torch.config import RescanPointGeometry

        igeom = RescanPointGeometry(grid, rescan_factor=2.0)

    def run(p, generator):
        return to_numpy(dose_matched_sweep(
            sample, pbase, lbase, pgeom, lgeom, p, dose_budget,
            generator=generator, orientations=orientations,
            rescan_geom=rgeom, fuse_orientations=fuse_orientations,
            fusion_iters=fusion_iters, ism_geom=igeom, frc=frc, device=dev))

    ckpt = SweepCheckpoint(os.path.join(out_dir, "sweep_ckpt"))
    meta = dict(size=size, num_powers=num_powers, max_power=max_power,
                dose_budget=dose_budget, seed=seed, chunk=chunk,
                orientations=orientations,
                fuse_orientations=fuse_orientations, boundary=boundary,
                include_ism=include_ism, frc=frc)
    stored = ckpt.read_meta()
    if stored and stored != meta and ckpt.completed():
        raise ValueError(
            f"checkpoint dir {ckpt.directory!r} was written with different "
            f"sweep settings ({stored}); delete it or change out_dir")
    ckpt.write_meta(**meta)
    results, example = [], None
    # Ragged final chunk: pad with the last power (every chunk the same
    # length, as the JAX pipeline's one compiled shape), then trim the
    # merged results back to num_powers.
    n_chunks = -(-num_powers // chunk)
    for i in range(n_chunks):
        chunk_powers = powers[i * chunk:(i + 1) * chunk]
        if chunk_powers.shape[0] < chunk:
            pad = chunk - chunk_powers.shape[0]
            chunk_powers = torch.cat(
                [chunk_powers, chunk_powers[-1:].repeat(pad)])
        if ckpt.has(i):
            out = ckpt.load(i, like=example)
        else:
            out = run(chunk_powers, derived_generator(seed, i, dev))
            ckpt.save(i, out)
        example = out if example is None else example
        results.append(out)
    merged = _merge(results, num_powers)

    if margin:  # crop padded acquisitions back to the requested field
        def crop(arr):
            return arr[:, margin:margin + size, margin:margin + size]

        rimg = merged.rescan.image
        if fuse_orientations:  # fused estimate lives on the sample grid
            rimg = crop(rimg)
        else:  # canvas grid: x scales by R, both axes by 1/binning
            r, b = rgeom.rescan_factor, rgeom.binning
            x0 = int(round(r * margin)) // b
            rimg = rimg[:, margin // b: margin // b + size // b,
                        x0: x0 + int(round(r * size)) // b]
        repl = dict(
            point=merged.point.replace(image=crop(merged.point.image)),
            line=merged.line.replace(image=crop(merged.line.image)),
            rescan=merged.rescan.replace(image=rimg))
        if include_ism:
            # ISM canvases (raw AND deconvolved) live on the R-magnified
            # grid; both axes scale by R (binning=1 here)
            ri = igeom.rescan_factor
            i0 = int(round(ri * margin))
            iw = int(round(ri * size))
            repl["ism"] = merged.ism.replace(
                image=merged.ism.image[:, i0:i0 + iw, i0:i0 + iw])
        merged = merged.replace(**repl)

    curves = dict(
        depletion_powers=merged.depletion_powers,
        point_fwhm_x=merged.point.fwhm_x,
        point_fwhm_y=merged.point.fwhm_y,
        line_fwhm_x=merged.line.fwhm_x,
        line_fwhm_y=merged.line.fwhm_y,
        rescan_fwhm_x=merged.rescan.fwhm_x,
        rescan_fwhm_y=merged.rescan.fwhm_y,
        point_signal=merged.point.emitted_signal,
        line_signal=merged.line.emitted_signal)
    if include_ism:
        curves["ism_fwhm_x"] = merged.ism.fwhm_x
        curves["ism_fwhm_y"] = merged.ism.fwhm_y
    if frc:
        curves["point_frc_resolution"] = merged.point.frc_resolution
        curves["line_frc_resolution"] = merged.line.frc_resolution
        if fuse_orientations:
            curves["rescan_frc_resolution"] = merged.rescan.frc_resolution
        else:  # anisotropic unfused canvas: per-axis sectored FRC
            curves["rescan_frc_resolution_x"] = \
                merged.rescan.frc_resolution_x
            curves["rescan_frc_resolution_y"] = \
                merged.rescan.frc_resolution_y
        if include_ism:
            curves["ism_frc_resolution"] = merged.ism.frc_resolution
    np.savez(os.path.join(out_dir, "dose_sweep_curves.npz"), **curves)
    panels = {
        "point_s0": merged.point.image[0],
        "point_smax": merged.point.image[-1],
        "line_s0": merged.line.image[0],
        "line_smax": merged.line.image[-1],
    }
    if include_ism:
        panels["ism_smax"] = merged.ism.image[-1]
    _save_panels(out_dir, "dose_sweep_images", panels)
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4))
        p = merged.depletion_powers
        line_label = (f"line STED ({orientations}-orient. RL fused)"
                      if fuse_orientations else "line STED (scan axis)")
        ax1.plot(p, merged.point.fwhm_x, label="point STED")
        ax1.plot(p, merged.line.fwhm_x, label=line_label)
        ax1.plot(p, merged.rescan.fwhm_x, "--",
                 label="rescanned line STED")
        if include_ism:
            ax1.plot(p, merged.ism.fwhm_x, ":",
                     label="rescanned point (ISM)")
        if frc:
            ax1.plot(p, merged.point.frc_resolution, "x-",
                     alpha=0.6, label="point FRC (achieved)")
            ax1.plot(p, merged.line.frc_resolution, "x-",
                     alpha=0.6, label="line FRC (achieved)")
        ax1.set_xlabel("depletion power s"), ax1.set_ylabel("FWHM (px)")
        ax1.legend(), ax1.set_title("resolution at matched dose")
        ax2.plot(p, merged.point.emitted_signal, label="point")
        ax2.plot(p, merged.line.emitted_signal, label="line")
        ax2.set_xlabel("depletion power s"), ax2.set_ylabel("emitted signal")
        ax2.legend(), ax2.set_title("signal at matched dose")
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, "dose_sweep.png"), dpi=120)
        plt.close(fig)
    except ImportError:
        pass

    metrics = {
        "pipeline": "dose_sweep",
        "num_powers": num_powers,
        "num_sweep_points_run": int(merged.point.fwhm_x.shape[0]),
        "fused_orientations": orientations if fuse_orientations else 0,
        "boundary": boundary,
        "point_fwhm_x_at_smax": float(merged.point.fwhm_x[-1]),
        "line_fwhm_x_at_smax": float(merged.line.fwhm_x[-1]),
        "line_fwhm_y_at_smax": float(merged.line.fwhm_y[-1]),
        "line_to_point_step_ratio": float(merged.line.num_steps[0]
                                          / merged.point.num_steps[0]),
    }
    if include_ism:
        metrics["ism_fwhm_x_at_smax"] = float(merged.ism.fwhm_x[-1])
    if frc:
        metrics["point_frc_resolution_at_smax"] = float(
            merged.point.frc_resolution[-1])
        metrics["line_frc_resolution_at_smax"] = float(
            merged.line.frc_resolution[-1])
    emit_metrics(metrics, os.path.join(out_dir, "metrics.jsonl"))
    return metrics


def fusion_pipeline(out_dir: str, size: int = 256, num_angles: int = 4,
                    depletion: float = 8.0, rl_iters: int = 50,
                    seed: int = 0, modality: str = "descan",
                    device=None) -> dict:
    """Multi-orientation line-STED acquisition + RL fusion (config 5).

    ``modality="descan"`` fuses descanned images with per-view kernels;
    ``modality="rescan"`` fuses rescanned canvases through the operator-form
    RL (deconvolve + de-rescan in one loop, see ``algorithms/fusion.py``).
    """
    dev = resolve(device)
    grid = Grid(size, size)
    sample = _default_sample(size, dev)
    lgeom = LineSTEDGeometry(grid)
    params = LineSTEDParams.create(depletion=depletion, brightness=200.0)
    angles = torch.arange(num_angles, dtype=torch.float32) * (
        math.pi / num_angles)
    gen = torch.Generator(dev).manual_seed(seed)

    if modality == "rescan":
        from rescan_line_sted_torch.algorithms.fusion import (
            multi_orientation_rescan,
            rescan_fusion,
        )
        from rescan_line_sted_torch.imaging.orientations import (
            orientation_kernels,
        )
        rgeom = RescanGeometry(grid, rescan_factor=2.0)
        # Python-float angles parameterize the per-view operators
        angles_static = tuple(float(i) * np.pi / num_angles
                              for i in range(num_angles))
        views = multi_orientation_rescan(
            sample, params, rgeom,
            torch.tensor(angles_static, dtype=torch.float32), gen,
            device=dev)
        fused = rescan_fusion(views, params, rgeom, angles_static,
                              num_iter=rl_iters)
        kernels = orientation_kernels((size, size), params, angles,
                                      device=dev)
    elif modality == "descan":
        views, kernels = multi_orientation_line_sted(
            sample, params, lgeom, angles, gen, device=dev)
        fused = richardson_lucy_views(views, kernels, num_iter=rl_iters)
    else:
        raise ValueError(f"unknown modality {modality!r}")
    ky, kx = to_numpy(fwhm_2d(kernels[0]))
    _save_panels(out_dir, "fusion", {
        "sample": sample,
        "view_0deg": views[0],
        f"view_{int(180 // num_angles)}deg": views[1],
        "fused_rl": fused,
    })
    metrics = {
        "pipeline": "fusion",
        "modality": modality,
        "num_angles": num_angles,
        "rl_iters": rl_iters,
        "view_kernel_fwhm_x": float(kx),
        "view_kernel_fwhm_y": float(ky),
    }
    emit_metrics(metrics, os.path.join(out_dir, "metrics.jsonl"))
    return metrics


def fov_pipeline(out_dir: str, sizes: tuple[int, ...] = (128, 256, 512),
                 depletion: float = 8.0, num_angles: int = 4,
                 rl_iters: int = 40, seed: int = 0, device=None) -> dict:
    """Batched resolution/FOV sweep (config 5): fused resolution + timing
    per field-of-view size."""
    from rescan_line_sted_torch.sweeps import resolution_fov_sweep

    dev = resolve(device)
    params = LineSTEDParams.create(depletion=depletion, brightness=200.0)
    records = resolution_fov_sweep(
        tuple(sizes), params, num_angles=num_angles, rl_iters=rl_iters,
        generator=torch.Generator(dev).manual_seed(seed), device=dev)
    os.makedirs(out_dir, exist_ok=True)
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4))
        fovs = [r["fov"] for r in records]
        ax1.plot(fovs, [r["fused_fwhm_x"] for r in records], "o-",
                 label="fused x")
        ax1.plot(fovs, [r["fused_fwhm_y"] for r in records], "s-",
                 label="fused y")
        ax1.plot(fovs, [r["view_kernel_fwhm_y"] for r in records], "--",
                 label="single view (wide axis)")
        ax1.set_xlabel("FOV (px)"), ax1.set_ylabel("FWHM (px)"), ax1.legend()
        ax1.set_title("fused resolution vs FOV")
        ax2.plot(fovs, [r["wall_s"] for r in records], "o-")
        ax2.set_xlabel("FOV (px)"), ax2.set_ylabel("wall (s)")
        ax2.set_title("acquisition+fusion wall-clock")
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, "fov_sweep.png"), dpi=120)
        plt.close(fig)
    except ImportError:
        pass
    metrics = {"pipeline": "fov", "records": records}
    emit_metrics(metrics, os.path.join(out_dir, "metrics.jsonl"))
    return metrics


def ism_pipeline(out_dir: str, size: int = 256, depletion: float = 8.0,
                 rescan_factor: float = 2.0, seed: int = 0,
                 boundary: str = "padded", device=None) -> dict:
    """Rescanned POINT-STED (2D pixel reassignment / ISM; beyond-reference).

    Panels: descanned point-STED vs the ISM canvas at s=0 (classic rescan
    confocal, sqrt(2) gain) and at the requested depletion (rescan STED).
    Default ``boundary="padded"``: the siemens-star sample reaches the field
    edge, where the analytic canvas mean (unwrapped camera indices) and the
    wrapping scan path disagree under a circular world -- pad-acquire-crop
    keeps both exact (see ``imaging/rescan_point`` module doc).
    """
    from rescan_line_sted_torch.algorithms.metrics import fwhm_1d
    from rescan_line_sted_torch.config import RescanPointGeometry
    from rescan_line_sted_torch.imaging import (
        point_sted_image,
        rescan_point_system_kernel,
        rescanned_point_sted_image,
    )

    dev = resolve(device)
    grid = Grid(size, size)
    sample = _default_sample(size, dev)
    pgeom = PointSTEDGeometry(grid)
    rgeom = RescanPointGeometry(grid, rescan_factor=rescan_factor)
    conf = PointSTEDParams.create(depletion=0.0, brightness=200.0)
    sted = PointSTEDParams.create(depletion=depletion, brightness=200.0)
    gens = [derived_generator(seed, i, dev) for i in range(3)]
    descan = point_sted_image(sample, sted, pgeom, gens[0],
                              boundary=boundary, device=dev).image
    ism = rescanned_point_sted_image(sample, conf, rgeom, gens[1],
                                     boundary=boundary, device=dev).image
    ism_sted = rescanned_point_sted_image(sample, sted, rgeom, gens[2],
                                          boundary=boundary,
                                          device=dev).image
    kern_c = rescan_point_system_kernel(rgeom, conf, device=dev)
    kern_s = rescan_point_system_kernel(rgeom, sted, device=dev)
    hc = kern_c.shape[0] // 2
    fwhm_c, fwhm_s = to_numpy((fwhm_1d(kern_c[hc]) / rescan_factor,
                               fwhm_1d(kern_s[hc]) / rescan_factor))
    _save_panels(out_dir, "ism", {
        "sample": sample,
        "point_sted_descanned": descan,
        "ism_canvas_confocal": ism,
        "ism_canvas_sted": ism_sted,
    })
    metrics = {
        "pipeline": "ism",
        "canvas_shape": list(ism.shape),
        "rescan_factor": rescan_factor,
        "ism_confocal_fwhm_sample_px": float(fwhm_c),
        "ism_sted_fwhm_sample_px": float(fwhm_s),
    }
    emit_metrics(metrics, os.path.join(out_dir, "metrics.jsonl"))
    return metrics


def rescan_pipeline(out_dir: str, size: int = 256, depletion: float = 8.0,
                    rescan_factor: float = 2.0, seed: int = 0,
                    device=None) -> dict:
    """Rescanned line-STED canvas formation, descan comparison."""
    dev = resolve(device)
    grid = Grid(size, size)
    sample = _default_sample(size, dev)
    lgeom = LineSTEDGeometry(grid)
    rgeom = RescanGeometry(grid, rescan_factor=rescan_factor)
    params = LineSTEDParams.create(depletion=depletion, brightness=200.0)
    descan, rescan = to_numpy((
        line_sted_image(sample, params, lgeom,
                        derived_generator(seed, 0, dev), device=dev).image,
        rescanned_line_sted_image(sample, params, rgeom,
                                  derived_generator(seed, 1, dev),
                                  device=dev).image))
    _save_panels(out_dir, "rescan", {
        "sample": sample,
        "descanned": descan,
        "rescanned_canvas": rescan,
    })
    metrics = {
        "pipeline": "rescan",
        "canvas_shape": list(rescan.shape),
        "rescan_factor": rescan_factor,
        "descan_sum": float(descan.sum()),
        "rescan_sum": float(rescan.sum()),
    }
    emit_metrics(metrics, os.path.join(out_dir, "metrics.jsonl"))
    return metrics

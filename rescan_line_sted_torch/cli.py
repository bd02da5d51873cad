"""Command-line interface (port of the JAX package's ``cli.py``; SURVEY.md
section 6, "Config / flag system").

Maps flags onto the config dataclasses and runs the figure-equivalent
pipelines on the CUDA card, or on the CPU with ``--platform cpu``::

    python -m rescan_line_sted_torch figure comparison --out out/
    python -m rescan_line_sted_torch figure all --size 256 --out out/
    python -m rescan_line_sted_torch psf-report --depletion 8
    python -m rescan_line_sted_torch --platform cpu psf-report --vectorial
    python -m torch.distributed.run --nproc_per_node 2 \
        -m rescan_line_sted_torch --multihost psf-report
"""

from __future__ import annotations

import argparse
import json
import logging


def _figure(args) -> None:
    from rescan_line_sted_torch.pipelines import (
        comparison_pipeline,
        dose_sweep_pipeline,
        fov_pipeline,
        fusion_pipeline,
        html_report,
        ism_pipeline,
        line_scan_animation,
        rescan_pipeline,
    )

    dev = args.platform
    runners = {
        "comparison": lambda: comparison_pipeline(
            args.out, size=args.size, depletion=args.depletion,
            dose_budget=args.dose_budget, seed=args.seed, device=dev),
        "sweep": lambda: dose_sweep_pipeline(
            args.out, size=args.size, num_powers=args.num_powers,
            max_power=args.max_power, dose_budget=args.dose_budget,
            seed=args.seed, fuse_orientations=not args.no_fuse,
            boundary=args.boundary, include_ism=args.ism, frc=args.frc,
            device=dev),
        "fusion": lambda: fusion_pipeline(
            args.out, size=args.size, num_angles=args.num_angles,
            depletion=args.depletion, rl_iters=args.rl_iters,
            seed=args.seed, modality=args.modality, device=dev),
        "rescan": lambda: rescan_pipeline(
            args.out, size=args.size, depletion=args.depletion,
            seed=args.seed, device=dev),
        "ism": lambda: ism_pipeline(
            args.out, size=args.size, depletion=args.depletion,
            seed=args.seed, device=dev),
        "fov": lambda: fov_pipeline(
            args.out, sizes=tuple(args.fov_sizes),
            depletion=args.depletion, num_angles=args.num_angles,
            rl_iters=args.rl_iters, seed=args.seed, device=dev),
        "animation": lambda: line_scan_animation(
            args.out, size=args.size, depletion=args.depletion,
            seed=args.seed, device=dev),
        "report": lambda: html_report(
            args.out, size=min(args.size, 256),
            dose_budget=args.dose_budget, num_angles=args.num_angles,
            rl_iters=args.rl_iters, seed=args.seed, device=dev),
    }
    names = list(runners) if args.which == "all" else [args.which]
    if args.boundary != "circular" and args.which not in ("sweep", "all"):
        raise SystemExit(
            f"--boundary {args.boundary} is only wired into the 'sweep' "
            "figure; other pipelines acquire with circular boundaries "
            "(use the engine-level boundary= argument in the API)")
    for name in names:
        metrics = runners[name]()
        print(json.dumps(_json_safe(metrics), default=float))


def _json_safe(obj):
    """RFC-compliant JSON mapping (NaN/inf -> null); one canonical
    implementation in utils/observability.py, shared with emit_metrics."""
    from rescan_line_sted_torch.utils.observability import json_safe

    return json_safe(obj)


def _psf_report(args) -> None:
    from rescan_line_sted_torch.algorithms.metrics import (
        fwhm_2d,
        system_resolution_report,
    )
    from rescan_line_sted_torch.config import (
        Grid,
        LineSTEDParams,
        PointSTEDParams,
        RescanPointGeometry,
    )
    from rescan_line_sted_torch.device import resolve
    from rescan_line_sted_torch.imaging import rescan_point_system_kernel
    from rescan_line_sted_torch.io.checkpoint import to_numpy

    dev = resolve(args.platform)
    shape = (args.size, args.size)
    igeom = RescanPointGeometry(Grid(*shape), rescan_factor=2.0)
    point, line, (ism_y, ism_x) = to_numpy((
        system_resolution_report(shape, PointSTEDParams.create(
            depletion=args.depletion), device=dev),
        system_resolution_report(shape, LineSTEDParams.create(
            depletion=args.depletion), device=dev),
        fwhm_2d(rescan_point_system_kernel(igeom, PointSTEDParams.create(
            depletion=args.depletion), device=dev))))
    report = {
        "depletion": args.depletion,
        "point_fwhm_x": float(point.fwhm_x),
        "point_fwhm_y": float(point.fwhm_y),
        "line_fwhm_x": float(line.fwhm_x),
        "line_fwhm_y": float(line.fwhm_y),
        # ISM (rescanned point, R=2) in sample pixels: canvas FWHM / R
        "ism_fwhm_x": float(ism_x) / 2.0,
        "ism_fwhm_y": float(ism_y) / 2.0,
    }
    if args.vectorial:
        # Richards-Wolf vectorial donut: per-polarization null depth and
        # achieved STED resolution (physics/models.VectorialDonutModel)
        from rescan_line_sted_torch.imaging.analytic import (
            point_system_kernel,
        )
        from rescan_line_sted_torch.physics.models import (
            VectorialDonutModel,
        )

        c = args.size // 2
        for pol in ("circular+", "circular-", "linear-x"):
            model = VectorialDonutModel(na=args.na, polarization=pol)
            p = PointSTEDParams.create(depletion=args.depletion, model=model)
            null, (fy, fx) = to_numpy((
                model.depletion(shape, p, dev)[c, c],
                fwhm_2d(point_system_kernel(shape, p, dev))))
            key = pol.replace("+", "_co").replace("-", "_counter") \
                if pol.startswith("circular") else pol.replace("-", "_")
            report[f"vectorial_{key}_null"] = float(null)
            report[f"vectorial_{key}_fwhm_x"] = float(fx)
    print(json.dumps(_json_safe(report)))


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    # The nvcc kernel library and the TIFF codec are built once into the
    # build directory and reused by every later invocation (override the
    # path with RLS_TORCH_BUILD_DIR).
    from rescan_line_sted_torch.utils.observability import (
        enable_compilation_cache,
    )

    enable_compilation_cache()
    parser = argparse.ArgumentParser(prog="rescan_line_sted_torch")
    parser.add_argument(
        "--platform", default=None, choices=["cpu", "cuda"],
        help="device to run on (default: the CUDA card; no card is an "
             "error, never a quiet fall back to the CPU)")
    parser.add_argument(
        "--multihost", action="store_true",
        help="join the multi-process runtime before running "
             "(parallel.initialize_multihost: torchrun's or SLURM's "
             "environment). Opt-in: single-host boxes with launcher-like "
             "env vars must not accidentally wait on a coordinator.")
    sub = parser.add_subparsers(dest="command", required=True)

    fig = sub.add_parser("figure", help="run a figure-equivalent pipeline")
    fig.add_argument("which", choices=["comparison", "sweep", "fusion",
                                       "rescan", "ism", "fov", "animation",
                                       "report", "all"])
    fig.add_argument("--out", default="out")
    fig.add_argument("--size", type=int, default=256)
    fig.add_argument("--depletion", type=float, default=8.0)
    fig.add_argument("--dose-budget", type=float, default=100.0)
    fig.add_argument("--num-powers", type=int, default=16)
    fig.add_argument("--max-power", type=float, default=16.0)
    fig.add_argument("--num-angles", type=int, default=4)
    fig.add_argument("--rl-iters", type=int, default=50)
    fig.add_argument("--modality", choices=["descan", "rescan"],
                     default="descan")
    fig.add_argument("--fov-sizes", type=int, nargs="+",
                     default=[128, 256, 512])
    fig.add_argument("--ism", action="store_true",
                     help="sweep: add the beyond-reference rescanned-point "
                          "(2D pixel reassignment / ISM) arm at the point "
                          "arm's dose")
    fig.add_argument("--frc", action="store_true",
                     help="sweep: acquire a second independent noisy "
                          "realization per arm and report achieved "
                          "Fourier-Ring-Correlation resolution curves")
    fig.add_argument("--no-fuse", action="store_true",
                     help="sweep: skip multi-orientation RL fusion (report "
                          "raw single-orientation arms instead)")
    fig.add_argument("--boundary",
                     choices=["circular", "padded", "apodized"],
                     default="circular",
                     help="sweep: field boundary -- circular wrap "
                          "(grid-periodic world), padded (open boundary "
                          "via pad-acquire-crop), or apodized "
                          "(raised-cosine edge taper)")
    fig.add_argument("--seed", type=int, default=0)
    fig.set_defaults(func=_figure)

    rep = sub.add_parser("psf-report", help="print system-kernel resolutions")
    rep.add_argument("--size", type=int, default=128)
    rep.add_argument("--depletion", type=float, default=8.0)
    rep.add_argument("--vectorial", action="store_true",
                     help="add Richards-Wolf vectorial-donut null depth "
                          "and STED resolution per polarization")
    rep.add_argument("--na", type=float, default=0.9,
                     help="numerical aperture for --vectorial")
    rep.set_defaults(func=_psf_report)

    args = parser.parse_args(argv)
    if args.multihost:
        from rescan_line_sted_torch.parallel import initialize_multihost

        proc, nprocs = initialize_multihost(
            backend="gloo" if args.platform == "cpu" else None)
        logging.getLogger(__name__).info(
            "multihost: process %d/%d", proc, nprocs)
    args.func(args)


if __name__ == "__main__":
    main()

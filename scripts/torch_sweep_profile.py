#!/usr/bin/env python3
"""Where the dose-matched sweep's time goes on the card.

    python scripts/torch_sweep_profile.py [--tree DIR] [--cell bench|figure]
                                          [--top N]

Imports ``rescan_line_sted_torch`` and ``chip_smoke`` from DIR (default:
this checkout), builds the kernels, and for each cell of
``chip_smoke.phase_sweep`` (``bench``: 256^2, 8 powers, point and line
arms, a CUDA generator; ``figure``: 2048^2, powers 0, 4, 8, 16, all four
arms, two orientations, ``frc=True``) prints one JSON line with the card's
``nvidia-smi`` name and power limit and:

- ``ms``: CUDA events around one whole sweep (median of ``--repeats``
  after a warm-up sweep);
- ``device_ms``: the kernels' and copies' time of one sweep under
  ``torch.profiler``, and its largest rows;
- ``host``: one sweep under ``cProfile`` (host seconds; the card's work is
  queued, so a host-bound sweep's time is its host time): the cumulative
  seconds of each stage of the sweep (dose ledgers, each engine, system
  kernels, FWHMs, FRC, the host phase tables) and the ``--top`` functions
  by their own time.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import subprocess
import sys

import torch

STAGES = ("point_sted_dose", "line_sted_dose", "point_sted_image",
          "line_sted_image", "rescanned_line_sted_image",
          "rescan_point_canvas_mean", "maybe_poisson", "point_system_kernel",
          "line_system_kernel", "rescan_system_kernel",
          "rescan_point_system_kernel", "fwhm_1d", "frc_resolution",
          "frc_sectored_resolution", "_plan", "_np_phases", "host_table",
          "arm_generators")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--cell", choices=("bench", "figure"), action="append")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_sweep_profile: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.tree))
    import chip_smoke
    from rescan_line_sted_torch.kernels import _build
    from rescan_line_sted_torch.sweeps import dose_matched_sweep

    _build.lib()
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    for cell in args.cell or ("bench", "figure"):
        if cell == "bench":
            kw = dict(chip_smoke.bench_sweep_args(dev))
        else:
            kw = dict(chip_smoke.figure_sweep_args(dev), frc=True)
        gen = torch.Generator(dev).manual_seed(1)

        def run():
            return dose_matched_sweep(generator=gen, **kw)

        ms = chip_smoke.cuda_ms(run, repeats=args.repeats)
        device_ms, rows = chip_smoke.device_busy(run)
        torch.cuda.synchronize()
        prof = cProfile.Profile()
        prof.enable()
        run()
        torch.cuda.synchronize()
        prof.disable()
        stats = pstats.Stats(prof).stats
        stages = {}
        for (path, _, name), (_, _, _, ct, _) in stats.items():
            if name in STAGES and "rescan_line_sted_torch" in path:
                stages[name] = stages.get(name, 0.0) + ct
        total = sum(v[2] for v in stats.values())
        top = sorted(((v[2], f"{os.path.basename(k[0])}:{k[1]}:{k[2]}")
                      for k, v in stats.items()), reverse=True)[:args.top]
        print(json.dumps({
            "cell": cell, "card": card, "ms": ms, "device_ms": device_ms,
            "busy_share": device_ms / ms,
            "device_rows": [[round(r[0], 4), r[1][:80], r[2]]
                            for r in rows],
            "host": {"profiled_s": total,
                     "stages_s": {k: round(v, 4) for k, v in sorted(
                         stages.items(), key=lambda kv: -kv[1])},
                     "top_self_s": [[round(t, 4), n] for t, n in top]}}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

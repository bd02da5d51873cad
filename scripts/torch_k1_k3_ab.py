#!/usr/bin/env python3
"""Time K1 (``rescan_banded_fused``, every mode) and K3 (``line_sted_fused``)
of one checkout of the PyTorch port on the card, to compare two checkouts in
turns.

    python scripts/torch_k1_k3_ab.py [--tree DIR] [--label NAME]

Imports ``rescan_line_sted_torch`` and ``chip_smoke`` from DIR (default:
this checkout), builds its kernels and prints one JSON line with the card's
``nvidia-smi`` name and power limit and:

- K1 in each of its four modes on ``chip_smoke.py``'s timed cases (the
  flagship 2048^2 at R = 1.5, class placement; the irrational cell, NUFFT
  spreading; the wide windows, sigma_exc = 8, at R = 1.5 and at the
  irrational step), noisy (a CPU generator) and noise-free: the CUDA-event
  time (median of 7 after a warm-up) and the device time of one call
  under ``torch.profiler``, with the tree's launch shape where it reports
  one;
- K3 on the line_2048 cell, called as the tree's line engine calls it
  (with its cached plan where the tree has one), noisy and noise-free,
  event and device time, and noisy without a plan;
- the flagship's per-step image (``rescanned_line_sted_image``): its event
  time, device busy time and idle share.

Run the parent's and the change's trees as parent, change, change, parent
in one call on one card: a card may run below its power limit, so numbers
from two calls are not compared.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch


def timed(cs, fn) -> dict:
    return {"ms": cs.cuda_ms(fn), "device_ms": cs.device_busy(fn)[0]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_k1_k3_ab: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.tree))
    import chip_smoke as cs
    from rescan_line_sted_torch import rescanned_line_sted_image
    from rescan_line_sted_torch.data import siemens_star
    from rescan_line_sted_torch.kernels import _build
    from rescan_line_sted_torch.kernels import line_fused
    from rescan_line_sted_torch.kernels import rescan_banded_fused as k1

    _build.lib()
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(1)
    out = {"label": args.label, "tree": args.tree,
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip(), "k1": {}}
    for mode, (_, case) in cs.K1_MODES.items():
        a, kw = cs.k1_inputs(case, dev)
        if not isinstance(kw, dict):   # (sample_y, plan): K1's two inputs
            a, kw = (a, kw), {}
        out["k1"][mode] = {
            "noisy": timed(cs, lambda: k1.rescan_banded_fused(
                *a, **kw, generator=gen)),
            "noise_free": timed(cs, lambda: k1.rescan_banded_fused(
                *a, **kw)),
            "launch": getattr(k1, "LAUNCH_SHAPE", {}).get(mode)}
        del a, kw
    star = siemens_star((cs.SIZE, cs.SIZE), device=dev)
    a = cs.k3_inputs(cs.line_setup(cs.SIZE)[0], star)
    kw = dict(slit_support=cs.K3_SUPPORT)
    if hasattr(line_fused, "line_plan"):
        kw["plan"] = line_fused.line_plan(*a[1:], cs.K3_SUPPORT)
    out["k3"] = {
        "noisy": timed(cs, lambda: line_fused.line_sted_fused(*a, gen, **kw)),
        "noise_free": timed(cs, lambda: line_fused.line_sted_fused(*a, **kw)),
        "noisy_no_plan_ms": cs.cuda_ms(lambda: line_fused.line_sted_fused(
            *a, gen, slit_support=cs.K3_SUPPORT)),
        "launch": getattr(line_fused, "LAUNCH_SHAPE", None)}
    params, geom = cs.flagship()

    def image():
        return rescanned_line_sted_image(star, params, geom, gen,
                                         method="scan",
                                         noise_mode="per_step")

    ms = cs.cuda_ms(image)
    busy = cs.device_busy(image)[0]
    out["flagship_image"] = {"ms": ms, "device_ms": busy,
                             "idle": 1.0 - busy / ms}
    print("K1_K3_AB " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

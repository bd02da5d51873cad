#!/usr/bin/env python3
"""Time K2c (``poisson_flat``) and K5 (``rescan_accumulate``) of one
checkout of the PyTorch port on the card, to compare two checkouts in turns.

    python scripts/torch_k2c_k5_ab.py [--tree DIR] [--label NAME]

Imports ``rescan_line_sted_torch`` from DIR (default: this checkout), builds
its kernels and prints one JSON line with the card's ``nvidia-smi`` name and
power limit and, each as the CUDA-event time (median of 7 after a warm-up)
and the device time of one call under ``torch.profiler``:

- K2c on the flagship's noise-free canvas ([2048, 3072]: siemens star,
  2048^2, R = 1.5, chunk 32, depletion 8, ``bench.py`` line settings) with
  a CPU generator and with a CUDA one, and ``torch.poisson`` on it;
- K5 on 32 frames [512, 512] into a [512, 1024] canvas (the shape and seed
  of ``chip_smoke.k5_inputs``: offsets in [-wc, 2 wc), duplicates), and
  ``index_add_`` of the same columns;
- the nobands_512_scatter image (512^2, R = 2, the stripe model flagged as
  not Gaussian, per-step noise, ``use_pallas=False``: 32 launches each of
  K2c and K5), CUDA events around the whole call.

Run the parent's and the change's trees as parent, change, change, parent
in one call on one card: a card may run below its power limit, so numbers
from two calls are not compared.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import torch


def cuda_ms(fn, repeats: int = 7) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn) -> float:
    """Device time (ms) of the kernels and copies of one ``fn()``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):          # a short call's trace has come back empty
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
        if total:
            return total / 1e3
    return 0.0


def both(fn) -> dict:
    return {"ms": cuda_ms(fn), "device_ms": device_ms(fn)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_k2c_k5_ab: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.tree))
    import rescan_line_sted_torch as T
    from rescan_line_sted_torch.data import siemens_star
    from rescan_line_sted_torch.kernels import _build
    from rescan_line_sted_torch.kernels.poisson import poisson_flat
    from rescan_line_sted_torch.kernels.rescan_accumulate import (
        rescan_accumulate)
    from rescan_line_sted_torch.physics.models import GaussianStripeModel

    _build.lib()
    dev = torch.device("cuda", 0)
    line_kw = dict(sigma_exc=3.0, sigma_det=3.0, stripe_period=12.0,
                   slit_halfwidth=4.0, brightness=1.0, depletion=8.0)
    params = T.LineSTEDParams.create(**line_kw)
    geom = T.RescanGeometry(T.Grid(2048, 2048), rescan_factor=1.5, chunk=32)
    canvas = T.rescanned_line_sted_image(siemens_star((2048, 2048),
                                                      device=dev),
                                         params, geom, method="scan").image
    cpu_gen = torch.Generator().manual_seed(1)
    dev_gen = torch.Generator(dev).manual_seed(1)
    lam = canvas.clamp_min(0)
    out = {"label": args.label, "tree": args.tree,
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip(),
           "k2c_flagship_canvas": {
               "cpu_generator": both(lambda: poisson_flat(canvas, cpu_gen)),
               "cuda_generator": both(lambda: poisson_flat(canvas,
                                                           dev_gen)),
               "torch_poisson": both(lambda: torch.poisson(lam, dev_gen))}}

    g = torch.Generator().manual_seed(0)                  # k5_inputs(dev)
    n, h, w, wc = 32, 512, 512, 1024
    offsets = torch.randint(-wc, 2 * wc, (n,), generator=g)
    offsets[1::4] = offsets[::4]
    base = torch.rand((h, wc), generator=g).to(dev)
    frames = torch.rand((n, h, w), generator=g).to(dev)
    offsets = offsets.to(dev)
    cols = torch.remainder(offsets[:, None] + torch.arange(w, device=dev),
                           wc).reshape(-1)
    src = frames.permute(1, 0, 2).reshape(h, n * w).contiguous()
    target = base.clone()
    out["k5"] = {"kernel": both(lambda: rescan_accumulate(base, frames,
                                                          offsets)),
                 "index_add": both(lambda: target.index_add_(1, cols, src))}

    class StripeNoBands(GaussianStripeModel):
        gaussian_excitation = False

    nob = dataclasses.replace(T.LineSTEDParams.create(**line_kw),
                              model=StripeNoBands())
    ngeom = T.RescanGeometry(T.Grid(512, 512), rescan_factor=2.0, chunk=32)
    star = siemens_star((512, 512), device=dev)
    out["nobands_512_scatter"] = both(lambda: T.rescanned_line_sted_image(
        star, nob, ngeom, cpu_gen, method="scan", noise_mode="per_step",
        use_pallas=False))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

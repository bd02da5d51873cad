#!/usr/bin/env python3
"""Time and check K6's two product bodies (``sgemm``, ``tf32x3`` in
``csrc/primitives.cu``) of one checkout of the PyTorch port on the card,
to compare two checkouts in turns.

    python scripts/torch_k6_gemm_ab.py [--tree DIR] [--label NAME]

Imports ``rescan_line_sted_torch`` from DIR (default: this checkout), builds
its kernels and prints one JSON line with the card's ``nvidia-smi`` name and
power limit, the ``ptxas -v`` lines of the two kernels, and per body:

- its error against the float64 product on the rate call's eighths (the
  checks' reps) and on seeded standard-normal operands (numpy, seed 0) at
  [4096, 128] x [128, 512] and [256, 64] x [64, 128], reps 1 and 3;
- its rate call (``primitives.calls``' GEMM_SHAPE eighths, reps grown until
  a call lasts 1 ms, then the median of 7 CUDA-event timings) in fp32 FMA/s
  and its share of the datasheet peak (33.5 T FFMA/s; 82.5 T fp32 FMA/s in
  three TF32 passes), and the same reps of ``torch.mm`` (TF32 off).

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

import numpy as np
import torch

PEAK_FFMA = 67e12 / 2          # H100 SXM fp32 FMA/s outside the tensor cores
PEAK_TF32X3 = 495e12 / 2 / 3   # fp32 FMA/s of a product in three TF32 passes
SHAPES = ((4096, 128, 512), (256, 64, 128))


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


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--label", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))
    from rescan_line_sted_torch.kernels import _build
    from rescan_line_sted_torch.kernels import primitives as prim

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    lib = _build.build()
    _build.lib()
    ptxas, keep = [], False
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            keep = "sgemm" in line or "tf32x3" in line
        if keep:
            ptxas.append(line.strip())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    calls = prim.calls(dev, check=True)
    out = {"tree": args.label or args.tree, "card": card, "ptxas": ptxas}
    for name in ("sgemm", "tf32x3"):
        run, plain, units = calls[name]
        reps = prim.CHECKS[name][0]
        res = {"eighths_rel": rel(run(reps), plain(reps))}
        for m, k, n in SHAPES:
            rng = np.random.default_rng(0)
            a = torch.from_numpy(rng.standard_normal((m, k), np.float32))
            b = torch.from_numpy(rng.standard_normal((k, n), np.float32))
            for r in (1, 3):
                want = sum(a.double() @ (b.double() + i * 1e-9)
                           for i in range(r))
                got = getattr(prim, name)(a.to(dev), b.to(dev), r)
                res[f"normal_{m}x{k}x{n}_reps{r}_rel"] = rel(got, want)
        reps = 16
        while True:
            ms = cuda_ms(lambda: run(reps), 3)
            if ms >= 1.0 or reps >= 1 << 16:
                break
            reps = min(reps * max(2, int(1.2 / max(ms, 1e-3)) + 1), 1 << 16)
        ms = cuda_ms(lambda: run(reps))
        m, k, n = prim.GEMM_SHAPE
        a = (torch.randint(0, 8, (m, k)) / 8).to(dev)
        b = (torch.randint(0, 8, (k, n)) / 8).to(dev)
        c = torch.empty((m, n), device=dev)

        def products():
            for _ in range(reps):
                torch.mm(a, b, out=c)

        mm_ms = cuda_ms(products)
        peak = PEAK_FFMA if name == "sgemm" else PEAK_TF32X3
        rate = units * reps / (ms * 1e-3)
        res.update(reps=reps, ms=ms, rate=rate, peak_share=rate / peak,
                   torch_mm_ms=mm_ms,
                   torch_mm_rate=units * reps / (mm_ms * 1e-3))
        out[name] = res
    print("K6_GEMM " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

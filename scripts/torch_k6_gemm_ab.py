#!/usr/bin/env python3
"""Time and check K6 bodies (``csrc/primitives.cu``) of one checkout of the
PyTorch port on the card, to compare two checkouts in turns.

    python scripts/torch_k6_gemm_ab.py [--tree DIR] [--label NAME]
                                       [--body NAME ...]

Imports ``rescan_line_sted_torch`` from DIR (default: this checkout), builds
its kernels and prints one JSON line with the card's ``nvidia-smi`` name and
power limit, the ``ptxas -v`` lines of the bodies asked for (``--body``,
repeatable; default ``sgemm`` and ``tf32x3``), and per body:

- its error against its plain version on the rate call's inputs at the
  checks' reps (``primitives.CHECKS``);
- its rate call (``primitives.calls``' inputs, reps grown until a call
  lasts 1 ms, then the median of 7 CUDA-event timings) in units per second;
- ``sgemm`` / ``tf32x3``: the error against the float64 product on seeded
  standard-normal operands (numpy, seed 0) at [4096, 128] x [128, 512] and
  [256, 64] x [64, 128], reps 1 and 3; the rate's share of the datasheet
  peak (33.5 T FFMA/s; 82.5 T fp32 FMA/s in three TF32 passes), and the
  same reps of ``torch.mm`` (TF32 off);
- ``place_add``: bit for bit against in-order adds on the tree's
  ``primitives.PLACE_CASES`` where it has them; event ms at 481 and 2000
  reps (the same work in every tree); windows per second against its
  bound, and one ``index_add_`` of the same sum at 256 reps, per window.
  The cases, the bound and the ``index_add_`` come from this checkout's
  ``chip_smoke.py`` (``place_add_cases``, ``prim_bound``,
  ``place_add_library``), whichever tree supplies the kernel.

Run the parent's and the change's trees as parent, change, change, parent
in one call on one card: a card may run below its power limit, so numbers
from two calls are not compared.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

PEAK_FFMA = 67e12 / 2          # H100 SXM fp32 FMA/s outside the tensor cores
PEAK_TF32X3 = 495e12 / 2 / 3   # fp32 FMA/s of a product in three TF32 passes
SHAPES = ((4096, 128, 512), (256, 64, 128))
PLACE_REPS = (481, 2000)       # place_add at fixed work in every tree
LIBRARY_REPS = 256             # index_add_'s reps: 2.35 GB of source


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


def smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def rate_call(run, units: int) -> dict:
    """Reps grown until a call lasts 1 ms, then the median of 7."""
    reps = 16
    while True:
        ms = cuda_ms(lambda: run(reps), 3)
        if ms >= 1.0 or reps >= 1 << 16:
            break
        reps = min(reps * max(2, int(1.2 / max(ms, 1e-3)) + 1), 1 << 16)
    ms = cuda_ms(lambda: run(reps))
    return {"reps": reps, "ms": ms, "rate": units * reps / (ms * 1e-3)}


def products(prim, name: str, dev, res: dict) -> None:
    for m, k, n in SHAPES:
        rng = np.random.default_rng(0)
        a = torch.from_numpy(rng.standard_normal((m, k), np.float32))
        b = torch.from_numpy(rng.standard_normal((k, n), np.float32))
        for r in (1, 3):
            want = sum(a.double() @ (b.double() + i * 1e-9)
                       for i in range(r))
            got = getattr(prim, name)(a.to(dev), b.to(dev), r)
            res[f"normal_{m}x{k}x{n}_reps{r}_rel"] = rel(got, want)
    m, k, n = prim.GEMM_SHAPE
    a = (torch.randint(0, 8, (m, k)) / 8).to(dev)
    b = (torch.randint(0, 8, (k, n)) / 8).to(dev)
    c = torch.empty((m, n), device=dev)

    def mm():
        for _ in range(res["reps"]):
            torch.mm(a, b, out=c)

    mm_ms = cuda_ms(mm)
    peak = PEAK_FFMA if name == "sgemm" else PEAK_TF32X3
    res.update(peak_share=res["rate"] / peak, torch_mm_ms=mm_ms,
               torch_mm_rate=m * k * n * res["reps"] / (mm_ms * 1e-3))


def _this_smoke():
    """This checkout's ``chip_smoke.py`` (place_add's cases, bound and
    ``index_add_`` timing), loaded apart from the measured tree's."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("_this_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def place_add(prim, run, dev, res: dict) -> None:
    here = _this_smoke()
    if hasattr(prim, "PLACE_CASES"):    # fails unless every case is exact
        res["cases_bit_for_bit"] = here.place_add_cases(dev)
    res["fixed_reps_ms"] = {r: cuda_ms(lambda: run(r)) for r in PLACE_REPS}
    bound, _, unit = here.prim_bound("place_add", res)
    lib = here.place_add_library(dev, LIBRARY_REPS)
    res.update(windows_per_s=res["rate"], bound_ms=bound, bound_unit=unit,
               bound_share=bound / res["ms"], index_add_ms=lib["ms"],
               index_add_reps=lib["reps"],
               index_add_us_per_window=1e3 * lib["ms_per_window"],
               us_per_window=1e3 * res["ms"] / (prim.PLACE_CANVASES
                                                * res["reps"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--label", default=None)
    ap.add_argument("--body", action="append", default=None,
                    help="a K6 body (primitives.NAMES); repeatable")
    args = ap.parse_args(argv)
    bodies = args.body or ["sgemm", "tf32x3"]
    sys.path.insert(0, os.path.abspath(args.tree))
    from rescan_line_sted_torch.kernels import _build
    from rescan_line_sted_torch.kernels import primitives as prim

    unknown = set(bodies) - set(prim.NAMES)
    if unknown:
        raise SystemExit(f"no K6 body {sorted(unknown)}: {prim.NAMES}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    lib = _build.build()
    _build.lib()
    ptxas, keep = [], False
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            keep = any(f"{b}_kernel" in line for b in bodies)
        if keep:
            ptxas.append(line.strip())
    calls = prim.calls(dev, check=True)
    out = {"tree": args.label or args.tree, "card": smi("name,power.limit"),
           "ptxas": ptxas}
    for name in bodies:
        run, plain, units = calls[name]
        reps = prim.CHECKS[name][0]
        want = plain(reps)
        res = {"check_rel": rel(run(reps), want)}
        res.update(rate_call(run, units))
        if name in ("sgemm", "tf32x3"):
            products(prim, name, dev, res)
        elif name == "place_add":
            place_add(prim, run, dev, res)
        out[name] = res
    print("K6_AB " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

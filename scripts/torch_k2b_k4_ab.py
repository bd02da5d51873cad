#!/usr/bin/env python3
"""Time K2b (``poisson_rows_tiered``) and K4 (``rescan_fused``) of one
checkout of the PyTorch port on the card, to compare two checkouts in turns.

    python scripts/torch_k2b_k4_ab.py [--tree DIR] [--label NAME]

Imports ``rescan_line_sted_torch`` and ``chip_smoke`` from DIR (default:
this checkout), builds its kernels and prints one JSON line with the card's
``nvidia-smi`` name and power limit and:

- K2b on each caller's first frames (line_2048 [32, 48, 2048], point_512
  [64, 64, 16, 80], the rescan hybrid nobands_512_subpixel [32, 512, 512],
  ism_256 [64, 256, 256]; ``chip_smoke.py``'s settings) with a CPU and a
  CUDA generator, and ``torch.poisson`` on the same rates: the CUDA-event
  time (median of 7 after a warm-up) and the device time of one call
  under ``torch.profiler``;
- where the wrapper's host time goes, on the line frames: each step of
  K2b's and K2c's wrappers timed alone with ``time.perf_counter_ns`` over
  ``HOST_CALLS`` calls in batches of 100 (mean us per call): the dtype /
  device check, ``empty_like``, the key words (``_build.key_words`` and,
  where the tree has it, ``_build.seeds_from``; the bare ``torch.randint``)
  with either generator, the current stream's handle (``_build``'s, and
  two ways of reading it), the bare ctypes call, and the whole wrapper;
- K4 on the nobands_2048 cell (2048^2, R = 2, the stripe model flagged as
  not Gaussian), noisy and noise-free, event and device time;
- the ism_256 per-step image (K2b once per chunk of 64) driven by a CUDA
  generator: its event time, device busy time and idle share.

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
import time

import torch

HOST_CALLS = 2000


class _Seen(Exception):
    pass


def first_frames(module, run) -> torch.Tensor:
    """A copy of the first rates ``module``'s engine hands K2b in
    ``run()``; the run stops there."""
    orig = module.poisson_rows_tiered
    seen = []

    def keep(lam, generator):
        seen.append(lam.clone())
        raise _Seen

    module.poisson_rows_tiered = keep
    try:
        run()
    except _Seen:
        pass
    finally:
        module.poisson_rows_tiered = orig
    return seen[0]


def host_us(fn, calls: int = HOST_CALLS, batch: int = 100) -> float:
    """Mean host microseconds of ``fn()`` over ``calls`` calls (after a
    warm-up), in batches of ``batch`` with the device synchronised between
    them, so that a full launch queue never makes the host wait."""
    for _ in range(20):
        fn()
    total = 0
    for _ in range(calls // batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(batch):
            fn()
        total += time.perf_counter_ns() - t0
    torch.cuda.synchronize()
    return total / (calls // batch * batch) / 1e3


def host_breakdown(lam, dev, _build, poisson) -> dict:
    """Each step of K2b's and K2c's wrappers alone on rates ``lam``."""
    lib = _build.lib()
    out = torch.empty_like(lam)
    rows, cols = lam.numel() // lam.shape[-1], lam.shape[-1]
    stream = _build.stream_handle(dev)
    gens = {"cpu_generator": torch.Generator().manual_seed(1),
            "cuda_generator": torch.Generator(dev).manual_seed(1)}
    keys = (lambda g: _build.key_words(g, dev)) \
        if hasattr(_build, "key_words") else None
    k2b_keys = len(_build._SIGNATURES["rls_poisson_rows_tiered"]) > 7
    res = {"calls": HOST_CALLS,
           "require_cuda_f32": host_us(
               lambda: _build.require_cuda_f32("k", lam)),
           "empty_like": host_us(lambda: torch.empty_like(lam)),
           "stream_handle": host_us(lambda: _build.stream_handle(dev)),
           "current_stream": host_us(
               lambda: torch.cuda.current_stream(dev).cuda_stream),
           "raw_stream": host_us(
               lambda: torch._C._cuda_getCurrentRawStream(dev.index)),
           "randint": {k: host_us(lambda g=g: torch.randint(
               0, 2**31 - 1, (2,), generator=g, device=g.device,
               dtype=torch.int64)) for k, g in gens.items()}}
    if hasattr(_build, "seeds_from"):
        res["seeds_from"] = {k: host_us(lambda g=g: _build.seeds_from(g))
                             for k, g in gens.items()}
    if keys is not None:
        res["key_words"] = {k: host_us(lambda g=g: keys(g))
                            for k, g in gens.items()}
    if k2b_keys:
        res["ctypes_k2b"] = host_us(lambda: lib.rls_poisson_rows_tiered(
            lam.data_ptr(), out.data_ptr(), rows, cols, 1, 2, None, stream))
    else:
        res["ctypes_k2b"] = host_us(lambda: lib.rls_poisson_rows_tiered(
            lam.data_ptr(), out.data_ptr(), rows, cols, 1, 2, stream))
    res["ctypes_k2c"] = host_us(lambda: lib.rls_poisson_flat(
        lam.data_ptr(), out.data_ptr(), lam.numel(), 1, 2, None, stream))
    res["k2b_wrapper"] = {k: host_us(
        lambda g=g: poisson.poisson_rows_tiered(lam, g))
        for k, g in gens.items()}
    res["k2c_wrapper"] = {k: host_us(lambda g=g: poisson.poisson_flat(lam, g))
                          for k, g in gens.items()}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_k2b_k4_ab: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.tree))
    import chip_smoke as cs
    import rescan_line_sted_torch as T
    from rescan_line_sted_torch.data import siemens_star
    from rescan_line_sted_torch.imaging import (
        line_sted, point_sted, rescan, rescan_point)
    from rescan_line_sted_torch.kernels import _build, poisson
    from rescan_line_sted_torch.kernels.rescan_fused import rescan_fused

    _build.lib()
    dev = torch.device("cuda", 0)
    cpu_gen = torch.Generator().manual_seed(1)
    dev_gen = torch.Generator(dev).manual_seed(1)
    out = {"label": args.label, "tree": args.tree,
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip()}

    def star(n):
        return siemens_star((n, n), device=dev)

    def per_step(image, n, params, geom, gen=cpu_gen):
        return lambda: image(star(n), params, geom, gen, method="scan",
                             noise_mode="per_step")

    callers = {
        "line_2048": (line_sted, per_step(T.line_sted_image, cs.SIZE,
                                          *cs.line_setup(cs.SIZE))),
        "point_512": (point_sted, per_step(T.point_sted_image, 512,
                                           *cs.point_setup(512))),
        "nobands_512_subpixel": (rescan, per_step(
            T.rescanned_line_sted_image, cs.SCAN_SIZE,
            *cs.nobands(cs.SCAN_SIZE, 1.5))),
        "ism_256": (rescan_point, per_step(
            T.rescanned_point_sted_image, cs.ISM_SIZE,
            *cs.ism_setup(cs.ISM_SIZE)))}
    k2b = {}
    line = None
    for name, (module, run) in callers.items():
        lam = first_frames(module, run)
        clamped = lam.clamp_min(0)
        k2b[name] = {"shape": list(lam.shape)}
        for key, fn in (
                ("cpu_generator", lambda: poisson.poisson_rows_tiered(
                    lam, cpu_gen)),
                ("cuda_generator", lambda: poisson.poisson_rows_tiered(
                    lam, dev_gen)),
                ("torch_poisson", lambda: torch.poisson(clamped, dev_gen))):
            k2b[name][key] = {"ms": cs.cuda_ms(fn),
                              "device_ms": cs.device_busy(fn)[0]}
        if name == "line_2048":
            line = lam
    out["k2b"] = k2b
    out["host_us_line_frames"] = host_breakdown(line, dev, _build, poisson)

    args4 = cs.k4_inputs(*cs.nobands(cs.SIZE), star(cs.SIZE))
    out["k4_nobands_2048"] = {
        "noisy": {"ms": cs.cuda_ms(lambda: rescan_fused(
            *args4, generator=cpu_gen)), "device_ms": cs.device_busy(
            lambda: rescan_fused(*args4, generator=cpu_gen))[0]},
        "noise_free": {"ms": cs.cuda_ms(lambda: rescan_fused(*args4)),
                       "device_ms": cs.device_busy(
                           lambda: rescan_fused(*args4))[0]}}

    ism = per_step(T.rescanned_point_sted_image, cs.ISM_SIZE,
                   *cs.ism_setup(cs.ISM_SIZE), gen=dev_gen)
    ms = cs.cuda_ms(ism, 3)
    busy = cs.device_busy(ism)[0]
    out["ism_256_per_step_cuda_generator"] = {
        "ms": ms, "device_ms": busy, "idle": 1.0 - busy / ms}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

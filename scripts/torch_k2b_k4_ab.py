#!/usr/bin/env python3
"""Time K2b (``poisson_rows_tiered``), K2c (``poisson_flat``) and K4
(``rescan_fused``) of one checkout of the PyTorch port on the card, to
compare two checkouts in turns.

    python scripts/torch_k2b_k4_ab.py [--tree DIR] [--label NAME]

Imports ``rescan_line_sted_torch`` and ``chip_smoke`` from DIR (default:
this checkout), builds its kernels and prints one JSON line with the card's
``nvidia-smi`` name and power limit and:

- K2b on each caller's first frames (line_2048 [32, 48, 2048], point_512
  [64, 64, 16, 80], the rescan hybrid nobands_512_subpixel [32, 512, 512],
  ism_256 [64, 256, 256]; ``chip_smoke.py``'s settings) and K2c on the
  dose sweep's point image 0 [256, 256] and the flagship's noise-free
  canvas [2048, 3072]: ``chip_smoke.sampler_times`` (CUDA-event ms with a
  CPU and a CUDA generator, the plain version and ``torch.poisson``, each
  with its device time of one call under ``torch.profiler``), and the
  device ms per call of the kernel with either generator and of
  ``torch.poisson`` with the host's launch work hidden (this checkout's
  ``chip_smoke.queued_ms``: the calls queue behind ``torch.cuda._sleep``,
  events around 100 back-to-back calls);
- where the wrappers' host time goes, on the line frames and on the dose
  sweep's image: each step of K2b's and K2c's wrappers timed alone with
  ``time.perf_counter_ns`` over ``HOST_CALLS`` calls in batches of 100
  (mean us per call, this checkout's ``chip_smoke.host_us``): the dtype /
  device check, the output's allocation (``empty_like`` and two other
  ways), the key words
  (``_build.key_words``; where the tree has it ``_build.generator_words``
  and the generator offset calls it makes; the bare ``torch.randint``)
  with either generator, the current stream's handle, K2c's layout
  (``flat_layout`` with the cached SM count, where the tree has it), the
  bare ctypes call, the whole wrapper, and ``torch.poisson``'s host time;
- where the tree has ``flat_layout``: K2c's two layouts forced, queued
  device ms per call at sizes 2^16-2^23 on bright rates (the dose image
  tiled) and on dim ones (uniform in [0, 1.4)), and on the two callers;
- K4 on the nobands_2048 cell (2048^2, R = 2, the stripe model flagged as
  not Gaussian), noisy with either generator and noise-free, event and
  device time;
- the ism_256 per-step image (K2b once per chunk of 64) driven by a CUDA
  generator: its event time, device busy time and idle share.

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


def _this_smoke():
    """This checkout's ``chip_smoke.py`` (its timing helpers ``queued_ms``
    and ``host_us``), loaded apart from the measured tree's."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("_this_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


HERE = _this_smoke()


def host_us(fn) -> float:
    return HERE.host_us(fn, HOST_CALLS)


def host_breakdown(lam, dev, _build, poisson) -> dict:
    """Each step of K2b's and K2c's wrappers alone on rates ``lam``, over
    ``HOST_CALLS`` calls each (``host_us``)."""
    lib = _build.lib()
    out = torch.empty_like(lam)
    clamped = lam.clamp_min(0)
    rows, cols = lam.numel() // lam.shape[-1], lam.shape[-1]
    stream = _build.stream_handle(dev)
    gens = {"cpu_generator": torch.Generator().manual_seed(1),
            "cuda_generator": torch.Generator(dev).manual_seed(1)}
    dev_gen = gens["cuda_generator"]
    k2b_keys = len(_build._SIGNATURES["rls_poisson_rows_tiered"]) > 7
    k2c_layout = len(_build._SIGNATURES["rls_poisson_flat"]) > 7
    res = {"shape": list(lam.shape), "calls": HOST_CALLS,
           "require_cuda_f32": host_us(
               lambda: _build.require_cuda_f32("k", lam)),
           "empty_like": host_us(lambda: torch.empty_like(lam)),
           "empty": host_us(lambda: torch.empty(
               lam.shape, dtype=lam.dtype, device=lam.device)),
           "new_empty": host_us(lambda: lam.new_empty(lam.shape)),
           "stream_handle": host_us(lambda: _build.stream_handle(dev)),
           "randint": {k: host_us(lambda g=g: torch.randint(
               0, 2**31 - 1, (2,), generator=g, device=g.device,
               dtype=torch.int64)) for k, g in gens.items()},
           "key_words": {k: host_us(lambda g=g: _build.key_words(g, dev))
                         for k, g in gens.items()},
           "torch_poisson": host_us(lambda: torch.poisson(clamped, dev_gen))}
    if hasattr(dev_gen, "get_offset"):
        res["generator_offset_calls"] = {
            "initial_seed": host_us(lambda: dev_gen.initial_seed()),
            "get_offset": host_us(lambda: dev_gen.get_offset()),
            "set_offset": host_us(
                lambda: dev_gen.set_offset(dev_gen.get_offset())),
            "is_current_stream_capturing": host_us(
                torch.cuda.is_current_stream_capturing)}
    if hasattr(_build, "generator_words"):
        res["generator_words"] = host_us(
            lambda: _build.generator_words(dev_gen))
        res["mix_words"] = host_us(lambda: _build.mix_words(1, 2))
    if hasattr(poisson, "flat_layout"):
        res["flat_layout"] = host_us(lambda: poisson.flat_layout(
            lam.numel(), _build.sm_count(dev)))
    if k2b_keys:
        res["ctypes_k2b"] = host_us(lambda: lib.rls_poisson_rows_tiered(
            lam.data_ptr(), out.data_ptr(), rows, cols, 1, 2, None, stream))
    else:
        res["ctypes_k2b"] = host_us(lambda: lib.rls_poisson_rows_tiered(
            lam.data_ptr(), out.data_ptr(), rows, cols, 1, 2, stream))
    if k2c_layout:
        per, blocks = poisson.flat_layout(lam.numel(), _build.sm_count(dev))
        res["ctypes_k2c"] = host_us(lambda: lib.rls_poisson_flat(
            lam.data_ptr(), out.data_ptr(), lam.numel(), 1, 2, None, per,
            blocks, stream))
    else:
        res["ctypes_k2c"] = host_us(lambda: lib.rls_poisson_flat(
            lam.data_ptr(), out.data_ptr(), lam.numel(), 1, 2, None,
            stream))
    res["k2b_wrapper"] = {k: host_us(
        lambda g=g: poisson.poisson_rows_tiered(lam, g))
        for k, g in gens.items()}
    res["k2c_wrapper"] = {k: host_us(lambda g=g: poisson.poisson_flat(lam, g))
                          for k, g in gens.items()}
    return res


def sampler(cs, lam, kernel, cpu_gen, dev_gen) -> dict:
    """``chip_smoke.sampler_times`` of ``kernel`` on ``lam``, with the
    device time per call of the kernel with either generator and of
    ``torch.poisson`` with the host's launch work hidden (``queued_ms``)
    and the host time of one call after a sync (``cold_host_us``) where
    the tree's smoke does not time them."""
    t = cs.sampler_times(lam, cpu_gen, dev_gen, kernel)
    t.pop("counts", None)
    if "queued" not in t:
        clamped = lam.clamp_min(0)
        t["queued"] = HERE.queued_ms(lambda: kernel(lam, cpu_gen))
        t["cuda_gen_queued"] = HERE.queued_ms(lambda: kernel(lam, dev_gen))
        t["library_queued"] = HERE.queued_ms(
            lambda: torch.poisson(clamped, dev_gen))
        t["cold_host_us"] = HERE.cold_host_us(lambda: kernel(lam, cpu_gen))
        t["cuda_gen_cold_host_us"] = HERE.cold_host_us(
            lambda: kernel(lam, dev_gen))
        t["library_cold_host_us"] = HERE.cold_host_us(
            lambda: torch.poisson(clamped, dev_gen))
    return t


def layouts(lam_by_name, dev, _build, poisson) -> dict:
    """K2c's two layouts forced: queued device ms per call on each
    caller's rates and on bright and dim rates of 2^16-2^23 elements."""
    bright = lam_by_name["k2c_dose_sweep_point_image_0"].reshape(-1)
    dim = 1.4 * torch.rand(1 << 23, device=dev,
                           generator=torch.Generator(dev).manual_seed(2))
    cases = dict(lam_by_name)
    for k in range(16, 24):
        n = 1 << k
        cases[f"bright_{n}"] = bright.repeat(-(-n // bright.numel()))[:n]
        cases[f"dim_{n}"] = dim[:n].contiguous()
    out = {}
    for name, lam in cases.items():
        out[name] = {"n": lam.numel(), "default": poisson.flat_layout(
            lam.numel(), _build.sm_count(dev))[0]}
        for per in (1, 4):
            out[name][f"per_thread_{per}"] = HERE.queued_ms(
                lambda: poisson.poisson_flat(lam, key=(5, 6),
                                             _per_thread=per))["device_ms"]
    return out


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
    k2b, rates = {}, {}
    for name, (module, run) in callers.items():
        lam = first_frames(module, run)
        rates[name] = lam
        k2b[name] = sampler(cs, lam, poisson.poisson_rows_tiered, cpu_gen,
                            dev_gen)
    out["k2b"] = k2b

    from rescan_line_sted_torch.sweeps import dose_matched_sweep
    k2c_rates = {
        "k2c_dose_sweep_point_image_0": dose_matched_sweep(
            **cs.bench_sweep_args(dev)).point.image[0].contiguous(),
        "k2c_flagship_canvas": T.rescanned_line_sted_image(
            star(cs.SIZE), *cs.flagship(), method="scan").image}
    out["k2c"] = {name: sampler(cs, lam, poisson.poisson_flat, cpu_gen,
                                dev_gen) for name, lam in k2c_rates.items()}
    out["host_us"] = {
        "line_2048_frames": host_breakdown(rates["line_2048"], dev, _build,
                                           poisson),
        "dose_sweep_point_image_0": host_breakdown(
            k2c_rates["k2c_dose_sweep_point_image_0"], dev, _build,
            poisson)}
    if hasattr(poisson, "flat_layout"):
        out["k2c_layouts"] = layouts(k2c_rates, dev, _build, poisson)

    args4 = cs.k4_inputs(*cs.nobands(cs.SIZE), star(cs.SIZE))
    out["k4_nobands_2048"] = {
        "noisy": {"ms": cs.cuda_ms(lambda: rescan_fused(
            *args4, generator=cpu_gen)), "device_ms": cs.device_busy(
            lambda: rescan_fused(*args4, generator=cpu_gen))[0]},
        "noisy_cuda_generator": {"ms": cs.cuda_ms(lambda: rescan_fused(
            *args4, generator=dev_gen)), "device_ms": cs.device_busy(
            lambda: rescan_fused(*args4, generator=dev_gen))[0]},
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

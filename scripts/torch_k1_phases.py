#!/usr/bin/env python3
"""Where kernel K1's time goes on the card: time it with phases compiled out.

    python3 scripts/torch_k1_phases.py [--tree DIR] [--label NAME] [--mode M]

Builds variants of DIR's ``rescan_line_sted_torch/csrc/rescan_banded_fused.cu``
(default: this checkout's) in which the staging of the sample window and
placement scalars (1), the convolution (2), the draws (3) or the placement
(4) is compiled out (``variant_source``; ``placement_only`` keeps the
staging, so that the placement reads real scalars and writes inside the
canvas), and times each (CUDA events,
median of 7 after a warm-up) on the flagship cell of ``chip_smoke.py``
(2048^2, R = 1.5, chunk 32, class placement), or on another mode's cell
of ``chip_smoke.K1_MODES`` (``--mode``: ``rescan_banded_fused_spread``,
``_wide``, ``_spread_wide``), noise-free and noisy. A
variant's output is wrong by construction; only its time means anything
(where the convolution is out, the draws run on stale rates). The phases
are found by the source's ``// [phase NAME]`` /
``// [end NAME]`` markers, or, in the source K1 had before its tensor-core
engine (fp32 FFMA, 256 threads), by the lines that open and close each
phase there. Prints the card's name and power limit first and, last, the
launch: its layout, shared memory per CTA, CTAs, CTAs per SM and threads.
Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("staging", "convolution", "draws", "placement")
# (start, end) of each phase in the FFMA source: the end is kept
FFMA_PHASES = {
    "staging": ("    for (int i = tid; i < d_in * kLanes; i += kThreads) {\n"
                "      const int d = i / kLanes;",
                "    __syncthreads();\n    const int split = p.m0[ic];"),
    "convolution": ("      {\n        int c[kRows], r[kRows];",
                    "      const int first = ps * kPassRows;"),
    "draws": ("      if (p.noisy) {", "      // Placement. The pass's"),
    "placement": ("      const int end = min(first + kPassRows, rows_used);",
                  "    }\n  }\n}\n\n// Dynamic shared memory"),
}
VARIANTS = {"whole": (), "no_staging": ("staging",),
            "no_convolution": ("convolution",), "no_draws": ("draws",),
            "no_placement": ("placement",),
            "convolution_only": ("staging", "draws", "placement"),
            "placement_only": ("convolution", "draws")}


def spans(src: str) -> dict:
    """Each phase's [start, end) in ``src``, and whether a barrier takes
    its place: the FFMA source's phases each sit at one level of the pass
    loop, where every thread passes; the marked source's convolution and
    draws sit inside a warp's loop over its groups, and its phases keep
    their barriers outside the markers (but the chunk's first)."""
    out = {}
    for name in NAMES:
        start, end = f"// [phase {name}]", f"// [end {name}]"
        if start in src:
            out[name] = (src.index(start), src.index(end), name == "staging")
        else:
            a, b = FFMA_PHASES[name]
            i = src.index(a)
            out[name] = (i, src.index(b, i), True)
    return out


def variant_source(src: str, skip) -> str:
    """``src`` with the phases in ``skip`` compiled out, each replaced by
    one barrier where one is due, so that every thread still meets the
    same barriers."""
    cuts = sorted((spans(src)[name] for name in skip), reverse=True)
    for a, b, barrier in cuts:
        src = (src[:a] + "\n#if 0\n" + src[a:b] + "\n#else\n"
               + ("__syncthreads();\n" if barrier else "") + "#endif\n"
               + src[b:])
    return src


def build(csrc, variants: dict, build_dir, nvcc, flags, signature) -> dict:
    """Compile each variant source (one nvcc per variant, all started
    together) and return its ``rls_rescan_banded_fused`` entry by name."""
    build_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, text in variants.items():
        cu, so = build_dir / f"{name}.cu", build_dir / f"{name}.so"
        cu.write_text(text)
        jobs[name] = (so, subprocess.Popen(
            [nvcc, *flags, "-shared", "-I", str(csrc), "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    fns = {}
    for name, (so, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{err}")
        fn = ctypes.CDLL(str(so)).rls_rescan_banded_fused
        fn.argtypes = signature
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--label", default="")
    ap.add_argument("--mode", default="rescan_banded_fused")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_k1_phases: CUDA is not available", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import chip_smoke as cs
    from rescan_line_sted_torch.kernels import _build
    from rescan_line_sted_torch.kernels.rescan_banded_fused import (
        _sample_ext, banded_plan)

    print(cs.card(), flush=True)
    dev = torch.device("cuda", 0)
    src = (_build.CSRC / "rescan_banded_fused.cu").read_text()
    fns = build(_build.CSRC, {name: variant_source(src, skip)
                              for name, skip in VARIANTS.items()},
                _build.BUILD_DIR / "k1_phases", _build._nvcc(),
                _build.NVCC_FLAGS,
                _build._SIGNATURES["rls_rescan_banded_fused"])
    sample_y, plan = cs.k1_inputs(cs.K1_MODES[args.mode][1], dev)
    if isinstance(plan, dict):   # a tree whose K1 takes its raw arguments
        sample_y, plan = sample_y[0], banded_plan(*sample_y[1:], **plan)
    h, w = sample_y.shape
    b, chunk, d_in, d_out, wc = (plan.binning, plan.chunk, plan.d_in,
                                 plan.d_out, plan.wc)
    dob = d_out // b
    q, n_spread, taps = plan.q, plan.n_spread, plan.taps
    g_t, ill_w, sa_lo, sa_hi, m0, cls = (plan.g_t, plan.ill_w, plan.sa_lo,
                                         plan.sa_hi, plan.m0, plan.cls)
    sample_ext = _sample_ext(sample_y, d_in, chunk)
    # the scan's band as K1 takes it (a tree whose K1 has no band: none)
    band = (plan.supports or (-1, -1)) if hasattr(plan, "supports") else ()
    out = torch.empty((q, wc, h // b), device=dev)
    info = (ctypes.c_int * 5)()
    res = {"label": args.label, "tree": tree, "mode": args.mode,
           "card": cs.card(), "ms": {}}
    for noisy in (0, 1):
        for name, fn in fns.items():
            def call():
                code = fn(g_t.data_ptr(), ill_w.data_ptr(),
                          sample_ext.data_ptr(), sa_lo.data_ptr(),
                          sa_hi.data_ptr(), m0.data_ptr(), cls.data_ptr(),
                          None if taps is None else taps.data_ptr(),
                          out.data_ptr(), h, w, chunk, d_in, dob, b, q, wc,
                          n_spread, noisy, *band, 1, 2, None,
                          _build.stream_handle(dev), info)
                _build.check(code, name)
            key = f"{'noisy' if noisy else 'noise_free'} {name}"
            res["ms"][key] = cs.cuda_ms(call)
            print(f"{args.mode} {key}: {res['ms'][key]:.3f} ms", flush=True)
    smem = (ctypes.c_longlong * 3)()
    _build.lib().rls_rescan_banded_fused_smem(d_in, dob, chunk, b, n_spread,
                                              smem)
    if "[phase staging]" in src:   # info: layout, bytes, CTAs, per SM, threads
        res["launch"] = {"layout": info[0], "smem_bytes": info[1],
                         "ctas": info[2], "ctas_per_sm": info[3],
                         "threads": info[4]}
    else:                          # 16 lanes and 256 threads a CTA, 1 an SM
        res["launch"] = {"layout": info[0], "smem_bytes": smem[info[0]],
                         "ctas": -(-(h // b) // 16), "ctas_per_sm": 1,
                         "threads": 256}
    print(f"launch: {json.dumps(res['launch'])}", flush=True)
    print("K1_PHASES " + json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

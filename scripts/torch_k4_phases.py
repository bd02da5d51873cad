#!/usr/bin/env python3
"""Where kernel K4's time goes on the card: time it with phases compiled out.

    python3 scripts/torch_k4_phases.py

Builds variants of ``rescan_line_sted_torch/csrc/rescan_fused.cu`` in which
the staging of the sample windows (1), the tap runs' convolution (2) or
the bin / draw / placement phase (3) is compiled out
(each replaced by one barrier), and times each (CUDA events, median of 7
after a warm-up) on the nobands_2048 cell of ``chip_smoke.py`` (2048^2,
R = 2, the stripe model without band windows), noise-free and noisy. A
variant's output is wrong by construction; only its time means anything.
Prints the card's name and power limit first and, last, the launch's
shared memory per CTA, binned rows per CTA, CTAs and CTAs per SM. Needs a
CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from rescan_line_sted_torch.data import siemens_star  # noqa: E402
from rescan_line_sted_torch.kernels import _build  # noqa: E402
from rescan_line_sted_torch.kernels.rescan_fused import _run  # noqa: E402

PHASES = ("    // 1. stage", "    // 2. the runs'",
          "    // 3. the chunk's placement", "  }\n}\n\n}  // namespace")
VARIANTS = {"whole": (), "no_staging": (1,), "no_convolution": (2,),
            "no_placement": (3,), "convolution_only": (1, 3),
            "placement_only": (1, 2)}


def variant_source(src: str, skip) -> str:
    """``src`` with the phases in ``skip`` compiled out, each replaced by
    one barrier so that every thread still meets the same barriers."""
    cuts = [src.index(marker) for marker in PHASES]
    parts = [src[:cuts[0]]]
    for k in range(3):
        body = src[cuts[k]:cuts[k + 1]]
        parts.append(f"#if 0\n{body}#else\n    __syncthreads();\n#endif\n"
                     if k + 1 in skip else body)
    parts.append(src[cuts[3]:])
    return "".join(parts)


def build(variants: dict) -> dict:
    """Compile each variant source (one nvcc per variant, all started
    together) and return its ``rls_rescan_fused`` entry by name."""
    out = _build.BUILD_DIR / "k4_phases"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, text in variants.items():
        cu, so = out / f"{name}.cu", out / f"{name}.so"
        cu.write_text(text)
        jobs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
             str(_build.CSRC), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    fns = {}
    for name, (so, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{err}")
        fn = ctypes.CDLL(str(so)).rls_rescan_fused
        fn.argtypes = _build._SIGNATURES["rls_rescan_fused"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_k4_phases: CUDA is not available", file=sys.stderr)
        return 1
    print(cs.card())
    dev = torch.device("cuda", 0)
    src = (_build.CSRC / "rescan_fused.cu").read_text()
    fns = build({name: variant_source(src, skip)
                 for name, skip in VARIANTS.items()})
    params, geom = cs.nobands(cs.SIZE)
    s, eff, gx, offs, wc, b = cs.k4_inputs(
        params, geom, siemens_star((cs.SIZE, cs.SIZE), device=dev))
    (e0, ne), (g0, ng) = _run(eff), _run(gx)
    offs = torch.remainder(offs.long(), wc).int()
    h, w = s.shape
    out = torch.zeros((h // b, wc), device=dev)
    info = (ctypes.c_int * 5)()
    for noisy in (0, 1):
        for name, fn in fns.items():
            def call():
                code = fn(s.data_ptr(), eff.data_ptr(), gx.data_ptr(),
                          offs.data_ptr(), out.data_ptr(), h, w, b, wc, e0, ne,
                          g0, ng, noisy, 1, 2, None,
                          _build.stream_handle(dev), info)
                _build.check(code, name)
            print(f"nobands_2048 {'noisy' if noisy else 'noise-free'} "
                  f"{name}: {cs.cuda_ms(call):.3f} ms", flush=True)
    print(f"launch: {info[0]} bytes of shared memory per CTA (of "
          f"{info[1]}), {info[2]} binned rows per CTA, {info[3]} CTAs, "
          f"{info[4]} per SM", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

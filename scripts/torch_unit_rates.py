#!/usr/bin/env python3
"""Measure the card's per-SM rate of single SASS instructions, the rates
``chip_smoke.UNIT_RATES`` takes from the CUDA C++ Programming Guide.

    python scripts/torch_unit_rates.py [--build DIR]

Builds one small library (``nvcc``, sm_90a) with a kernel per instruction:
``FFMA``, ``IMAD`` (``mad.lo.u32``), ``IMAD.HI`` (``mad.hi.u32``),
``IMAD.WIDE`` (``mul.wide.u32``: a 32 x 32 -> 64-bit product, both words
kept, as Philox uses it: beside one ``LOP3`` each), ``IMAD`` beside a
``LOP3`` chain, ``LOP3`` (``lop3.b32``), ``MUFU.EX2`` (``ex2.approx.ftz``)
and ``I2FP`` (``cvt.rn.f32.u32``). Each thread runs ``CHAINS`` independent
chains of the instruction, ``UNROLL`` steps a loop pass, on 2048 threads per
SM over every SM. The build's SASS (``cuobjdump -sass``) must hold the
instruction ``CHAINS * UNROLL`` times per loop pass (or a multiple where
``ptxas`` unrolled further) and few others; then reps are grown until a
call lasts 1 ms and the median of 7 CUDA-event timings gives thread
instructions per SM per clock at ``nvidia-smi clocks.max.sm``.

Prints one JSON line (``UNIT_RATES``, the card's name and power limit, SMs,
the clock before and after, and per instruction: its loop's opcodes, ms,
reps and rate) and, from it, how many slots of the integer multiply pipe an
``IMAD.WIDE`` takes: ``IMAD``'s rate over ``IMAD.WIDE``'s.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
CHAINS = 8
UNROLL = 16
THREADS = 256
PER_SM = 2048

# instruction -> (one step of chain c, the SASS opcode counted); a step takes
# the next chain's value where a constant operand would let ptxas fold two
# steps into one. "IMAD.WIDE" is a Philox round's half: a 32 x 32 -> 64-bit
# product of a constant, its high word XORed with two words (LOP3), its low
# word the next input; "IMAD+LOP3" runs an IMAD chain and a LOP3 chain side
# by side (two pipes, both instructions issued).
STEPS = {
    "FFMA": ("f[c] = fmaf(f[c], fa, fb);", "FFMA"),
    "IMAD": ('asm("mad.lo.u32 %0, %0, %1, %2;" : "+r"(x[c]) : "r"(a), '
             '"r"(x[(c + 1) % CHAINS]));', "IMAD"),
    "IMAD.HI": ('asm("mad.hi.u32 %0, %0, %1, %2;" : "+r"(x[c]) : "r"(a), '
                '"r"(x[(c + 1) % CHAINS]));', "IMAD.HI"),
    "IMAD.WIDE": ('{ uint64_t p; asm("mul.wide.u32 %0, %1, %2;" : "=l"(p) : '
                  '"r"(x[c]), "r"(a)); asm("lop3.b32 %0, %1, %2, %3, 0x96;" '
                  ': "=r"(x[c]) : "r"(static_cast<uint32_t>(p >> 32)), '
                  '"r"(y[c]), "r"(b)); y[c] = static_cast<uint32_t>(p); }',
                  "IMAD.WIDE"),
    "IMAD+LOP3": ('{ asm("mad.lo.u32 %0, %0, %1, %2;" : "+r"(x[c]) : '
                  '"r"(a), "r"(x[(c + 1) % CHAINS])); asm("lop3.b32 %0, %0, '
                  '%1, %2, 0x6a;" : "+r"(y[c]) : "r"(y[(c + 1) % CHAINS]), '
                  '"r"(b)); }', "IMAD"),
    "LOP3": ('asm("lop3.b32 %0, %0, %1, %2, 0x6a;" : "+r"(x[c]) : '
             '"r"(x[(c + 1) % CHAINS]), "r"(b));', "LOP3"),
    "MUFU.EX2": ('asm("ex2.approx.ftz.f32 %0, %0;" : "+f"(f[c]));',
                 "MUFU.EX2"),
    "I2FP": ('{ float t; asm("cvt.rn.f32.u32 %0, %1;" : "=f"(t) : '
             '"r"(x[c])); x[c] = __float_as_uint(t); }', "I2F"),
}


def source() -> str:
    kernels, cases = [], []
    for i, (name, (step, _)) in enumerate(STEPS.items()):
        kernels.append(f"""
__global__ void __launch_bounds__({THREADS})
k{i}(unsigned* out, int reps, uint32_t a, uint32_t b, float fa, float fb) {{
  const int i = blockIdx.x * {THREADS} + threadIdx.x;
  uint32_t x[{CHAINS}], y[{CHAINS}];
  float f[{CHAINS}];
#pragma unroll
  for (int c = 0; c < {CHAINS}; ++c) {{
    x[c] = i + c;
    y[c] = 3 * i + c;
    f[c] = 1e-3f * (i + c);
  }}
  for (int r = 0; r < reps; r += {UNROLL}) {{
#pragma unroll
    for (int k = 0; k < {UNROLL}; ++k) {{
#pragma unroll
      for (int c = 0; c < {CHAINS}; ++c) {step}
    }}
  }}
  uint32_t s = 0;
#pragma unroll
  for (int c = 0; c < {CHAINS}; ++c)
    s ^= x[c] ^ y[c] ^ __float_as_uint(f[c]);
  out[i] = s;
}}  // {name}
""")
        cases.append(f"    case {i}: k{i}<<<blocks, {THREADS}, 0, s>>>"
                     f"(out, reps, a, b, fa, fb); break;")
    return ("#include <cstdint>\n#include <cuda_runtime.h>\n"
            f"constexpr int CHAINS = {CHAINS};\n"
            + "".join(kernels) + f"""
extern "C" int unit_rate_launch(int op, unsigned* out, int blocks, int reps,
                                unsigned a, unsigned b, float fa, float fb,
                                void* stream) {{
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {{
{chr(10).join(cases)}
    default: return -1;
  }}
  return static_cast<int>(cudaGetLastError());
}}
""")


def tool(name: str) -> str:
    return shutil.which(name) or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", name)


def build(out_dir: Path) -> Path:
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "unit_rates.cu"
    cu.write_text(source())
    lib = out_dir / "libunit_rates.so"
    subprocess.run([tool("nvcc"), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
                    str(cu), "-o", str(lib)], check=True)
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--build", default=str(
        ROOT / "rescan_line_sted_torch" / "_build" / "unit_rates"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    lib_path = build(Path(args.build))
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.unit_rate_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_uint, ctypes.c_uint, ctypes.c_float,
                   ctypes.c_float, ctypes.c_void_p]
    sass = subprocess.run([tool("cuobjdump"), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = cs.max_sm_clock_hz()
    blocks = sms * PER_SM // THREADS
    out = torch.empty(blocks * THREADS, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    res = {"card": cs.card(), "sms": sms, "clock_max_sm_hz": clock,
           "clocks_before": cs.nvidia_smi("clocks.sm"),
           "guide_per_sm_per_clock": cs.UNIT_RATES, "ops": {}}
    for i, (name, (_, opcode)) in enumerate(STEPS.items()):
        ops = cs.sass_loop(sass, f"2k{i}P")
        hits = sum(op.startswith(opcode) and not op.startswith(opcode + "32I")
                   for op in ops)
        if opcode == "IMAD":    # not .HI, .WIDE, .MOV, .SHL, .IADD
            hits = sum(op in ("IMAD", "IMAD.U32") for op in ops)
        if hits == 0 or hits % (CHAINS * UNROLL):
            raise SystemExit(f"{name}: {hits} {opcode} in its loop, not a "
                             f"multiple of {CHAINS * UNROLL}: {Counter(ops)}")

        def run(reps, i=i):
            code = fn(i, out.data_ptr(), blocks, reps, 0x9E3779B9,
                      0xBB67AE85, 0.999999, 1e-7, stream)
            if code:
                raise RuntimeError(f"{name}: CUDA error {code}")

        reps = UNROLL
        while True:
            ms = cs.cuda_ms(lambda: run(reps), 3)
            if ms >= 1.0:
                break
            reps *= max(2, int(1.2 / max(ms, 1e-3)) + 1)
            reps = -(-reps // UNROLL) * UNROLL
        ms = cs.cuda_ms(lambda: run(reps))
        per_clock = blocks * THREADS * reps * CHAINS / (ms * 1e-3) / (
            sms * clock)
        res["ops"][name] = {"loop_opcodes": dict(Counter(ops)),
                            "per_pass": hits, "reps": reps, "ms": ms,
                            "per_sm_per_clock": per_clock}
    res["clocks_after"] = cs.nvidia_smi("clocks.sm")
    r = {k: v["per_sm_per_clock"] for k, v in res["ops"].items()}
    res["imad_wide_slots"] = r["IMAD"] / r["IMAD.WIDE"]
    print("UNIT_RATES " + json.dumps(res), flush=True)
    print(f"on {res['card']}, {sms} SMs at {clock / 1e6:.0f} MHz: "
          + ", ".join(f"{k} {v:.2f}" for k, v in r.items())
          + f" per SM per clock; IMAD.WIDE takes "
          f"{res['imad_wide_slots']:.3f} IMAD slots", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

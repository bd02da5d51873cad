#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``rescan_line_sted_torch/csrc`` (nvcc,
sm_90a), then:

1. prints the card (``nvidia-smi`` name and power limit);
2. checks the Poisson samplers K2b / K2c: moments, chi-square against the
   exact pmf (truncated where a tier truncates), zeros, NaN propagation and
   seeding, at 2^20 draws per rate; K2b and K2c count by count against
   their host reference (same Philox stream, ``flat=True`` for K2c's warps
   of 128 rates) at every rate below the bright tier, K2b also on rows of
   1, 3, 5 and 130 columns and a misaligned view with a CPU and a CUDA
   generator, and K2b's chi-square p over 16 seeds per single-draw tier;
   K2b and K2c with a CUDA generator, and a second per-step K3 line image
   (its plan cached by the line engine), under sync-debug mode "error";
3. holds kernel K1 (banded fused scan, its convolution in three TF32
   passes on the tensor cores) against its plain PyTorch version,
   noise-free, in each of its modes (max relative error <= 1e-5, logged
   beside the fp32 FFMA engine's 7.4e-7, with each case's shared-memory
   layout and grid; two noisy launches with one key give the same canvas
   bit for bit in every case): integer and class placement at the
   flagship shape (2048^2, R = 1.5, q = 2), at 2048^2 R = 2.0 and at
   512^2 R = 3.0, b = 2; NUFFT spreading at 2048^2
   R = 1 + pi/16 and 512^2 R = 1 + pi/8, b = 2; the wide layout (band
   windows D_in = D_out = 256, sigma_exc = 8) at 2048^2, R = 1.5 and
   R = 1 + pi/16; and a noisy class and NUFFT canvas total within 5 sigma;
4. drives ``rescanned_line_sted_image`` on each path, with the launch
   counters reset just before and read just after each: the flagship
   (2048^2, R = 1.5, chunk 32, depletion 8, siemens star; per-step,
   collapsed and analytic), the irrational cell (R = 1 + pi/16, same
   three), the wide-window cell (sigma_exc = 8, R = 1.5 and R = 1 + pi/16,
   per-step), and the flagship with ``boundary="padded"`` and
   ``"apodized"``; every noisy total within 5 sigma of its mean, noise-free
   scan vs analytic on a star with zeroed x-margins (R = 1.5 and 1 + pi/16)
   and padded scan vs padded analytic within 1e-5 (relative L2); K2c and
   its plain version on the flagship's noise-free canvas (totals,
   dispersion);
5. times every K1 mode, K2b and K2c against their plain versions (and
   ``torch.poisson``) and each rescan path's per-step image with CUDA
   events (median of 7 after warm-up), with each kernel's bound on this
   card, before any descanned phase runs; K2c also under the profiler and
   with a CUDA generator (its key words drawn and read on the card), with
   its warps' tier mix, and count by count against its host reference on
   the flagship canvas below the bright tier, with either generator;
   then K1's host bound: band windows beyond it (sigma_exc = 64, D_in =
   896) give the 2048^2 noise-free and per-step images with no K1 launch,
   and the card's image matches the CPU route's at 16 x 1024;
6. holds kernel K3 (descanned line scan) against its plain version,
   noise-free (max relative error <= 1e-5), at 512^2 and 2048^2 with the
   line settings (siemens star, depletion 8), at 512^2 with an undersized
   ``slit_support`` (mean rows) and with eff and gx rolled so that K3's
   tap run wraps past the last offset, and K3's noise-free 2048^2 image
   against the analytic one; noisy K3 at 256^2 over 24 draws: every
   total within 5 sigma, seed-mean and per-pixel variance / mean as the
   JAX suite holds the TPU kernel;
7. drives ``line_sted_image`` and ``point_sted_image`` on each path, the
   counters reset before and read after each: line 2048^2 (per-step on the
   default banded K2b route and with ``use_pallas=True`` on K3, collapsed,
   analytic), line 512^2 (both per-step routes), line 128^2 (default route:
   K3), point 512^2 (per-step, banded K2b), point 96^2 (per-step,
   full-frame K2b: below 256 columns the banded route needs
   ``chunk + 2 S_exc`` rounded up to 8 under the width, so 128^2 at chunk
   64 is banded, as in the JAX package) and point 2048^2 (collapsed,
   analytic); every noisy
   total within 5 sigma of its mean; noise-free scan against analytic
   (zeroed x-margins) and padded scan against padded analytic within 1e-5
   (relative L2) for each modality, and each K2b route with its draws
   replaced by the identity against the analytic image;
8. times K3 against its plain version and its bound (counted on this
   run's taps and rates), K2b on each caller's own frames, K2a's draws
   against ``torch.poisson`` on the same count, and each descanned path's
   per-step image with CUDA events; and the device time of one image of
   each descanned path and of the flagship under ``torch.profiler`` (the
   host's share is the rest);
9. holds kernel K4 (the full-frame rescan scan) against its plain
   version, noise-free (max relative error <= 1e-5), on the nobands_2048
   cell, at 512^2 with b = 2, with eff and gx rolled so that their tap runs
   wrap, with a full-width run (a flat excitation at 256^2) and with frame
   windows that wrap the camera columns in most chunks (256^2, b = 2),
   each case's chunks per placement path logged, and its draws at 256^2
   over 16 seeds; and K5 (the scatter-add) against its
   plain version with duplicate offsets and frames wider than the canvas,
   bit for bit the in-order per-frame adds where frames fit the canvas;
10. drives the rescan scan without band windows, counters reset before
   and read after each path: nobands_2048 (2048^2, R = 2, the stripe
   model flagged as not Gaussian: K4; noise-free held to K1's banded image
   of the same physics within 1e-5 relative L2), at 512^2 the subpixel
   per-step route (K2b on W-major frames), the ``use_pallas=False``
   scatter (K5) and collapsed noise with ``use_pallas=True`` (K4) and
   None (FFT phase accumulation), and rescan_128 (the default model: K4
   by default); each route with its draws replaced by the identity
   against the analytic image; then times K4 against its plain version
   and ``k4_bound``, K5 against its plain version and ``index_add_`` (event
   and device times, against its bytes bound), K2b on the hybrid's frames
   (count by count against its host reference with either generator),
   K2c on the scatter route's frames (as on the flagship canvas), and each
   new path's image (CUDA events and one profiler image);
11. drives ``rescanned_point_sted_image`` (ISM, POINT_KW, depletion 8) on
   each path, counters reset before and read after each: ism_2048 (2048^2,
   R = 2, canvas [4096, 4096]: analytic, and K2c on it), ism_256
   (``bench.py:395-410``: analytic, per-step scan with K2b once per chunk
   of 64, 1024 chunks, collapsed scan), ism_256_b2 (b = 2), ism_128_subpixel
   (R = 1.5) and padded / apodized at 256^2; every noisy total within 5
   sigma; noise-free scan, each K2b route with its draws replaced by the
   identity, and padded scan against their analytic canvases (relative L2
   <= 1e-5), apodized scan and analytic totals; the 512^2 analytic canvas
   (complex64 products on the card) against its complex128 closed form on
   the host; CUDA-event image times and one profiler image per path; K2b
   on ism_256's frames, timed and held count by count against its host
   reference with either generator (as on the line and point frames);
12. holds each K6 microkernel (``csrc/primitives.cu``) against its plain
   version on the inputs of its rate call, at the reps and constants of
   ``primitives.CHECKS`` (where a kernel that ran another count of reps
   fails), measures this card's primitive rates through
   ``primitives.primitive_rates`` (counters reset before and read after),
   holds place_add bit for bit on ``primitives.PLACE_CASES`` too,
   charges each rate's bound to the unit that limits it (the elementwise
   bodies' ``BODY_NEEDS``, the instructions one rep of the function
   needs, at sm_90's per-SM rates times this card's SMs and clock, each
   held under its count in the built library's SASS by ``cuobjdump``;
   place_add's read-modify-write at the shared-memory rate) and prints
   each body's rate, bound, unit and share,
   times the sgemm and tf32x3 rate calls' products in cuBLAS and
   place_add's sum as one ``index_add_``, and prints
   the composite bound (``primitives.composite_bound``) of K1 in each of
   its four modes (its convolution at the tf32x3 rate), K3 at line_2048
   and K4 at nobands_2048 beside their datasheet bounds (K1's three TF32
   passes at 495 TFLOP/s, and in fp32 FFMA; K4's also with one Philox
   block per draw), of K2c on the flagship canvas and the scatter frames
   and of K2b on each caller's frames, failing if a kernel runs under its
   composite;
13. drives the dose-matched sweep (``sweeps/dose.py``): the bench cell
   (``bench.py:413-459``: 256^2, POINT_KW / LINE_KW, 8 powers over [0,
   16], budget 100, point and line arms, a CUDA generator) with the
   counters reset before and read after (K2c once per arm and point, 16,
   nothing else), its noise-free columns on the card against
   ``device="cpu"`` (max relative error <= 1e-5 on every image, FWHM,
   emitted-signal and exposure column), its noisy totals within 5 sigma,
   K2c's counts on its second power's point and line images against the
   host reference (with either generator), the sweep under sync-debug mode (a CPU
   generator never syncs; a CUDA generator once, for its seed table), its
   time (CUDA events, median of 7), device-busy share (one profiled
   sweep) and speedup over the float64 oracle's cost per sweep (timed
   here as ``bench_oracle_sweep`` times it, ``bench.py:462-509``); then
   the figure sweep (four arms as ``pipelines/report.py:161-175`` sets
   them up, without fusion: 2048^2, powers 0, 4, 8, 16, two
   orientations, ``frc=True``, budget 5000): K2c twice per arm and point,
   every arm's fwhm_x falling with depletion, exposure times the card's
   dose ledger equal to the budget within 1e-5 (per orientation for the
   line arms), finite FRC resolutions >= 2 for point, line and ISM and
   finite per-axis ones for the rescan arm, every noisy total within 5
   sigma, and its time;
14. drives the resolution / FOV sweep (``sweeps/fov.py``, BASELINE config
   5): ``resolution_fov_sweep`` at 128^2, 256^2, 512^2
   (``fov_pipeline``'s sizes, ``pipelines/figures.py:403-412``) and
   2048^2 (``bench.py:321-353``), four orientations, 40 RL iterations,
   depletion 8, brightness 200, a CUDA generator, with the counters reset
   before and read after (K2c once per call, two per size, nothing else)
   and the JAX test's properties at every size (fused FWHM y under the
   view kernel's, scan steps 4 x FOV); on the card against
   ``device="cpu"``, noise-free, at 128^2 and 256^2 (max relative error
   <= 1e-5): the rotation (also at 2048^2), the orientation kernels, the
   views, the fused image after 40 iterations plain and accelerated, and
   every FWHM column of the records; K2c count by count against its host
   reference on the 256^2 views' rates with either generator; the scan
   method at 512^2 (per-step banded K2b once per chunk of each view,
   ``use_pallas=True`` K3 once per view, collapsed K2c once per view;
   noise-free scan views against the analytic ones; noisy totals within
   5 sigma); RL and one size of the sweep under sync-debug mode "error";
   and per size ``compile_s``, ``wall_s``, the views + RL time and
   device-busy share, the acquisition's time, RL's ms per iteration at
   512^2 and 2048^2, and K2c on the 2048^2 views;
15. drives operator fusion and the dose sweep's fused protocol
   (``algorithms/fusion.py``, ``fuse_orientations=True``; ``phase_fusion``)
   at four configurations, none cut, each with the counters reset before
   and read after its main call and held to the predicted launches:
   dose_sweep_fused (``pipelines/figures.py:114-180``: 256^2 star,
   default params at brightness 1, 16 powers over [0, 16], budget 100,
   two orientations, rescan R = 2, 30 RL iterations, a CUDA generator:
   K2c 48, nothing else), report_sweep_fused (``pipelines/report.py:
   145-175``: 192^2, 6 powers, four arms, ISM R = 2, ``frc=True``: K2c
   48), fusion_rescan_256 (``fusion_pipeline(modality="rescan")``: four
   noisy analytic canvases, K2c once, fused by 50 RL iterations) and
   fusion_rescan_2048_scan (the flagship's params and geometry: two scan
   views, K1 once each noise-free and K2c once each collapsed, fused by 30
   RL iterations, then two analytic views, K2c once); for each, the median
   of three timed calls with its spread, the device-busy share (the
   sweeps' on two of their powers, traced on the device alone) and the
   largest device rows; card against ``device="cpu"``, noise-free: every
   column of every arm of both sweeps (the 256^2 one on every fifth
   power) and the 256^2 canvases (max relative error <= 1e-5), the
   50-iteration fused image (relative L2 <= 1e-5, its max relative error
   printed), the 2048^2 operator's forward and adjoint and its
   adjointness, and the flagship's fusion at 512^2; noisy totals within 5
   sigma, FRC columns finite or NaN (no crossing) and above Nyquist; RL's
   ms per iteration at 2048^2;
16. drives the command line (``rescan_line_sted_torch/cli.py``;
   ``phase_cli``): every figure of ``figure all --size 256`` (comparison,
   the fused sweep of 16 powers in four checkpointed chunks, fusion,
   rescan, ism, fov at 128^2, 256^2 and 512^2, the animation and the
   report at 192^2) through ``cli.main`` in this process, each with the
   counters reset before and read after and held to the K2c launches
   worked out from the pipelines (``CLI_K2C``: 4, 48, 1, 2, 3, 6, 2, 51,
   nothing else), its last stdout line parsed as strict JSON, its TIFFs
   read back with the port's reader at their shapes, the animation's
   frames and the report's one data URI per frame and three sliders
   checked (rendered without matplotlib where it is missing); its first
   call's synced wall time, and one more call's wall time and device-busy
   share under the profiler; each figure at 64^2 on the card against
   ``--platform cpu`` (the noise-free metrics within 1e-5 relative);
   ``python -m rescan_line_sted_torch psf-report --depletion 8
   --vectorial`` as a subprocess (rc 0, strict JSON); and the native TIFF
   codec (built with g++ into the build directory, byte-identical to the
   pure-Python writer on a [16, 256, 256] float32 stack);
17. drives instrument calibration (``algorithms/calibration.py``;
   ``phase_calibration``): the JAX suite's three fits
   (``tests/test_calibration.py``) at the cells' widths, each whole under
   sync-debug mode "error" with the counters reset before and read after
   (no launch: the fits run the analytic engines): line at 2048^2 on a
   bead lattice (sigma_det 3.0 and s 5.0 from 2.0 / 1.0, 400 Adam steps),
   point at 2048^2 on the beads (sigma_det 2.2 and s 3.0 from 3.2 / 1.0,
   500 steps) and on the JAX test's six-spoke star (printed, not held) and
   ISM at 512^2, R = 2, on the star; each held to the JAX tolerances
   (|d sigma_det| < 0.1, |d s| < 0.3, final loss < 1e-2 of the first),
   with its ms per Adam step (CUDA events, median of 3), the busy share
   of a profiled 20-step fit and the aten ops and device kernels of one
   step (``step_counts``); the 128^2 line fit's 50 losses and fitted
   fields against ``device="cpu"`` (1e-4 relative); and the noise-free
   analytic forward fitted to noisy 2048^2 acquisitions through K3 (line,
   per-step, K3 once) and K2c (point, analytic, K2c once), held to the JAX
   tolerance widened by five shot-noise standard deviations of the
   least-squares fields (from the photon count, ``shot_noise_sd``);
18. drives ``parallel/`` (``phase_parallel``): a world of one rank over
   NCCL in this process (the flagship through ``rescanned_line_sted_image``
   on a row-sharded ``DTensor``, the gathered route, and through
   ``rescanned_line_sted_sharded``, whose halo is the block's own wrap
   rows; K1 once each, within 1e-5 of the unsharded K1 call), then a world
   of two gloo ranks sharing this card in spawned processes
   (``parallel_rank``): the flagship noise-free (K1 once per rank, within
   1e-5), the NUFFT case R = 1 + pi/16 (within 1e-5), per-step and
   collapsed noise (K1, and K2c on each rank's rows; totals within 5
   sigma), a sample repeating every H/2 rows whose identical blocks must
   draw different, uncorrelated counts (per-rank key words), and
   ``run_sharded_sweep`` of the 256^2 sweep cell at 16 powers (columns
   within 1e-5 of the unsharded sweep, noisy totals within 5 sigma, K2c
   16 per rank); ``--multihost psf-report`` under ``torch.distributed.run``
   with two processes (rc 0, ``process 0/2`` and ``1/2`` logged, each
   rank's report equal to one process's); the halo exchange's and each
   rank's K1 ms inside the sharded call, and the whole call's ms against
   the unsharded one's, one rank and two.

Prints a ``rule2`` line (K2b's, K2c's and K5's times against their
library call and their bounds, K1's four modes and K3 against their bounds
and composites with their launch shapes, K4's against its composite, with
its chunks per placement path; a kernel that misses its target does not
fail the run),
one JSON line with the kernels, then the card, then the result line
``{"ok": true, "device": {...}}``. Any failure raises (exit code != 0).
Without CUDA it exits with code 1 and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
LINE_KW = dict(sigma_exc=3.0, sigma_det=3.0, stripe_period=12.0,
               slit_halfwidth=4.0, brightness=1.0)
POINT_KW = dict(sigma_exc=3.0, sigma_det=3.0, sigma_dep=3.0,
                pinhole_radius=4.0, brightness=1.0)       # bench.py:77-80
N_DRAWS = 1 << 20
RATES = (0.0, -0.1, 5e-4, 0.05, 0.3, 0.7, 1.2, 5.0, 30.0, 1e3)
REPEATS = 7
SEEDS = 16                                    # K2b chi-square seeds per tier
SPREAD_RATES = (5e-4, 0.05, 0.3, 0.7, 1.2, 5.0)  # one per single-draw tier
DISP_MIN = 0.05      # dispersion over rates above this (bounded terms)
SIZE = 2048                                   # flagship grid (bench.py:335)
IRRATIONAL = 1.0 + math.pi / 16               # bench.py:355-374
WIDE_SIGMA = 8.0          # sigma_exc giving D_in = D_out = 256 at chunk 32
# K1 cases (size, R, b, sigma_exc), noise-free against the plain version
K1_CASES = ((SIZE, 1.5, 1, 3.0), (SIZE, 2.0, 1, 3.0), (512, 3.0, 2, 3.0),
            (SIZE, IRRATIONAL, 1, 3.0), (512, 1.0 + math.pi / 8, 2, 3.0),
            (SIZE, 1.5, 1, WIDE_SIGMA), (SIZE, IRRATIONAL, 1, WIDE_SIGMA))
# K1 modes: launch counter, the TPU code it replaces, the timed case
K1_MODES = {
    "rescan_banded_fused": (
        "rescan_line_sted_tpu/kernels/rescan_banded_fused.py:317",
        (SIZE, 1.5, 1, 3.0)),
    "rescan_banded_fused_spread": (
        "rescan_line_sted_tpu/kernels/rescan_banded_fused.py:244",
        (SIZE, IRRATIONAL, 1, 3.0)),
    "rescan_banded_fused_wide": (
        "rescan_line_sted_tpu/kernels/rescan_banded_fused.py:317",
        (SIZE, 1.5, 1, WIDE_SIGMA)),
    "rescan_banded_fused_spread_wide": (
        "rescan_line_sted_tpu/kernels/rescan_banded_fused.py:244",
        (SIZE, IRRATIONAL, 1, WIDE_SIGMA)),
}
K1_FFMA_REL = 7.4e-7      # K1's worst error with its fp32 FFMA engine
PEAK_FLOPS = 67e12        # H100 SXM fp32 outside the tensor cores
PEAK_TF32 = 495e12        # H100 SXM TF32 on the tensor cores, dense
PEAK_BYTES = 3.35e12      # H100 SXM HBM3

# ---- bounds charged to the unit that limits them ----------------------------

# sm_90's rates per SM per clock, in one thread's instructions (shared memory:
# bytes). From the CUDA C++ Programming Guide: the throughput table of
# "Arithmetic Instructions", column 9.0, unless named.
# scripts/torch_unit_rates.py measures the arithmetic ones on the card.
UNIT_RATES = {
    "FP32": 128,              # 32-bit fp add, multiply, multiply-add
    "integer multiply": 64,   # 32-bit integer multiply, multiply-add
    "ALU": 64,                # 32-bit integer add, shift, compare, min, max,
                              # bitwise (and the fp compares)
    "MUFU": 16,               # 32-bit fp rcp, rsqrt, log2, exp2, sin, cos
    "conversion": 16,         # "all other type conversions" (I2F, F2I, F2F)
    "I2FP": 64,               # sm_90's 32-bit int -> fp32 (I2FP.F32.U32):
                              # not in the table; 62.6 measured by the script
    "issue": 128,             # 4 warp schedulers, one warp instruction each a
                              # clock ("Compute Capability 9.x")
    "shared memory": 128,     # 32 banks of 4 bytes a clock ("Shared Memory")
}
# integer multiply slots of one IMAD.WIDE (a 32 x 32 -> 64-bit product, both
# words), as two 32-bit multiplies; IMAD's rate over IMAD.WIDE's, measured
# by scripts/torch_unit_rates.py on an H100 80GB HBM3 in Philox's pattern,
# is 2.17 (IMAD.HI's 2.03), so two does not overstate it
IMAD_WIDE_SLOTS = 2
# what a Philox-4x32-10 block needs wherever it is drawn: rounds 3 to 10, two
# 32 x 32 -> 64-bit products and two three-way XORs each. Rounds 1 and 2
# work on the counter and the key, which a stream holds or steps by a
# constant, so a build may hoist them or reach them by adds (the
# multi-draw stream's build does: 17.25 products a block).
PHILOX_BLOCK = {"product": 16, "ALU": 16}
# what one rep of each elementwise K6 body's function needs, in instructions
# by unit ("product": IMAD_WIDE_SLOTS integer multiply slots); loop control,
# index arithmetic and the uniform datapath are left out
BODY_NEEDS = {
    "fma": {"FP32": 1},                                  # FFMA
    # a block of which one word serves (the last round's one product, its
    # XOR left out); bits >> 9, I2F, the FFMA into (0, 1), the FADD
    "uniform": {"product": 15, "ALU": 14 + 1, "I2FP": 1, "FP32": 2},
    # a block, its four words each >> 9, I2F, FFMA, FADD
    "uniform_block": {"product": 16, "ALU": 16 + 4, "I2FP": 4, "FP32": 8},
    # expf (six FP32 ops, the exponent's shift, ex2) and the FMUL by scale
    "exp": {"FP32": 7, "MUFU": 1, "ALU": 1},
    "inv_term": {"FP32": 3, "ALU": 1},                   # FSET; FADD FMUL FADD
    # a quarter block; >> 9, I2F, FFMA; FMUL; FSET, FADD
    "knuth_round": {"product": 4, "ALU": 4 + 2, "I2FP": 1, "FP32": 3},
}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, what) -> None:
    """Raise (the run fails) unless ``ok``; ``what`` says what was held."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi(fields: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def card() -> str:
    return nvidia_smi("name,power.limit")


def clocks() -> str:
    return "clocks sm, max sm, mem: " + nvidia_smi(
        "clocks.sm,clocks.max.sm,clocks.mem")


def unit_work(needs: dict, count: float = 1.0) -> dict:
    """Operations by unit of ``UNIT_RATES`` of ``count`` times ``needs``
    (instructions by unit): a ``"product"`` takes IMAD_WIDE_SLOTS integer
    multiply slots, and every instruction one issue slot."""
    work = {"issue": count * sum(needs.values())}
    for unit, n in needs.items():
        if unit == "product":
            unit, n = "integer multiply", n * IMAD_WIDE_SLOTS
        work[unit] = work.get(unit, 0.0) + count * n
    return work


def add_work(*works: dict) -> dict:
    out: dict = {}
    for work in works:
        for unit, n in work.items():
            out[unit] = out.get(unit, 0.0) + n
    return out


def fma_philox_work(fma: float, blocks: float) -> dict:
    """K3's and K4's work by unit: ``fma`` FFMAs (FP32 and issue) and
    ``blocks`` times PHILOX_BLOCK (integer multiply, ALU and issue)."""
    return add_work(unit_work({"FP32": 1}, fma),
                    unit_work(PHILOX_BLOCK, blocks))


def unit_bound(work: dict, sms: int, clock_hz: float, nbytes: float = 0.0,
               hbm_bytes_per_s: float = PEAK_BYTES
               ) -> tuple[float, str, dict]:
    """The least time (ms) of ``work`` (unit -> operations, or bytes for
    shared memory, over the whole call) on a card of ``sms`` SMs at
    ``clock_hz``, each unit at its ``UNIT_RATES`` rate and in parallel
    with the others, against ``nbytes`` of device memory at
    ``hbm_bytes_per_s``; the unit that sets it (``"HBM"`` for the bytes)
    and every unit's time."""
    t = {u: 1e3 * n / (UNIT_RATES[u] * sms * clock_hz)
         for u, n in work.items() if n}
    t["HBM"] = 1e3 * nbytes / hbm_bytes_per_s
    unit = max(t, key=lambda u: (t[u], u != "issue"))   # a tie: the pipe
    return t[unit], unit, t


_MAX_CLOCK: list = []


def max_sm_clock_hz() -> float:
    """This card's maximum SM clock (``nvidia-smi clocks.max.sm``), read
    once: the clock of ``unit_bound``."""
    if not _MAX_CLOCK:
        _MAX_CLOCK.append(1e6 * float(nvidia_smi("clocks.max.sm").split()[0]))
    return _MAX_CLOCK[0]


def unit_roofline(work: dict, nbytes: float) -> tuple[float, str, str]:
    """``unit_bound`` on this card (its SMs from ``_build.sm_count``):
    the ms, ``"operations"`` or ``"bytes"``, and the unit that sets it."""
    from rescan_line_sted_torch.kernels import _build

    ms, unit, _ = unit_bound(work, _build.sm_count(torch.device("cuda", 0)),
                             max_sm_clock_hz(), nbytes)
    return ms, "bytes" if unit == "HBM" else "operations", unit


def sass_unit(op: str) -> str | None:
    """The unit of ``BODY_NEEDS`` one SASS instruction counts toward:
    ``"product"`` for ``IMAD.WIDE`` and ``IMAD.HI`` (the high word of a
    product whose low word is an ``IMAD``), ``"integer multiply"`` for
    the other ``IMAD``s; None for the uniform datapath (``U...``), memory
    and control."""
    base = op.split(".")[0]
    if base in ("FFMA", "FADD", "FMUL", "FFMA32I", "FADD32I", "FMUL32I"):
        return "FP32"
    if base in ("IMAD", "IMAD32I", "IMUL", "IMUL32I"):
        return ("product" if ".WIDE" in op or ".HI" in op
                else "integer multiply")
    if base == "MUFU":
        return "MUFU"
    if base == "I2FP":
        return "I2FP"
    if base in ("I2F", "F2I", "F2IP", "F2F", "F2FP", "FRND"):
        return "conversion"
    if base in ("IADD3", "IADD", "VIADD", "IADD32I", "LOP3", "LOP", "LOP32I",
                "SHF", "SHL", "SHR", "ISETP", "ISET", "FSETP", "FSET", "SEL",
                "FSEL", "FMNMX", "IMNMX", "VIMNMX", "LEA", "PRMT", "MOV",
                "MOV32I", "PLOP3", "IABS"):
        return "ALU"
    return None


_SASS_INS = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]\s+)?"
                       r"([A-Z][A-Z0-9_.]*)([^;]*);")
# an elementwise body's instruction that each rep issues a known number of
# times: the loop's count of it over that number is its reps
REP_MARKERS = {"fma": ("FFMA", 1), "uniform": ("I2F", 1),
               "uniform_block": ("I2F", 4), "exp": ("MUFU", 1),
               "inv_term": ("FMUL", 1), "knuth_round": ("FMUL", 1)}


def sass_loop(sass: str, kernel: str) -> list[str]:
    """The opcodes of the longest loop of ``kernel``'s SASS (``cuobjdump
    -sass`` text; ``kernel`` a part of its mangled name, e.g.
    ``14uniform_kernelE``): from a backward branch's target to the
    branch."""
    part = next((f for f in re.split(r"\n\s*Function : ", sass)[1:]
                 if kernel in f.split("\n", 1)[0]), None)
    if part is None:
        raise ValueError(f"no SASS function matching {kernel!r}")
    ins = [(int(a, 16), op, rest) for a, op, rest in _SASS_INS.findall(part)]
    loops = [(int(m.group(1), 16), a) for a, op, rest in ins
             if op.startswith("BRA")
             for m in [re.search(r"0x([0-9a-f]+)", rest)]
             if m and int(m.group(1), 16) < a]
    if not loops:
        raise ValueError(f"{kernel}: no loop in its SASS")
    lo, hi = max(loops, key=lambda l: l[1] - l[0])
    return [op for a, op, _ in ins if lo <= a <= hi]


def sass_counts(ops: list[str], marker: str, per_rep: int) -> dict:
    """Per rep, a loop body's instructions (``ops``) by ``sass_unit`` and
    in all (``instructions``), the loop's reps being its count of opcodes
    starting with ``marker`` over ``per_rep``."""
    marks = sum(op.startswith(marker) for op in ops)
    if marks == 0 or marks % per_rep:
        raise ValueError(f"{marks} {marker} in the loop: not a whole number "
                         f"of reps at {per_rep} each")
    reps = marks // per_rep
    counts = {"instructions": len(ops) / reps}
    for op in ops:
        unit = sass_unit(op)
        if unit:
            counts[unit] = counts.get(unit, 0.0) + 1 / reps
    return {"reps_per_loop": reps, **counts}


def sass_shortfall(needs: dict, counts: dict) -> dict:
    """The units in which a build's SASS per rep (``sass_counts``) holds
    fewer instructions than ``needs``: there the needs overcount, and a
    bound from them would be too long."""
    return {u: (counts.get(u, 0.0), n) for u, n in needs.items()
            if counts.get(u, 0.0) < n - 1e-9}


def event_ms(fn, repeats) -> list:
    """CUDA-event milliseconds of ``repeats`` calls of ``fn``."""
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def cuda_ms(fn, repeats: int = REPEATS) -> float:
    """Median milliseconds of ``fn()`` on the card (CUDA events, warm-up)."""
    fn()
    torch.cuda.synchronize()
    return float(np.median(event_ms(fn, repeats)))


SAMPLER_REPEATS = 21   # a sampler call's event time is mostly host time,
                       # which varies 2x from call to call: median of 21
QUEUED_CALLS = 100
SLEEP_CYCLES = 100_000_000     # ~0.05 s of the card's clock: longer than
                               # the host's launching of QUEUED_CALLS calls


def queued_ms(fn, calls: int = QUEUED_CALLS, repeats: int = 3) -> dict:
    """Device ms per call of ``fn()`` with the host's launch work hidden:
    the calls queue behind ``torch.cuda._sleep(SLEEP_CYCLES)``, so the card
    runs them back to back; CUDA events around ``calls`` calls, median of
    ``repeats``. ``hidden`` says whether the host's launching ended before
    the sleep did (else the time includes host time)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    end.record()
    end.synchronize()
    sleep_ms = start.elapsed_time(end)
    per, host = [], []
    for _ in range(repeats):
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        t0 = time.perf_counter_ns()
        for _ in range(calls):
            fn()
        host.append((time.perf_counter_ns() - t0) / 1e6)
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / calls)
    return {"device_ms": float(np.median(per)), "host_ms": max(host),
            "sleep_ms": sleep_ms, "hidden": max(host) < sleep_ms}


def host_us(fn, calls: int = 1000, batch: int = 100) -> float:
    """Mean host microseconds of ``fn()`` over ``calls`` calls (after a
    warm-up), in batches of ``batch`` with the card synchronised between
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


def cold_host_us(fn, repeats: int = REPEATS) -> float:
    """Median host microseconds of one ``fn()`` right after the card is
    synchronised, as ``cuda_ms`` calls it: the host part of a single
    call's event time."""
    fn()
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        fn()
        times.append((time.perf_counter_ns() - t0) / 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


def wrapper_host_us(lam, kernel, cpu_gen, dev_gen) -> dict:
    """Host microseconds of each step of a sampler wrapper (K2b, or K2c
    with its layout) on rates ``lam``, each timed alone (``host_us``): the
    checks, the output's allocation, the key words with either generator,
    K2c's layout, the stream's handle, the ctypes call with its launch and
    without (0 elements: the C entry returns before launching), the whole
    wrapper with either generator, and ``torch.poisson``'s host time on
    the same rates."""
    from rescan_line_sted_torch.kernels import _build
    from rescan_line_sted_torch.kernels.poisson import (
        flat_layout, poisson_flat)

    lib, dev = _build.lib(), lam.device
    out = torch.empty_like(lam)
    clamped = lam.clamp_min(0)
    stream = _build.stream_handle(dev)
    steps = {"checks": lambda: _build.require_cuda_f32("k", lam),
             "empty_like": lambda: torch.empty_like(lam),
             "key_words_cpu_generator": lambda: _build.key_words(cpu_gen, dev),
             "key_words_cuda_generator": lambda: _build.key_words(dev_gen,
                                                                  dev),
             "stream_handle": lambda: _build.stream_handle(dev)}
    if kernel is poisson_flat:
        per, blocks = flat_layout(lam.numel(), _build.sm_count(dev))
        steps["layout"] = lambda: flat_layout(lam.numel(),
                                              _build.sm_count(dev))
        steps["ctypes_launch"] = lambda: lib.rls_poisson_flat(
            lam.data_ptr(), out.data_ptr(), lam.numel(), 1, 2, None, per,
            blocks, stream)
        steps["ctypes_no_launch"] = lambda: lib.rls_poisson_flat(
            lam.data_ptr(), out.data_ptr(), 0, 1, 2, None, per, blocks,
            stream)
    else:
        cols = lam.shape[-1]
        steps["ctypes_launch"] = lambda: lib.rls_poisson_rows_tiered(
            lam.data_ptr(), out.data_ptr(), lam.numel() // cols, cols, 1, 2,
            None, stream)
        steps["ctypes_no_launch"] = lambda: lib.rls_poisson_rows_tiered(
            lam.data_ptr(), out.data_ptr(), 0, cols, 1, 2, None, stream)
    steps["wrapper_cpu_generator"] = lambda: kernel(lam, cpu_gen)
    steps["wrapper_cuda_generator"] = lambda: kernel(lam, dev_gen)
    steps["torch_poisson"] = lambda: torch.poisson(clamped, dev_gen)
    return {k: host_us(fn) for k, fn in steps.items()}


def tier_kmax(lam: float) -> int | None:
    """The count at which K2a's tier for a constant rate ``lam`` truncates
    (its excess mass lands there); None for the untruncated bright tier."""
    from rescan_line_sted_torch.kernels.poisson import _INV_TIERS

    if lam < 1e-3:
        return 1
    return next((k for hi, k in _INV_TIERS if lam < hi), None)


def check_counts(name: str, x: torch.Tensor, lam: float,
                 trunc: int | None = None) -> dict:
    """Moments and chi-square of counts ``x`` drawn at constant ``lam``
    against the Poisson pmf, truncated at ``trunc`` with the tail mass on
    it (the tiered sampler's documented semantics)."""
    from scipy import stats

    v = x.double().cpu().numpy().ravel()
    n = v.size
    if lam <= 0.0:
        check((v == 0).all(),
              f"{name}: rate {lam} gave nonzero counts")
        return {"rate": lam, "mean": 0.0}
    check(np.isfinite(v).all() and (v >= 0).all()
          and (v == np.round(v)).all(),
          f"{name}: counts must be finite non-negative integers")
    mean, var = v.mean(), v.var()
    check(abs(mean - lam) <= 5 * math.sqrt(lam / n),
          (name, lam, mean))
    check(abs(var - lam) <= 5 * math.sqrt((lam + 2 * lam * lam) / n),
          (name, lam, var))
    kmax = trunc if trunc is not None else int(lam + 8 * math.sqrt(lam) + 10)
    k = np.arange(kmax + 1)
    pmf = stats.poisson.pmf(k, lam)
    pmf[-1] += stats.poisson.sf(kmax, lam)
    exp = pmf * n
    obs = np.bincount(v.astype(np.int64), minlength=kmax + 1)[:kmax + 1]
    keep = exp > 5
    chi2 = float(((obs[keep] - exp[keep]) ** 2 / exp[keep]).sum())
    p = float(stats.chi2.sf(chi2, max(int(keep.sum()) - 1, 1)))
    # a wrong tier or stream fails by many orders of magnitude; 1e-6 keeps
    # the false-alarm rate of the phase's 16 chi-square tests near 2e-5
    check(p > 1e-6,
          (name, lam, chi2, p))
    return {"rate": lam, "mean": float(mean), "var": float(var), "p": p}


def phase_sampler(dev) -> dict:
    from rescan_line_sted_torch.kernels.poisson import (
        poisson_flat, poisson_reference, poisson_rows_tiered)

    worst = {"poisson_rows_tiered": 0.0, "poisson_flat": 0.0}
    for lam in RATES:
        rate = torch.full((1024, 1024), lam, device=dev)
        plain = poisson_reference(rate, torch.Generator(dev).manual_seed(9))
        p_mean = float(plain.double().mean())
        for name, fn in (("poisson_rows_tiered", poisson_rows_tiered),
                         ("poisson_flat", poisson_flat)):
            x = fn(rate, torch.Generator().manual_seed(int(lam * 1000) + 1))
            res = check_counts(name, x, lam, tier_kmax(lam))
            if lam > 0:
                err = abs(res["mean"] - p_mean)
                check(err <= 5 * math.sqrt(2 * lam / N_DRAWS),
                      (name, lam))
                worst[name] = max(worst[name], err)
            log(f"sampler {name} {json.dumps(res)}")

    # K2b tiers side by side in one tensor (warp-level tier choice)
    bands = [(0.05, 100), (0.8, 200), (6.0, 300), (40.0, 400), (2e-4, 500)]
    rate = torch.zeros((1024, 512), device=dev)
    for lam, r0 in bands:
        rate[r0:r0 + 32] = lam
    x = poisson_rows_tiered(rate, torch.Generator().manual_seed(5))
    for lam, r0 in bands:
        m = float(x[r0:r0 + 32].double().mean())
        check(abs(m - lam) <= 5 * math.sqrt(lam / (32 * 512)),
              f"mixed tiers: rate {lam} band mean {m}")
    check(float(x[:100].abs().sum()) == 0.0,
          "mixed tiers: zero-rate rows gave counts")

    for name, fn in (("poisson_rows_tiered", poisson_rows_tiered),
                     ("poisson_flat", poisson_flat)):
        rate = torch.full((256, 256), 3.0, device=dev)
        rate[7, 9] = float("nan")
        rate[0, 0] = -2.0
        a, b, c = (fn(rate, torch.Generator().manual_seed(s)).nan_to_num(-1)
                   for s in (11, 11, 12))
        check(float(a[7, 9]) == -1 and int((a < 0).sum()) == 1,
              f"{name}: NaN rate must give NaN, and only there")
        check(float(a[0, 0]) == 0.0,
              f"{name}: negative rate must give 0")
        check(torch.equal(a, b),
              f"{name}: same seed, different counts")
        check(not torch.equal(a, c),
              f"{name}: new seed, same counts")
    torch.cuda.synchronize()
    worst["k2b_draw_for_draw"] = max(draw_for_draw(dev), k2b_ragged(dev))
    worst["k2c_draw_for_draw"] = draw_for_draw(dev, flat=True)
    k2c_layouts(dev)
    generator_key_path(dev)
    no_sync(dev)
    k2b_seed_spread(dev)
    log(f"sampler phase passed: max |mean(kernel) - mean(plain)| {worst}")
    return worst


def host_key(generator) -> tuple[int, int]:
    """The two Philox key words ``_build.key_words`` takes from
    ``generator`` (the kernels' key), by value: a CUDA generator's come
    from its seed and offset, with no device work."""
    from rescan_line_sted_torch.kernels import _build

    s0, s1, keys = _build.key_words(generator, generator.device)
    check(keys is None, "key words must come by value outside capture")
    return s0, s1


def k2c_layouts(dev) -> None:
    """K2c's one-element-per-thread layout against its four-element one,
    count for count under one key: on the dose sweep's point image at
    s = 0 (nearly every group bright: Knuth and PTRS) and on a ragged
    length with NaN and negative rates and a misaligned start."""
    from rescan_line_sted_torch.kernels.poisson import poisson_flat
    from rescan_line_sted_torch.sweeps import dose_matched_sweep

    g = torch.Generator().manual_seed(8)
    ragged = 4.0 * torch.rand(100003 + 1, generator=g) - 1.0
    ragged[1::1013] = float("nan")
    cases = {"dose_sweep point image 0": dose_matched_sweep(
                 **bench_sweep_args(dev)).point.image[0].contiguous(),
             "ragged, NaN and negative": ragged.to(dev)[1:]}
    for name, lam in cases.items():
        one, four = (poisson_flat(lam, key=(17, 23), _per_thread=p)
                     for p in (1, 4))
        same = torch.equal(one.nan_to_num(-1), four.nan_to_num(-1))
        log(f"K2c layouts on {name} {list(lam.shape)}: one and four "
            f"elements per thread {'equal' if same else 'DIFFER'}, "
            f"{int((one.nan_to_num(-1) != four.nan_to_num(-1)).sum())} "
            f"counts apart, NaN {int(torch.isnan(one).sum())}")
        check(same and torch.equal(torch.isnan(one), torch.isnan(lam))
              and bool((one[lam <= 0] == 0).all()),
              f"K2c layouts on {name}: counts must be identical")


def generator_key_path(dev) -> None:
    """The CUDA generator's key words by value: consecutive takes from one
    generator give new words (its offset advances by 4), a generator
    seeded alike gives the same words, and K2b's and K2c's counts follow
    them: new counts from consecutive calls, the same from a re-seeded
    generator."""
    from rescan_line_sted_torch.kernels.poisson import (
        poisson_flat, poisson_rows_tiered)

    gen = torch.Generator(dev).manual_seed(77)
    words = [host_key(gen) for _ in range(3)]
    check(len(set(words)) == 3 and gen.get_offset() == 12,
          f"consecutive key words must differ: {words}")
    check(host_key(torch.Generator(dev).manual_seed(77)) == words[0],
          "a generator seeded alike must give the same key words")
    lam = 3.0 * torch.rand((64, 2048), generator=torch.Generator(
        ).manual_seed(3)).to(dev)
    for fn in (poisson_rows_tiered, poisson_flat):
        gen = torch.Generator(dev).manual_seed(78)
        a, b = fn(lam, gen), fn(lam, gen)
        again = fn(lam, torch.Generator(dev).manual_seed(78))
        check(not torch.equal(a, b) and torch.equal(a, again),
              f"{fn.__name__}: a CUDA generator's consecutive calls must "
              "differ, and a re-seeded one repeat them")
    log(f"CUDA generator key words by value: {json.dumps(words)}; "
        "consecutive calls differ, a re-seeded generator repeats them")


def no_sync(dev) -> None:
    """K2b and K2c with a CUDA generator, and a second per-step line image
    on K3 (512^2, ``use_pallas=True``, a CUDA generator), under
    ``torch.cuda.set_sync_debug_mode("error")``: the key words come from
    the generator's seed and offset on the host and K3's plan from the
    line engine's cache, so nothing synchronises (a sync raises)."""
    from rescan_line_sted_torch.kernels import _build
    from rescan_line_sted_torch.kernels.poisson import (
        poisson_flat, poisson_rows_tiered)

    lam = torch.rand((64, 2048), generator=torch.Generator().manual_seed(2)
                     ).to(dev)
    for fn in (poisson_rows_tiered, poisson_flat):
        gen = torch.Generator(dev).manual_seed(4)
        fn(lam, gen)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn(lam, gen)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    # K3 through the line engine: the second image of one set of params
    # takes its rows, weights and tap run from the engine's cache
    from rescan_line_sted_torch import line_sted_image
    from rescan_line_sted_torch.data import siemens_star

    params, geom = line_setup(512)
    star = siemens_star((512, 512), device=dev)
    gen = torch.Generator(dev).manual_seed(4)
    before = _build.LAUNCHES["line_sted_fused"]

    def k3_image():
        return line_sted_image(star, params, geom, gen, method="scan",
                               noise_mode="per_step", use_pallas=True).image

    k3_image()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        k3_image()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    check(_build.LAUNCHES["line_sted_fused"] == before + 2,
          "the K3 line image must launch K3")
    log("K2b and K2c with a CUDA generator, and K3's second line image, "
        "under sync-debug mode 'error': no sync")


def k2b_ragged(dev) -> float:
    """K2b count by count against its host reference on rows of 1, 3, 5
    and 130 columns (warps that end inside a Philox block or a row) and on
    a view that does not start on 16 bytes (the scalar path), with a CPU
    and a CUDA generator; returns the max abs difference."""
    worst = 0.0
    for cols, shift in ((1, 0), (3, 0), (5, 0), (130, 0), (2048, 1)):
        rows = 4096 // max(1, cols // 64)
        g = torch.Generator().manual_seed(cols)
        full = (1.5 * torch.rand(rows * cols + shift, generator=g)).to(dev)
        lam = full[shift:].reshape(rows, cols)
        check((lam.data_ptr() % 16 == 0) == (shift == 0),
              "K2b's misaligned case must not start on 16 bytes")
        for gen in (lambda: torch.Generator().manual_seed(41),
                    lambda: torch.Generator(dev).manual_seed(41)):
            res = frames_draw_for_draw(f"[{rows}, {cols}] + {shift}", lam,
                                       generator=gen)
            worst = max(worst, res["max_abs_diff"])
    return worst


def draw_for_draw(dev, flat: bool = False) -> float:
    """K2b (``flat``: K2c) against its host reference on the same Philox
    stream, count by count, at every rate below the bright tier. A count
    may differ by one only where its uniform sits on a CDF boundary (the
    card's expf and CDF sums round differently by an ulp); returns the max
    abs difference."""
    from scipy import stats

    from rescan_line_sted_torch.kernels.poisson import (
        _CUT, poisson_flat, poisson_rows_tiered,
        poisson_rows_tiered_reference, single_draw_uniforms)

    kernel, name = ((poisson_flat, "K2c") if flat
                    else (poisson_rows_tiered, "K2b"))
    worst = 0.0
    for i, lam in enumerate(RATES):
        if lam >= _CUT:
            continue
        rate = torch.full((1024, 1024), lam, device=dev)
        got = kernel(rate, torch.Generator().manual_seed(100 + i)).cpu()
        key = host_key(torch.Generator().manual_seed(100 + i))
        diff = (got - poisson_rows_tiered_reference(rate, key, flat)).abs()
        bad = torch.nonzero(diff.reshape(-1)).flatten().numpy()
        gap = 0.0
        if bad.size:
            u = single_draw_uniforms(N_DRAWS, key)[bad].astype(np.float64)
            cdf = stats.poisson.cdf(np.arange(32), lam)
            gap = float(np.abs(u[:, None] - cdf[None, :]).min(axis=1).max())
        log(f"{name} vs host reference at rate {lam}: {bad.size} of "
            f"{N_DRAWS} counts differ, max abs diff {float(diff.max()):.0f}, "
            f"max |u - F(k)| of those {gap:.2e}")
        check(float(diff.max()) <= 1 and bad.size <= 16 and gap <= 1e-6,
              f"{name} vs host reference at rate {lam}: {bad.size} counts "
              f"differ, max |u - F(k)| {gap}")
        worst = max(worst, float(diff.max()))
    return worst


def frames_draw_for_draw(name: str, frames: torch.Tensor,
                         flat: bool = False, generator=None,
                         counts=None) -> dict:
    """K2b (``flat``: K2c) against its host reference on a caller's frames
    (rates varying over the frame, per-warp tiers), count by count under
    one key, on every warp below the bright cut (a bright warp draws Knuth
    / PTRS, which the host reference does not cover). As in
    ``draw_for_draw``, a count may differ by one only where its uniform
    sits within 1e-6 of a CDF value at its own rate, at most 16 per 2^20
    elements. ``generator``: a CUDA generator's seed instead of the CPU
    one (K2c then reads its key words on the card). ``counts``: counts a
    caller drew on rates ``frames`` with a generator in the state of
    ``generator()``, held instead of a fresh launch."""
    from scipy import stats

    from rescan_line_sted_torch.kernels.poisson import (
        _CUT, poisson_flat, poisson_rows_tiered,
        poisson_rows_tiered_reference, single_draw_uniforms, warp_tiers)

    kernel = poisson_flat if flat else poisson_rows_tiered
    make = generator or (lambda: torch.Generator().manual_seed(41))
    lam = frames.detach().float().cpu().clamp_min(0)
    got = (kernel(frames.contiguous(), make()) if counts is None
           else counts).cpu()
    key = host_key(make())
    bright = warp_tiers(lam, flat) >= _CUT
    want = poisson_rows_tiered_reference(torch.where(bright, 0.0, lam), key,
                                         flat)
    diff = torch.where(bright, 0.0, (got.reshape(lam.shape) - want).abs())
    bad = torch.nonzero(diff.reshape(-1)).flatten().numpy()
    gap = 0.0
    if bad.size:
        u = single_draw_uniforms(lam.numel(), key)[bad].astype(np.float64)
        rate = lam.reshape(-1)[bad].double().numpy()
        cdf = stats.poisson.cdf(np.arange(32)[None, :], rate[:, None])
        gap = float(np.abs(u[:, None] - cdf).min(axis=1).max())
    res = {"shape": list(frames.shape), "compared": int((~bright).sum()),
           "differ": int(bad.size), "max_abs_diff": float(diff.max()),
           "max_gap": gap}
    log(f"{'K2c' if flat else 'K2b'} vs host reference on {name}, count by "
        f"count: {json.dumps(res)}")
    check(res["compared"] > 0 and res["max_abs_diff"] <= 1
          and bad.size <= 16 * max(1, lam.numel() >> 20) and gap <= 1e-6,
          f"{'K2c' if flat else 'K2b'} vs host reference on {name}: {res}")
    return res


def k2b_seed_spread(dev) -> None:
    """K2b's chi-square p at one rate per single-draw tier over SEEDS
    seeds (the first is the sampler loop's); the p values of a right
    sampler are uniform, so a Kolmogorov-Smirnov test holds them to it."""
    from scipy import stats

    from rescan_line_sted_torch.kernels.poisson import poisson_rows_tiered

    for lam in SPREAD_RATES:
        rate = torch.full((1024, 1024), lam, device=dev)
        s0 = int(lam * 1000) + 1
        ps = np.array([check_counts(
            "poisson_rows_tiered",
            poisson_rows_tiered(rate, torch.Generator().manual_seed(s)),
            lam, tier_kmax(lam))["p"] for s in range(s0, s0 + SEEDS)])
        ks = float(stats.kstest(ps, "uniform").pvalue)
        log(f"K2b chi-square p over {SEEDS} seeds at rate {lam}: "
            f"min {ps.min():.3e} median {np.median(ps):.3f} "
            f"max {ps.max():.3f}; KS p vs uniform {ks:.3f}; "
            f"all {json.dumps([float(f'{p:.4g}') for p in ps])}")
        check(ks > 1e-6, f"K2b p values at rate {lam} not uniform: KS p {ks}")


def flagship(size=None, rescan_factor=1.5, binning=1, sigma_exc=3.0):
    from rescan_line_sted_torch import Grid, LineSTEDParams, RescanGeometry

    size = size or SIZE
    geom = RescanGeometry(Grid(size, size), rescan_factor=rescan_factor,
                          binning=binning, chunk=32)
    kw = dict(LINE_KW, sigma_exc=sigma_exc)
    return LineSTEDParams.create(depletion=8.0, **kw), geom


def k1_inputs(case, dev):
    """The scan's own K1 inputs for a (size, R, b, sigma_exc) case: the
    y-convolved sample and the entry's K1 plan."""
    from rescan_line_sted_torch.data import siemens_star
    from rescan_line_sted_torch.imaging.rescan import _banded_inputs

    size, rf, b, sig = case
    params, geom = flagship(size, rf, b, sig)
    sample_y, plan, _ = _banded_inputs(
        siemens_star((size, size), device=dev), params, geom)
    return sample_y, plan


def k1_counts(sample_y, plan) -> dict:
    """K1's work on these inputs: the convolution's fp32 FMAs over each
    frame's band (on the tensor cores, three TF32 passes each: 32 rows x 8
    columns x H/b lanes a group-k-step, ``band_k_steps``), the spreading
    taps' FMAs (FFMA) and the frame elements it places."""
    from rescan_line_sted_torch.kernels.rescan_banded_fused import (
        band_k_steps)

    h, w = sample_y.shape
    b = plan.binning
    dob, hb = plan.d_out // b, h // b
    steps = band_k_steps(plan.d_in, dob, plan.chunk, b, plan.supports)[0]
    n = {"tc_fma": w // plan.chunk * steps * 32 * 8 * hb, "conv_fma": 0,
         "placed": w * dob * hb}
    if plan.n_spread:
        taps = 2 * plan.n_spread                      # 2 parities x n_spread
        n["conv_fma"] = w * dob * hb * taps
        n["placed"] = w * (2 * dob + taps - 2) * hb
    return n


def k1_bound(sample_y, plan) -> tuple[float, str, float]:
    """Least time (ms) of one K1 call on this card, and what bounds it:
    the convolution's three TF32 passes at the tensor cores' TF32 peak
    plus the spreading taps at the fp32 peak, against the sample read once
    and the canvas written once; and the same bound with the convolution
    in fp32 FFMA (what bounded K1 before its tensor-core engine)."""
    h, w = sample_y.shape
    n = k1_counts(sample_y, plan)
    nbytes = 4 * ((w + plan.d_in) * h
                  + plan.q * plan.wc * (h // plan.binning))
    tc = roofline(2.0 * n["conv_fma"], nbytes, tc_flops=6.0 * n["tc_fma"])
    fp32 = roofline(2.0 * (n["conv_fma"] + n["tc_fma"]), nbytes)
    return tc[0], tc[1], fp32[0]


def roofline(flops: float, nbytes: float,
             tc_flops: float = 0.0) -> tuple[float, str]:
    """Least time (ms): fp32 ``flops`` at the fp32 peak plus TF32
    ``tc_flops`` at the tensor cores' peak, or ``nbytes`` at the memory
    rate, whichever is longer; and which."""
    t_ops = flops / PEAK_FLOPS + tc_flops / PEAK_TF32
    t_bytes = nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def phase_k1(dev) -> dict:
    """K1 against its plain version in every mode; returns the worst
    absolute and relative error per mode (launch counter name)."""
    from rescan_line_sted_torch.kernels import _build
    from rescan_line_sted_torch.kernels.rescan_banded_fused import (
        rescan_banded_fused, rescan_banded_fused_reference)

    from rescan_line_sted_torch.kernels.rescan_banded_fused import (
        LAUNCH_SHAPE, band_k_steps)

    worst = {}
    for case in K1_CASES:
        sample_y, plan = k1_inputs(case, dev)
        before = dict(_build.LAUNCHES)
        got = rescan_banded_fused(sample_y, plan)
        mode = next(k for k, v in _build.LAUNCHES.items() if v != before[k])
        want = rescan_banded_fused_reference(sample_y, plan)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        log(f"K1 {mode} vs plain {case[0]}^2 R={case[1]:.6f} b={case[2]} "
            f"sigma_exc={case[3]} q={got.shape[0]} d_in={plan.d_in} "
            f"d_out={plan.d_out}: max abs err {err:.3e}, "
            f"max rel err {rel:.3e} (three TF32 passes; the fp32 FFMA "
            f"engine before them: <= {K1_FFMA_REL:.1e}); launch "
            f"{json.dumps(LAUNCH_SHAPE[mode])}")
        check(got.shape == want.shape and rel <= 1e-5,
              f"K1 {mode} vs plain at {case}: rel err {rel}")
        steps, whole = band_k_steps(plan.d_in, plan.d_out // case[2],
                                    plan.chunk, case[2], plan.supports)
        shape = LAUNCH_SHAPE[mode]
        log(f"K1 {mode} band at {case}: supports {plan.supports}, "
            f"{steps} of {whole} group-k-steps a chunk "
            f"(band_share {shape['band_share']:.4f})")
        check(shape["band_k_steps"] == steps
              and shape["band_share"] == steps / whole,
              f"K1 {mode} at {case}: recorded band {shape} is not the "
              f"host's {steps} / {whole}")
        w0 = worst.setdefault(mode, {"abs": 0.0, "rel": 0.0})
        worst[mode] = {"abs": max(w0["abs"], err), "rel": max(w0["rel"], rel)}
        # the same key twice: the same canvas bit for bit
        twice = [rescan_banded_fused(
            sample_y, plan, generator=torch.Generator().manual_seed(21))
            for _ in range(2)]
        check(torch.equal(twice[0], twice[1]),
              f"K1 {mode} at {case}: two launches with one key differ")
        del twice
        if case in (K1_CASES[0], K1_CASES[3]):
            k1_noisy_total(sample_y, plan, want, mode)
    missing = set(K1_MODES) - set(worst)
    check(not missing, f"K1 modes never taken: {missing}")
    log("K1: every case's noisy canvas the same bit for bit over two "
        "launches with one key")
    return worst


def k1_noisy_total(sample_y, plan, clean, mode) -> None:
    """A noisy K1 canvas: finite, non-negative (integer counts where each
    lands whole), its total within 5 sigma of the noise-free total. With
    spreading a count n of position c adds n * S_c (S_c: the sum of c's
    taps), so Var(total) = sum_c S_c^2 mu_c <= max S_c * total."""
    from rescan_line_sted_torch.kernels.rescan_banded_fused import (
        rescan_banded_fused)

    noisy = rescan_banded_fused(sample_y, plan,
                                generator=torch.Generator().manual_seed(3))
    total = float(noisy.double().sum())
    mu = float(clean.double().sum())
    scale = 1.0
    if plan.n_spread:
        scale = float(plan.taps.double().sum(1).max())
    else:
        check(torch.equal(noisy, noisy.round()),
              f"K1 {mode} noisy canvas must hold integer counts")
    check(torch.isfinite(noisy).all() and (noisy >= 0).all(),
          f"K1 {mode} noisy canvas must be finite and non-negative")
    z = (total - mu) / math.sqrt(scale * mu)
    log(f"K1 {mode} noisy total {total:.1f} vs noise-free {mu:.1f} "
        f"({z:+.2f} sigma)")
    check(abs(z) <= 5, f"K1 {mode} noisy total {total} vs noise-free {mu}")


def drive(name, fn):
    """Run one path with every launch counter set to 0 just before and
    read just after; returns fn's result and the counts that moved."""
    from rescan_line_sted_torch.kernels import _build

    _build.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    log(f"path {name}: launches {json.dumps(launches)}")
    return out, launches


def noisy_path(name, sample, params, geom, n_per_step=2, others=True):
    """Drive a noise-free scan, ``n_per_step`` per-step scans and (with
    ``others``) a collapsed scan and a noisy analytic image; each noisy
    total must lie within 5 sigma of its Poisson mean. Returns the
    noise-free canvas and the path's launch counts."""
    from rescan_line_sted_torch import rescanned_line_sted_image as image

    gen = torch.Generator().manual_seed(2024)

    def run():
        clean = image(sample, params, geom, method="scan").image
        imgs = [image(sample, params, geom, gen, method="scan",
                      noise_mode="per_step").image
                for _ in range(n_per_step)]
        if others:
            imgs += [image(sample, params, geom, gen, method="scan").image,
                     image(sample, params, geom, gen).image]
        return clean, imgs

    (clean, imgs), launches = drive(name, run)
    check(clean.shape == geom.canvas_shape,
          f"{name}: canvas shape {tuple(clean.shape)} != {geom.canvas_shape}")
    # per-step noise draws every (non-negative) frame element, and the
    # class residues / NUFFT deconvolution keep the sum; collapsed /
    # analytic noise draws the clamped canvas
    total = float(clean.double().sum())
    means = [total] * n_per_step
    if others:
        clean_ana = image(sample, params, geom).image
        means += [float(clean.clamp_min(0).double().sum()),
                  float(clean_ana.clamp_min(0).double().sum())]
        for img in imgs[n_per_step:]:
            check((img >= 0).all() and torch.equal(img, img.round()),
                  f"{name}: collapsed / analytic noise must give "
                  "non-negative counts")
    for img, mu in zip(imgs, means):
        check(img.shape == geom.canvas_shape and torch.isfinite(img).all(),
              f"{name}: noisy image must be finite with the canvas shape")
        t = float(img.double().sum())
        # per-step subpixel canvases place integer counts band-limitedly,
        # which rings below zero (rescan module doc); K1's own noisy output
        # is checked non-negative in phase_k1
        neg = float(img.clamp_max(0).double().sum())
        log(f"{name}: image total {t:.1f} vs mean {mu:.1f} "
            f"({(t - mu) / math.sqrt(mu):+.2f} sigma), "
            f"negative mass {neg / t:.2e}")
        check(abs(t - mu) <= 5 * math.sqrt(mu),
              f"{name}: noisy total {t} not within 5 sigma of its mean {mu}")
    check(not torch.equal(imgs[0], imgs[1]),
          f"{name}: two noisy images from one generator must differ")
    return clean, launches


def rel_l2(got, want) -> float:
    return float((got - want).double().norm() / want.double().norm())


def scan_vs_analytic(name, sample, params, geom, image=None, **kw) -> float:
    """Noise-free scan against the analytic image (relative L2), through
    ``image`` (default: ``rescanned_line_sted_image``)."""
    if image is None:
        from rescan_line_sted_torch import rescanned_line_sted_image as image

    scan = image(sample, params, geom, method="scan", **kw).image
    ana = image(sample, params, geom, **kw).image
    rel = rel_l2(scan, ana)
    rel_max = float((scan - ana).abs().max() / ana.abs().max())
    log(f"{name}: scan vs analytic rel err {rel:.3e} (max-rel {rel_max:.3e})")
    return rel


def zero_margins(sample, margin=64):
    out = sample.clone()
    out[:, :margin] = 0
    out[:, -margin:] = 0
    return out


def phase_e2e(dev) -> dict:
    """Every path through ``rescanned_line_sted_image``; returns each
    path's launch counts."""
    from rescan_line_sted_torch import rescanned_line_sted_image as image
    from rescan_line_sted_torch.data import siemens_star

    sample = siemens_star((SIZE, SIZE), device=dev)
    paths = {}

    params, geom = flagship()
    clean, paths["flagship"] = noisy_path("flagship", sample, params, geom,
                                          n_per_step=3)
    check(paths["flagship"].get("rescan_banded_fused", 0) >= 5,
          f"flagship must launch K1 for every scan image: {paths}")
    check(paths["flagship"].get("poisson_flat", 0) >= 2,
          f"collapsed and analytic noise must launch K2c: {paths}")
    k2c_on_canvas(clean, dev)
    rel = scan_vs_analytic("flagship (zero x-margins)", zero_margins(sample),
                           params, geom)
    check(rel <= 1e-5, f"flagship scan vs analytic rel err {rel}")

    params, geom = flagship(rescan_factor=IRRATIONAL)
    _, paths["irrational"] = noisy_path("irrational", sample, params, geom)
    check(paths["irrational"].get("rescan_banded_fused_spread", 0) >= 4
          and paths["irrational"].get("poisson_flat", 0) >= 2,
          f"irrational R must launch K1's NUFFT mode and K2c: {paths}")
    rel = scan_vs_analytic("irrational (zero x-margins)",
                           zero_margins(sample), params, geom)
    check(rel <= 1e-5, f"irrational scan vs analytic rel err {rel}")

    for name, rf in (("wide", 1.5), ("spread_wide", IRRATIONAL)):
        params, geom = flagship(rescan_factor=rf, sigma_exc=WIDE_SIGMA)
        _, paths[name] = noisy_path(name, sample, params, geom, others=False)
        key = "rescan_banded_fused_" + name
        check(paths[name].get(key, 0) >= 3,
              f"sigma_exc = {WIDE_SIGMA} must launch K1 {key}: {paths}")

    params, geom = flagship()

    def boundaries():
        return {bd: (image(sample, params, geom, method="scan",
                           boundary=bd).image,
                     image(sample, params, geom, boundary=bd).image)
                for bd in ("padded", "apodized")}

    out, paths["padded"] = drive("padded / apodized", boundaries)
    scan, ana = out["padded"]
    rel = rel_l2(scan, ana)
    log(f"padded: scan vs analytic rel err {rel:.3e}, canvas "
        f"{tuple(scan.shape)}")
    check(scan.shape == geom.canvas_shape and rel <= 1e-5,
          f"padded scan vs padded analytic rel err {rel}")
    # the apodized sample still reaches the x-edges, so its circular scan
    # and analytic canvas differ at the seam; their totals agree exactly
    scan, ana = out["apodized"]
    tot = abs(float(scan.double().sum()) / float(ana.double().sum()) - 1.0)
    log(f"apodized: scan vs analytic rel err {rel_l2(scan, ana):.3e}, "
        f"totals differ by {tot:.2e} (relative)")
    check(scan.shape == geom.canvas_shape and torch.isfinite(scan).all()
          and tot <= 1e-5, f"apodized scan total off by {tot}")
    check(paths["padded"].get("rescan_banded_fused", 0) >= 2,
          f"padded and apodized scans must launch K1: {paths}")
    return paths


def k2c_on_canvas(canvas, dev) -> None:
    """K2c and its plain version on the flagship's noise-free canvas (rates
    varying over the image), SEEDS draws each. Per draw: the total within 5
    sigma of the canvas sum, and the dispersion mean((x - lam)^2 / lam)
    over rates above DISP_MIN within 5 sigma of 1 (its terms have variance
    2 + 1/lam). Over the draws: the mean of each z score within 5 sigma of
    0 (a bias of 0.1% in the total fails), and K2c's mean total within 5
    sigma of the plain version's."""
    from rescan_line_sted_torch.kernels.poisson import (
        poisson_flat, poisson_reference)

    lam = canvas.clamp_min(0).double()
    mu = float(lam.sum())
    keep = lam > DISP_MIN
    lk = lam[keep]
    disp_sd = float(torch.sqrt((2.0 + 1.0 / lk).sum())) / lk.numel()
    mean_total = {}
    for name, draw in (
            ("poisson_flat", lambda s: poisson_flat(
                canvas, torch.Generator().manual_seed(s))),
            ("poisson_reference", lambda s: poisson_reference(
                canvas, torch.Generator(dev).manual_seed(s)))):
        z_tot, z_disp = [], []
        for s in range(77, 77 + SEEDS):
            x = draw(s).double()
            z_tot.append((float(x.sum()) - mu) / math.sqrt(mu))
            z_disp.append(
                (float(((x[keep] - lk) ** 2 / lk).mean()) - 1.0) / disp_sd)
        z_tot, z_disp = np.array(z_tot), np.array(z_disp)
        log(f"{name} on the flagship canvas ({mu:.1f} counts, {lk.numel()} "
            f"rates > {DISP_MIN}) over {SEEDS} seeds: total z "
            f"{json.dumps([round(float(z), 2) for z in z_tot])}, mean "
            f"{z_tot.mean():+.3f}; dispersion z "
            f"{json.dumps([round(float(z), 2) for z in z_disp])}, mean "
            f"{z_disp.mean():+.3f}")
        check(np.abs(z_tot).max() <= 5 and np.abs(z_disp).max() <= 5,
              f"{name}: canvas total or dispersion beyond 5 sigma")
        check(abs(z_tot.mean()) * math.sqrt(SEEDS) <= 5
              and abs(z_disp.mean()) * math.sqrt(SEEDS) <= 5,
              f"{name}: mean z over {SEEDS} seeds beyond 5 sigma")
        mean_total[name] = mu + z_tot.mean() * math.sqrt(mu)
    diff = mean_total["poisson_flat"] - mean_total["poisson_reference"]
    check(abs(diff) <= 5 * math.sqrt(2 * mu / SEEDS),
          f"K2c vs plain mean canvas totals differ by {diff}")


def phase_times(dev) -> dict:
    """CUDA-event times (ms): each K1 mode and its plain version, noisy and
    noise-free, with its bound; K2b / K2c, their plain version and
    ``torch.poisson`` on the flagship canvas; each path's per-step image."""
    from rescan_line_sted_torch import rescanned_line_sted_image as image
    from rescan_line_sted_torch.data import siemens_star
    from rescan_line_sted_torch.imaging.boundary import default_margin
    from rescan_line_sted_torch.kernels.poisson import poisson_rows_tiered
    from rescan_line_sted_torch.kernels.rescan_banded_fused import (
        LAUNCH_SHAPE, rescan_banded_fused, rescan_banded_fused_reference)

    cpu_gen = torch.Generator().manual_seed(1)
    dev_gen = torch.Generator(dev).manual_seed(1)
    sample = siemens_star((SIZE, SIZE), device=dev)

    def per_step(params, geom, **kw):
        return cuda_ms(lambda: image(sample, params, geom, cpu_gen,
                                     method="scan", noise_mode="per_step",
                                     **kw))

    # the flagship image first, before the heavier configurations
    t = {"e2e": {"flagship": per_step(*flagship())}}
    for mode, (_, case) in K1_MODES.items():
        sample_y, plan = k1_inputs(case, dev)
        bound, by, fp32_bound = k1_bound(sample_y, plan)
        t[mode] = {
            "ms": cuda_ms(lambda: rescan_banded_fused(
                sample_y, plan, generator=cpu_gen)),
            "plain_ms": cuda_ms(lambda: rescan_banded_fused_reference(
                sample_y, plan, generator=dev_gen)),
            "noise_free_ms": cuda_ms(
                lambda: rescan_banded_fused(sample_y, plan)),
            "noise_free_plain_ms": cuda_ms(
                lambda: rescan_banded_fused_reference(sample_y, plan)),
            "bound_ms": bound, "bound_by": by,
            "bound_kind": "three TF32 passes at 495 TFLOP/s",
            "bound_fp32_ms": fp32_bound, "launch": dict(LAUNCH_SHAPE[mode])}
    canvas = image(sample, *flagship(), method="scan").image
    k2c = k2c_times("the flagship canvas", canvas, dev)
    k2c["draws"] = draw_checks("the flagship canvas", canvas, dev, True)
    t["poisson_flat"] = k2c
    t["poisson_rows_tiered"] = {
        "ms": cuda_ms(lambda: poisson_rows_tiered(canvas, cpu_gen)),
        **{k: k2c[k] for k in ("plain_ms", "library_ms", "bound_ms",
                               "bound_by")}}
    t["e2e"]["irrational"] = per_step(*flagship(rescan_factor=IRRATIONAL))
    t["e2e"]["wide"] = per_step(*flagship(sigma_exc=WIDE_SIGMA))
    t["e2e"]["spread_wide"] = per_step(*flagship(rescan_factor=IRRATIONAL,
                                                 sigma_exc=WIDE_SIGMA))
    t["e2e"]["padded"] = per_step(*flagship(), boundary="padded")
    t["e2e"]["flagship_again"] = per_step(*flagship())
    margin = default_margin(flagship()[1])
    for name, ms in t["e2e"].items():
        steps = SIZE + (2 * margin if name == "padded" else 0)
        log(f"time e2e per-step {name} {ms:.4f} ms, "
            f"{steps / (ms * 1e-3):.1f} steps/s")
    for name, v in t.items():
        if name != "e2e":
            log(f"time {name} {json.dumps(v)}")
    return t


def tier_mix(lam, flat: bool = True) -> dict:
    """Share of K2c's (``flat``: 128 consecutive rates a warp) or K2b's
    (128 adjacent columns of a row) elements on each tier of K2a's ladder,
    by the max of their warp."""
    from rescan_line_sted_torch.kernels.poisson import (
        _CUT, _INV_TIERS, warp_tiers)

    mx = warp_tiers(lam.float(), flat=flat).reshape(-1)
    tiers = [("zero", mx == 0), ("bernoulli", (mx > 0) & (mx < 1e-3))]
    lo = 1e-3
    for hi, kmax in _INV_TIERS:
        tiers.append((f"inversion_{kmax}", (mx >= lo) & (mx < hi)))
        lo = hi
    tiers.append(("bright", (mx >= _CUT) | torch.isnan(mx)))
    return {k: float(v.sum()) / mx.numel() for k, v in tiers}


def k2c_times(name, lam, dev) -> dict:
    """K2c on rates ``lam`` (``name``'s): ``sampler_times`` and the warps'
    tier mix."""
    from rescan_line_sted_torch.kernels.poisson import poisson_flat

    t = sampler_times(lam, torch.Generator().manual_seed(1),
                      torch.Generator(dev).manual_seed(1), poisson_flat)
    t["tiers"] = tier_mix(lam)
    log(f"time poisson_flat on {name} {json.dumps(t)}")
    return t


def draw_checks(name, lam, dev, flat: bool) -> dict:
    """K2b (``flat``: K2c) count by count against its host reference on
    ``lam`` below the bright tier, with a CPU generator and with a CUDA
    one."""
    return {"cpu_generator": frames_draw_for_draw(name, lam, flat=flat),
            "cuda_generator": frames_draw_for_draw(
                name, lam, flat=flat,
                generator=lambda: torch.Generator(dev).manual_seed(41))}


def k2b_times(name, lam, dev) -> dict:
    """K2b on a caller's frames ``lam``: ``sampler_times``, the warps'
    tier mix and ``draw_checks``."""
    from rescan_line_sted_torch.kernels.poisson import poisson_rows_tiered

    t = sampler_times(lam, torch.Generator().manual_seed(3),
                      torch.Generator(dev).manual_seed(3),
                      poisson_rows_tiered)
    t["tiers"] = tier_mix(lam, flat=False)
    log(f"time poisson_rows_tiered on {name} {json.dumps(t)}")
    t["draws"] = draw_checks(name, lam, dev, flat=False)
    return t


OVER_SIGMA = 64.0   # sigma_exc giving D_in = 896 at chunk 32: beyond K1


def phase_k1_bound(dev) -> dict:
    """K1's host bound (``banded_fits``): band windows beyond it take the
    routes without band windows on every device. sigma_exc = OVER_SIGMA
    gives D_in = 896 at chunk 32. At full width (2048^2, R = 1.5) the
    noise-free and per-step images come back with no K1 launch (per-step:
    the W-major K2b route), finite, the noisy total within 5 sigma of the
    noise-free one; at 16 x 1024 (cheap on the host) the card's noise-free
    image matches the same call on CPU tensors within 1e-5 (max
    relative)."""
    from rescan_line_sted_torch import RescanGeometry, Grid
    from rescan_line_sted_torch import rescanned_line_sted_image as image
    from rescan_line_sted_torch.data import siemens_star
    from rescan_line_sted_torch.imaging import rescan
    from rescan_line_sted_torch.kernels.rescan_banded_fused import banded_fits

    params, geom = flagship(sigma_exc=OVER_SIGMA)
    d_in, d_out = rescan._illum_band(params, SIZE, geom.chunk)
    check(d_out is not None and not banded_fits(d_in, d_out, geom.chunk),
          f"sigma_exc {OVER_SIGMA}: windows {d_in}, {d_out} must exceed K1")
    sample = siemens_star((SIZE, SIZE), device=dev)
    gen = torch.Generator().manual_seed(11)

    def run():
        t0 = time.time()
        clean = image(sample, params, geom, method="scan").image
        noisy = image(sample, params, geom, gen, method="scan",
                      noise_mode="per_step").image
        torch.cuda.synchronize()
        return clean, noisy, time.time() - t0

    (clean, noisy, secs), launches = drive("over_bound", run)
    check(not any(k.startswith("rescan_banded_fused") for k in launches)
          and launches.get("poisson_rows_tiered", 0) == SIZE // geom.chunk,
          f"over-bound windows must take the W-major K2b route, not K1: "
          f"{launches}")
    mu, tot = float(clean.double().sum()), float(noisy.double().sum())
    z = (tot - mu) / math.sqrt(mu)
    check(noisy.shape == clean.shape == geom.canvas_shape
          and torch.isfinite(noisy).all() and abs(z) <= 5,
          f"over-bound per-step image: total {tot} vs {mu}")
    small = RescanGeometry(Grid(16, 1024), rescan_factor=1.5, chunk=32)
    s = torch.rand((16, 1024), generator=torch.Generator().manual_seed(4))
    want = image(s, params, small, method="scan", device="cpu").image
    got = image(s, params, small, method="scan", device=dev).image
    rel = float((got.cpu().double() - want.double()).abs().max()
                / want.double().abs().max())
    res = {"d_in": d_in, "d_out": d_out, "launches": launches,
           "noisy_total_z": z, "two_images_s": secs,
           "card_vs_cpu_16x1024_max_rel": rel}
    log(f"over-bound band windows (sigma_exc {OVER_SIGMA}): "
        f"{json.dumps(res)}")
    check(rel <= 1e-5, f"over-bound route on the card vs CPU: rel err {rel}")
    return res


# ---- descanned line- and point-STED: K3 and K2b's callers ----------------

K3_SUPPORT = 18     # the line engine's window at slit_halfwidth 4: 2 * 4 + 10
# the JAX suite's hardware noise test of the TPU kernel
# (tests/test_fused_noise.py:26-28, 48-72)
NOISE_KW = dict(sigma_exc=2.0, sigma_det=2.5, stripe_period=9.0,
                depletion=4.0, slit_halfwidth=3.0, brightness=100.0)


def line_setup(size, chunk=32):
    from rescan_line_sted_torch import Grid, LineSTEDGeometry, LineSTEDParams

    return (LineSTEDParams.create(depletion=8.0, **LINE_KW),
            LineSTEDGeometry(Grid(size, size), chunk=chunk))


def point_setup(size, chunk=64):
    from rescan_line_sted_torch import (
        Grid, PointSTEDGeometry, PointSTEDParams)

    return (PointSTEDParams.create(depletion=8.0, **POINT_KW),
            PointSTEDGeometry(Grid(size, size), chunk=chunk))


def k3_inputs(params, sample):
    """K3's arguments as the line engine builds them: the y-convolved
    sample, the brightness-scaled line, gx and the slit."""
    from rescan_line_sted_torch.imaging.line_sted import (
        effective_line_profile)
    from rescan_line_sted_torch.kernels import fftconv
    from rescan_line_sted_torch.physics import psf

    h, w = sample.shape
    dev = sample.device
    otf_y = fftconv.profile_to_otf1d(
        psf.detection_profile(h, params.sigma_det, dev))
    sample_y = fftconv.convolve_otf1d(sample, otf_y, axis=-2, n=h)
    return (sample_y.contiguous(),
            params.brightness * effective_line_profile(w, params, dev),
            psf.detection_profile(w, params.sigma_det, dev),
            psf.slit_profile(w, params.slit_halfwidth, dev))


def k3_bound(args, slit_support, noisy=True) -> tuple[float, str, dict]:
    """Least time (ms) of one K3 call and what bounds it. Operations
    (``unit_roofline``): an FMA per nonzero tap of each computed row at
    every position and lane, at the FP32 rate, and, for a noisy call, the
    Philox blocks its draws take on these rates (below 10: a quarter block
    per Knuth round, whose loop ends once the count is settled: min(rate +
    1, 24) rounds in expectation; at 10 or above one block, a PTRS
    acceptance at the first attempt; none at 0), each PHILOX_BLOCK's
    products and XORs (``fma_philox_work``). Bytes: the sample read and the
    image written once. Returns the counts too, with the limiting unit
    (``bound_unit``)."""
    from rescan_line_sted_torch.kernels.line_fused import (
        _rows, _span, _taps, line_sted_fused_reference)
    from rescan_line_sted_torch.kernels.primitives import knuth_counts

    s, eff, gx, slit = args
    h, w = s.shape
    i0, ws, _ = _rows(slit, w, slit_support)
    taps = _taps(eff, gx, i0, ws.size)
    blocks = 0
    sampler = dict.fromkeys(("exps", "inv_terms", "knuth_rounds"), 0)
    for k in np.flatnonzero(ws) if noisy else []:
        row = torch.zeros_like(slit)         # frame row i0 + k alone, weight 1
        row[i0 + k] = 1.0
        lam = line_sted_fused_reference(s, eff, gx, row, slit_support=w)
        low = lam[(lam > 0) & (lam < 10)].double()
        blocks += float((low + 1.0).clamp(max=24).sum()) / 4 \
            + int((lam >= 10).sum())
        for key, v in knuth_counts(lam).items():
            sampler[key] += v
    n = {"rows": int(ws.size), "run": _span(taps)[1],
         "taps": int(taps.sum()), "fma": int(taps.sum()) * h * w,
         "philox_blocks": blocks, **sampler}
    ms, by, n["bound_unit"] = unit_roofline(
        fma_philox_work(n["fma"], blocks), 4 * (2 * h * w + 3 * w))
    return ms, by, n


def phase_k3(dev) -> dict:
    """K3 against its plain version, noise-free; its 2048^2 image against
    the analytic one; its draws' statistics. Returns the worst errors."""
    from rescan_line_sted_torch import line_sted_image
    from rescan_line_sted_torch.data import siemens_star
    from rescan_line_sted_torch.kernels.line_fused import (
        _rows, _span, _taps, line_sted_fused, line_sted_fused_reference)

    worst = {"abs": 0.0, "rel": 0.0}
    # (size, slit_support, roll of eff and gx: 250 makes the tap run wrap)
    for size, support, shift in ((512, K3_SUPPORT, 0), (SIZE, K3_SUPPORT, 0),
                                 (512, 4, 0), (512, K3_SUPPORT, 250)):
        params, geom = line_setup(size)
        star = siemens_star((size, size), device=dev)
        s, eff, gx, slit = k3_inputs(params, star)
        args = s, eff.roll(shift), gx.roll(shift), slit
        got = line_sted_fused(*args, slit_support=support)
        want = line_sted_fused_reference(*args, slit_support=support)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        i0, ws, wm = _rows(slit, size, support)
        j0, run = _span(_taps(*args[1:3], i0, ws.size))
        log(f"K3 vs plain {size}^2 slit_support={support} roll={shift} "
            f"({ws.size} rows, {int((wm != 0).sum())} of them mean; taps "
            f"{j0}..{j0 + run - 1} mod {size}): max abs err {err:.3e}, "
            f"max rel err {rel:.3e}")
        check(got.shape == want.shape and rel <= 1e-5,
              f"K3 vs plain at {size}^2, slit_support {support}, roll "
              f"{shift}: rel {rel}")
        check(shift == 0 or j0 + run > size,
              f"the rolled K3 case must wrap its tap run: {j0}, {run}")
        worst = {"abs": max(worst["abs"], err), "rel": max(worst["rel"], rel)}
        if size == SIZE:
            ana = line_sted_image(star, params, geom).image
            rel = rel_l2(got, ana)
            log(f"K3 {size}^2 noise-free vs analytic rel err {rel:.3e}")
            check(rel <= 1e-5, f"K3 vs analytic at {size}^2: {rel}")

    from rescan_line_sted_torch import LineSTEDParams

    params = LineSTEDParams.create(**NOISE_KW)
    sample = 5.0 * torch.rand((256, 256),
                              generator=torch.Generator().manual_seed(7))
    args = k3_inputs(params, sample.to(dev))
    support = int(2 * NOISE_KW["slit_halfwidth"]) + 10
    mean = line_sted_fused(*args, slit_support=support)
    draws = torch.stack([line_sted_fused(
        *args, torch.Generator().manual_seed(100 + k), slit_support=support)
        for k in range(24)]).double()
    check(torch.equal(draws, draws.round()) and (draws >= 0).all(),
          "K3 noisy images must hold non-negative integer counts")
    mu = float(mean.double().sum())
    z = (draws.sum((1, 2)) - mu) / math.sqrt(mu)
    sel = mean > 20.0
    rel = float((draws.mean(0)[sel] - mean[sel]).abs().mean()
                / mean[sel].mean())
    ratio = float((draws.var(0)[sel] / mean[sel]).mean())
    log(f"K3 noisy 256^2 over 24 draws: total z "
        f"{json.dumps([round(float(v), 2) for v in z])}; seed-mean rel err "
        f"{rel:.4f}, variance / mean {ratio:.4f} over {int(sel.sum())} "
        "pixels with mean > 20")
    check(float(z.abs().max()) <= 5, "K3 noisy totals beyond 5 sigma")
    check(rel < 0.03 and 0.93 < ratio < 1.07,
          f"K3 noisy moments: rel {rel}, variance / mean {ratio}")
    return worst


def descanned_path(name, image, sample, params, geom, routes, others=True):
    """Drive one per-step image per route (keyword sets of ``image``) and,
    with ``others``, a collapsed and an analytic noisy image; every total
    within 5 sigma of its mean. Returns the path's launch counts."""
    gen = torch.Generator().manual_seed(2025)

    def run():
        clean = image(sample, params, geom, method="scan").image
        imgs = [image(sample, params, geom, gen, method="scan",
                      noise_mode="per_step", **kw).image for kw in routes]
        if others:
            imgs += [image(sample, params, geom, gen, method="scan").image,
                     image(sample, params, geom, gen).image]
        return clean, imgs

    (clean, imgs), launches = drive(name, run)
    shape = geom.grid.shape
    check(clean.shape == shape, f"{name}: image shape {tuple(clean.shape)}")
    # a per-step image sums Poisson counts of the noise-free frames, whose
    # slit / pinhole sums are the noise-free scan; collapsed and analytic
    # noise draw the clamped image
    means = [float(clean.double().sum())] * len(routes)
    if others:
        ana = image(sample, params, geom).image
        means += [float(clean.clamp_min(0).double().sum()),
                  float(ana.clamp_min(0).double().sum())]
        for img in imgs[len(routes):]:
            check((img >= 0).all() and torch.equal(img, img.round()),
                  f"{name}: collapsed / analytic noise must give "
                  "non-negative counts")
    for img, mu in zip(imgs, means):
        check(img.shape == shape and torch.isfinite(img).all(),
              f"{name}: noisy image must be finite with the grid's shape")
        t = float(img.double().sum())
        log(f"{name}: image total {t:.1f} vs mean {mu:.1f} "
            f"({(t - mu) / math.sqrt(mu):+.2f} sigma)")
        check(abs(t - mu) <= 5 * math.sqrt(mu),
              f"{name}: noisy total {t} not within 5 sigma of its mean {mu}")
    if len(imgs) > 1:
        check(not torch.equal(imgs[0], imgs[1]),
              f"{name}: two noisy images must differ")
    return launches


def boundary_checks(name, image, sample, params, geom) -> None:
    """Noise-free scan against analytic with zeroed x-margins, and the
    padded and apodized scans against their analytic images."""
    rel = scan_vs_analytic(f"{name} (zero x-margins)", zero_margins(sample),
                           params, geom, image=image)
    check(rel <= 1e-5, f"{name} scan vs analytic rel err {rel}")
    for bd in ("padded", "apodized"):
        rel = scan_vs_analytic(f"{name} {bd}", sample, params, geom,
                               image=image, boundary=bd)
        check(rel <= 1e-5, f"{name} {bd} scan vs analytic rel err {rel}")


def phase_descanned(dev) -> dict:
    """Every path through ``line_sted_image`` and ``point_sted_image``;
    returns each path's launch counts."""
    from rescan_line_sted_torch import line_sted_image, point_sted_image
    from rescan_line_sted_torch.data import siemens_star

    paths = {}
    star = siemens_star((SIZE, SIZE), device=dev)
    params, geom = line_setup(SIZE)
    paths["line_2048"] = descanned_path(
        "line_2048", line_sted_image, star, params, geom,
        [{}, {"use_pallas": True}])
    boundary_checks("line_2048", line_sted_image, star, params, geom)
    for size in (512, 128):
        params, geom = line_setup(size)
        routes = [{}, {"use_pallas": True}] if size == 512 else [{}, {}]
        paths[f"line_{size}"] = descanned_path(
            f"line_{size}", line_sted_image,
            siemens_star((size, size), device=dev), params, geom, routes,
            others=False)
    for size in (512, 96):              # banded, full-frame (rows crossed)
        params, geom = point_setup(size)
        paths[f"point_{size}"] = descanned_path(
            f"point_{size}", point_sted_image,
            siemens_star((size, size), device=dev), params, geom, [{}, {}],
            others=False)
    params, geom = point_setup(SIZE)
    paths["point_2048"] = descanned_path(
        "point_2048", point_sted_image, star, params, geom, [])
    boundary_checks("point_2048", point_sted_image, star, params, geom)

    want = {  # path: {kernel: least launches}
        "line_2048": {"poisson_rows_tiered": SIZE // 32, "line_sted_fused": 1,
                      "poisson_flat": 2},
        "line_512": {"poisson_rows_tiered": 512 // 32, "line_sted_fused": 1},
        "line_128": {"line_sted_fused": 2},
        "point_512": {"poisson_rows_tiered": 2 * 64},
        "point_96": {"poisson_rows_tiered": 2 * 96 * 96 // 64},
        "point_2048": {"poisson_flat": 2}}
    for name, kernels in want.items():
        for kernel, least in kernels.items():
            check(paths[name].get(kernel, 0) >= least,
                  f"{name} must launch {kernel} at least {least} times: "
                  f"{paths[name]}")
    check("poisson_rows_tiered" not in paths["line_128"],
          "line_128's default route is K3, not K2b")
    check(paths["point_96"].get("poisson_rows_tiered") == 2 * 96 * 96 // 64,
          "point_96 must take the full-frame route (one K2b per chunk)")
    return paths


def phase_route_parity(dev) -> None:
    """The per-step K2b routes with the draw replaced by the identity (the
    clamped noise-free frames), held to the analytic image (relative L2 <=
    1e-5): line 2048^2 banded, point 512^2 banded, point 96^2 full-frame.
    (Noise-free K3 is held to the analytic image in ``phase_k3``.)"""
    from rescan_line_sted_torch import line_sted_image, point_sted_image
    from rescan_line_sted_torch.data import siemens_star
    from rescan_line_sted_torch.imaging import line_sted, point_sted

    cases = (("line_2048", line_sted, line_sted_image, line_setup(SIZE)),
             ("point_512", point_sted, point_sted_image, point_setup(512)),
             ("point_96", point_sted, point_sted_image, point_setup(96)))
    for name, module, image, (params, geom) in cases:
        star = siemens_star(geom.grid.shape, device=dev)
        orig = module.poisson_rows_tiered
        module.poisson_rows_tiered = lambda lam, generator: lam.clamp_min(0)
        try:
            got = image(star, params, geom, torch.Generator().manual_seed(0),
                        method="scan", noise_mode="per_step").image
        finally:
            module.poisson_rows_tiered = orig
        rel = rel_l2(got, image(star, params, geom).image)
        log(f"{name} per-step route, draws replaced by the identity, vs "
            f"analytic: rel err {rel:.3e}")
        check(rel <= 1e-5, f"{name} noise-free per-step route vs analytic "
              f"rel err {rel}")


def caller_frames(module, run, sampler="poisson_rows_tiered") -> torch.Tensor:
    """A copy of the first rates ``module``'s engine hands its sampler in
    ``run()``: K2b (``poisson_rows_tiered(lam, generator)``) or, with
    ``sampler="maybe_poisson"``, K2c (``maybe_poisson(generator, lam)``)."""
    seen = []
    orig = getattr(module, sampler)

    def keep(*args):
        lam = args[0] if sampler == "poisson_rows_tiered" else args[1]
        if not seen:
            seen.append(lam.clone())
        return orig(*args)

    setattr(module, sampler, keep)
    try:
        run()
    finally:
        setattr(module, sampler, orig)
    return seen[0]


def k1_frames(sample_y, plan) -> torch.Tensor:
    """Every camera frame K1 samples in one image (K2a's rates), [W / C,
    C * dob, H]: the conv table on its band times each chunk's sample
    window."""
    from rescan_line_sted_torch.kernels.rescan_banded_fused import (
        _sample_ext, banded_table)

    h, w = sample_y.shape
    chunk, d_in = plan.chunk, plan.d_in
    sample_ext = _sample_ext(sample_y, d_in, chunk)
    check(plan.binning == 1, "K2a's frames: the flagship has b = 1")
    table = banded_table(plan)
    win = sample_ext.unfold(0, d_in, chunk)[: w // chunk]   # [n, H, d_in]
    return table @ win.transpose(1, 2)


def sampler_times(lam, cpu_gen, dev_gen, kernel=None) -> dict:
    """A sampler's times on rates ``lam``: the kernel (if given) with a CPU
    generator (``ms``) and a CUDA one (``cuda_gen_ms``; key words by value
    from either), the plain version and ``torch.poisson`` (``library_``),
    each the CUDA-event time of one call, median of ``SAMPLER_REPEATS``,
    beside the bound of reading and writing every element once. A call
    shorter than the host's launch work times the host, so each also gets
    its device time under the profiler (``*device_ms``); the kernel and
    ``torch.poisson`` also their device time per call with the host's
    launch work hidden (``*queued``, ``queued_ms``) and the host time of
    one call after a sync (``*cold_host_us``); the kernel its wrapper's
    host time by step (``host_us``, ``wrapper_host_us``) and the work
    counts of its composite bound (``phase_primitives``): each element at
    its own tier (a lower bound of its warp's), one Philox block per four
    single draws, two draws per bright element (a PTRS acceptance at the
    first attempt)."""
    from rescan_line_sted_torch.kernels import primitives as prim
    from rescan_line_sted_torch.kernels.poisson import poisson_reference

    clamped = lam.clamp_min(0)
    bound, by = roofline(0.0, 2 * 4 * lam.numel())
    calls = {"plain": lambda: poisson_reference(lam, dev_gen),
             "library": lambda: torch.poisson(clamped, dev_gen)}
    if kernel is not None:
        calls["kernel"] = lambda: kernel(lam, cpu_gen)
        calls["cuda_gen"] = lambda: kernel(lam, dev_gen)
    t = {"shape": list(lam.shape), "bound_ms": bound, "bound_by": by}
    for name, fn in calls.items():
        key = "" if name == "kernel" else name + "_"
        t[key + "ms"] = cuda_ms(fn, SAMPLER_REPEATS)
        t[key + "device_ms"] = device_busy(fn)[0]
        if name != "plain":
            t[key + "queued"] = queued_ms(fn)
            t[key + "cold_host_us"] = cold_host_us(fn, SAMPLER_REPEATS)
    if kernel is not None:
        t["host_us"] = wrapper_host_us(lam, kernel, cpu_gen, dev_gen)
        cn = prim.tiered_counts(lam)
        t["counts"] = {"exps": cn["exps"], "philox_blocks": cn["uniforms"] / 4,
                       "inv_terms": cn["inv_terms"],
                       "knuth_rounds": cn["knuth_rounds"]}
    return t


def device_busy(fn, warm_up=True, host=True) -> tuple[float, list]:
    """Device time (ms) of the kernels and copies of one ``fn()`` under
    ``torch.profiler`` (after a warm-up call unless the caller warmed it
    up), and its five largest entries as [ms, name, count]; 0.0 where the
    profiler saw no device activity. ``host=False`` traces the device
    alone: the host's op events cost the profiler seconds on long calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warm_up:
        fn()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] + (
        [ProfilerActivity.CPU] if host else [])
    for _ in range(3):      # a short image's trace has come back empty once
        with profile(activities=activities) as prof:
            fn()
            torch.cuda.synchronize()
        rows = sorted(([e.self_device_time_total / 1e3, e.key, e.count]
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA), reverse=True)
        if rows:
            break
    return sum(r[0] for r in rows), rows[:5]


def phase_times_descanned(dev, k1_times) -> dict:
    """CUDA-event times (ms): each descanned path's per-step image, K3
    noisy and noise-free against its plain version and bound, K2b on each
    caller's first frames, K2a's draws (K1 noisy - noise-free) against
    ``torch.poisson`` on the flagship's frames."""
    from rescan_line_sted_torch import (
        line_sted_image, point_sted_image, rescanned_line_sted_image)
    from rescan_line_sted_torch.data import siemens_star
    from rescan_line_sted_torch.imaging import line_sted, point_sted
    from rescan_line_sted_torch.kernels.line_fused import (
        LAUNCH_SHAPE, line_plan, line_sted_fused, line_sted_fused_reference)

    cpu_gen = torch.Generator().manual_seed(3)
    dev_gen = torch.Generator(dev).manual_seed(3)
    stars = {n: siemens_star((n, n), device=dev)
             for n in (SIZE, 512, 128, 96)}

    def per_step(image, size, setup, **kw):
        params, geom = setup(size)
        return lambda: image(stars[size], params, geom, cpu_gen,
                             method="scan", noise_mode="per_step", **kw)

    runs = {
        "line_2048": (per_step(line_sted_image, SIZE, line_setup), SIZE),
        "line_2048_k3": (per_step(line_sted_image, SIZE, line_setup,
                                  use_pallas=True), SIZE),
        "line_512": (per_step(line_sted_image, 512, line_setup), 512),
        "line_512_k3": (per_step(line_sted_image, 512, line_setup,
                                 use_pallas=True), 512),
        "line_128": (per_step(line_sted_image, 128, line_setup), 128),
        "point_512": (per_step(point_sted_image, 512, point_setup), 512 ** 2),
        "point_96": (per_step(point_sted_image, 96, point_setup), 96 ** 2),
    }
    e2e, busy = {}, {}
    for name, (fn, steps) in runs.items():
        ms = cuda_ms(fn)
        e2e[name] = ms
        log(f"time e2e per-step {name} {ms:.4f} ms, "
            f"{steps / (ms * 1e-3):.1f} steps/s")
    # the host's share: device busy time of one image against its time
    params, geom = flagship()
    runs["flagship"] = (lambda: rescanned_line_sted_image(
        stars[SIZE], params, geom, cpu_gen, method="scan",
        noise_mode="per_step"), SIZE)
    for name, (fn, _) in runs.items():
        ms, top = device_busy(fn)
        busy[name] = {"device_ms": ms, "top": top}
        log(f"profile {name}: device busy {ms:.3f} ms"
            + (f", idle {1.0 - ms / e2e[name]:.1%} of the timed image"
               if name in e2e else "")
            + f"; largest: {json.dumps([[round(t, 3), k[:60], n] for t, k, n in top])}")

    args = k3_inputs(line_setup(SIZE)[0], stars[SIZE])
    bound, by, counts = k3_bound(args, K3_SUPPORT)
    # the line engine hands K3 its cached plan: time the call it makes
    plan = line_plan(*args[1:], K3_SUPPORT)
    k3 = {"ms": cuda_ms(lambda: line_sted_fused(
              *args, cpu_gen, slit_support=K3_SUPPORT, plan=plan)),
          "no_plan_ms": cuda_ms(lambda: line_sted_fused(
              *args, cpu_gen, slit_support=K3_SUPPORT)),
          "plain_ms": cuda_ms(lambda: line_sted_fused_reference(
              *args, dev_gen, slit_support=K3_SUPPORT)),
          "noise_free_ms": cuda_ms(lambda: line_sted_fused(
              *args, slit_support=K3_SUPPORT, plan=plan)),
          "noise_free_plain_ms": cuda_ms(lambda: line_sted_fused_reference(
              *args, slit_support=K3_SUPPORT)),
          "bound_ms": bound, "bound_by": by,
          "noise_free_bound_ms": k3_bound(args, K3_SUPPORT, noisy=False)[0],
          **counts}
    k3["device_ms"] = device_busy(lambda: line_sted_fused(
        *args, cpu_gen, slit_support=K3_SUPPORT, plan=plan))[0]
    k3["launch"] = dict(LAUNCH_SHAPE)
    log(f"time line_sted_fused {json.dumps(k3)}")

    k2b = {
        "line_2048": caller_frames(line_sted, runs["line_2048"][0]),
        "point_512": caller_frames(point_sted, runs["point_512"][0])}
    k2b = {name: k2b_times(f"{name}'s frames", f, dev)
           for name, f in k2b.items()}

    frames = k1_frames(*k1_inputs(K1_MODES["rescan_banded_fused"][1], dev))
    k2a = sampler_times(frames, cpu_gen, dev_gen)
    k2a["elements"] = frames.numel()
    k2a["ms"] = (k1_times["ms"] - k1_times["noise_free_ms"])
    log(f"time K2a in K1 (noisy - noise-free) vs torch.poisson on the "
        f"flagship's frames {json.dumps(k2a)}")
    del frames
    return {"e2e": e2e, "line_sted_fused": k3, "poisson_rows_tiered": k2b,
            "k2a": k2a, "busy": busy}


# ---- the rescan scan without band windows: K4, K5, K2b's rescan caller --

SCAN_SIZE = 512                               # bench.py's SCAN_SIZE


def stripe_no_bands():
    """A copy of the default stripe model without ``gaussian_excitation``:
    the same physics, with the band windows declined."""
    from rescan_line_sted_torch.physics.models import GaussianStripeModel

    class StripeNoBands(GaussianStripeModel):
        gaussian_excitation = False

    return StripeNoBands()


class WideExcModel:
    """A flat excitation and no depletion (no ``gaussian_excitation``):
    K4's run spans the whole frame."""

    def excitation(self, width, params, device=None):
        return torch.ones(width, device=device)

    def depletion(self, width, params, device=None):
        return torch.zeros(width, device=device)


def nobands(size, rescan_factor=2.0, binning=1, model=None):
    """The flagship's physics at ``size``, its stripe model flagged as not
    Gaussian (no band windows); ``model=False`` keeps the default model."""
    params, geom = flagship(size, rescan_factor, binning)
    if model is not False:
        params = dataclasses.replace(params, model=model or stripe_no_bands())
    return params, geom


def k4_inputs(params, geom, sample):
    """K4's arguments as ``_full_frame_scan`` builds them."""
    from rescan_line_sted_torch.imaging.line_sted import (
        effective_line_profile)
    from rescan_line_sted_torch.kernels import fftconv
    from rescan_line_sted_torch.physics import psf

    h, w = geom.grid.shape
    dev = sample.device
    b = geom.binning
    otf_y = fftconv.profile_to_otf1d(
        psf.detection_profile(h, params.sigma_det, dev))
    pos = torch.arange(w, device=dev)
    offsets = torch.round((float(geom.rescan_factor) - 1.0) * pos / b).int()
    return (fftconv.convolve_otf1d(sample, otf_y, axis=-2, n=h).contiguous(),
            params.brightness * effective_line_profile(w, params, dev),
            psf.detection_profile(w, params.sigma_det, dev), offsets,
            geom.canvas_shape[1], b)


def k4_bound(args, noisy=True) -> tuple[float, str, dict]:
    """Least time (ms) of one K4 call and what bounds it. Operations
    (``unit_roofline``): an FMA per pair of nonzero eff and gx taps at
    every position and sample row, at the FP32 rate, and, for a noisy
    call, the Philox blocks its draws take on this run's binned rates: a
    quarter block per element of rate in (0, 10) (one single-draw uniform,
    four to a block), one block at 10 or above (a PTRS acceptance at the
    first attempt), none at 0; each PHILOX_BLOCK's products and XORs
    (``fma_philox_work``). Bytes: the sample read and the canvas written
    once. Returns the counts too, with the limiting unit (``bound_unit``)."""
    from rescan_line_sted_torch.kernels.primitives import tiered_counts
    from rescan_line_sted_torch.kernels.rescan_fused import _run, _window

    s, eff, gx, offsets, wc, b = args
    h, w = s.shape
    (e0, ne), (g0, ng) = _run(eff), _run(gx)
    n = {"eff_run": ne, "gx_run": ng,
         "eff_taps": int((eff != 0).sum()), "gx_taps": int((gx != 0).sum())}
    n["fma"] = n["eff_taps"] * n["gx_taps"] * h * w
    l, hb = ne + ng - 1, h // b
    lb = min(w // b, -(-(l + b - 1) // b))
    n["placed"] = w * lb * hb           # frame window elements placed
    low = high = 0
    sampler = dict.fromkeys(("uniforms", "exps", "inv_terms",
                             "knuth_rounds"), 0)
    if noisy:                           # this run's binned rates (plain math)
        i = torch.arange(ne, device=s.device)
        k = torch.arange(l, device=s.device)[None, :] - i[:, None]
        band = torch.where((k >= 0) & (k < ng),
                           gx[(g0 + k.clamp(0, ng - 1)) % w], 0.0)
        effr = eff[(e0 + i) % w]
        for p0 in range(0, w, 64):
            pos = torch.arange(p0, min(p0 + 64, w), device=s.device)
            cols = (pos[:, None] + e0 + i[None, :] + w - w // 2) % w
            run = ((s[:, cols] * effr) @ band).reshape(
                hb, b, pos.numel(), l).sum(1)
            _, xl = _window(pos, w, b, e0, g0, l)
            fr = torch.zeros((hb, pos.numel(), lb), device=s.device)
            fr.scatter_add_(2, xl[None].expand_as(run), run)
            low += int(((fr > 0) & (fr < 10)).sum())
            high += int((fr >= 10).sum())
            for key, v in tiered_counts(fr).items():
                sampler[key] += v
    n["drawn_low"], n["drawn_high"] = low, high
    n.update(sampler)
    n["philox_blocks"] = low / 4 + high
    ms, by, n["bound_unit"] = unit_roofline(
        fma_philox_work(n["fma"], n["philox_blocks"]),
        4 * (h * w + (h // b) * wc))
    return ms, by, n


def phase_k4(dev) -> dict:
    """K4 against its plain version, noise-free (max relative <= 1e-5):
    the 2048^2 cell, b = 2, eff and gx rolled so that their runs wrap, a
    full-width run (WideExcModel at 256^2), and frame windows that wrap the
    camera columns in most chunks at b = 2 (each chunk's placement path
    logged, ``rescan_fused.chunk_paths``); its draws at 256^2 over SEEDS
    seeds. Returns the worst errors."""
    from rescan_line_sted_torch.data import siemens_star
    from rescan_line_sted_torch.kernels.rescan_fused import (
        _run, chunk_paths, rescan_fused, rescan_fused_reference)

    worst = {"abs": 0.0, "rel": 0.0}
    cases = (("nobands_2048", nobands(SIZE), 0),
             ("512^2 R=3 b=2", nobands(512, 3.0, 2), 0),
             ("512^2 rolled 250", nobands(512), 250),
             ("256^2 WideExcModel", nobands(256, model=WideExcModel()), 0),
             ("256^2 R=2 b=2 windows wrapped", nobands(256, 2.0, 2), 0))
    for name, (params, geom), shift in cases:
        star = siemens_star(geom.grid.shape, device=dev)
        s, eff, gx, offs, wc, b = k4_inputs(params, geom, star)
        args = (s, eff.roll(shift), gx.roll(shift), offs, wc, b)
        got = rescan_fused(*args)
        want = rescan_fused_reference(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        (e0, ne), (g0, ng) = _run(args[1]), _run(args[2])
        paths = chunk_paths(s.shape[1], b, args[1], args[2])
        log(f"K4 vs plain {name}: eff run {e0}+{ne}, gx run {g0}+{ng} mod "
            f"{s.shape[1]}, chunks {json.dumps(paths)}: max abs err "
            f"{err:.3e}, max rel err {rel:.3e}")
        check(got.shape == want.shape and rel <= 1e-5,
              f"K4 vs plain at {name}: rel err {rel}")
        check("wrapped" not in name or paths["split"] > paths["strip"],
              f"{name}: most chunks' windows must wrap: {paths}")
        check(shift == 0 or e0 + ne > s.shape[1],
              f"the rolled K4 case must wrap its eff run: {e0}, {ne}")
        check(isinstance(params.model, WideExcModel) == (ne == s.shape[1]),
              f"{name}: a full-width run only for the flat excitation")
        worst = {"abs": max(worst["abs"], err), "rel": max(worst["rel"], rel)}

    params, geom = nobands(256)
    params = dataclasses.replace(params, brightness=20.0)
    sample = 5.0 * torch.rand((256, 256),
                              generator=torch.Generator().manual_seed(7))
    args = k4_inputs(params, geom, sample.to(dev))
    mean = rescan_fused(*args)
    draws = torch.stack([rescan_fused(
        *args, generator=torch.Generator().manual_seed(100 + k))
        for k in range(SEEDS)]).double()
    check(torch.equal(draws, draws.round()) and (draws >= 0).all(),
          "K4 noisy canvases must hold non-negative integer counts")
    mu = float(mean.double().sum())
    z = (draws.sum((1, 2)) - mu) / math.sqrt(mu)
    sel = mean > 20.0
    rel = float((draws.mean(0)[sel] - mean[sel]).abs().mean()
                / mean[sel].mean())
    ratio = float((draws.var(0)[sel] / mean[sel]).mean())
    log(f"K4 noisy 256^2 over {SEEDS} draws: total z "
        f"{json.dumps([round(float(v), 2) for v in z])}; seed-mean rel err "
        f"{rel:.4f}, variance / mean {ratio:.4f} over {int(sel.sum())} "
        "canvas pixels with mean > 20")
    check(float(z.abs().max()) <= 5, "K4 noisy totals beyond 5 sigma")
    check(rel < 0.03 and 0.9 < ratio < 1.1,
          f"K4 noisy moments: rel {rel}, variance / mean {ratio}")
    again = rescan_fused(*args, generator=torch.Generator().manual_seed(100))
    check(torch.equal(again.double(), draws[0]),
          "K4: the same seed must give the same canvas")
    return worst


def k5_inputs(dev, n=32, h=SCAN_SIZE, w=SCAN_SIZE, wc=2 * SCAN_SIZE,
              seed=0):
    """A scatter call of the 512^2 rescan route's shape (a chunk of 32
    frames into the [512, 1024] canvas), duplicates included."""
    g = torch.Generator().manual_seed(seed)
    offsets = torch.randint(-wc, 2 * wc, (n,), generator=g)
    offsets[1::4] = offsets[::4]                   # duplicates
    return (torch.rand((h, wc), generator=g).to(dev),
            torch.rand((n, h, w), generator=g).to(dev), offsets.to(dev))


def phase_k5(dev) -> dict:
    """K5 against its plain version: the 512^2 route's shape with
    duplicate offsets, frames as wide as the canvas, and frames wider
    than the canvas (heavy wrap); deterministic over two calls, and bit
    for bit the in-order per-frame adds where frames are no wider than the
    canvas. Returns the worst errors."""
    from rescan_line_sted_torch.kernels.rescan_accumulate import (
        rescan_accumulate, rescan_accumulate_reference)

    worst = {"abs": 0.0, "rel": 0.0}
    for n, h, w, wc in ((32, SCAN_SIZE, SCAN_SIZE, 2 * SCAN_SIZE),
                        (32, 256, 256, 256), (16, 128, 1000, 300)):
        args = k5_inputs(dev, n, h, w, wc, seed=n + w)
        got = rescan_accumulate(*args)
        want = rescan_accumulate_reference(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        log(f"K5 vs plain: {n} frames [{h}, {w}] into [{h}, {wc}]: max abs "
            f"err {err:.3e}, max rel err {rel:.3e}")
        check(got.shape == want.shape and rel <= 1e-5,
              f"K5 vs plain at {(n, h, w, wc)}: rel err {rel}")
        check(torch.equal(got, rescan_accumulate(*args)),
              "K5 must be deterministic")
        if w <= wc:
            check(torch.equal(got, in_order_adds(*args)),
                  f"K5 at {(n, h, w, wc)} must equal the in-order per-frame "
                  "adds bit for bit")
        worst = {"abs": max(worst["abs"], err), "rel": max(worst["rel"], rel)}
    return worst


def in_order_adds(canvas, frames, offsets) -> torch.Tensor:
    """The canvas plus each frame added in turn on the card (``canvas[:,
    cols_n] += frames[n]``, n = 0, 1, ...): K5's sum order, for frames no
    wider than the canvas."""
    out = canvas.clone()
    x = torch.arange(frames.shape[2], device=canvas.device)
    for n in range(frames.shape[0]):
        out[:, torch.remainder(offsets[n].long() + x, canvas.shape[1])] += \
            frames[n]
    return out


# path: (size, R, b, model, per-step keyword sets, kernels that must run)
NOBAND_PATHS = {
    "nobands_2048": (SIZE, 2.0, 1, None, [{}, {}],
                     {"rescan_fused": 4, "poisson_flat": 2}),
    "nobands_512_subpixel": (SCAN_SIZE, 1.5, 1, None, [{}, {}],
                             {"poisson_rows_tiered": 2 * SCAN_SIZE // 32}),
    "nobands_512_scatter": (SCAN_SIZE, 2.0, 1, None,
                            [{"use_pallas": False}] * 2,
                            {"rescan_accumulate": 2 * SCAN_SIZE // 32,
                             "poisson_flat": 2 * SCAN_SIZE // 32}),
    "rescan_128": (128, 2.0, 1, False, [{}, {}], {"rescan_fused": 2}),
}


def phase_nobands(dev) -> dict:
    """Every route without band windows through
    ``rescanned_line_sted_image``, the launch counters reset before and
    read after each path: nobands_2048 (K4; noise-free held to K1's banded
    image of the same physics), the 512^2 subpixel (K2b hybrid) and
    ``use_pallas=False`` scatter (K5) routes, collapsed noise with
    ``use_pallas=True`` (K4) and None (phase accumulation) at 512^2, and
    rescan_128 (the default model: K4 by default). Each route with its
    draws replaced by the identity (K4: noise-free) against the analytic
    image on a star with zeroed x-margins. Returns each path's launches."""
    from rescan_line_sted_torch import rescanned_line_sted_image as image
    from rescan_line_sted_torch.data import siemens_star
    from rescan_line_sted_torch.imaging import rescan

    paths = {}
    for name, (size, rf, b, model, routes, least) in NOBAND_PATHS.items():
        params, geom = nobands(size, rf, b, model)
        check(rescan._illum_band(params, size, 32, b) is None,
              f"{name} must have no band windows")
        star = siemens_star((size, size), device=dev)
        others = name == "nobands_2048"
        # the noise-free image of a large grid through K4 (use_pallas=True)
        kw = {"use_pallas": True} if size == SIZE else {}
        gen = torch.Generator().manual_seed(2026)

        def run():
            clean = image(star, params, geom, method="scan", **kw).image
            imgs = [image(star, params, geom, gen, method="scan",
                          noise_mode="per_step", **r).image for r in routes]
            if others:
                imgs += [image(star, params, geom, gen, method="scan",
                               use_pallas=True, device=dev).image,
                         image(star, params, geom, gen).image]
            return clean, imgs

        (clean, imgs), paths[name] = drive(name, run)
        total = float(clean.double().sum())
        means = [total] * len(routes)
        if others:
            means += [float(clean.clamp_min(0).double().sum()),
                      float(image(star, params, geom).image.clamp_min(0)
                            .double().sum())]
        for img, mu in zip(imgs, means):
            t = float(img.double().sum())
            log(f"{name}: image total {t:.1f} vs mean {mu:.1f} "
                f"({(t - mu) / math.sqrt(mu):+.2f} sigma)")
            check(img.shape == geom.canvas_shape and torch.isfinite(img).all()
                  and abs(t - mu) <= 5 * math.sqrt(mu),
                  f"{name}: noisy total {t} vs its mean {mu}")
        check(not torch.equal(imgs[0], imgs[1]),
              f"{name}: two noisy images must differ")
        for kernel, n in least.items():
            check(paths[name].get(kernel, 0) >= n,
                  f"{name} must launch {kernel} at least {n} times: "
                  f"{paths[name]}")
        if name == "nobands_2048":
            k1 = image(star, *flagship(SIZE, 2.0), method="scan").image
            rel = rel_l2(clean, k1)
            log(f"nobands_2048 (K4) noise-free vs K1's banded image of the "
                f"same physics: rel err {rel:.3e}")
            check(rel <= 1e-5, f"K4 image vs K1 image: rel err {rel}")

    def collapsed():
        params, geom = nobands(SCAN_SIZE)
        star = siemens_star((SCAN_SIZE, SCAN_SIZE), device=dev)
        gen = torch.Generator().manual_seed(5)
        return [image(star, params, geom, gen, method="scan",
                      use_pallas=up).image for up in (True, None)]

    imgs, paths["nobands_512_collapsed"] = drive("nobands_512_collapsed",
                                                 collapsed)
    check(paths["nobands_512_collapsed"] == {"rescan_fused": 1,
                                             "poisson_flat": 2},
          f"collapsed: K4 once (use_pallas=True), K2c twice: {paths}")
    for img in imgs:
        check((img >= 0).all() and torch.equal(img, img.round()),
              "collapsed noise must give non-negative counts")
    route_parity(dev)
    return paths


def route_parity(dev) -> None:
    """Each route without band windows, its draws replaced by the identity
    (K4 and the collapsed routes: noise-free), against the analytic image
    on a star with zeroed x-margins: relative L2 <= 1e-5."""
    from rescan_line_sted_torch import rescanned_line_sted_image as image
    from rescan_line_sted_torch.data import siemens_star
    from rescan_line_sted_torch.imaging import rescan

    def identity(lam, generator=None):
        return lam.clamp_min(0)

    cases = (("nobands_2048 K4", SIZE, 2.0, None, dict(use_pallas=True)),
             ("rescan_128 K4", 128, 2.0, False, dict(use_pallas=True)),
             ("512^2 phase accumulation", SCAN_SIZE, 2.0, None, {}),
             ("512^2 subpixel K2b", SCAN_SIZE, 1.5, None, dict(
                 noise_mode="per_step")),
             ("512^2 scatter K5", SCAN_SIZE, 2.0, None, dict(
                 noise_mode="per_step", use_pallas=False)),
             ("512^2 subpixel K2c", SCAN_SIZE, 1.5, None, dict(
                 noise_mode="per_step", use_pallas=False)))
    orig = rescan.poisson_rows_tiered, rescan.maybe_poisson
    for name, size, rf, model, kw in cases:
        params, geom = nobands(size, rf, 1, model)
        star = zero_margins(siemens_star((size, size), device=dev),
                            min(64, size // 8))
        gen = torch.Generator().manual_seed(0) if "noise_mode" in kw else None
        rescan.poisson_rows_tiered = identity
        rescan.maybe_poisson = lambda g, m: m if g is None else identity(m)
        try:
            got = image(star, params, geom, gen, method="scan", **kw).image
        finally:
            rescan.poisson_rows_tiered, rescan.maybe_poisson = orig
        rel = rel_l2(got, image(star, params, geom).image)
        log(f"{name}: draws replaced by the identity, vs analytic: rel err "
            f"{rel:.3e}")
        check(rel <= 1e-5, f"{name} vs analytic rel err {rel}")


def phase_times_nobands(dev) -> dict:
    """CUDA-event times (ms): K4 noisy and noise-free against its plain
    version and ``k4_bound`` on the 2048^2 cell, K5 against its plain
    version and ``index_add_``, K2b on the rescan hybrid's frames, each
    new path's per-step image, and one profiler image per path."""
    from rescan_line_sted_torch import rescanned_line_sted_image as image
    from rescan_line_sted_torch.data import siemens_star
    from rescan_line_sted_torch.imaging import rescan
    from rescan_line_sted_torch.kernels.rescan_accumulate import (
        _cols, rescan_accumulate, rescan_accumulate_reference)
    from rescan_line_sted_torch.kernels.rescan_fused import (
        chunk_paths, rescan_fused, rescan_fused_reference)

    cpu_gen = torch.Generator().manual_seed(4)
    dev_gen = torch.Generator(dev).manual_seed(4)
    stars = {n: siemens_star((n, n), device=dev)
             for n in (SIZE, SCAN_SIZE, 128)}
    runs = {}
    for name, (size, rf, b, model, routes, _) in NOBAND_PATHS.items():
        params, geom = nobands(size, rf, b, model)
        runs[name] = (lambda p=params, g=geom, s=stars[size], kw=routes[0]:
                      image(s, p, g, cpu_gen, method="scan",
                            noise_mode="per_step", **kw), size)
    e2e, busy = {}, {}
    for name, (fn, steps) in runs.items():
        e2e[name] = cuda_ms(fn)
        log(f"time e2e per-step {name} {e2e[name]:.4f} ms, "
            f"{steps / (e2e[name] * 1e-3):.1f} steps/s")
        ms, top = device_busy(fn)
        busy[name] = {"device_ms": ms, "top": top}
        log(f"profile {name}: device busy {ms:.3f} ms, idle "
            f"{1.0 - ms / e2e[name]:.1%} of the timed image; largest: "
            f"{json.dumps([[round(t, 3), k[:60], n] for t, k, n in top])}")

    args = k4_inputs(*nobands(SIZE), stars[SIZE])
    bound, by, counts = k4_bound(args)
    counts["chunk_paths"] = chunk_paths(SIZE, 1, args[1], args[2])
    k4 = {"ms": cuda_ms(lambda: rescan_fused(*args, generator=cpu_gen)),
          "plain_ms": cuda_ms(lambda: rescan_fused_reference(
              *args, generator=dev_gen)),
          "noise_free_ms": cuda_ms(lambda: rescan_fused(*args)),
          "noise_free_plain_ms": cuda_ms(lambda: rescan_fused_reference(
              *args)),
          "bound_ms": bound, "bound_by": by,
          "noise_free_bound_ms": k4_bound(args, noisy=False)[0], **counts}
    k4["device_ms"] = device_busy(
        lambda: rescan_fused(*args, generator=cpu_gen))[0]
    log(f"time rescan_fused {json.dumps(k4)}")

    canvas, frames, offsets = k5_inputs(dev)
    n, h, w = frames.shape
    cols = _cols(offsets, w, canvas.shape[1]).reshape(-1)
    src = frames.permute(1, 0, 2).reshape(h, n * w).contiguous()
    target = canvas.clone()
    k5 = {"ms": cuda_ms(lambda: rescan_accumulate(canvas, frames, offsets)),
          "plain_ms": cuda_ms(lambda: rescan_accumulate_reference(
              canvas, frames, offsets)),
          "library_ms": cuda_ms(lambda: target.index_add_(1, cols, src)),
          "shape": [n, h, w, canvas.shape[1]]}
    k5["bound_ms"], k5["bound_by"] = roofline(
        float(n * h * w), 4 * (n * h * w + 2 * canvas.numel()))
    k5["device_ms"] = device_busy(
        lambda: rescan_accumulate(canvas, frames, offsets))[0]
    k5["library_device_ms"] = device_busy(
        lambda: target.index_add_(1, cols, src))[0]
    k5["device_over_bound"] = k5["device_ms"] / k5["bound_ms"]
    log(f"time rescan_accumulate {json.dumps(k5)}")

    scatter = caller_frames(rescan, runs["nobands_512_scatter"][0],
                            "maybe_poisson")
    k2c = k2c_times("nobands_512_scatter's frames", scatter, canvas.device)
    k2c["draws"] = draw_checks("nobands_512_scatter's frames", scatter,
                               canvas.device, True)

    hybrid = caller_frames(rescan, runs["nobands_512_subpixel"][0])
    k2b = k2b_times("nobands_512_subpixel's frames", hybrid, dev)
    return {"e2e": e2e, "busy": busy, "rescan_fused": k4,
            "rescan_accumulate": k5, "k2b": k2b, "k2c": k2c}


# ---- rescanned point-STED (ISM): K2b's last caller, K2c -------------------

ISM_SIZE = 256                                # bench.py:395-410


def ism_setup(size, rescan_factor=2.0, binning=1, chunk=64):
    from rescan_line_sted_torch import (
        Grid, PointSTEDParams, RescanPointGeometry)

    return (PointSTEDParams.create(depletion=8.0, **POINT_KW),
            RescanPointGeometry(Grid(size, size), rescan_factor=rescan_factor,
                                binning=binning, chunk=chunk))


def zero_frame(sample, margin):
    """``sample`` with a zeroed frame of ``margin`` pixels on every edge:
    both axes of ISM reassign, so scan and closed form agree only there."""
    out = torch.zeros_like(sample)
    out[margin:-margin, margin:-margin] = sample[margin:-margin,
                                                 margin:-margin]
    return out


def ism_closed_form_c128(sample, params, geom) -> np.ndarray:
    """The b = 1 ISM closed form in complex128 on the host (numpy), from
    the port's float32 PSFs: the reference for the card's complex64
    products."""
    from rescan_line_sted_torch.physics import models, psf

    h, w = geom.grid.shape
    hc, wc = geom.canvas_shape
    r = float(geom.rescan_factor)
    eff = models.effective_point_psf((h, w), params).double().numpy()
    det = psf.detection_psf((h, w), params.sigma_det).double().numpy()
    ky, kx = np.arange(hc), np.arange(wc // 2 + 1)
    ay, ax = np.arange(h), np.arange(w)

    def ph(theta):
        return np.exp(-2j * np.pi * theta)

    s_hat = (ph(ky[None] * r * ay[:, None] / hc).T
             @ sample.double().cpu().numpy()) @ ph(kx[None] * r * ax[:, None]
                                                   / wc)
    e_hat = (ph(-ky[None] * (r - 1) * (ay - h // 2)[:, None] / hc).T @ eff) \
        @ ph(-kx[None] * (r - 1) * (ax - w // 2)[:, None] / wc)
    d_embed = np.zeros((hc, wc))
    d_embed[:h, :w] = det
    d_hat = np.fft.rfft2(d_embed) * ph(-ky * (h // 2) / hc)[:, None] \
        * ph(-kx * (w // 2) / wc)[None, :]
    return params.brightness * np.fft.irfft2(s_hat * e_hat * d_hat,
                                             s=(hc, wc))


def ism_path(name, sample, params, geom, per_step=1, collapsed=False):
    """Drive one ISM path (noise-free analytic, a noisy analytic image, and
    with ``per_step`` / ``collapsed`` that many per-step scans and a
    collapsed one), counters reset before and read after; every noisy
    total within 5 sigma of its mean. Returns the launch counts."""
    from rescan_line_sted_torch import rescanned_point_sted_image as image

    gen = torch.Generator().manual_seed(2027)

    def run():
        ana = image(sample, params, geom).image
        imgs = {"analytic": image(sample, params, geom, gen).image}
        clean = None
        if per_step or collapsed:
            clean = image(sample, params, geom, method="scan").image
        for k in range(per_step):
            imgs[f"per_step_{k}"] = image(
                sample, params, geom, gen, method="scan",
                noise_mode="per_step").image
        if collapsed:
            imgs["collapsed"] = image(sample, params, geom, gen,
                                      method="scan").image
        return ana, clean, imgs

    (ana, clean, imgs), launches = drive(name, run)
    for kind, img in imgs.items():
        # per-step draws every (non-negative) frame element and placement
        # keeps the sum; collapsed and analytic noise draw the clamped canvas
        mean = (clean if kind.startswith("per_step") else
                clean.clamp_min(0) if kind == "collapsed" else
                ana.clamp_min(0))
        mu = float(mean.double().sum())
        t = float(img.double().sum())
        log(f"{name} {kind}: canvas {tuple(img.shape)} total {t:.1f} vs "
            f"mean {mu:.1f} ({(t - mu) / math.sqrt(mu):+.2f} sigma)")
        check(img.shape == geom.canvas_shape and torch.isfinite(img).all()
              and abs(t - mu) <= 5 * math.sqrt(mu),
              f"{name} {kind}: noisy total {t} vs its mean {mu}")
    chunks = geom.num_steps // geom.chunk
    check(launches.get("poisson_rows_tiered", 0) == per_step * chunks,
          f"{name}: K2b once per chunk of every per-step image: {launches}")
    check(launches.get("poisson_flat", 0) == 1 + int(collapsed),
          f"{name}: K2c once per analytic and collapsed image: {launches}")
    return launches


def ism_identity_routes(dev) -> dict:
    """Each K2b route of the ISM scan with its draws replaced by the
    identity, and the noise-free scan, against the analytic canvas on a
    star with a zeroed frame (relative L2 <= 1e-5); padded scan against
    padded analytic, apodized totals. Returns the errors."""
    from rescan_line_sted_torch import rescanned_point_sted_image as image
    from rescan_line_sted_torch.data import siemens_star
    from rescan_line_sted_torch.imaging import rescan_point

    errs = {}
    orig = rescan_point.poisson_rows_tiered
    for name, (size, rf, b) in {"ism_256": (ISM_SIZE, 2.0, 1),
                                "ism_256_b2": (ISM_SIZE, 2.0, 2),
                                "ism_128_subpixel": (128, 1.5, 1)}.items():
        params, geom = ism_setup(size, rf, b)
        star = zero_frame(siemens_star((size, size), device=dev), size // 8)
        ana = image(star, params, geom).image
        scan = image(star, params, geom, method="scan").image
        rescan_point.poisson_rows_tiered = lambda lam, g: lam.clamp_min(0)
        try:
            ident = image(star, params, geom, torch.Generator().manual_seed(0),
                          method="scan", noise_mode="per_step").image
        finally:
            rescan_point.poisson_rows_tiered = orig
        errs[name] = {"scan": rel_l2(scan, ana), "identity": rel_l2(ident,
                                                                    ana)}
        log(f"{name}: noise-free scan vs analytic rel err "
            f"{errs[name]['scan']:.3e}; per-step route, draws replaced by "
            f"the identity, vs analytic {errs[name]['identity']:.3e}")
        check(max(errs[name].values()) <= 1e-5,
              f"{name} scan / identity route vs analytic: {errs[name]}")
    params, geom = ism_setup(ISM_SIZE)
    star = siemens_star((ISM_SIZE, ISM_SIZE), device=dev)
    scan = image(star, params, geom, method="scan", boundary="padded").image
    errs["padded"] = rel_l2(scan, image(star, params, geom,
                                        boundary="padded").image)
    log(f"ism_256 padded: scan vs analytic rel err {errs['padded']:.3e}, "
        f"canvas {tuple(scan.shape)}")
    check(scan.shape == geom.canvas_shape and errs["padded"] <= 1e-5,
          f"ism_256 padded scan vs analytic: {errs['padded']}")
    # the apodized sample still reaches within the PSF of the edges, so its
    # circular scan and closed form differ at the seam; their totals agree
    scan = image(star, params, geom, method="scan", boundary="apodized").image
    ana = image(star, params, geom, boundary="apodized").image
    errs["apodized_total"] = abs(float(scan.double().sum())
                                 / float(ana.double().sum()) - 1.0)
    log(f"ism_256 apodized: scan vs analytic rel err {rel_l2(scan, ana):.3e}, "
        f"totals differ by {errs['apodized_total']:.2e} (relative)")
    check(scan.shape == geom.canvas_shape and torch.isfinite(scan).all()
          and errs["apodized_total"] <= 1e-5,
          f"ism_256 apodized scan total off by {errs['apodized_total']}")
    return errs


def phase_ism(dev) -> dict:
    """Every ISM path through ``rescanned_point_sted_image``: the full field
    (ism_2048, analytic, K2c), ism_256 (analytic, per-step K2b: 1024 chunks
    of 64, collapsed), ism_256_b2, ism_128_subpixel, padded / apodized;
    the analytic canvas at 512^2 against its complex128 closed form; the
    identity routes; CUDA-event image times and one profiler image each."""
    from rescan_line_sted_torch import rescanned_point_sted_image as image
    from rescan_line_sted_torch.data import siemens_star
    from rescan_line_sted_torch.imaging import rescan_point

    paths = {}
    stars = {n: siemens_star((n, n), device=dev)
             for n in (SIZE, 512, ISM_SIZE, 128)}
    params, geom = ism_setup(SIZE)
    t0 = time.time()
    image(stars[SIZE], params, geom)
    torch.cuda.synchronize()
    first = time.time() - t0
    paths["ism_2048"] = ism_path("ism_2048", stars[SIZE], params, geom,
                                 per_step=0)
    paths["ism_256"] = ism_path("ism_256", stars[ISM_SIZE],
                                *ism_setup(ISM_SIZE), collapsed=True)
    paths["ism_256_b2"] = ism_path("ism_256_b2", stars[ISM_SIZE],
                                   *ism_setup(ISM_SIZE, binning=2))
    paths["ism_128_subpixel"] = ism_path("ism_128_subpixel", stars[128],
                                         *ism_setup(128, 1.5))

    def boundaries():
        return [image(stars[ISM_SIZE], *ism_setup(ISM_SIZE), method=m,
                      boundary=bd).image
                for bd in ("padded", "apodized")
                for m in ("analytic", "scan")]

    _, paths["ism_256_boundaries"] = drive("ism_256 padded / apodized",
                                           boundaries)
    errs = ism_identity_routes(dev)
    params, geom = ism_setup(512)
    got = image(stars[512], params, geom).image.double().cpu().numpy()
    want = ism_closed_form_c128(stars[512], params, geom)
    errs["ism_512_c128"] = float(np.linalg.norm(got - want)
                                 / np.linalg.norm(want))
    log(f"ism_512 analytic (complex64 on the card) vs its complex128 closed "
        f"form on the host: rel err {errs['ism_512_c128']:.3e}")
    check(errs["ism_512_c128"] <= 1e-5,
          f"ISM complex64 products off the complex128 closed form: {errs}")

    gen = torch.Generator().manual_seed(6)
    runs = {
        "ism_2048": (lambda: image(stars[SIZE], *ism_setup(SIZE), gen),
                     REPEATS, SIZE ** 2),
        "ism_256": (lambda: image(stars[ISM_SIZE], *ism_setup(ISM_SIZE), gen),
                    REPEATS, ISM_SIZE ** 2),
        "ism_256_per_step": (lambda: image(
            stars[ISM_SIZE], *ism_setup(ISM_SIZE), gen, method="scan",
            noise_mode="per_step"), 3, ISM_SIZE ** 2),
        "ism_256_b2_per_step": (lambda: image(
            stars[ISM_SIZE], *ism_setup(ISM_SIZE, binning=2), gen,
            method="scan", noise_mode="per_step"), 3, ISM_SIZE ** 2),
        "ism_128_subpixel_per_step": (lambda: image(
            stars[128], *ism_setup(128, 1.5), gen, method="scan",
            noise_mode="per_step"), 3, 128 ** 2)}
    e2e, busy = {}, {}
    for name, (fn, repeats, steps) in runs.items():
        e2e[name] = cuda_ms(fn, repeats)
        ms, top = device_busy(fn)
        busy[name] = {"device_ms": ms, "top": top}
        log(f"time e2e {name} {e2e[name]:.4f} ms, "
            f"{steps / (e2e[name] * 1e-3):.1f} steps/s; device busy "
            f"{ms:.3f} ms, idle {1.0 - ms / e2e[name]:.1%}; largest: "
            f"{json.dumps([[round(t, 3), k[:60], n] for t, k, n in top])}")
    e2e["ism_2048_first_call"] = 1e3 * first
    log(f"ism_2048 first analytic image (phase tables built, cached) "
        f"{1e3 * first:.1f} ms")
    frames = caller_frames(rescan_point, runs["ism_256_per_step"][0])
    k2b = k2b_times("ism_256's frames", frames, dev)
    return {"paths": paths, "errs": errs, "e2e": e2e, "busy": busy,
            "k2b": k2b}


# ---- K6: the card's primitive rates and the composite bound --------------

PRIM_SOURCES = {"fma": 117, "uniform": 133, "uniform_block": 133,
                "exp": 151, "inv_term": 167, "knuth_round": 194,
                "place_add": 219, "sgemm": 237, "tf32x3": 237}


def prim_checks(dev) -> tuple[dict, dict]:
    """Each K6 kernel against its plain version on the inputs its rate call
    uses (``primitives.calls``: FILL elements, PLACE_CANVASES canvases at
    ``place_offsets``, the GEMM_SHAPE product), at the reps, constants and
    tolerances of ``primitives.CHECKS``: there one rep more or less moves
    the result past the tolerance, so a kernel that ran another count of
    reps fails. Returns the errors and the plain versions' times (ms, CUDA
    events) at these inputs and reps."""
    from rescan_line_sted_torch.kernels import primitives as prim

    errs, plain_ms = {}, {}
    for name, call in prim.calls(dev, check=True).items():
        reps, tol = prim.CHECKS[name]
        want = call.plain(reps)
        got = call.run(reps)
        torch.cuda.synchronize()
        err = float((got.double() - want.double()).abs().max())
        errs[name] = {"abs": err, "rel": err / float(want.abs().max()),
                      "reps": reps, "shape": list(got.shape)}
        log(f"K6 {name} vs plain at {reps} reps on {list(got.shape)}: max "
            f"abs err {err:.3e}, max rel err {errs[name]['rel']:.3e} "
            f"(tolerance {tol})")
        check(got.shape == want.shape and errs[name]["rel"] <= tol,
              f"K6 {name} vs its plain version: {errs[name]}")
        plain_ms[name] = cuda_ms(lambda: call.plain(reps), 3)
    return errs, plain_ms


def prim_normal_checks(dev) -> dict:
    """K6's two product bodies on seeded standard-normal operands
    (``primitives.normal_operands``: values one TF32 pass does not hold,
    unlike the rate calls' eighths) at each of ``NORMAL_SHAPES`` and
    ``NORMAL_REPS``, each held within ``NORMAL_TOL`` of the float64
    product. On the same inputs one TF32 pass (hi * hi alone,
    ``tf32_passes_reference(passes=1)`` on the host) must miss that bar,
    so the check tells a tf32x3 with wrong or missing lo passes apart.
    Returns the relative errors (max |err| / max |product|) per case."""
    from rescan_line_sted_torch.kernels import primitives as prim

    errs = {}
    for m, k, n in prim.NORMAL_SHAPES:
        a, b = prim.normal_operands(m, k, n)
        for reps in prim.NORMAL_REPS:
            want = prim.product_float64(a, b, reps)
            case = f"{m}x{k}x{n}, reps {reps}"
            errs[case] = {"one_tf32_pass": max_rel(
                prim.tf32_passes_reference(a, b, reps, passes=1), want)}
            check(errs[case]["one_tf32_pass"] > prim.NORMAL_TOL,
                  f"one TF32 pass must miss {prim.NORMAL_TOL} on normal "
                  f"operands {case}: {errs[case]}")
            for name in ("sgemm", "tf32x3"):
                got = getattr(prim, name)(a.to(dev), b.to(dev), reps)
                torch.cuda.synchronize()
                errs[case][name] = max_rel(got, want)
            log(f"K6 products on normal operands {case} against float64: "
                f"max rel err sgemm {errs[case]['sgemm']:.3e}, tf32x3 "
                f"{errs[case]['tf32x3']:.3e}, one TF32 pass (host) "
                f"{errs[case]['one_tf32_pass']:.3e} (tolerance "
                f"{prim.NORMAL_TOL})")
            check(max(errs[case]["sgemm"], errs[case]["tf32x3"])
                  <= prim.NORMAL_TOL,
                  f"K6 products on normal operands {case}: {errs[case]}")
    return errs


def k6_sass() -> dict:
    """Per elementwise K6 body: its loop's instructions per rep by
    ``sass_unit`` and in all (``sass_counts``), counted in the SASS of the
    library this run built (``cuobjdump -sass``), and the reps one pass of
    the loop runs. Fails where a body holds fewer instructions of a unit
    than BODY_NEEDS gives it (``sass_shortfall``): its bound would be too
    long."""
    import shutil

    from rescan_line_sted_torch.kernels import _build

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build.library_path())],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for name, (marker, per_rep) in REP_MARKERS.items():
        kernel = f"{name}_kernel"
        out[name] = sass_counts(
            sass_loop(sass, f"{len(kernel)}{kernel}E"), marker, per_rep)
        short = sass_shortfall(BODY_NEEDS[name], out[name])
        check(not short, f"K6 {name}'s build issues fewer instructions per "
                         f"rep than its function needs (unit: (build, "
                         f"needs)): {short}")
    return out


def prim_bound(name, rate) -> tuple[float, str, str]:
    """The bound of one rate call of a K6 kernel (``rate``: the entry of
    ``primitive_rates``), charged to the unit that limits it
    (``unit_roofline``): an elementwise body's BODY_NEEDS per rep on FILL
    threads against its output written once; place_add's
    read-modify-write, a load and a store of 4 bytes per window element,
    at the shared-memory rate against the canvases read and written once;
    sgemm's FMAs at the fp32 peak and tf32x3's three TF32 passes at the
    tensor cores' (``roofline``), against A and B read and C written.
    Returns the ms, ``"operations"`` or ``"bytes"``, and the unit."""
    from rescan_line_sted_torch.kernels import primitives as prim

    reps = rate["reps"]
    if name in ("sgemm", "tf32x3"):
        m, k, n = prim.GEMM_SHAPE
        nbytes = 4 * (m * k + k * n + m * n)
        if name == "tf32x3":      # three TF32 passes per product
            ms, by = roofline(0.0, nbytes, tc_flops=6.0 * m * k * n * reps)
        else:
            ms, by = roofline(2.0 * m * k * n * reps, nbytes)
        unit = "TF32 tensor cores" if name == "tf32x3" else "FP32"
        return ms, by, unit if by == "operations" else "HBM"
    if name == "place_add":
        elems = prim.PLACE_CANVASES * prim.CANVAS_ROWS * prim.COLS
        return unit_roofline(
            {"shared memory": 8.0 * prim.PLACE_CANVASES * reps * prim.WINDOW},
            4 * (2 * elems + prim.WINDOW + reps))
    return unit_roofline(unit_work(BODY_NEEDS[name], prim.FILL * reps),
                         4 * prim.FILL)


def place_add_cases(dev) -> dict:
    """place_add bit for bit against its plain version (in-order adds on
    the card) on ``primitives.PLACE_CASES``, one launch each; offsets
    outside [0, 2944] raise. Returns each case's reps and canvases."""
    from rescan_line_sted_torch.kernels import _build
    from rescan_line_sted_torch.kernels import primitives as prim

    window = torch.rand((prim.WIN_ROWS, prim.COLS),
                        generator=torch.Generator().manual_seed(6)).to(dev)
    out = {}
    for i in range(len(prim.PLACE_CASES)):
        name, canvas, offsets = prim.place_add_case(i, dev)
        want = prim.place_add_reference(canvas, window, offsets)
        before = _build.LAUNCHES["primitives_place_add"]
        got = prim.place_add(canvas, window, offsets)
        torch.cuda.synchronize()
        check(_build.LAUNCHES["primitives_place_add"] == before + 1
              and torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"K6 place_add bit for bit on {name}")
        out[name] = {"reps": offsets.numel(), "canvases": canvas.shape[0]}
        del canvas, want
    for bad in ([0, 2945], [-1]):
        try:
            prim.place_add(torch.zeros((1, prim.CANVAS_ROWS, prim.COLS),
                                       device=dev), window,
                           torch.tensor(bad, device=dev))
            refused = False
        except ValueError:
            refused = True
        check(refused, f"K6 place_add must refuse offsets {bad}")
    log(f"K6 place_add bit for bit against in-order adds on {len(out)} "
        f"cases: {json.dumps(out)}; offsets 2945 and -1 refused")
    return out


PLACE_LIBRARY_BYTES = 12 << 30   # index_add_'s source at most


def place_add_library(dev, reps: int) -> dict:
    """place_add's sum as one PyTorch call: ``index_add_`` along the
    canvases' rows, the reps' window rows as the index and the windows,
    repeated, as the source (materialized: [canvases, reps * 136, 512]),
    at the rate call's reps or as many as PLACE_LIBRARY_BYTES of source
    hold; its ms (CUDA events) and ms per window."""
    from rescan_line_sted_torch.kernels import primitives as prim

    g = prim.PLACE_CANVASES
    reps = min(reps, PLACE_LIBRARY_BYTES // (4 * g * prim.WINDOW))
    canvas = torch.zeros((g, prim.CANVAS_ROWS, prim.COLS), device=dev)
    window = torch.rand((prim.WIN_ROWS, prim.COLS),
                        generator=torch.Generator().manual_seed(0)).to(dev)
    offs = prim.place_offsets(reps, dev).long()
    index = (offs[:, None]
             + torch.arange(prim.WIN_ROWS, device=dev)).reshape(-1)
    source = window.repeat(reps, 1).expand(g, -1, -1).contiguous()
    ms = cuda_ms(lambda: canvas.index_add_(1, index, source))
    del source
    return {"reps": int(reps), "ms": ms, "ms_per_window": ms / (g * reps)}


def phase_primitives(dev, k1, k3, k4, k2c, k2b) -> dict:
    """K6: every microkernel against its plain version; place_add bit for
    bit on its edge cases (``place_add_cases``); the two product bodies on
    normal operands against float64 (``prim_normal_checks``); the rates
    (``primitive_rates``, counters reset before and read after), the
    product bodies' with their share of the datasheet peak, and every
    body's bound charged to its limiting unit (``prim_bound``, the
    elementwise bodies' from BODY_NEEDS, held under their SASS counted by
    ``k6_sass``) and its share; reps
    cuBLAS products against sgemm and tf32x3 and one ``index_add_``
    against place_add (``place_add_library``); the composite bound of K1
    (flagship, its frames' tiers counted per element, in each of its four
    modes: the convolution at the tf32x3 rate, the spreading taps at the
    FFMA one), K3 (line_2048), K4 (nobands_2048), K2c (``k2c``: its timing
    dicts on the flagship canvas and nobands_512_scatter's frames, with
    their counts) and K2b (``k2b``: on each caller's frames) from those
    rates, each held under the kernel's noisy time measured in this run
    (``k1``, ``k3``, ``k4``: their timing dicts, K3's and K4's with their
    counts)."""
    from rescan_line_sted_torch.kernels import primitives as prim

    errs, plain_ms = prim_checks(dev)
    place_cases = place_add_cases(dev)
    normal = prim_normal_checks(dev)
    t0 = time.time()
    sass = k6_sass()
    log(f"K6 SASS instructions per rep by unit (cuobjdump of the built "
        f"library, {time.time() - t0:.1f} s), each at or above its "
        f"function's needs {json.dumps(BODY_NEEDS)}: {json.dumps(sass)}")
    rates, launches = drive("primitives", lambda: prim.primitive_rates(dev))
    log(f"K6 rates on {card()} ({clocks()}): " + json.dumps(
        {k: {"rate": f"{v['rate']:.4e}", "reps": v["reps"],
             "ms": round(v["ms"], 4)} for k, v in rates.items()}))
    peaks = {"sgemm": PEAK_FLOPS / 2, "tf32x3": PEAK_TF32 / 6}
    for name, unit in (("sgemm", "FFMA"), ("tf32x3", "three TF32 passes")):
        log(f"K6 {name}: {rates[name]['rate']:.4e} fp32 FMA/s, "
            f"{rates[name]['rate'] / peaks[name]:.1%} of the datasheet peak "
            f"{peaks[name]:.4e} ({unit}), {rates[name]['reps']} reps in "
            f"{rates[name]['ms']:.4f} ms, on {card()}")
    m, k, n = prim.GEMM_SHAPE
    g = torch.Generator().manual_seed(0)
    a = (torch.randint(0, 8, (m, k), generator=g) / 8).to(dev)
    b = (torch.randint(0, 8, (k, n), generator=g) / 8).to(dev)
    c = torch.empty((m, n), device=dev)
    library_ms = {}
    for name in ("sgemm", "tf32x3"):     # the same product, each its reps
        reps = rates[name]["reps"]

        def products():
            for _ in range(reps):
                torch.mm(a, b, out=c)

        library_ms[name] = cuda_ms(products)
        log(f"{reps} cuBLAS fp32 products {m}x{k}x{n} (TF32 off): "
            f"{library_ms[name]:.4f} ms = "
            f"{reps * m * k * n / (library_ms[name] * 1e-3):.4e} FMA/s, "
            f"against K6 {name} {rates[name]['rate']:.4e} in "
            f"{rates[name]['ms']:.4f} ms, on {card()}")

    # K1, K2b, K2c and K4 take four elements' uniforms from one Philox
    # block; K3's draws are in its Knuth rounds. K1's convolution runs on
    # the tensor cores (tc_fma), its spreading taps in FFMA (conv_fma).
    counts, measured = {}, {}
    for mode, (_, case) in K1_MODES.items():
        sample_y, plan = k1_inputs(case, dev)
        work = k1_counts(sample_y, plan)
        frames = k1_frames(sample_y, plan)
        sampler = prim.tiered_counts(frames)
        del frames
        counts[mode] = {
            "tc_fma": work["tc_fma"], "conv_fma": work["conv_fma"],
            "exps": sampler["exps"], "philox_blocks": sampler["uniforms"] / 4,
            "inv_terms": sampler["inv_terms"],
            "knuth_rounds": sampler["knuth_rounds"],
            "windows": work["placed"] / prim.WINDOW}
        measured[mode] = k1[mode]["ms"]
    counts.update({
        "line_sted_fused": {"conv_fma": k3["fma"], "exps": k3["exps"],
                            "inv_terms": k3["inv_terms"],
                            "knuth_rounds": k3["knuth_rounds"]},
        "rescan_fused": {"conv_fma": k4["fma"], "exps": k4["exps"],
                         "philox_blocks": k4["uniforms"] / 4,
                         "inv_terms": k4["inv_terms"],
                         "knuth_rounds": k4["knuth_rounds"],
                         "windows": k4["placed"] / prim.WINDOW}})
    measured.update({"line_sted_fused": k3["ms"], "rescan_fused": k4["ms"]})
    for kernel, by_caller in (("poisson_flat", k2c),
                              ("poisson_rows_tiered", k2b)):
        for where, t in by_caller.items():
            counts[f"{kernel} on {where}"] = t["counts"]
            measured[f"{kernel} on {where}"] = t["ms"]
    bounds = {name: {**prim.composite_bound(cn, rates), "counts": cn}
              for name, cn in counts.items()}
    # K4's composite with one Philox block per draw, as its draws were
    # counted before they shared blocks: the work, not the kernel, sets it
    one_each = dict(counts["rescan_fused"],
                    philox_blocks=k4["uniforms"])
    log(f"composite bound rescan_fused with one Philox block per draw: "
        f"{json.dumps(prim.composite_bound(one_each, rates))}")
    log(f"composite bounds (ms) at this run's K6 rates (tf32x3 "
        f"{rates['tf32x3']['rate']:.4e} FMA/s) on {card()}: " + json.dumps(
            {name: round(bounds[name]["total_ms"], 4)
             for name in (*K1_MODES, "line_sted_fused", "rescan_fused")}))
    for name, bd in bounds.items():
        log(f"composite bound {name}: {json.dumps(bd)}; the kernel ran "
            f"{measured[name]:.4f} ms noisy, "
            f"{measured[name] / bd['total_ms']:.2f}x the bound")
        check(measured[name] >= bd["total_ms"],
              f"{name} ran {measured[name]} ms, under its composite bound "
              f"{bd['total_ms']} ms: the bound overcounts")
    place_lib = place_add_library(dev, rates["place_add"]["reps"])
    place_rate = rates["place_add"]["rate"]
    log(f"index_add_ of place_add's sum, {place_lib['reps']} reps on "
        f"{prim.PLACE_CANVASES} canvases: {place_lib['ms']:.4f} ms, "
        f"{place_lib['ms_per_window'] * 1e3:.4f} us per window, against K6 "
        f"place_add {1e3 / place_rate * 1e3:.4f} us per window "
        f"({place_rate:.4e} windows/s), on {card()}")
    library_ms["place_add"] = place_lib["ms"]
    entries = {}
    for name, rate in rates.items():
        bound, by, unit = prim_bound(name, rate)
        entries[name] = {"ms": rate["ms"], "reps": rate["reps"],
                         "rate_per_s": rate["rate"], "bound_ms": bound,
                         "bound_by": by, "bound_unit": unit,
                         "bound_share": bound / rate["ms"],
                         "needs_per_rep": BODY_NEEDS.get(name),
                         "sass_per_rep": sass.get(name),
                         "plain_ms": plain_ms[name],
                         "plain_at": "the rate call's inputs, the check's "
                                     "reps",
                         "library_ms": library_ms.get(name)}
        log(f"K6 {name}: {rate['rate']:.4e} per s ({rate['reps']} reps in "
            f"{rate['ms']:.4f} ms), bound {bound:.4f} ms by {unit}: "
            f"{bound / rate['ms']:.1%} of the bound, on {card()}")
    entries["place_add"].update(
        library_call=f"index_add_ of {place_lib['reps']} reps' windows",
        library_reps=place_lib["reps"],
        library_ms_per_window=place_lib["ms_per_window"],
        ms_per_window=1e3 / place_rate, edge_cases=place_cases)
    for name in [n for n in entries if entries[n]["library_ms"] is None]:
        entries[name]["library_call"] = "(no one PyTorch call)"
    for name in ("sgemm", "tf32x3"):
        entries[name]["library_call"] = (
            f"{rates[name]['reps']} torch.mm, TF32 off")
        entries[name]["peak_share"] = rates[name]["rate"] / peaks[name]
        entries[name]["normal_operands_rel_err"] = {
            case: e[name] for case, e in normal.items()}
    return {"errs": errs, "rates": rates, "launches": launches,
            "bounds": bounds, "entries": entries, "library_ms": library_ms,
            "normal": normal}


SWEEP_SIZE = 256               # bench.py:71, the dose sweep's grid
SWEEP_POWERS = 8               # bench.py:72, linspace(0, 16) (:419)
SWEEP_BUDGET = 100.0           # bench.py:424
ORACLE_POINT_STEPS = 512       # bench.py:73
ORACLE_LINE_STEPS = 64         # bench.py:74
FIGURE_POWERS = (0.0, 4.0, 8.0, 16.0)
FIGURE_BUDGET = 5000.0         # tests/test_sweeps.py:175-177
SWEEP_COLUMNS = ("image", "fwhm_x", "fwhm_y", "emitted_signal", "exposure")


def bench_sweep_args(dev) -> dict:
    """``bench_tpu_sweep``'s cell (``bench.py:413-459``): 256^2 siemens
    star, POINT_KW / LINE_KW, 8 powers over [0, 16], budget 100, the
    point and line arms."""
    from rescan_line_sted_torch import (
        Grid, LineSTEDGeometry, LineSTEDParams, PointSTEDGeometry,
        PointSTEDParams)
    from rescan_line_sted_torch.data import siemens_star

    grid = Grid(SWEEP_SIZE, SWEEP_SIZE)
    return dict(sample=siemens_star((SWEEP_SIZE, SWEEP_SIZE), device=dev),
                point_base=PointSTEDParams.create(**POINT_KW),
                line_base=LineSTEDParams.create(**LINE_KW),
                point_geom=PointSTEDGeometry(grid),
                line_geom=LineSTEDGeometry(grid),
                depletion_powers=np.linspace(0.0, 16.0, SWEEP_POWERS),
                dose_budget=SWEEP_BUDGET)


def figure_sweep_args(dev) -> dict:
    """All four arms as ``pipelines/report.py:161-175`` sets them up,
    without fusion, at 2048^2: default params at brightness 1, R = 2 for
    the rescan and ISM arms, two orientations, budget 5000."""
    from rescan_line_sted_torch import (
        Grid, LineSTEDGeometry, LineSTEDParams, PointSTEDGeometry,
        PointSTEDParams, RescanGeometry, RescanPointGeometry)
    from rescan_line_sted_torch.data import siemens_star

    grid = Grid(SIZE, SIZE)
    return dict(sample=siemens_star((SIZE, SIZE), device=dev),
                point_base=PointSTEDParams.create(brightness=1.0),
                line_base=LineSTEDParams.create(brightness=1.0),
                point_geom=PointSTEDGeometry(grid),
                line_geom=LineSTEDGeometry(grid),
                depletion_powers=FIGURE_POWERS, dose_budget=FIGURE_BUDGET,
                orientations=2,
                rescan_geom=RescanGeometry(grid, rescan_factor=2.0),
                ism_geom=RescanPointGeometry(grid, rescan_factor=2.0))


def oracle_sweep_s() -> tuple[float, float, float]:
    """The float64 numpy oracle's cost of the bench cell's sweep, as
    ``bench_oracle_sweep`` (``bench.py:462-509``) takes it: per-step costs
    timed on 512 point and 64 line steps (each subset twice, the minimum
    kept), times the steps of one point and one line image per power.
    Returns (seconds per sweep, s per point step, s per line step)."""
    import importlib.util

    from rescan_line_sted_torch.data import siemens_star

    # by path: an installed package named ``tests`` would shadow the repo's
    spec = importlib.util.spec_from_file_location(
        "oracle", os.path.join(ROOT, "tests", "oracle", "oracle.py"))
    oracle = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(oracle)
    n = SWEEP_SIZE
    sample = siemens_star((n, n), device="cpu").double().numpy()
    rng = np.random.default_rng(0)
    shape = sample.shape
    exc = oracle.gaussian_psf(shape, POINT_KW["sigma_exc"])
    dep = oracle.donut_psf(shape, POINT_KW["sigma_dep"])
    eff = oracle.effective_psf(exc, dep, 8.0)
    det = oracle.detection_psf(shape, POINT_KW["sigma_det"])
    pin = oracle.pinhole_mask(shape, POINT_KW["pinhole_radius"])
    point_per_step = 1e9
    for _ in range(2):
        t0 = time.perf_counter()
        for step in range(ORACLE_POINT_STEPS):
            y0, x0 = step // n, step % n
            ill = oracle.shift_to(eff, y0, x0)
            cam = oracle.fft_convolve(sample * ill, det)
            cam = rng.poisson(np.maximum(cam, 0.0)).astype(np.float64)
            _ = np.sum(cam * oracle.shift_to(pin, y0, x0))
        point_per_step = min(point_per_step, (time.perf_counter() - t0)
                             / ORACLE_POINT_STEPS)
    excl = oracle.line_excitation_profile(n, LINE_KW["sigma_exc"])
    depl = oracle.stripe_depletion_profile(n, LINE_KW["stripe_period"])
    effl = oracle.effective_psf(excl, depl, 8.0)
    slit = oracle.slit_profile(n, LINE_KW["slit_halfwidth"])
    line_per_step = 1e9
    for _ in range(2):
        t0 = time.perf_counter()
        for x0 in range(ORACLE_LINE_STEPS):
            ill = oracle.shift_profile_to(effl, x0)[None, :]
            cam = oracle.fft_convolve(sample * ill, det)
            cam = rng.poisson(np.maximum(cam, 0.0)).astype(np.float64)
            _ = cam @ oracle.shift_profile_to(slit, x0)
        line_per_step = min(line_per_step, (time.perf_counter() - t0)
                            / ORACLE_LINE_STEPS)
    per_point = n * n * point_per_step + n * line_per_step
    return per_point * SWEEP_POWERS, point_per_step, line_per_step


def sweep_totals(name, noisy, clean, arms) -> None:
    """Every noisy image total within 5 sigma of its noise-free mean."""
    worst = 0.0
    for arm in arms:
        for img, mean in zip(getattr(noisy, arm).image,
                             getattr(clean, arm).image):
            mu = float(mean.clamp_min(0).double().sum())
            z = (float(img.double().sum()) - mu) / math.sqrt(mu)
            check(abs(z) <= 5, f"{name} {arm}: noisy total {z:+.2f} sigma "
                  "from its mean")
            worst = max(worst, abs(z))
    log(f"{name}: every noisy total within {worst:.2f} sigma of its mean")


def sweep_no_sync(args, dev) -> int:
    """The bench cell's sweep under sync-debug mode: with a CPU generator
    nothing synchronises (mode "error" raises on a sync); with a CUDA
    generator the seed table is read once per sweep (mode "warn",
    counted). Returns that count."""
    import warnings

    from rescan_line_sted_torch.sweeps import dose_matched_sweep as sweep

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sweep(generator=torch.Generator().manual_seed(5), **args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            sweep(generator=torch.Generator(dev).manual_seed(5), **args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    syncs = [str(w.message) for w in caught
             if "synchroniz" in str(w.message)]
    log(f"dose_sweep under sync-debug mode: CPU generator no sync; CUDA "
        f"generator {len(syncs)} sync(s): {json.dumps(syncs[:3])}")
    check(len(syncs) <= 1, "the sweep must sync at most once (a CUDA "
          f"generator's seed table), not per point: {len(syncs)}")
    return len(syncs)


def phase_sweep(dev) -> dict:
    """The dose-matched sweep (``sweeps/dose.py``) on the card: the bench
    cell, its launches, time, device-busy share and the oracle's speedup;
    the 2048^2 four-arm figure sweep with FRC; card against CPU; K2c's
    counts on a sweep image against its host reference."""
    from rescan_line_sted_torch.physics.dose import (
        line_sted_dose, point_sted_dose)
    from rescan_line_sted_torch.sweeps import dose_matched_sweep as sweep
    from rescan_line_sted_torch.sweeps.dose import arm_generators

    name_power = card()
    args = bench_sweep_args(dev)
    out = {"paths": {}, "e2e": {}}

    # the main path: the bench cell with a CUDA generator
    noisy, out["paths"]["dose_sweep"] = drive("dose_sweep", lambda: sweep(
        generator=torch.Generator(dev).manual_seed(100), **args))
    n_k2c = out["paths"]["dose_sweep"].get("poisson_flat", 0)
    check(out["paths"]["dose_sweep"] == {"poisson_flat": 2 * SWEEP_POWERS},
          f"dose_sweep must launch K2c once per arm and point (16) and "
          f"nothing else: {out['paths']['dose_sweep']}")
    clean = sweep(**args)
    cpu = sweep(device="cpu", **args)
    errs = {}
    for arm in ("point", "line"):
        for col in SWEEP_COLUMNS:
            got, want = getattr(getattr(clean, arm), col), \
                getattr(getattr(cpu, arm), col)
            check(got.is_cuda and got.shape == want.shape,
                  f"dose_sweep {arm}.{col}: on the card, CPU's shape")
            errs[f"{arm}.{col}"] = float(
                (got.double().cpu() - want.double()).abs().max()
                / want.double().abs().max())
        fx = getattr(clean, arm).fwhm_x
        check(bool((fx[1:] < fx[:-1]).all()),
              f"dose_sweep {arm}: fwhm_x must fall with depletion: {fx}")
    log(f"dose_sweep card vs CPU, noise-free (max rel): {json.dumps(errs)}")
    check(max(errs.values()) <= 1e-5,
          f"dose_sweep card vs CPU beyond 1e-5: {errs}")
    out["errs"] = errs
    sweep_totals("dose_sweep", noisy, clean, ("point", "line"))
    # K2c's counts on the sweep's point and line images of its second power
    # (rates up to ~1.4: every warp below the bright cut; at s = 0 nearly
    # every warp is bright), with either generator (arm_generators:
    # [arm][point][draw])
    out["draws"] = {}
    for gname, make in (("cpu_generator", lambda: torch.Generator()),
                        ("cuda_generator", lambda: torch.Generator(dev))):
        drawn = sweep(generator=make().manual_seed(21), **args)
        for a, arm in enumerate(("point", "line")):
            out["draws"][f"{arm} {gname}"] = frames_draw_for_draw(
                f"dose_sweep {arm} image 1 ({gname})",
                getattr(clean, arm).image[1], flat=True,
                counts=getattr(drawn, arm).image[1],
                generator=lambda a=a: arm_generators(
                    make().manual_seed(21), SWEEP_POWERS)[a][1][0])
    out["syncs"] = sweep_no_sync(args, dev)
    out["k2c"] = k2c_times("dose_sweep point image 0", clean.point.image[0],
                           dev)

    gen = torch.Generator(dev).manual_seed(101)
    ms = cuda_ms(lambda: sweep(generator=gen, **args))
    busy_ms, rows = device_busy(lambda: sweep(generator=gen, **args))
    oracle_s, point_step, line_step = oracle_sweep_s()
    out["bench"] = {
        "ms": ms, "device_busy_ms": busy_ms, "busy_share": busy_ms / ms,
        "poisson_flat_launches": n_k2c, "oracle_s": oracle_s,
        "oracle_point_step_s": point_step, "oracle_line_step_s": line_step,
        "speedup": oracle_s / (ms / 1e3), "device_rows": rows}
    out["e2e"]["dose_sweep (whole sweep)"] = ms
    log(f"dose_sweep {SWEEP_SIZE}^2, {SWEEP_POWERS} powers, point + line, "
        f"budget {SWEEP_BUDGET:g}, CUDA generator: {ms:.3f} ms per sweep "
        f"(CUDA events, median of {REPEATS}) | {name_power}")
    log(f"dose_sweep device busy {busy_ms:.3f} ms of {ms:.3f} "
        f"({busy_ms / ms:.1%}; largest rows {json.dumps(rows[:3])}) | "
        f"{name_power}")
    log(f"dose_sweep poisson_flat launches {n_k2c} (16 expected) | "
        f"{name_power}")
    log(f"dose_sweep oracle (float64 numpy, this host): {oracle_s:.2f} s "
        f"per sweep ({point_step * 1e3:.3f} ms per point step, "
        f"{line_step * 1e3:.3f} ms per line step); speedup "
        f"{oracle_s / (ms / 1e3):.1f}x | {name_power}")

    # the figure sweep: four arms, FRC, 2048^2
    fargs = figure_sweep_args(dev)
    t0 = time.time()
    fclean = sweep(**fargs)
    torch.cuda.synchronize()
    clean_s = time.time() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def figure():
        start.record()
        res = sweep(generator=torch.Generator(dev).manual_seed(7), frc=True,
                    **fargs)
        end.record()
        return res

    fnoisy, out["paths"]["dose_sweep_2048"] = drive("dose_sweep_2048",
                                                    figure)
    fig_ms = start.elapsed_time(end)
    arms = ("point", "line", "rescan", "ism")
    check(out["paths"]["dose_sweep_2048"].get("poisson_flat") ==
          len(arms) * len(FIGURE_POWERS) * 2,
          "the figure sweep must draw two images per arm and point on K2c")
    for arm in arms:
        fx = getattr(fclean, arm).fwhm_x
        check(bool((fx[1:] < fx[:-1]).all()),
              f"figure sweep {arm}: fwhm_x must fall with depletion: {fx}")
    for i, s in enumerate(FIGURE_POWERS):
        pd = point_sted_dose(fargs["point_base"].replace(depletion=s),
                             fargs["point_geom"], dev)
        ld = line_sted_dose(fargs["line_base"].replace(depletion=s),
                            fargs["line_geom"], dev)
        for arm, total in (("point", pd.total_dose), ("ism", pd.total_dose),
                           ("line", ld.total_dose * 2),
                           ("rescan", ld.total_dose * 2)):
            dose = float(getattr(fnoisy, arm).exposure[i] * total)
            check(abs(dose - FIGURE_BUDGET) <= 1e-5 * FIGURE_BUDGET,
                  f"figure sweep {arm} at s = {s}: exposure x dose {dose}")
    frc = {arm: getattr(fnoisy, arm).frc_resolution for arm in arms}
    frc_xy = (fnoisy.rescan.frc_resolution_x, fnoisy.rescan.frc_resolution_y)
    for arm in ("point", "line", "ism"):
        check(bool(torch.isfinite(frc[arm]).all() and (frc[arm] >= 2).all()),
              f"figure sweep {arm}: FRC resolution {frc[arm]}")
    check(frc["rescan"] is None and all(
        bool(torch.isfinite(c).all()) for c in frc_xy),
        f"figure sweep rescan: radial None, per-axis finite: {frc_xy}")
    sweep_totals("figure sweep", fnoisy, fclean, arms)
    out["figure"] = {
        "ms": fig_ms, "noise_free_wall_s": clean_s,
        "fwhm_x": {a: getattr(fclean, a).fwhm_x.tolist() for a in arms},
        "frc": {a: frc[a].tolist() for a in ("point", "line", "ism")},
        "rescan_frc_xy": [c.tolist() for c in frc_xy]}
    out["e2e"]["dose_sweep_2048 (four arms, frc, whole sweep)"] = fig_ms
    log(f"figure sweep {SIZE}^2, powers {list(FIGURE_POWERS)}, four arms, "
        f"two orientations, frc, budget {FIGURE_BUDGET:g}: {fig_ms:.1f} ms "
        f"(CUDA events, one sweep; the noise-free sweep before it "
        f"{clean_s:.2f} s wall, its first) | {name_power}")
    log(f"figure sweep: {json.dumps(out['figure'])}")
    return out


FOV_SIZES = (128, 256, 512, 2048)   # figures.py:403-412 and bench.py:321-353
FOV_ANGLES = 4
FOV_ITERS = 40
FOV_SCAN_SIZE = 512
FOV_COLUMNS = ("fused_fwhm_y", "fused_fwhm_x", "view_kernel_fwhm_y",
               "view_kernel_fwhm_x")


def fov_setup(size, dev):
    """The FOV sweep's inputs at one size (``sweeps/fov.py``): params at
    depletion 8 and brightness 200 (``figures.py:403-412``), the lattice
    sample, chunk min(32, size), angles ``arange(4) * pi / 4``."""
    from rescan_line_sted_torch import Grid, LineSTEDGeometry, LineSTEDParams
    from rescan_line_sted_torch.data import sparse_points

    params = LineSTEDParams.create(depletion=8.0, brightness=200.0)
    geom = LineSTEDGeometry(Grid(size, size), chunk=min(32, size))
    angles = torch.arange(FOV_ANGLES, dtype=torch.float32) * (
        math.pi / FOV_ANGLES)
    return params, geom, sparse_points((size, size), device=dev), angles


def max_rel(got, want) -> float:
    return float((got.double().cpu() - want.double().cpu()).abs().max()
                 / want.double().abs().max())


def fov_card_vs_cpu(dev) -> dict:
    """Noise-free at 128^2 and 256^2, on the card against ``device="cpu"``:
    the rotation, the orientation kernels, the views, the fused image
    after 40 RL iterations (plain and accelerated) and every FWHM column
    of the records; the rotation also at 2048^2."""
    from rescan_line_sted_torch.algorithms import richardson_lucy_views
    from rescan_line_sted_torch.data import siemens_star
    from rescan_line_sted_torch.imaging.orientations import (
        multi_orientation_line_sted, orientation_kernels)
    from rescan_line_sted_torch.sweeps import resolution_fov_sweep
    from rescan_line_sted_torch.utils import rotate_image

    errs = {}
    for n in (128, 256):
        params, geom, sample, angles = fov_setup(n, "cpu")
        errs[f"rotate_{n}"] = max_rel(rotate_image(sample.to(dev), angles),
                                      rotate_image(sample, angles))
        errs[f"orientation_kernels_{n}"] = max_rel(
            orientation_kernels((n, n), params, angles, dev),
            orientation_kernels((n, n), params, angles, "cpu"))
        on = multi_orientation_line_sted(sample, params, geom, angles,
                                         device=dev)
        off = multi_orientation_line_sted(sample, params, geom, angles,
                                          device="cpu")
        errs[f"views_{n}"] = max_rel(on[0], off[0])
        for accel in (False, True):
            errs[f"fused_{n}{'_accelerate' if accel else ''}"] = max_rel(
                richardson_lucy_views(*on, FOV_ITERS, accelerate=accel),
                richardson_lucy_views(*off, FOV_ITERS, accelerate=accel))
        got = resolution_fov_sweep((n,), params, device=dev)[0]
        want = resolution_fov_sweep((n,), params, device="cpu")[0]
        for col in FOV_COLUMNS:
            errs[f"{col}_{n}"] = abs(got[col] - want[col]) / abs(want[col])
    img = siemens_star((SIZE, SIZE), device="cpu") + fov_setup(SIZE, "cpu")[2]
    angles = fov_setup(SIZE, "cpu")[3]
    errs[f"rotate_{SIZE}"] = max_rel(rotate_image(img.to(dev), angles),
                                     rotate_image(img, angles))
    log(f"fov card vs CPU, noise-free (max rel): {json.dumps(errs)}")
    check(max(errs.values()) <= 1e-5, f"fov card vs CPU beyond 1e-5: {errs}")
    return errs


def fov_scan(dev) -> dict:
    """``multi_orientation_line_sted(method="scan")`` at 512^2, 4 angles,
    a CUDA generator: its noise-free views against the analytic ones
    (relative L2 <= 1e-5), and its noisy call on the JAX package's
    default, collapsed noise (K2c once per view). The per-step routes on
    the same rotated samples, through ``line_sted_image`` view after view:
    the default route (banded K2b, once per chunk of each view) and
    ``use_pallas=True`` (K3 once per view). Counters are reset before and
    read after each call; every noisy view's total lies within 5 sigma
    of its noise-free mean."""
    from rescan_line_sted_torch.imaging.line_sted import line_sted_image
    from rescan_line_sted_torch.imaging.orientations import (
        multi_orientation_line_sted as views)
    from rescan_line_sted_torch.utils import rotate_image

    params, geom, sample, angles = fov_setup(FOV_SCAN_SIZE, dev)
    chunks = FOV_SCAN_SIZE // geom.chunk
    clean = views(sample, params, geom, angles, method="scan")[0]
    ana = views(sample, params, geom, angles)[0]
    rel = rel_l2(clean, ana)
    log(f"fov_scan_{FOV_SCAN_SIZE}: noise-free scan vs analytic views rel "
        f"err {rel:.3e}")
    check(rel <= 1e-5, f"fov scan views vs analytic: {rel}")
    rotated = rotate_image(sample, -angles)
    clean_rot = torch.stack([
        line_sted_image(r, params, geom, method="scan").image
        for r in rotated])
    out = {"scan_vs_analytic": rel, "paths": {}}
    gen = torch.Generator(dev).manual_seed(11)

    def per_view(**kw):
        return torch.stack([
            line_sted_image(r, params, geom, gen, method="scan",
                            noise_mode="per_step", **kw).image
            for r in rotated])

    for mode, run, means, want in (
            ("collapsed", lambda: views(sample, params, geom, angles, gen,
                                        method="scan")[0],
             clean, {"poisson_flat": FOV_ANGLES}),
            ("per_step", per_view, clean_rot,
             {"poisson_rows_tiered": FOV_ANGLES * chunks}),
            ("per_step_k3", lambda: per_view(use_pallas=True), clean_rot,
             {"line_sted_fused": FOV_ANGLES})):
        name = f"fov_scan_{FOV_SCAN_SIZE}_{mode}"
        noisy, launched = drive(name, run)
        check(launched == want, f"{name} must launch {want}: {launched}")
        out["paths"][name] = launched
        for v, (img, mean) in enumerate(zip(noisy, means)):
            mu = float(mean.clamp_min(0).double().sum())
            z = (float(img.double().sum()) - mu) / math.sqrt(mu)
            check(abs(z) <= 5, f"{name} view {v}: total {z:+.2f} sigma")
        log(f"{name}: launches {json.dumps(launched)}, every view's total "
            "within 5 sigma")
    return out


def fov_no_sync(dev) -> None:
    """``richardson_lucy_views`` at 512^2 (plain and accelerated) and the
    256^2 size of the sweep, all but its record read (``fov.fused_views``
    with a CUDA generator and ``fov.lattice_fwhm``), under sync-debug mode
    "error" after a warm-up: nothing in them reads the card."""
    from rescan_line_sted_torch.algorithms import richardson_lucy_views
    from rescan_line_sted_torch.imaging.orientations import (
        multi_orientation_line_sted)
    from rescan_line_sted_torch.sweeps import fov

    params, geom, sample, angles = fov_setup(512, dev)
    data, kernels = multi_orientation_line_sted(sample, params, geom, angles)
    p256, g256, s256, a256 = fov_setup(256, dev)
    gen = torch.Generator(dev).manual_seed(12)

    def body():
        for accel in (False, True):
            richardson_lucy_views(data, kernels, FOV_ITERS, accelerate=accel)
        fused, ks = fov.fused_views(s256, p256, g256, a256, FOV_ITERS, gen)
        return fov.lattice_fwhm(fused, ks, 24)

    body()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = body()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(res).all()), f"fov lattice FWHMs: {res}")
    log("richardson_lucy_views (512^2, plain and accelerated) and the "
        "256^2 FOV size with a CUDA generator under sync-debug mode "
        "'error': no sync")


def phase_fov(dev) -> dict:
    """The resolution / FOV sweep (``sweeps/fov.py``, BASELINE config 5)
    on the card: the main path at 128^2-2048^2 with its launches and the
    JAX test's properties, card against CPU, K2c count by count on the
    views, the scan method, the sync checks, and the times."""
    from rescan_line_sted_torch.algorithms import richardson_lucy_views
    from rescan_line_sted_torch.imaging.line_sted import analytic_images
    from rescan_line_sted_torch.imaging.orientations import (
        multi_orientation_line_sted)
    from rescan_line_sted_torch.sweeps import fov, resolution_fov_sweep
    from rescan_line_sted_torch.utils import rotate_image

    name_power = card()
    params = fov_setup(128, dev)[0]
    out = {"paths": {}, "e2e": {}}

    # the main path: the sweep at fov_pipeline's sizes and the large FOV
    recs, out["paths"]["fov_sweep"] = drive("fov_sweep", lambda: (
        resolution_fov_sweep(FOV_SIZES, params, num_angles=FOV_ANGLES,
                             rl_iters=FOV_ITERS,
                             generator=torch.Generator(dev).manual_seed(0))))
    check(out["paths"]["fov_sweep"] == {"poisson_flat": 2 * len(FOV_SIZES)},
          "the FOV sweep must launch K2c once per call (two per size) and "
          f"nothing else: {out['paths']['fov_sweep']}")
    for r in recs:
        check(all(math.isfinite(r[c]) for c in FOV_COLUMNS)
              and r["fused_fwhm_y"] < r["view_kernel_fwhm_y"]
              and r["scan_steps"] == FOV_ANGLES * r["fov"],
              f"FOV record {r}")
        log(f"fov_sweep record: {json.dumps(r)} | {name_power}")
    out["records"] = recs

    out["errs"] = fov_card_vs_cpu(dev)
    # K2c on the views' rates (before the derotation), count by count
    params256, _, s256, a256 = fov_setup(256, dev)
    rates = analytic_images(rotate_image(s256, -a256), params256)
    out["draws"] = draw_checks("fov_views_256", rates, dev, flat=True)
    out["scan"] = fov_scan(dev)
    out["paths"].update(out["scan"]["paths"])
    fov_no_sync(dev)

    # times: each size's sweep body, device-busy share, RL iterations,
    # the acquisition alone
    out["sizes"] = {}
    for r in recs:
        n = r["fov"]
        p, g, s, a = fov_setup(n, dev)
        gen = torch.Generator(dev).manual_seed(13)
        ms = cuda_ms(lambda: fov.fused_views(s, p, g, a, FOV_ITERS, gen))
        busy, rows = device_busy(
            lambda: fov.fused_views(s, p, g, a, FOV_ITERS, gen))
        acq_ms = cuda_ms(lambda: multi_orientation_line_sted(s, p, g, a, gen))
        t = {"compile_s": r["compile_s"], "wall_s": r["wall_s"],
             "ms": ms, "device_busy_ms": busy, "busy_share": busy / ms,
             "acquisition_ms": acq_ms, "device_rows": rows}
        if n in (512, SIZE):
            views, ks = multi_orientation_line_sted(s, p, g, a, gen)
            rl_ms = cuda_ms(lambda: richardson_lucy_views(views, ks,
                                                          FOV_ITERS))
            rl_busy = device_busy(lambda: richardson_lucy_views(
                views, ks, FOV_ITERS))[0]
            t.update(rl_ms_per_iter=rl_ms / FOV_ITERS,
                     rl_device_ms_per_iter=rl_busy / FOV_ITERS)
        if n == SIZE:
            rates = analytic_images(rotate_image(s, -a), p)
            t["k2c"] = k2c_times(f"fov_views_{n}", rates, dev)
            out["k2c"] = t["k2c"]
        out["sizes"][n] = t
        out["e2e"][f"fov_{n} (views + {FOV_ITERS} RL iterations)"] = ms
        log(f"fov_{n}: compile_s {r['compile_s']:.4f} wall_s "
            f"{r['wall_s']:.4f}; views + RL {ms:.3f} ms (CUDA events, median "
            f"of {REPEATS}), device busy {busy:.3f} ms ({busy / ms:.1%}), "
            f"acquisition {acq_ms:.3f} ms"
            + (f", RL {t['rl_ms_per_iter']:.4f} ms per iteration (device "
               f"{t['rl_device_ms_per_iter']:.4f})" if "rl_ms_per_iter" in t
               else "") + f" | {name_power}")
    log(f"fov_sweep: {json.dumps({k: {q: v for q, v in t.items() if q not in ('device_rows', 'k2c')} for k, t in out['sizes'].items()})}")
    return out


FUSED_POWERS = 16          # figures.py:114-180: linspace(0, 16, 16)
REPORT_SIZE, REPORT_POWERS = 192, 6      # report.py:145-175
FUSION_ITERS = 30          # the sweeps' fusion_iters; rescan_fusion's too
FUSION_ANGLES, FUSION_RL = 4, 50         # fusion_pipeline, figures.py:333
CALL_REPEATS = 3


def call_times(fn, profiled=None, warm_up=True) -> dict:
    """Median, min and max ms of ``CALL_REPEATS`` calls of ``fn`` after a
    warm-up (CUDA events; ``warm_up=False`` where the caller has just run
    it), and the device-busy share of one more call, traced on the device
    alone: of ``profiled`` where given, a shorter call of the same work
    per sweep point, its share against its own event time."""
    if warm_up:
        fn()
    torch.cuda.synchronize()
    times = event_ms(fn, CALL_REPEATS)
    ms = float(np.median(times))
    busy_ms = ms
    if profiled is not None:
        profiled()
        busy_ms = event_ms(profiled, 1)[0]
    busy, rows = device_busy(profiled or fn, warm_up=False, host=False)
    return {"ms": ms, "min_ms": min(times), "max_ms": max(times),
            "device_busy_ms": busy, "busy_share": busy / busy_ms,
            "profiled_ms": busy_ms, "device_rows": rows}


def fused_sweep_args(dev, size, powers, ism) -> dict:
    """The fused protocol as the JAX pipelines set it up: siemens star,
    default params at brightness 1, two orientations, rescan R = 2 (and
    ISM R = 2), budget 100, 30 RL iterations."""
    from rescan_line_sted_torch import (
        Grid, LineSTEDGeometry, LineSTEDParams, PointSTEDGeometry,
        PointSTEDParams, RescanGeometry, RescanPointGeometry)
    from rescan_line_sted_torch.data import siemens_star

    grid = Grid(size, size)
    return dict(sample=siemens_star((size, size), device=dev),
                point_base=PointSTEDParams.create(brightness=1.0),
                line_base=LineSTEDParams.create(brightness=1.0),
                point_geom=PointSTEDGeometry(grid),
                line_geom=LineSTEDGeometry(grid),
                depletion_powers=np.linspace(0.0, 16.0, powers),
                dose_budget=100.0, orientations=2,
                rescan_geom=RescanGeometry(grid, rescan_factor=2.0),
                ism_geom=(RescanPointGeometry(grid, rescan_factor=2.0)
                          if ism else None),
                fuse_orientations=True, fusion_iters=FUSION_ITERS)


def sweep_card_vs_cpu(name, clean, cpu, arms) -> dict:
    """Every column of every arm of a noise-free sweep on the card against
    ``device="cpu"`` (max relative error)."""
    errs = {}
    for arm in arms:
        for col in SWEEP_COLUMNS:
            got, want = getattr(getattr(clean, arm), col), \
                getattr(getattr(cpu, arm), col)
            check(got.is_cuda and got.shape == want.shape,
                  f"{name} {arm}.{col}: on the card, CPU's shape")
            errs[f"{arm}.{col}"] = max_rel(got, want)
    log(f"{name} card vs CPU, noise-free (max rel): {json.dumps(errs)}")
    check(max(errs.values()) <= 1e-5, f"{name} card vs CPU beyond 1e-5")
    return errs


def fusion_setup(size, dev, rescan_factor, chunk=32, **kw):
    """``fusion_pipeline(modality="rescan")``'s params (depletion 8,
    brightness 200, R = 2, the default chunk 64 at 256^2) or the
    flagship's (``LINE_KW``, R = 1.5, chunk 32), and the siemens star."""
    from rescan_line_sted_torch import Grid, LineSTEDParams, RescanGeometry
    from rescan_line_sted_torch.data import siemens_star

    geom = RescanGeometry(Grid(size, size), rescan_factor=rescan_factor,
                          chunk=chunk)
    return (LineSTEDParams.create(**kw), geom,
            siemens_star((size, size), device=dev))


def phase_fusion(dev) -> dict:
    """Operator fusion and the dose sweep's fused protocol on the card
    (``algorithms/fusion.py``, ``sweeps/dose.py`` with
    ``fuse_orientations=True``): four configurations, each driven once
    with the counters reset before and read after, then timed, profiled
    and held against ``device="cpu"``."""
    from rescan_line_sted_torch.algorithms import (
        multi_orientation_rescan, rescan_fusion, rescan_operator)
    from rescan_line_sted_torch.sweeps import dose_matched_sweep as sweep

    name_power = card()
    out = {"paths": {}, "e2e": {}, "configs": {}, "errs": {}}

    t_phase = time.time()

    def run(name, fn, want, label, profiled=None):
        log(f"phase_fusion: {name} starts {time.time() - t_phase:.1f} s in")
        res, launched = drive(name, fn)
        check(launched == want, f"{name} must launch {want} and nothing "
              f"else: {launched}")
        t = call_times(fn, profiled, warm_up=False)   # drive warmed it up
        out["paths"][name] = launched
        out["configs"][name] = dict(t, launches=launched)
        out["e2e"][f"{name} ({label})"] = t["ms"]
        log(f"{name}: launches {json.dumps(launched)} (predicted "
            f"{json.dumps(want)}); {t['ms']:.2f} ms per call (CUDA events, "
            f"median of {CALL_REPEATS} after a warm-up, {t['min_ms']:.2f}-"
            f"{t['max_ms']:.2f}), device busy {t['device_busy_ms']:.2f} ms "
            f"of {t['profiled_ms']:.2f} ({t['busy_share']:.1%}"
            f"{'' if profiled is None else ', on two of its points'}); "
            "largest rows "
            f"{json.dumps(t['device_rows'][:3])} | {name_power}")
        return res

    # dose_sweep_fused: the figure pipeline's defaults (figures.py:114-180)
    args = fused_sweep_args(dev, SWEEP_SIZE, FUSED_POWERS, ism=False)
    gen = torch.Generator(dev).manual_seed(30)
    two = dict(args, depletion_powers=args["depletion_powers"][::15])
    noisy = run("dose_sweep_fused", lambda: sweep(generator=gen, **args),
                {"poisson_flat": 3 * FUSED_POWERS},
                f"{SWEEP_SIZE}^2, {FUSED_POWERS} powers, fused, whole sweep",
                lambda: sweep(generator=gen, **two))
    arms = ("point", "line", "rescan")
    log(f"phase_fusion: dose_sweep_fused card vs CPU starts "
        f"{time.time() - t_phase:.1f} s in")
    # noise-free, card vs CPU, on every fifth power (the CPU takes ~1 s per
    # power)
    some = dict(args, depletion_powers=args["depletion_powers"][::5])
    clean = sweep(**some)
    out["errs"]["dose_sweep_fused"] = sweep_card_vs_cpu(
        "dose_sweep_fused (powers 0, 5.3, 10.7, 16)", clean,
        sweep(**dict(some, device="cpu")), arms)
    for arm in arms:
        fx = getattr(clean, arm).fwhm_x
        check(bool(torch.isfinite(getattr(noisy, arm).image).all()),
              f"dose_sweep_fused {arm}: noisy images finite")
        check(float(fx[-1]) < float(fx[0]), f"dose_sweep_fused {arm}: the "
              f"fused FWHM must fall with depletion: {fx}")
    r = clean.rescan
    iso = float((r.fwhm_y[-1] - r.fwhm_x[-1]).abs() / r.fwhm_x[-1])
    log(f"dose_sweep_fused fused FWHM x at s = 0 / 16: "
        f"{json.dumps({a: [float(getattr(clean, a).fwhm_x[0]), float(getattr(clean, a).fwhm_x[-1])] for a in arms})}; "
        f"rescan y/x at s = 16 differ by {iso:.3f}")

    # report_sweep_fused: pipelines/report.py:145-175
    rargs = fused_sweep_args(dev, REPORT_SIZE, REPORT_POWERS, ism=True)
    rgen = torch.Generator(dev).manual_seed(31)
    rtwo = dict(rargs, depletion_powers=rargs["depletion_powers"][::5])
    rnoisy = run("report_sweep_fused",
                 lambda: sweep(generator=rgen, frc=True, **rargs),
                 {"poisson_flat": 4 * 2 * REPORT_POWERS},
                 f"{REPORT_SIZE}^2, {REPORT_POWERS} powers, four arms, frc, "
                 "fused, whole sweep",
                 lambda: sweep(generator=rgen, frc=True, **rtwo))
    arms4 = ("point", "line", "rescan", "ism")
    log(f"phase_fusion: report_sweep_fused card vs CPU starts "
        f"{time.time() - t_phase:.1f} s in")
    rclean = sweep(**rargs)
    out["errs"]["report_sweep_fused"] = sweep_card_vs_cpu(
        "report_sweep_fused", rclean, sweep(**dict(rargs, device="cpu")),
        arms4)
    # FRC: NaN where the curve never falls below 1/7 (the resolution lies
    # beyond the measured band), else >= 2 px
    frcs = {arm: getattr(rnoisy, arm).frc_resolution.tolist()
            for arm in arms4}
    log(f"report_sweep_fused FRC resolutions: {json.dumps(frcs)}")
    for arm, col in frcs.items():
        # Nyquist: 2 px, on ISM's R-magnified canvas 2 / R sample px
        low = 2.0 / rargs["ism_geom"].rescan_factor if arm == "ism" else 2.0
        check(all(math.isnan(v) or low <= v < math.inf for v in col)
              and any(not math.isnan(v) for v in col),
              f"report_sweep_fused {arm}: FRC resolution {col}")

    # fusion_rescan_256: fusion_pipeline(modality="rescan"), figures.py:333
    params, geom, sample = fusion_setup(SWEEP_SIZE, dev, 2.0, chunk=64,
                                        depletion=8.0, brightness=200.0)
    angles = torch.arange(FUSION_ANGLES, dtype=torch.float32) * (
        math.pi / FUSION_ANGLES)
    static = tuple(i * math.pi / FUSION_ANGLES for i in range(FUSION_ANGLES))
    fgen = torch.Generator(dev).manual_seed(32)

    def fusion_256():
        canv = multi_orientation_rescan(sample, params, geom, angles, fgen)
        return canv, rescan_fusion(canv, params, geom, static, FUSION_RL)

    canv, fused = run("fusion_rescan_256", fusion_256, {"poisson_flat": 1},
                      f"{FUSION_ANGLES} views + {FUSION_RL} RL iterations")
    check(bool(torch.isfinite(fused).all() and (fused >= 0).all()),
          "fusion_rescan_256: fused image finite and non-negative")
    clean_canv = multi_orientation_rescan(sample, params, geom, angles)
    cpu_canv = multi_orientation_rescan(sample.cpu(), params, geom, angles,
                                        device="cpu")
    got = rescan_fusion(clean_canv, params, geom, static, FUSION_RL)
    want = rescan_fusion(cpu_canv, params, geom, static, FUSION_RL)
    # the fused image by relative L2: after 50 iterations over four views
    # its max relative error sits at float32's floor (1.08e-5 on an H100,
    # cuBLAS / cuFFT / atomics against MKL / pocketfft order), printed
    out["errs"]["fusion_rescan_256"] = errs = {
        "canvases": max_rel(clean_canv, cpu_canv),
        "fused_rel_l2": rel_l2(got.cpu(), want)}
    fused_max_rel = max_rel(got, want)
    for img, mean in zip(canv, clean_canv):
        mu = float(mean.clamp_min(0).double().sum())
        z = (float(img.double().sum()) - mu) / math.sqrt(mu)
        check(abs(z) <= 5, f"fusion_rescan_256 noisy canvas total {z:+.2f}")
    log(f"fusion_rescan_256 card vs CPU, noise-free: {json.dumps(errs)} "
        f"(the fused image's max rel {fused_max_rel:.3e})")
    check(max(errs.values()) <= 1e-5, "fusion_rescan_256 card vs CPU")

    # fusion_rescan_2048_scan: the flagship (bench.py:335-353), two scan
    # views (K1 each, noise-free, then collapsed K2c each), rescan_fusion,
    # and one analytic acquisition (K2c once)
    params, geom, sample = fusion_setup(SIZE, dev, 1.5, depletion=8.0,
                                        **LINE_KW)
    angles = torch.arange(2, dtype=torch.float32) * (math.pi / 2)
    static = (0.0, math.pi / 2)
    sgen = torch.Generator(dev).manual_seed(33)

    def fusion_2048():
        canv = multi_orientation_rescan(sample, params, geom, angles, sgen,
                                        method="scan")
        fused = rescan_fusion(canv, params, geom, static, FUSION_ITERS)
        ana = multi_orientation_rescan(sample, params, geom, angles, sgen)
        return canv, fused, ana

    canv, fused, ana = run(
        "fusion_rescan_2048_scan", fusion_2048,
        {"rescan_banded_fused": 2, "poisson_flat": 3},
        f"2 scan views + {FUSION_ITERS} RL iterations + 2 analytic views")
    check(bool(torch.isfinite(fused).all() and (fused >= 0).all()),
          "fusion_rescan_2048_scan: fused image finite and non-negative")
    clean_scan = multi_orientation_rescan(sample, params, geom, angles,
                                          method="scan")
    clean_ana = multi_orientation_rescan(sample, params, geom, angles)
    for name, imgs, means in (("scan", canv, clean_scan),
                              ("analytic", ana, clean_ana)):
        for img, mean in zip(imgs, means):
            mu = float(mean.clamp_min(0).double().sum())
            z = (float(img.double().sum()) - mu) / math.sqrt(mu)
            check(abs(z) <= 5, f"fusion_rescan_2048 {name} total {z:+.2f}")
    log(f"phase_fusion: 2048^2 RL and card vs CPU start "
        f"{time.time() - t_phase:.1f} s in")
    rl = call_times(lambda: rescan_fusion(clean_scan, params, geom, static,
                                          FUSION_ITERS))
    # card vs CPU: one view's operator at 2048^2, and the whole fusion on
    # the flagship's params at 512^2
    op = rescan_operator(geom, params, angle=math.pi / 2)
    op_cpu = rescan_operator(geom, params, angle=math.pi / 2, device="cpu")
    y = clean_ana[1]
    p512, g512, s512 = fusion_setup(512, "cpu", 1.5, depletion=8.0,
                                    **LINE_KW)
    c512 = multi_orientation_rescan(s512, p512, g512, angles, device="cpu")
    out["errs"]["fusion_rescan_2048_scan"] = errs = {
        "forward_2048": max_rel(op[0](sample), op_cpu[0](sample.cpu())),
        "adjoint_2048": max_rel(op[1](y), op_cpu[1](y.cpu())),
        "canvases_512": max_rel(multi_orientation_rescan(
            s512, p512, g512, angles, device=dev), c512),
        "fused_512": max_rel(
            rescan_fusion(c512.to(dev), p512, g512, static, FUSION_ITERS),
            rescan_fusion(c512, p512, g512, static, FUSION_ITERS))}
    lhs = float((op[0](sample).double() * y.double()).sum())
    rhs = float((sample.double() * op[1](y).double()).sum())
    errs["adjointness_2048"] = abs(lhs - rhs) / abs(lhs)
    log(f"fusion_rescan_2048_scan card vs CPU (max rel) and <Ax, y> - <x, "
        f"A^T y>: {json.dumps(errs)}")
    check(max(errs.values()) <= 1e-5, "fusion_rescan_2048_scan card vs CPU")
    t = out["configs"]["fusion_rescan_2048_scan"]
    t["rl_ms_per_iter"] = rl["ms"] / FUSION_ITERS
    t["rl_device_ms_per_iter"] = rl["device_busy_ms"] / FUSION_ITERS
    t["rl_busy_share"] = rl["busy_share"]
    log(f"phase_fusion took {time.time() - t_phase:.1f} s")
    log(f"fusion_rescan_2048_scan: rescan_fusion ({FUSION_ITERS} iterations, "
        f"2 views) {rl['ms']:.2f} ms, {t['rl_ms_per_iter']:.3f} ms per "
        f"iteration (device {t['rl_device_ms_per_iter']:.3f}, busy "
        f"{rl['busy_share']:.1%}; rows {json.dumps(rl['device_rows'][:3])})"
        f" | {name_power}")
    return out


CLI_SIZE = 256                 # `figure all`'s default --size (cli.py)
CLI_SMALL = 64                 # card against CPU
CLI_OUT = os.path.join(ROOT, "out", "chip_smoke_cli")    # git-ignored
# K2c launches of each figure of `figure all --size 256`, worked out from
# the pipelines (pipelines/figures.py, animation.py, report.py): every
# noisy acquisition draws once through physics.noise.maybe_poisson
CLI_K2C = {
    "comparison": 2 * 2,       # point and line arms x powers 0 and 8
    "sweep": 3 * 16,           # point, line, rescan x 16 powers (4 chunks)
    "fusion": 1,               # the 4 views of one multi-orientation call
    "rescan": 2,               # line_sted_image, rescanned_line_sted_image
    "ism": 3,                  # point_sted_image and two ISM canvases
    "fov": 2 * 3,              # two calls per size (compile_s, wall_s)
    "animation": 2,            # the camera frames and the scan image
    "report": 4 * 2 * 6 + 3,   # 4 arms x 2 draws (frc) x 6 powers; frames,
                               # scan image, views
}
# the noise-free metrics held card against CPU (figures.py, report.py)
CLI_CLEAN = {
    "comparison": ("point_fwhm_x", "line_fwhm_x", "point_steps",
                   "line_steps", "point_signal", "line_signal"),
    "sweep": ("point_fwhm_x_at_smax", "line_fwhm_x_at_smax",
              "line_fwhm_y_at_smax", "line_to_point_step_ratio",
              "num_sweep_points_run"),
    "fusion": ("view_kernel_fwhm_x", "view_kernel_fwhm_y"),
    "rescan": ("canvas_shape",),
    "ism": ("canvas_shape", "ism_confocal_fwhm_sample_px",
            "ism_sted_fwhm_sample_px"),
    "fov": ("records",),
    "animation": ("frames",),
    "report": ("figures", "frames"),
}


def strict_json(line: str):
    """``line`` as JSON, refusing NaN and Infinity as RFC parsers do."""
    def no_const(c):
        raise ValueError(f"non-RFC JSON constant {c} in {line[:200]}")
    return json.loads(line, parse_constant=no_const)


def json_objects(text: str) -> list:
    """Every JSON object that begins a line of ``text`` or follows one on
    it, refusing NaN and Infinity as ``strict_json`` does. Processes that
    share one pipe (torchrun's ranks) can put two objects on one line: an
    unbuffered ``print`` writes its newline apart from its text."""
    def no_const(c):
        raise ValueError(f"non-RFC JSON constant {c} in {text[:200]}")
    decoder = json.JSONDecoder(parse_constant=no_const)
    objects = []
    for line in text.splitlines():
        pos = 0
        while line.startswith("{", pos):
            obj, pos = decoder.raw_decode(line, pos)
            objects.append(obj)
    return objects


def run_cli(argv) -> dict:
    """``python -m rescan_line_sted_torch`` in this process: its last
    stdout line as strict JSON."""
    import contextlib
    import io

    from rescan_line_sted_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    lines = buf.getvalue().strip().splitlines()
    check(lines, f"cli {' '.join(argv)} printed nothing")
    return strict_json(lines[-1])


def figure_argv(name, size, out, small=False):
    argv = ["figure", name, "--size", str(size), "--out", out]
    if small:           # few powers, one FOV size, few RL iterations
        argv += ["--num-powers", "4", "--fov-sizes", str(size),
                 "--rl-iters", "10"]
    return argv


def profiled_call(fn) -> dict:
    """Wall ms of one synced call under ``torch.profiler`` (the device
    alone traced), its device-busy ms and largest device rows, summed from
    the raw trace events (``key_averages`` takes tens of seconds on a
    whole fused sweep's events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            ms, n = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    rows = sorted(([ms, name[:80], n] for name, (ms, n) in by_name.items()),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    return {"ms": wall, "device_busy_ms": busy, "busy_share": busy / wall,
            "device_rows": rows[:3]}


def cli_artifacts(name, out, size, metrics) -> None:
    """The TIFFs read back with the port's reader at their shapes, the
    animation's frames, and the report's data URIs and sliders."""
    from rescan_line_sted_torch.io import tif_to_array

    s, c2 = (size, size), (size, 2 * size)
    tifs = {"comparison": {f"comparison_{k}.tif": s for k in (
                "sample", "point_confocal", "point_sted", "line_confocal",
                "line_sted")},
            "sweep": {f"dose_sweep_images_{k}.tif": s for k in (
                "point_s0", "point_smax", "line_s0", "line_smax")},
            "fusion": {f"fusion_{k}.tif": s for k in (
                "sample", "view_0deg", "view_45deg", "fused_rl")},
            "rescan": {"rescan_sample.tif": s, "rescan_descanned.tif": s,
                       "rescan_rescanned_canvas.tif": c2},
            "ism": {"ism_sample.tif": s, "ism_point_sted_descanned.tif": s,
                    "ism_ism_canvas_confocal.tif": (2 * size, 2 * size),
                    "ism_ism_canvas_sted.tif": (2 * size, 2 * size)}}
    for fname, shape in tifs.get(name, {}).items():
        img = tif_to_array(os.path.join(out, fname))
        check(img.shape == shape and np.isfinite(img).all(),
              f"cli {name}: {fname} {img.shape} != {shape} or not finite")
    if name == "sweep":
        curves = np.load(os.path.join(out, "dose_sweep_curves.npz"))
        check(all(curves[k].shape == (16,) for k in curves.files),
              f"cli sweep: curves {curves.files}")
    if name == "animation":
        path = metrics["path"]
        if path.endswith(".npz"):        # no Pillow: the frames as npz
            frames = np.load(path)["frames"]
            check(frames.shape == (32, size, 2 * size + 4, 3),
                  f"cli animation: frames {frames.shape}")
        else:
            check(os.path.getsize(path) > 0, "cli animation: empty GIF")
    if name == "report":
        html = open(os.path.join(out, "index.html")).read()
        uris = html.count("data:image/")
        check(uris == metrics["frames"] == 6 + 16 + 4 + 1
              and html.count('<input type="range"') == 3
              and "wire(" in html,
              f"cli report: {uris} data URIs for {metrics['frames']} frames")
        try:
            import matplotlib  # noqa: F401
            has_mpl = True
        except ImportError:
            has_mpl = False
        log(f"cli report: {uris} data URIs ({html.count('data:image/png')} "
            f"PNG, {html.count('data:image/svg+xml')} SVG), three sliders, "
            f"{len(html)} bytes, rendered "
            f"{'with' if has_mpl else 'without'} matplotlib")


def cli_card_vs_cpu(dev) -> dict:
    """Each figure at 64^2 (4 powers, one FOV size, 10 RL iterations) on
    the card and with ``--platform cpu``: its noise-free metrics within
    1e-5 relative (the sweep's fused FWHMs among them, the bound
    ``tests/test_torch_sweep.py`` holds against JAX)."""
    from rescan_line_sted_torch.kernels import _build

    errs = {}
    for name, keys in CLI_CLEAN.items():
        out = os.path.join(CLI_OUT, f"small_{name}")
        _build.reset_launches()
        card = run_cli(figure_argv(name, CLI_SMALL, out + "_card", True))
        check(_build.LAUNCHES["poisson_flat"] > 0,
              f"cli {name} at {CLI_SMALL}^2 must draw on the card")
        cpu = run_cli(["--platform", "cpu",
                       *figure_argv(name, CLI_SMALL, out + "_cpu", True)])
        worst = 0.0
        for key in keys:
            got, want = card[key], cpu[key]
            if key == "records":
                for g, w in zip(got, want):
                    check(g["fov"] == w["fov"]
                          and g["scan_steps"] == w["scan_steps"],
                          f"cli fov records {g} vs {w}")
                    for col in ("view_kernel_fwhm_y", "view_kernel_fwhm_x"):
                        worst = max(worst,
                                    abs(g[col] - w[col]) / abs(w[col]))
            elif isinstance(want, float):
                worst = max(worst, abs(got - want) / abs(want))
            else:
                check(got == want, f"cli {name} {key}: {got} != {want}")
        errs[name] = worst
    log(f"cli card vs CPU at {CLI_SMALL}^2, noise-free metrics (max rel): "
        f"{json.dumps(errs)}")
    check(max(errs.values()) <= 1e-5, "cli card vs CPU beyond 1e-5")
    return errs


def native_tiff() -> dict:
    """The native TIFF codec, built with g++ into the build directory:
    available, and byte-identical to the pure-Python writer on a [16, 256,
    256] float32 stack; both writers' host times."""
    import tempfile

    from rescan_line_sted_torch.io import array_to_tif
    from rescan_line_sted_torch.io.native import loader, native_available

    check(native_available(), "the native TIFF codec must build here")
    arr = np.random.default_rng(0).random((16, 256, 256), np.float32)
    times, blobs = {}, {}
    os.makedirs(CLI_OUT, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=CLI_OUT) as d:
        for native in (True, False):
            path = os.path.join(d, f"{native}.tif")
            array_to_tif(arr, path, use_native=native)      # warm
            t0 = time.perf_counter()
            array_to_tif(arr, path, use_native=native)
            times["native_ms" if native else "python_ms"] = (
                time.perf_counter() - t0) * 1e3
            blobs[native] = open(path, "rb").read()
    check(blobs[True] == blobs[False],
          "native TIFF bytes differ from the pure-Python writer's")
    log(f"native TIFF codec {loader.library_path().name}: byte-identical on "
        f"[16, 256, 256] float32 ({len(blobs[True])} bytes); write "
        f"{times['native_ms']:.1f} ms native, {times['python_ms']:.1f} ms "
        "pure Python (host)")
    return times


def phase_cli(dev) -> dict:
    """The command line on the card (``rescan_line_sted_torch/cli.py``):
    every figure of ``figure all --size 256`` run in this process through
    ``cli.main``, each with the counters reset before and read after and
    held to ``CLI_K2C``, its last stdout line strict JSON, its artifacts
    read back; then each once more under the profiler for its busy share;
    the figures card against ``--platform cpu`` at 64^2; ``psf-report
    --vectorial`` as a subprocess; and the native TIFF codec."""
    import shutil

    from rescan_line_sted_torch.kernels import _build

    name_power = card()
    out = {"paths": {}, "figures": {}}
    t_phase = time.time()
    shutil.rmtree(CLI_OUT, ignore_errors=True)   # no stale sweep checkpoint
    for name, want in CLI_K2C.items():
        fig_dir = os.path.join(CLI_OUT, name)
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = run_cli(figure_argv(name, CLI_SIZE, fig_dir))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launched = {k: v for k, v in _build.LAUNCHES.items() if v}
        check(launched == {"poisson_flat": want},
              f"cli {name}: launches {launched}, predicted K2c {want} and "
              "nothing else")
        cli_artifacts(name, fig_dir, CLI_SIZE, metrics)
        prof = profiled_call(lambda: run_cli(figure_argv(
            name, CLI_SIZE, os.path.join(CLI_OUT, f"{name}_profiled"))))
        out["paths"][f"cli_{name}"] = launched
        out["figures"][name] = dict(first_ms=wall, launches=launched,
                                    **prof)
        log(f"cli figure {name} --size {CLI_SIZE}: first call {wall:.1f} ms "
            f"(synced, K2c {want} as predicted), profiled call "
            f"{prof['ms']:.1f} ms, device busy {prof['device_busy_ms']:.2f} "
            f"ms ({prof['busy_share']:.1%}); rows "
            f"{json.dumps(prof['device_rows'])} | {name_power}")
        log(f"cli figure {name}: {json.dumps(metrics)[:600]}")
    out["card_vs_cpu"] = cli_card_vs_cpu(dev)
    proc = subprocess.run(
        [sys.executable, "-m", "rescan_line_sted_torch", "psf-report",
         "--depletion", "8", "--vectorial"], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    check(proc.returncode == 0, f"psf-report failed: {proc.stderr[-2000:]}")
    out["psf_report"] = strict_json(proc.stdout.strip().splitlines()[-1])
    log(f"psf-report --vectorial: {json.dumps(out['psf_report'])}")
    out["tiff"] = native_tiff()
    out["seconds"] = time.time() - t_phase
    log(f"phase_cli took {out['seconds']:.1f} s | {name_power}")
    return out


# calibration: the JAX suite's fits (tests/test_calibration.py) at the
# cells' widths
CAL_LINE = dict(sigma_exc=2.5, sigma_det=3.0, stripe_period=10.0,
                depletion=5.0, slit_halfwidth=3.0, brightness=100.0)
CAL_POINT = dict(sigma_exc=2.0, sigma_det=2.2, sigma_dep=2.0, depletion=3.0,
                 pinhole_radius=3.0, brightness=1.0)
CAL_FIELDS = ("sigma_det", "depletion")
CAL_TOL = {"sigma_det": 0.1, "depletion": 0.3}   # the JAX suite's bounds
CAL_ISM_SIZE, CAL_CPU_SIZE, CAL_CPU_STEPS = 512, 128, 50
CAL_SIGMAS = 5.0           # shot-noise standard deviations a noisy fit adds


def cal_cases(dev, size=SIZE) -> list:
    """The JAX suite's three fits as dicts (name, fit(data, steps), data,
    truth, steps, the fields held, the noise-free forward of params, and
    the noisy acquisition of a generator): line at ``size`` (sparse
    points, sigma_det 3.0 and s 5.0 from 2.0 / 1.0, 400 steps at 5e-2;
    per-step noise on K3), and at 2048^2 also point (the same beads,
    sigma_det 2.2 and s 3.0 from 3.2 / 1.0, 500 steps at 0.1; analytic
    noise, K2c; and on the JAX test's six-spoke star, held to nothing)
    and ISM at ``CAL_ISM_SIZE`` (the point's physics on the star through
    ``rescan_point_canvas_mean``, R = 2)."""
    from rescan_line_sted_torch import (
        Grid, LineSTEDGeometry, LineSTEDParams, PointSTEDGeometry,
        PointSTEDParams, RescanPointGeometry, line_sted_image,
        point_sted_image)
    from rescan_line_sted_torch.algorithms import (
        fit_acquisition_params, fit_line_sted_params, fit_point_sted_params)
    from rescan_line_sted_torch.data import siemens_star, sparse_points
    from rescan_line_sted_torch.imaging import rescan_point_canvas_mean

    lt = LineSTEDParams.create(**CAL_LINE)
    lg = LineSTEDGeometry(Grid(size, size), chunk=32)
    ls = sparse_points((size, size), spacing=16, device=dev)
    cases = [dict(
        name=f"calibration_line_{size}", truth=lt, steps=400,
        held=CAL_FIELDS,
        fit=lambda d, n: fit_line_sted_params(
            d, ls, lt.replace(sigma_det=2.0, depletion=1.0), lg,
            num_steps=n, learning_rate=5e-2),
        forward=lambda p: line_sted_image(ls, p, lg, device=dev).image,
        acquire=lambda g: line_sted_image(
            ls, lt, lg, generator=g, method="scan", noise_mode="per_step",
            use_pallas=True, device=dev).image,
        launches={"line_sted_fused": 1})]
    if size != SIZE:
        return cases
    pt = PointSTEDParams.create(**CAL_POINT)
    pinit = pt.replace(sigma_det=3.2, depletion=1.0)
    pg = PointSTEDGeometry(Grid(size, size), chunk=64)
    star = siemens_star((size, size), spokes=6, device=dev)
    n = CAL_ISM_SIZE
    ig = RescanPointGeometry(Grid(n, n), rescan_factor=2.0)
    iss = siemens_star((n, n), spokes=6, device=dev)

    def point(name, ps, held, acquire):
        return dict(
            name=name, truth=pt, steps=500, held=held,
            fit=lambda d, k: fit_point_sted_params(
                d, ps, pinit, pg, num_steps=k, learning_rate=0.1),
            forward=lambda p: point_sted_image(ps, p, pg, device=dev).image,
            acquire=(lambda g: point_sted_image(
                ps, pt, pg, generator=g, device=dev).image) if acquire
            else None,
            launches={"poisson_flat": 1})

    cases += [
        point(f"calibration_point_{size}", ls, CAL_FIELDS, True),
        # the JAX test's star (32^2 there): wider, its few edges leave
        # sigma_det and s confounded after 500 steps (the JAX fit's too),
        # so nothing is held
        point(f"calibration_point_{size}_star", star, (), False),
        dict(name=f"calibration_ism_{n}", truth=pt, steps=500,
             held=("sigma_det",),
             fit=lambda d, k: fit_acquisition_params(
                 lambda p: rescan_point_canvas_mean(iss, p, ig), d, pinit,
                 CAL_FIELDS, num_steps=k, learning_rate=0.1),
             forward=lambda p: rescan_point_canvas_mean(iss, p, ig),
             acquire=None)]
    return cases


def sync_free(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("error")``: a
    host-device sync inside raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def step_counts(fit, data) -> dict:
    """What one Adam step of ``fit`` dispatches on the card: aten ops
    (forward, backward and Adam, counted by a ``TorchDispatchMode``) and
    device kernels and copies (``torch.profiler``'s device events), each
    as a 3-step fit less a 1-step one, over 2."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    ops, kernels = {}, {}
    for steps in (1, 3):
        with Count() as c:
            fit(data, steps)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fit(data, steps)
            torch.cuda.synchronize()
        ops[steps] = c.n
        kernels[steps] = sum(e.count for e in prof.key_averages()
                             if e.device_type == DeviceType.CUDA)
    return {"aten_ops_per_step": (ops[3] - ops[1]) / 2,
            "device_kernels_per_step": (kernels[3] - kernels[1]) / 2}


def fit_errors(fitted, truth) -> dict:
    return {f: float(getattr(fitted, f)) - float(getattr(truth, f))
            for f in CAL_FIELDS}


def shot_noise_sd(forward, truth) -> tuple[dict, float]:
    """Standard deviation of each least-squares field under the Poisson
    noise of the noise-free image ``mu`` at ``truth``: ``sqrt(diag(A^-1 B
    A^-1))`` with ``A = J^T J``, ``B = J^T diag(mu) J`` and the Jacobian J
    by central differences of the card's forward (steps of 1e-3 of each
    field, float64 sums); and the photon count ``sum(mu)``. A per-step
    image sums independent Poisson counts, so its pixels are Poisson in
    ``mu`` too."""
    mu = forward(truth).double().flatten()
    cols = []
    for f in CAL_FIELDS:
        v = float(getattr(truth, f))
        up, dn = float(np.float32(v * 1.001)), float(np.float32(v * 0.999))
        cols.append((forward(truth.replace(**{f: up})).double().flatten()
                     - forward(truth.replace(**{f: dn})).double().flatten())
                    / (up - dn))
    j = torch.stack(cols, 1)
    a_inv = torch.linalg.inv(j.T @ j)
    cov = a_inv @ (j.T @ (mu[:, None] * j)) @ a_inv
    return ({f: float(s) for f, s in zip(CAL_FIELDS, cov.diagonal().sqrt())},
            float(mu.sum()))


def phase_calibration(dev) -> dict:
    """Instrument calibration on the card (``algorithms/calibration.py``):
    the JAX suite's three fits at the cells' widths (line and point
    2048^2, ISM 512^2), each run whole under sync-debug mode "error" with
    the counters reset before and read after (no kernel: the fits run the
    analytic engines), held to the JAX suite's tolerances and timed (ms
    per Adam step, busy share of a profiled 20-step fit, ``step_counts``);
    the 128^2 line fit against ``device="cpu"``; then the noise-free analytic forward
    fitted to noisy 2048^2 acquisitions through K3 (line, per-step) and
    K2c (point, analytic), held to the JAX tolerance widened by
    ``CAL_SIGMAS`` shot-noise standard deviations."""
    name_power = card()
    out = {"paths": {}, "fits": {}, "e2e": {}, "noisy": {}}
    t_phase = time.time()
    cases = cal_cases(dev)
    for c in cases:
        name, fit, steps = c["name"], c["fit"], c["steps"]
        data = c["forward"](c["truth"])
        fit(data, 2)                         # cuFFT plans, Adam's kernels
        t0 = time.perf_counter()
        (fitted, losses), launched = drive(
            name, lambda: sync_free(lambda: fit(data, steps)))
        wall_ms = (time.perf_counter() - t0) * 1e3
        check(launched == {}, f"{name} must launch no kernel: {launched}")
        check(losses.is_cuda and fitted.sigma_det.is_cuda,
              f"{name}: the fit must stay on the card")
        loss = losses.cpu()                   # the one read, after the loop
        err = fit_errors(fitted, c["truth"])
        check(bool(torch.isfinite(loss).all())
              and (float(loss[-1]) < 1e-2 * float(loss[0]) or not c["held"]),
              f"{name}: loss {float(loss[0])} -> {float(loss[-1])}")
        for f in c["held"]:
            check(abs(err[f]) < CAL_TOL[f], f"{name}: {f} off by {err[f]}")
        t = call_times(lambda: fit(data, steps), lambda: fit(data, 20),
                       warm_up=False)
        step_ms = t["ms"] / steps
        counts = step_counts(fit, data)
        out["paths"][name] = launched
        out["e2e"][f"{name} ({steps} Adam steps)"] = t["ms"]
        out["fits"][name] = dict(
            steps=steps, errors=err, loss_first=float(loss[0]),
            loss_last=float(loss[-1]), wall_ms=wall_ms, ms_per_step=step_ms,
            **counts, **t)
        log(f"{name}: {steps} steps, errors {json.dumps(err)} (JAX bounds "
            f"{json.dumps({f: CAL_TOL[f] for f in c['held']})}), loss "
            f"{float(loss[0]):.4g} -> {float(loss[-1]):.4g}, no sync, no "
            f"launch; wall {wall_ms:.1f} ms (synced, under sync-debug); "
            f"{t['ms']:.1f} ms per fit (median of {CALL_REPEATS}, "
            f"{t['min_ms']:.1f}-{t['max_ms']:.1f}), {step_ms:.3f} ms per "
            f"Adam step; 20 profiled steps {t['profiled_ms']:.1f} ms, "
            f"device busy {t['device_busy_ms']:.2f} ms "
            f"({t['busy_share']:.1%}); rows {json.dumps(t['device_rows'][:3])}"
            f"; per step {counts['aten_ops_per_step']:g} aten ops, "
            f"{counts['device_kernels_per_step']:g} device kernels"
            f" | {name_power}")

    # the 128^2 line fit on the card against the CPU, on the same data
    (c,) = cal_cases(dev, CAL_CPU_SIZE)
    (cpu,) = cal_cases("cpu", CAL_CPU_SIZE)
    name, fit = c["name"], c["fit"]
    data = c["forward"](c["truth"])
    fitted, losses = sync_free(lambda: fit(data, CAL_CPU_STEPS))
    cfitted, closses = cpu["fit"](data.cpu(), CAL_CPU_STEPS)
    lerr = float(((losses.double().cpu() - closses.double())
                  / closses.double()).abs().max())
    ferr = max(abs(float(getattr(fitted, f)) / float(getattr(cfitted, f))
                   - 1.0) for f in CAL_FIELDS)
    t = call_times(lambda: fit(data, CAL_CPU_STEPS), lambda: fit(data, 20))
    counts = step_counts(fit, data)
    out["card_vs_cpu"] = {"losses_max_rel": lerr, "fields_max_rel": ferr}
    out["fits"][name] = dict(steps=CAL_CPU_STEPS,
                             ms_per_step=t["ms"] / CAL_CPU_STEPS, **counts,
                             **t)
    out["e2e"][f"{name} ({CAL_CPU_STEPS} Adam steps)"] = t["ms"]
    log(f"{name} card vs CPU over {CAL_CPU_STEPS} steps: losses max rel "
        f"{lerr:.3e}, fitted fields max rel {ferr:.3e}; {t['ms']:.1f} ms "
        f"per fit, {t['ms'] / CAL_CPU_STEPS:.3f} ms per Adam step, busy "
        f"{t['busy_share']:.1%}; per step {counts['aten_ops_per_step']:g} "
        f"aten ops, {counts['device_kernels_per_step']:g} device kernels | "
        f"{name_power}")
    check(lerr <= 1e-4 and ferr <= 1e-4,
          f"{name} card vs CPU: losses {lerr}, fields {ferr}")

    # the noise-free forward fitted to noisy acquisitions through K3 / K2c
    for c in cases:
        if not c["acquire"]:
            continue
        name = f"{c['name']}_noisy"
        gen = torch.Generator().manual_seed(1400)
        noisy, launched = drive(name, lambda: c["acquire"](gen))
        check(launched == c["launches"], f"{name}: launches {launched}, "
              f"predicted {c['launches']} and nothing else")
        (fitted, losses), fit_launched = drive(
            f"{name}_fit",
            lambda: sync_free(lambda: c["fit"](noisy, c["steps"])))
        check(fit_launched == {}, f"{name}: the fit launched {fit_launched}")
        sd, photons = shot_noise_sd(c["forward"], c["truth"])
        err = fit_errors(fitted, c["truth"])
        bound = {f: CAL_TOL[f] + CAL_SIGMAS * sd[f] for f in CAL_FIELDS}
        fields = {f: float(getattr(fitted, f)) for f in CAL_FIELDS}
        out["paths"][name] = launched
        out["noisy"][name] = dict(
            photons=photons, sd=sd, bound=bound, errors=err, fitted=fields,
            loss_first=float(losses[0]), loss_last=float(losses[-1]))
        log(f"{name}: {photons:.6g} photons, launches {json.dumps(launched)}"
            f"; fitted {json.dumps(fields)}, errors {json.dumps(err)}, "
            f"shot-noise sd {json.dumps(sd)}, bounds (JAX + {CAL_SIGMAS:g} "
            f"sd) {json.dumps(bound)} | {name_power}")
        for f in CAL_FIELDS:
            check(abs(err[f]) < bound[f],
                  f"{name}: {f} off by {err[f]}, bound {bound[f]}")
    out["seconds"] = time.time() - t_phase
    log(f"phase_calibration took {out['seconds']:.1f} s | {name_power}")
    return out


PARALLEL_WORLD = 2              # ranks of the gloo world, all on cuda:0
PARALLEL_POWERS = 16            # the sharded sweep's points (256^2 cell)
PARALLEL_REPEATS = 5
PARALLEL_CASES = ("flagship", "irrational", "flagship_per_step",
                  "flagship_collapsed", "periodic_clean", "periodic_per_step")


def sharded_times(call, barrier=None, repeats=PARALLEL_REPEATS) -> dict:
    """Median ms of the whole ``call()`` (host clock around synchronised
    calls, after ``barrier``), and of its halo exchange (host clock,
    synchronised around it) and K1 launch (CUDA events) in instrumented
    calls (module attributes wrapped, then restored)."""
    import importlib

    from rescan_line_sted_torch.parallel import sharded_rescan

    rbf = importlib.import_module(
        "rescan_line_sted_torch.kernels.rescan_banded_fused")

    def timed(fn):
        (barrier or (lambda: None))()
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t)

    call()
    whole = [timed(call) for _ in range(repeats)]
    rec = {"halo_ms": [], "k1_ms": []}
    halo, k1 = sharded_rescan.halo_exchange, rbf.rescan_banded_fused

    def timed_halo(*a, **kw):
        out = []
        rec["halo_ms"].append(timed(lambda: out.append(halo(*a, **kw))))
        return out[0]

    def timed_k1(*a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = k1(*a, **kw)
        end.record()
        end.synchronize()
        rec["k1_ms"].append(start.elapsed_time(end))
        return out

    sharded_rescan.halo_exchange, rbf.rescan_banded_fused = timed_halo, timed_k1
    try:
        for _ in range(repeats):
            (barrier or (lambda: None))()
            call()
    finally:
        sharded_rescan.halo_exchange, rbf.rescan_banded_fused = halo, k1
    return {"call_ms": float(np.median(whole)),
            "call_ms_all": [round(t, 3) for t in whole],
            "halo_ms": float(np.median(rec["halo_ms"])),
            "k1_ms": float(np.median(rec["k1_ms"]))}


def parallel_rank(rank: int, world: int, store: str, out: str) -> None:
    """One rank of ``phase_parallel``'s gloo world (a spawned process on
    cuda:0): the flagship noise-free, per-step and collapsed, the NUFFT
    case and the periodic sample through ``rescanned_line_sted_image`` on
    row shards, and the batch-sharded sweep; each run's launches (counters
    reset just before, read just after), local rows and times go to
    ``out``."""
    sys.path.insert(0, ROOT)
    import torch.distributed as dist
    from torch.distributed.tensor import Shard, distribute_tensor

    from rescan_line_sted_torch import rescanned_line_sted_image
    from rescan_line_sted_torch.data import siemens_star
    from rescan_line_sted_torch.kernels import _build
    from rescan_line_sted_torch.parallel import initialize_multihost, make_mesh
    from rescan_line_sted_torch.sweeps import dose_matched_sweep
    from rescan_line_sted_torch.sweeps.mesh import run_sharded_sweep

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    facts = {"init": initialize_multihost(f"file://{store}", world, rank,
                                          backend="gloo"),
             "backend": dist.get_backend(), "launches": {}}
    mesh = make_mesh({"space": world})
    arrays = {}

    def rows(x):
        return distribute_tensor(x, mesh, [Shard(0)], src_data_rank=None)

    def run(name, fn):
        dist.barrier()
        _build.reset_launches()
        img = fn()
        torch.cuda.synchronize()
        facts["launches"][name] = {k: v for k, v in _build.LAUNCHES.items()
                                   if v}
        return img

    def scan(smp, params, geom, seed=None, **kw):
        return rescanned_line_sted_image(
            rows(smp), params, geom, method="scan",
            generator=None if seed is None
            else torch.Generator(dev).manual_seed(seed), **kw).image

    sample = siemens_star((SIZE, SIZE), device=dev)
    params, geom = flagship()
    p_ir, g_ir = flagship(rescan_factor=IRRATIONAL)
    periodic = sample[:SIZE // world].repeat(world, 1)
    runs = {
        "flagship": lambda: scan(sample, params, geom),
        "irrational": lambda: scan(sample, p_ir, g_ir),
        "flagship_per_step": lambda: scan(sample, params, geom, 31,
                                          noise_mode="per_step"),
        "flagship_collapsed": lambda: scan(sample, params, geom, 32),
        "periodic_clean": lambda: scan(periodic, params, geom),
        "periodic_per_step": lambda: scan(periodic, params, geom, 33,
                                          noise_mode="per_step")}
    for name, fn in runs.items():
        img = run(name, fn)
        arrays[name] = img.to_local().cpu().numpy()
        facts[f"{name}_placements"] = [str(p) for p in img.placements]

    sa = bench_sweep_args(dev)
    batch = make_mesh({"batch": world})
    powers = torch.linspace(0.0, 16.0, PARALLEL_POWERS)

    def sweep_fn(s, pw, *gen):
        return dose_matched_sweep(s, sa["point_base"], sa["line_base"],
                                  sa["point_geom"], sa["line_geom"], pw,
                                  sa["dose_budget"], *gen)

    for name, gen in (("sweep_clean", ()),
                      ("sweep_noisy", (torch.Generator(dev).manual_seed(34),))):
        got = run(name, lambda gen=gen: run_sharded_sweep(
            sweep_fn, batch, sa["sample"], (powers,), *gen))
        for arm in ("point", "line"):
            for col in SWEEP_COLUMNS:
                arrays[f"{name}_{arm}_{col}"] = getattr(
                    getattr(got, arm), col).to_local().cpu().numpy()
        facts[f"{name}_placements"] = [str(p) for p in
                                       got.point.image.placements]

    facts["times"] = sharded_times(
        lambda: scan(sample, params, geom, 35, noise_mode="per_step"),
        barrier=dist.barrier)
    np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(facts, f)
    dist.barrier()
    dist.destroy_process_group()


def parallel_cli(single: dict, name_power: str) -> dict:
    """``--multihost psf-report`` under ``torch.distributed.run`` with two
    processes on this card (gloo: two ranks share it): rc 0, each
    process's log line, and each rank's report equal to ``single``."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
           str(PARALLEL_WORLD), "-m", "rescan_line_sted_torch", "--multihost",
           "psf-report", "--size", "128"]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          env=env, cwd=ROOT)
    wall = time.time() - t0
    check(proc.returncode == 0, f"{' '.join(cmd[2:])} exited "
          f"{proc.returncode}:\n{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    for r in range(PARALLEL_WORLD):
        check(f"multihost: process {r}/{PARALLEL_WORLD}" in proc.stderr,
              f"torchrun psf-report: no 'process {r}/{PARALLEL_WORLD}' log "
              f"line:\n{proc.stderr[-2000:]}")
    reports = json_objects(proc.stdout)
    check(len(reports) == PARALLEL_WORLD,
          f"torchrun psf-report: {len(reports)} reports, not one per rank")
    worst = max(abs(rep[k] - v) / max(abs(v), 1e-30)
                for rep in reports for k, v in single.items())
    check(all(rep.keys() == single.keys() for rep in reports)
          and worst <= 1e-6,
          f"torchrun psf-report differs from the single-process report "
          f"({worst:.2e}): {reports} vs {single}")
    log(f"parallel cli: {' '.join(cmd[2:])}: rc 0 in {wall:.1f} s, logs "
        f"process 0/2 and 1/2, both reports equal the single-process one "
        f"(max rel {worst:.1e}) | {name_power}")
    return {"wall_s": wall, "max_rel": worst}


def phase_parallel(dev) -> dict:
    """``parallel/`` on the card (phase 18): a world of one rank over NCCL
    in this process, a world of two gloo ranks on this one card in spawned
    processes, the batch-sharded sweep over them, and ``--multihost`` under
    torchrun; parity with the unsharded K1 calls, noise statistics, rank
    streams, launches per rank and times."""
    import contextlib
    import io
    import multiprocessing
    import shutil
    import tempfile

    import torch.distributed as dist
    from torch.distributed.tensor import Shard, distribute_tensor

    from rescan_line_sted_torch import cli, rescanned_line_sted_image
    from rescan_line_sted_torch.data import siemens_star
    from rescan_line_sted_torch.parallel import (
        initialize_multihost, make_mesh, rescanned_line_sted_sharded)
    from rescan_line_sted_torch.parallel.mesh import full_tensor
    from rescan_line_sted_torch.sweeps import dose_matched_sweep

    name_power = card()
    out = {"paths": {}, "errs": {}, "times": {}}
    t_phase = time.time()
    sample = siemens_star((SIZE, SIZE), device=dev)
    params, geom = flagship()
    p_ir, g_ir = flagship(rescan_factor=IRRATIONAL)
    ref = rescanned_line_sted_image(sample, params, geom,
                                    method="scan").image
    ref_ir = rescanned_line_sted_image(sample, p_ir, g_ir,
                                       method="scan").image
    mean_total = float(ref.double().sum())
    gen = torch.Generator(dev).manual_seed(36)
    out["times"]["unsharded_ms"] = cuda_ms(lambda: rescanned_line_sted_image(
        sample, params, geom, method="scan", noise_mode="per_step",
        generator=gen))

    # a world of one rank over NCCL, in this process
    tmp = tempfile.mkdtemp(prefix="rls_parallel_")
    try:
        initialize_multihost(f"file://{tmp}/store1", 1, 0, backend="nccl")
        check(dist.get_backend() == "nccl", "the one-rank world runs NCCL")
        mesh = make_mesh({"space": 1})
        rows = distribute_tensor(sample, mesh, [Shard(0)],
                                 src_data_rank=None)
        for name, fn in (
                ("parallel_1rank_entry", lambda: rescanned_line_sted_image(
                    rows, params, geom, method="scan").image),
                ("parallel_1rank_sharded", lambda: rescanned_line_sted_sharded(
                    rows, params, geom, mesh).image)):
            img, out["paths"][name] = drive(name, fn)
            check(out["paths"][name] == {"rescan_banded_fused": 1},
                  f"{name}: K1 once and nothing else: {out['paths'][name]}")
            check([str(p) for p in img.placements] == ["S(0)"],
                  f"{name}: rows sharded")
            out["errs"][name] = max_rel(full_tensor(img), ref)
        out["times"]["1rank"] = sharded_times(
            lambda: rescanned_line_sted_sharded(
                rows, params, geom, mesh, generator=gen,
                noise_mode="per_step"))
        dist.destroy_process_group()

        # a world of two gloo ranks sharing this card
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=parallel_rank, args=(
            r, PARALLEL_WORLD, f"{tmp}/store2", tmp))
            for r in range(PARALLEL_WORLD)]
        t0 = time.time()
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=max(1.0, 600 - (time.time() - t0)))
        alive = [p.pid for p in procs if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
        check(not alive, f"parallel ranks timed out: {alive}")
        check(all(p.exitcode == 0 for p in procs),
              f"parallel ranks exited {[p.exitcode for p in procs]}")
        out["times"]["2rank_wall_s"] = time.time() - t0
        ranks = [(dict(np.load(f"{tmp}/rank{r}.npz")),
                  json.load(open(f"{tmp}/rank{r}.json")))
                 for r in range(PARALLEL_WORLD)]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)

    def whole(name):
        return torch.from_numpy(np.concatenate([a[name] for a, _ in ranks]))

    want = {"flagship": {"rescan_banded_fused": 1},
            "irrational": {"rescan_banded_fused_spread": 1},
            "flagship_per_step": {"rescan_banded_fused": 1},
            "flagship_collapsed": {"rescan_banded_fused": 1,
                                   "poisson_flat": 1},
            "periodic_clean": {"rescan_banded_fused": 1},
            "periodic_per_step": {"rescan_banded_fused": 1},
            "sweep_clean": {},
            "sweep_noisy": {"poisson_flat": PARALLEL_POWERS}}
    for r, (_, facts) in enumerate(ranks):
        check(facts["backend"] == "gloo" and facts["init"] == [r, 2],
              f"rank {r}: {facts['init']} over {facts['backend']}")
        for name, launches in want.items():
            got = facts["launches"][name]
            out["paths"][f"parallel_2rank_{name}_rank{r}"] = got
            check(got == launches, f"rank {r} {name}: launches {got}, "
                  f"expected {launches}")
        for name in PARALLEL_CASES:
            check(facts[f"{name}_placements"] == ["S(0)"],
                  f"rank {r} {name}: rows sharded")
    out["errs"]["parallel_2rank_flagship"] = max_rel(whole("flagship"), ref)
    out["errs"]["parallel_2rank_irrational"] = max_rel(whole("irrational"),
                                                       ref_ir)
    for name, err in out["errs"].items():
        check(err <= 1e-5, f"{name}: {err:.2e} from the unsharded K1 call")
    z = {}
    for name in ("flagship_per_step", "flagship_collapsed"):
        got = whole(name).double()
        z[name] = (float(got.sum()) - mean_total) / math.sqrt(mean_total)
        check(abs(z[name]) <= 5 and bool(torch.isfinite(got).all()),
              f"{name}: total {z[name]:+.2f} sigma from the noise-free one")
    # the periodic sample gives both ranks the same block: their counts
    # must differ, and their residuals be uncorrelated
    (a0, _), (a1, _) = ranks
    res = [torch.from_numpy(a["periodic_per_step"] - a["periodic_clean"])
           .double().ravel() for a in (a0, a1)]
    blocks_equal = bool(np.array_equal(a0["periodic_clean"],
                                       a1["periodic_clean"]))
    corr = float(torch.corrcoef(torch.stack(res))[0, 1])
    bound = 5.0 / math.sqrt(res[0].numel())
    check(not np.array_equal(a0["periodic_per_step"],
                             a1["periodic_per_step"]),
          "the ranks drew the same counts on identical blocks")
    check(abs(corr) <= bound, f"rank streams correlated: {corr:.2e} "
          f"(bound {bound:.2e})")

    # the batch-sharded sweep against the unsharded one on the card
    sa = bench_sweep_args(dev)
    sa["depletion_powers"] = np.linspace(0.0, 16.0, PARALLEL_POWERS)
    clean = dose_matched_sweep(**sa)
    sweep_errs = {}
    for arm in ("point", "line"):
        for col in SWEEP_COLUMNS:
            sweep_errs[f"{arm}.{col}"] = max_rel(
                whole(f"sweep_clean_{arm}_{col}"),
                getattr(getattr(clean, arm), col))
    check(max(sweep_errs.values()) <= 1e-5,
          f"sharded sweep against the unsharded one: {sweep_errs}")
    worst = 0.0
    for arm in ("point", "line"):
        for img, mean in zip(whole(f"sweep_noisy_{arm}_image"),
                             getattr(clean, arm).image):
            mu = float(mean.clamp_min(0).double().sum())
            zz = (float(img.double().sum()) - mu) / math.sqrt(mu)
            check(abs(zz) <= 5, f"sharded sweep {arm}: noisy total "
                  f"{zz:+.2f} sigma from its mean")
            worst = max(worst, abs(zz))
    out["errs"]["parallel_2rank_sweep"] = max(sweep_errs.values())

    # the command line under torchrun, against one process
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["psf-report", "--size", "128"])
    single = strict_json(buf.getvalue().strip().splitlines()[-1])
    out["cli"] = parallel_cli(single, name_power)

    out["times"]["2rank"] = {f"rank{r}": facts["times"]
                             for r, (_, facts) in enumerate(ranks)}
    out["stats"] = {"noisy_total_sigma": z, "rank_corr": corr,
                    "rank_corr_bound": bound,
                    "periodic_blocks_equal": blocks_equal,
                    "sweep_noisy_worst_sigma": worst,
                    "sweep_card_vs_unsharded": sweep_errs}
    out["phase_s"] = time.time() - t_phase
    log(f"parallel: 1 rank (NCCL) and 2 gloo ranks on one card, flagship "
        f"{SIZE}^2 against the unsharded K1 call (max rel): "
        f"{json.dumps(out['errs'])} | {name_power}")
    log(f"parallel: per-step totals {json.dumps(z)} sigma; rank residual "
        f"correlation {corr:+.2e} (bound {bound:.2e}); sharded sweep noisy "
        f"totals within {worst:.2f} sigma | {name_power}")
    log(f"parallel times (ms): unsharded {out['times']['unsharded_ms']:.3f}; "
        f"{json.dumps({k: v for k, v in out['times'].items() if k != 'unsharded_ms'})}"
        f" | {name_power}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from rescan_line_sted_torch.kernels import _build

    dev = torch.device("cuda", 0)
    name_power = card()
    log(f"card: {name_power} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    log(clocks())
    t0 = time.time()
    lib_path = _build.build()
    _build.lib()
    log(f"kernels built in {time.time() - t0:.1f} s: {lib_path.name}")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"ptxas: {line.strip()}")

    sampler_err = phase_sampler(dev)
    k1_err = phase_k1(dev)
    paths = phase_e2e(dev)
    times = phase_times(dev)          # rescan timings before the new phases
    over_bound = phase_k1_bound(dev)
    k3_err = phase_k3(dev)
    paths.update(phase_descanned(dev))
    phase_route_parity(dev)
    desc = phase_times_descanned(dev, times["rescan_banded_fused"])
    k4_err = phase_k4(dev)
    k5_err = phase_k5(dev)
    paths.update(phase_nobands(dev))
    nob = phase_times_nobands(dev)
    ism = phase_ism(dev)
    paths.update(ism["paths"])
    k2c = {"flagship canvas": times["poisson_flat"],
           "nobands_512_scatter frames": nob["k2c"]}
    k2b = {**desc["poisson_rows_tiered"], "nobands_512_subpixel": nob["k2b"],
           "ism_256": ism["k2b"]}
    k6 = phase_primitives(dev, {m: times[m] for m in K1_MODES},
                          desc["line_sted_fused"], nob["rescan_fused"], k2c,
                          k2b)
    dose = phase_sweep(dev)
    paths.update(dose["paths"])
    fov = phase_fov(dev)
    paths.update(fov["paths"])
    fusion = phase_fusion(dev)
    paths.update(fusion["paths"])
    cli = phase_cli(dev)
    paths.update(cli["paths"])
    cal = phase_calibration(dev)
    paths.update(cal["paths"])
    par = phase_parallel(dev)
    paths.update(par["paths"])
    log(f"after timing: {clocks()}")
    log(f"smoke run took {time.time() - t0:.1f} s after the card was named")

    k1_path = {"rescan_banded_fused": "flagship",
               "rescan_banded_fused_spread": "irrational",
               "rescan_banded_fused_wide": "wide",
               "rescan_banded_fused_spread_wide": "spread_wide"}
    def launched(kernel):
        return {p: n[kernel] for p, n in paths.items() if n.get(kernel)}

    kernels = [
        {"name": mode, "route": "cuda",
         "source": "rescan_line_sted_torch/csrc/rescan_banded_fused.cu",
         "replaces": replaces, "path": k1_path[mode],
         "paths": launched(mode),
         "launches": sum(launched(mode).values()),
         "max_abs_err": k1_err[mode]["abs"],
         "max_rel_err": k1_err[mode]["rel"],
         "err_kind": "noise-free, against the plain version",
         **times[mode], "library_ms": None,
         "composite_bound_ms": k6["bounds"][mode]["total_ms"]}
        for mode, (replaces, _) in K1_MODES.items()]
    k2c_paths = launched("poisson_flat")
    kernels.append(
        {"name": "poisson_flat", "route": "cuda",
         "source": "rescan_line_sted_torch/csrc/poisson.cu",
         "replaces": "rescan_line_sted_tpu/kernels/poisson_pallas.py:398",
         "path": "flagship", "paths": k2c_paths,
         "launches": sum(k2c_paths.values()),
         "max_abs_err": sampler_err["poisson_flat"],
         "err_kind": "max |mean(kernel) - mean(plain)| over rates",
         **times["poisson_flat"],
         "composite_bound_ms": k6["bounds"][
             "poisson_flat on flagship canvas"]["total_ms"],
         "nobands_512_scatter_frames": nob["k2c"],
         "dose_sweep_point_image": dose["k2c"],
         "dose_sweep_draws": dose["draws"],
         "fov_views_2048": fov["k2c"], "fov_views_draws": fov["draws"]})

    k3_paths = launched("line_sted_fused")
    kernels.append(
        {"name": "line_sted_fused", "route": "cuda",
         "source": "rescan_line_sted_torch/csrc/line_fused.cu",
         "replaces": "rescan_line_sted_tpu/kernels/line_fused.py:80",
         "path": "line_2048 (use_pallas=True)", "paths": k3_paths,
         "launches": sum(k3_paths.values()),
         "max_abs_err": k3_err["abs"], "max_rel_err": k3_err["rel"],
         "err_kind": "noise-free, against the plain version",
         **desc["line_sted_fused"], "library_ms": None,
         "composite_bound_ms": k6["bounds"]["line_sted_fused"]["total_ms"]})
    k2b_paths = launched("poisson_rows_tiered")
    kernels.append(
        {"name": "poisson_rows_tiered", "route": "cuda",
         "source": "rescan_line_sted_torch/csrc/poisson.cu",
         "replaces": "rescan_line_sted_tpu/kernels/poisson_pallas.py:344",
         "path": "line_2048 (banded frames)", "paths": k2b_paths,
         "launches": sum(k2b_paths.values()),
         "max_abs_err": max([sampler_err["k2b_draw_for_draw"]] + [
             d["max_abs_diff"] for t in k2b.values()
             for d in t["draws"].values()]),
         "err_kind": "counts against the host reference on the same "
                     "Philox stream, rates below the bright tier (constant "
                     "rates, ragged and misaligned rows, each caller's "
                     "frames with a CPU and a CUDA generator)",
         **k2b["line_2048"],
         "composite_bound_ms": k6["bounds"][
             "poisson_rows_tiered on line_2048"]["total_ms"],
         "callers": k2b,
         "flagship_canvas": times["poisson_rows_tiered"]})
    for name, replaces, path, err in (
            ("rescan_fused",
             "rescan_line_sted_tpu/kernels/rescan_fused.py:102",
             "nobands_2048", k4_err),
            ("rescan_accumulate",
             "rescan_line_sted_tpu/kernels/rescan_accumulate.py:104",
             "nobands_512_scatter", k5_err)):
        on = launched(name)
        kernels.append(
            {"name": name, "route": "cuda",
             "source": f"rescan_line_sted_torch/csrc/{name}.cu",
             "replaces": replaces, "path": path, "paths": on,
             "launches": sum(on.values()), "max_abs_err": err["abs"],
             "max_rel_err": err["rel"],
             "err_kind": "noise-free, against the plain version",
             "library_ms": None, **nob[name]})
    kernels[-2]["composite_bound_ms"] = \
        k6["bounds"]["rescan_fused"]["total_ms"]
    for name, entry in k6["entries"].items():
        kernels.append(
            {"name": f"primitives_{name}", "route": "cuda",
             "source": "rescan_line_sted_torch/csrc/primitives.cu",
             "replaces": f"scripts/perf_vpu_bound.py:{PRIM_SOURCES[name]}",
             "path": "primitive_rates",
             "launches": k6["launches"].get(f"primitives_{name}", 0),
             "max_abs_err": k6["errs"][name]["abs"],
             "max_rel_err": k6["errs"][name]["rel"],
             "err_kind": "the check's reps on the rate call's inputs, "
                         "against the plain version",
             **entry})
    check(all(k["launches"] > 0 for k in kernels[-len(k6["entries"]):]),
          f"every K6 kernel must launch in primitive_rates: {k6['launches']}")
    rule2 = {}
    for name, t, composite in (
            ("poisson_flat (flagship canvas)", times["poisson_flat"],
             "poisson_flat on flagship canvas"),
            ("poisson_flat (nobands_512_scatter frames)", nob["k2c"],
             "poisson_flat on nobands_512_scatter frames"),
            ("rescan_accumulate (k5_inputs)", nob["rescan_accumulate"],
             None),
            *((f"poisson_rows_tiered ({where} frames)", t,
               f"poisson_rows_tiered on {where}") for where, t in k2b.items())):
        rule2[name] = {
            "ms": t["ms"], "device_ms": t["device_ms"],
            "library_ms": t["library_ms"], "bound_ms": t["bound_ms"],
            "over_library": t["ms"] / t["library_ms"],
            "over_bound": t["ms"] / t["bound_ms"],
            "device_over_bound": t["device_ms"] / t["bound_ms"]}
        if composite:
            c = k6["bounds"][composite]["total_ms"]
            rule2[name].update(cuda_gen_ms=t["cuda_gen_ms"], composite_ms=c,
                               device_over_composite=t["device_ms"] / c)
    for mode, path in k1_path.items():
        t = times[mode]
        rule2[f"{mode} ({path})"] = {
            "ms": t["ms"], "noise_free_ms": t["noise_free_ms"],
            "bound_ms": t["bound_ms"], "bound_fp32_ms": t["bound_fp32_ms"],
            "composite_ms": k6["bounds"][mode]["total_ms"],
            "over_composite": t["ms"] / k6["bounds"][mode]["total_ms"],
            "launch": t["launch"]}
    k3 = desc["line_sted_fused"]
    rule2["line_sted_fused (line_2048)"] = {
        "ms": k3["ms"], "noise_free_ms": k3["noise_free_ms"],
        "device_ms": k3["device_ms"], "bound_ms": k3["bound_ms"],
        "composite_ms": k6["bounds"]["line_sted_fused"]["total_ms"],
        "over_composite": k3["ms"]
        / k6["bounds"]["line_sted_fused"]["total_ms"],
        "launch": k3["launch"]}
    k4 = nob["rescan_fused"]
    rule2["rescan_fused (nobands_2048)"] = {
        "ms": k4["ms"], "noise_free_ms": k4["noise_free_ms"],
        "device_ms": k4["device_ms"],
        "composite_ms": k6["bounds"]["rescan_fused"]["total_ms"],
        "chunk_paths": k4["chunk_paths"]}
    log(json.dumps({"rule2": rule2}))
    log(json.dumps({"k1_over_bound": over_bound}))
    log(json.dumps({"k2a_in_k1": desc["k2a"]}))
    busy = {**desc["busy"], **nob["busy"]}
    log(json.dumps({"device_busy_ms": {k: v["device_ms"]
                                       for k, v in busy.items()}}))
    log(json.dumps({"e2e_per_step_ms": {**times["e2e"], **desc["e2e"],
                                        **nob["e2e"]}}))
    log(json.dumps({"e2e_per_call_ms": {**dose["e2e"], **fov["e2e"],
                                        **fusion["e2e"], **cal["e2e"]}}))
    log(json.dumps({"fusion": {
        "configs": fusion["configs"], "card_vs_cpu": fusion["errs"],
        "card": name_power}}))
    log(json.dumps({"cli": {
        "figures": cli["figures"], "card_vs_cpu": cli["card_vs_cpu"],
        "psf_report": cli["psf_report"], "native_tiff": cli["tiff"],
        "card": name_power}}))
    log(json.dumps({"calibration": {
        "fits": {k: {q: v for q, v in f.items() if q != "device_rows"}
                 for k, f in cal["fits"].items()},
        "card_vs_cpu": cal["card_vs_cpu"], "noisy": cal["noisy"],
        "card": name_power}}))
    log(json.dumps({"parallel": {
        "errs": par["errs"], "times": par["times"], "stats": par["stats"],
        "cli": par["cli"], "phase_s": par["phase_s"], "card": name_power}}))
    log(json.dumps({"dose_sweep": {
        "bench_cell": dose["bench"], "card_vs_cpu": dose["errs"],
        "cuda_generator_syncs": dose["syncs"], "figure_2048": dose["figure"],
        "card": name_power}}))
    log(json.dumps({"fov_sweep": {
        "records": fov["records"], "card_vs_cpu": fov["errs"],
        "sizes": {n: {q: v for q, v in t.items() if q != "k2c"}
                  for n, t in fov["sizes"].items()},
        "scan_vs_analytic": fov["scan"]["scan_vs_analytic"],
        "card": name_power}}))
    log(json.dumps({"ism": {"e2e_ms": ism["e2e"], "errs": ism["errs"],
                            "device_busy_ms": {k: v["device_ms"] for k, v
                                               in ism["busy"].items()}}}))
    log(json.dumps({"primitive_rates": k6["rates"],
                    "gemm_library_ms": k6["library_ms"],
                    "composite_bounds": {k: {q: v[q] for q in (
                        "conv_ms", "sampler_ms", "placement_ms", "total_ms")}
                        for k, v in k6["bounds"].items()}}))
    log(json.dumps({"kernels": kernels}))
    log(name_power)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``rescan_line_sted_torch/csrc`` (nvcc,
sm_90a), then:

1. prints the card (``nvidia-smi`` name and power limit);
2. checks the Poisson samplers K2b / K2c: moments, chi-square against the
   exact pmf, zeros, NaN propagation and seeding, at 2^20 draws per rate;
   K2b count by count against its host reference (same Philox stream) at
   every rate below the bright tier, and its chi-square p over 16 seeds per
   single-draw tier;
3. holds kernel K1 (banded fused scan) against its plain PyTorch version,
   noise-free, in each of its modes (max relative error <= 1e-5): integer
   and class placement at the flagship shape (2048^2, R = 1.5, q = 2), at
   2048^2 R = 2.0 and at 512^2 R = 3.0, b = 2; NUFFT spreading at 2048^2
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
   ``torch.poisson``) and each path's per-step image with CUDA events
   (median of 7 after warm-up), with each kernel's bound on this card.

Prints one JSON line with the kernels, then the card, then the result line
``{"ok": true, "device": {...}}``. Any failure raises (exit code != 0).
Without CUDA it exits with code 1 and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
LINE_KW = dict(sigma_exc=3.0, sigma_det=3.0, stripe_period=12.0,
               slit_halfwidth=4.0, brightness=1.0)
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
PEAK_FLOPS = 67e12        # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12      # H100 SXM HBM3


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


def cuda_ms(fn, repeats: int = REPEATS) -> float:
    """Median milliseconds of ``fn()`` on the card (CUDA events, warm-up)."""
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
            trunc = tier_kmax(lam) if name == "poisson_rows_tiered" else None
            res = check_counts(name, x, lam, trunc)
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
    worst["k2b_draw_for_draw"] = k2b_draw_for_draw(dev)
    k2b_seed_spread(dev)
    log(f"sampler phase passed: max |mean(kernel) - mean(plain)| {worst}")
    return worst


def k2b_draw_for_draw(dev) -> float:
    """K2b against its host reference on the same Philox stream, count by
    count, at every rate below the bright tier. A count may differ by one
    only where its uniform sits on a CDF boundary (the card's expf and CDF
    sums round differently by an ulp); returns the max abs difference."""
    from scipy import stats

    from rescan_line_sted_torch.kernels import _build
    from rescan_line_sted_torch.kernels.poisson import (
        _CUT, poisson_rows_tiered, poisson_rows_tiered_reference,
        single_draw_uniforms)

    worst = 0.0
    for i, lam in enumerate(RATES):
        if lam >= _CUT:
            continue
        rate = torch.full((1024, 1024), lam, device=dev)
        got = poisson_rows_tiered(
            rate, torch.Generator().manual_seed(100 + i)).cpu()
        key = _build.seeds_from(torch.Generator().manual_seed(100 + i))
        diff = (got - poisson_rows_tiered_reference(rate, key)).abs()
        bad = torch.nonzero(diff.reshape(-1)).flatten().numpy()
        gap = 0.0
        if bad.size:
            u = single_draw_uniforms(N_DRAWS, key)[bad].astype(np.float64)
            cdf = stats.poisson.cdf(np.arange(32), lam)
            gap = float(np.abs(u[:, None] - cdf[None, :]).min(axis=1).max())
        log(f"K2b vs host reference at rate {lam}: {bad.size} of {N_DRAWS} "
            f"counts differ, max abs diff {float(diff.max()):.0f}, "
            f"max |u - F(k)| of those {gap:.2e}")
        check(float(diff.max()) <= 1 and bad.size <= 16 and gap <= 1e-6,
              f"K2b vs host reference at rate {lam}: {bad.size} counts "
              f"differ, max |u - F(k)| {gap}")
        worst = max(worst, float(diff.max()))
    return worst


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
    """The scan's own K1 arguments for a (size, R, b, sigma_exc) case."""
    from rescan_line_sted_torch.data import siemens_star
    from rescan_line_sted_torch.imaging.rescan import _banded_inputs

    size, rf, b, sig = case
    params, geom = flagship(size, rf, b, sig)
    args, kw, _ = _banded_inputs(siemens_star((size, size), device=dev),
                                 params, geom)
    return args, kw


def k1_bound(args, kw) -> tuple[float, str]:
    """Least time (ms) of one K1 call on this card, and what bounds it:
    the conv FMAs (and spreading taps) at the fp32 peak, against the
    sample read once and the canvas written once."""
    sample_y = args[0]
    h, w = sample_y.shape
    b = kw.get("binning", 1)
    dob, hb = kw["d_out"] // b, h // b
    fma = w * dob * kw["d_in"] * hb
    q = kw.get("q", 1)
    if "spread_weights" in kw:
        fma += w * dob * hb * kw["spread_weights"].shape[1]
        q = 2
    nbytes = 4 * ((w + kw["d_in"]) * h + q * kw["wc"] * hb)
    return roofline(2 * fma, nbytes)


def roofline(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def phase_k1(dev) -> dict:
    """K1 against its plain version in every mode; returns the worst
    absolute and relative error per mode (launch counter name)."""
    from rescan_line_sted_torch.kernels import _build
    from rescan_line_sted_torch.kernels.rescan_banded_fused import (
        rescan_banded_fused, rescan_banded_fused_reference)

    worst = {}
    for case in K1_CASES:
        args, kw = k1_inputs(case, dev)
        before = dict(_build.LAUNCHES)
        got = rescan_banded_fused(*args, **kw)
        mode = next(k for k, v in _build.LAUNCHES.items() if v != before[k])
        want = rescan_banded_fused_reference(*args, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        log(f"K1 {mode} vs plain {case[0]}^2 R={case[1]:.6f} b={case[2]} "
            f"sigma_exc={case[3]} q={got.shape[0]} d_in={kw['d_in']} "
            f"d_out={kw['d_out']}: max abs err {err:.3e}, "
            f"max rel err {rel:.3e}")
        check(got.shape == want.shape and rel <= 1e-5,
              f"K1 {mode} vs plain at {case}: rel err {rel}")
        w0 = worst.setdefault(mode, {"abs": 0.0, "rel": 0.0})
        worst[mode] = {"abs": max(w0["abs"], err), "rel": max(w0["rel"], rel)}
        if case in (K1_CASES[0], K1_CASES[3]):
            k1_noisy_total(args, kw, want, mode)
    missing = set(K1_MODES) - set(worst)
    check(not missing, f"K1 modes never taken: {missing}")
    return worst


def k1_noisy_total(args, kw, clean, mode) -> None:
    """A noisy K1 canvas: finite, non-negative (integer counts where each
    lands whole), its total within 5 sigma of the noise-free total. With
    spreading a count n of position c adds n * S_c (S_c: the sum of c's
    taps), so Var(total) = sum_c S_c^2 mu_c <= max S_c * total."""
    from rescan_line_sted_torch.kernels.rescan_banded_fused import (
        rescan_banded_fused)

    noisy = rescan_banded_fused(*args, **kw,
                                generator=torch.Generator().manual_seed(3))
    total = float(noisy.double().sum())
    mu = float(clean.double().sum())
    scale = 1.0
    if "spread_weights" in kw:
        scale = float(kw["spread_weights"].double().sum(1).max())
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


def scan_vs_analytic(name, sample, params, geom, **kw) -> float:
    """Noise-free scan against the analytic canvas (relative L2)."""
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
    from rescan_line_sted_torch.kernels.poisson import (
        poisson_flat, poisson_reference, poisson_rows_tiered)
    from rescan_line_sted_torch.kernels.rescan_banded_fused import (
        rescan_banded_fused, rescan_banded_fused_reference)

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
        args, kw = k1_inputs(case, dev)
        bound, by = k1_bound(args, kw)
        t[mode] = {
            "ms": cuda_ms(lambda: rescan_banded_fused(
                *args, **kw, generator=cpu_gen)),
            "plain_ms": cuda_ms(lambda: rescan_banded_fused_reference(
                *args, **kw, generator=dev_gen)),
            "noise_free_ms": cuda_ms(lambda: rescan_banded_fused(*args, **kw)),
            "noise_free_plain_ms": cuda_ms(
                lambda: rescan_banded_fused_reference(*args, **kw)),
            "bound_ms": bound, "bound_by": by}
    canvas = image(sample, *flagship(), method="scan").image
    lam = canvas.clamp_min(0)
    bound, by = roofline(0.0, 2 * 4 * canvas.numel())
    plain = cuda_ms(lambda: poisson_reference(canvas, dev_gen))
    library = cuda_ms(lambda: torch.poisson(lam, dev_gen))
    for name, fn in (("poisson_flat", poisson_flat),
                     ("poisson_rows_tiered", poisson_rows_tiered)):
        t[name] = {"ms": cuda_ms(lambda: fn(canvas, cpu_gen)),
                   "plain_ms": plain, "library_ms": library,
                   "bound_ms": bound, "bound_by": by}
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
    times = phase_times(dev)
    log(f"after timing: {clocks()}")
    log(f"smoke run took {time.time() - t0:.1f} s after the card was named")

    k1_path = {"rescan_banded_fused": "flagship",
               "rescan_banded_fused_spread": "irrational",
               "rescan_banded_fused_wide": "wide",
               "rescan_banded_fused_spread_wide": "spread_wide"}
    kernels = [
        {"name": mode, "route": "cuda",
         "source": "rescan_line_sted_torch/csrc/rescan_banded_fused.cu",
         "replaces": replaces, "path": k1_path[mode],
         "launches": paths[k1_path[mode]][mode],
         "max_abs_err": k1_err[mode]["abs"],
         "max_rel_err": k1_err[mode]["rel"],
         "err_kind": "noise-free, against the plain version",
         **times[mode], "library_ms": None}
        for mode, (replaces, _) in K1_MODES.items()]
    kernels.append(
        {"name": "poisson_flat", "route": "cuda",
         "source": "rescan_line_sted_torch/csrc/poisson.cu",
         "replaces": "rescan_line_sted_tpu/kernels/poisson_pallas.py:398",
         "path": "flagship", "launches": paths["flagship"]["poisson_flat"],
         "max_abs_err": sampler_err["poisson_flat"],
         "err_kind": "max |mean(kernel) - mean(plain)| over rates",
         **times["poisson_flat"]})
    log(json.dumps({"standalone": [{
        "name": "poisson_rows_tiered", "route": "cuda",
        "source": "rescan_line_sted_torch/csrc/poisson.cu",
        "replaces": "rescan_line_sted_tpu/kernels/poisson_pallas.py:344",
        "launches": 0,
        "max_abs_err": sampler_err["k2b_draw_for_draw"],
        "err_kind": "counts against the host reference on the same "
                    "Philox stream, rates below the bright tier",
        **times["poisson_rows_tiered"]}]}))
    log(json.dumps({"e2e_per_step_ms": times["e2e"]}))
    log(json.dumps({"kernels": kernels}))
    log(name_power)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

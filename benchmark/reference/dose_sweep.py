"""Plain reference of the dose-matched point-vs-line sweep (BASELINE
config 4), for the ``dose_sweep`` driver. Plain PyTorch and numpy in
float64; it imports nothing of the program.

For each depletion power ``s`` and each arm, the dose ledger of a scan that
visits every position: each pixel receives ``sum(exc)`` excitation and
``s sum(dep)`` depletion; the exposure that meets the budget is ``budget /
(sum(exc) + s sum(dep))`` (the line arm's divided by its orientations);
the emitted signal is ``brightness exposure sum(exc e^(-s dep)) sum(sample)``.
The mean image is the per-position descanned process of
``tests/oracle/oracle.py`` summed in closed form, one circular correlation
of the sample with the system kernel:

* point: ``K = eff (pinhole (*) det)``, since ``sum_r det(r - a) pin(r -
  r0)`` is ``(det (*) pin)(a - r0)`` for a symmetric ``det``;
* line: ``K(vy, vx) = eff(vx) sum_d det(vy, d) slit(d + vx)``.

The FWHM columns are the linear-interpolation FWHMs of the centre column
(y) and row (x) of each power's system kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import plain


def fwhm(profile) -> float:
    """Width at half maximum of a one-lobed profile, the crossings found by
    linear interpolation between samples; NaN without two crossings."""
    p = np.asarray(profile, np.float64)
    p = p / p.max()
    peak = int(np.argmax(p))
    left = [i for i in range(peak) if p[i] < 0.5 <= p[i + 1]]
    right = [i for i in range(peak, p.size - 1) if p[i] >= 0.5 > p[i + 1]]
    if not left or not right:
        return float("nan")
    i, j = left[-1], right[0]
    x_l = i + (0.5 - p[i]) / (p[i + 1] - p[i])
    x_r = j + (0.5 - p[j]) / (p[j + 1] - p[j])
    return float(x_r - x_l)


def _kernel_point(shape, cfg, s, dev, prec):
    exc, dep = plain.point_profiles(shape, cfg, dev)
    y = plain.coords(shape[0], dev)[:, None]
    x = plain.coords(shape[1], dev)[None, :]
    det = plain.gaussian(y, cfg["sigma_det"]) * plain.gaussian(
        x, cfg["sigma_det"])
    det = det / det.sum()
    pin = ((y * y + x * x) <= cfg["pinhole_radius"] ** 2).to(torch.float64)
    exc, dep = exc.to(prec.real), dep.to(prec.real)
    eff = exc * torch.exp(-s * dep)
    return exc, dep, eff, eff * plain.convolve2(pin, det, prec)


def _kernel_line(shape, cfg, s, dev, prec):
    h, w = shape
    exc, dep = (p.to(prec.real) for p in plain.line_profiles(w, cfg, dev))
    eff = exc * torch.exp(-s * dep)
    det = (plain.detection_profile(h, cfg["sigma_det"], dev)[:, None]
           * plain.detection_profile(w, cfg["sigma_det"], dev)[None, :])
    taps = [t for t in range(-w // 2, w // 2)
            if abs(t) <= cfg["slit_halfwidth"]]
    j = torch.arange(w, device=dev)
    q = torch.zeros(shape, dtype=prec.real, device=dev)
    for t in taps:                 # Q(vy, vx) = sum_d det(vy, d) slit(d + vx)
        q += det[:, (t - (j - w // 2) + w // 2) % w].to(prec.real)
    return exc, dep, eff, eff[None, :] * q


def sweep(sample: torch.Tensor, config: dict, powers, precision="float64"):
    """Per arm (``"point"``, ``"line"``): ``image`` [B, H, W] (mean),
    ``exposure``, ``emitted_signal``, ``num_steps``, ``fwhm_x``,
    ``fwhm_y`` [B], on ``sample``'s device (float64; the control's images
    in float32)."""
    prec = plain.Precision(precision)
    dev = sample.device
    shape = tuple(sample.shape)
    s_real = sample.to(prec.real)
    total = float(s_real.sum())
    budget = float(config["dose_budget"])
    orient = float(config.get("orientations", 1))
    steps = {"point": shape[0] * shape[1], "line": shape[1]}
    out = {}
    for arm in ("point", "line"):
        cfg = config[arm]
        cols = {k: [] for k in ("image", "exposure", "emitted_signal",
                                "num_steps", "fwhm_x", "fwhm_y")}
        for s in powers:
            if arm == "point":
                exc, dep, eff, k = _kernel_point(shape, cfg, s, dev, prec)
                exposure = budget / float(exc.sum() + s * dep.sum())
                spread = 1.0
            else:
                exc, dep, eff, k = _kernel_line(shape, cfg, s, dev, prec)
                exposure = budget / (float(exc.sum() + s * dep.sum())
                                     * orient)
                spread = orient
            bright = cfg["brightness"] * exposure
            cols["image"].append(bright * plain.correlate2(s_real, k, prec))
            cols["exposure"].append(exposure)
            cols["emitted_signal"].append(
                bright * spread * float(eff.sum()) * total)
            cols["num_steps"].append(steps[arm] * orient
                                     if arm == "line" else steps[arm])
            kc = k.cpu().numpy()
            cols["fwhm_y"].append(fwhm(kc[:, shape[1] // 2]))
            cols["fwhm_x"].append(fwhm(kc[shape[0] // 2, :]))
        out[arm] = {k: (torch.stack(v) if k == "image" else torch.tensor(
            v, dtype=torch.float64, device=dev)) for k, v in cols.items()}
    return out

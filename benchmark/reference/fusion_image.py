"""Plain reference of BASELINE config 5's rescanned fusion (four
orientations, operator-form Richardson-Lucy), for the ``fusion_image``
driver. Plain PyTorch in float64; it imports nothing of the program.

With ``V`` orientations at the angles ``v pi / V``, view ``v`` is the
sample rotated by ``-v pi / V`` (bilinear, about ``(H // 2, W // 2)``,
zero fill) and acquired by the rescanned line-STED closed form, binning 1
(``report_sweep.CanvasMap``): its noise-free canvas is the mean a
Poisson draw is taken from. The canvases are fused on the sample grid by
``report_sweep.operator_rl``:

    est <- est sum_v A_v^T(d_v / A_v est) / sum_v A_v^T(1)

``A_v^T`` the exact transpose (the bilinear gather's scatter, the canvas
map read backwards), from the port's start ``mean(d) R / B``, with its
guard (the ratio 0 where the prediction is at or below 1e-6 of the first
canvas's mean magnitude) and the normaliser floored at 1e-6. The pieces
are ``report_sweep``'s, which ``tests/test_torch_report_reference.py``
holds to their definitions and their transposes.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import plain
from benchmark.reference.report_sweep import CanvasMap, Rotation, operator_rl


class Fusion:
    """The configuration's four views and their fusion, in ``precision``
    (``plain.Precision``'s names: "float64", or "tf32" for the control),
    on ``sample``'s device."""

    def __init__(self, sample: torch.Tensor, config: dict,
                 precision: str = "float64"):
        if config["rescan"]["binning"] != 1:
            raise ValueError("the reference's canvas map has binning 1")
        prec = plain.Precision(precision)
        dev = sample.device
        h, w = config["field"]
        v = config["orientations"]
        line = config["line"]
        self.real = prec.real
        self.r = float(config["rescan"]["rescan_factor"])
        self.brightness = float(line["brightness"])
        self.iters = config["fusion_iters"]
        self.views = [Rotation(h, w, -u * math.pi / v, dev, prec)
                      for u in range(v)]
        self.canvas = CanvasMap(h, w, line, float(config["depletion"]),
                                self.brightness, self.r, dev, prec)
        self.sample = sample.to(prec.real)

    def canvases(self) -> torch.Tensor:
        """The noise-free canvases [V, H, Wc]: each view's Poisson mean."""
        return self.canvas(torch.stack([rot(self.sample)
                                        for rot in self.views]))

    def restore(self, canvases: torch.Tensor) -> torch.Tensor:
        """The fused image [H, W] of ``canvases`` (noise-free or drawn)."""
        return operator_rl(canvases.to(self.sample.device, self.real),
                           self.views, self.canvas, self.r, self.brightness,
                           self.iters)

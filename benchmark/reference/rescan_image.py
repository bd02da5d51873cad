"""Plain reference of the rescanned line-STED canvas (noise-free mean),
for the ``rescan_image`` driver. Plain PyTorch in float64; it imports
nothing of the program.

**Scan** (``method="scan"``), from the per-position definition of
``tests/oracle/oracle.py``: the camera frame of scan position ``x0`` is the
sample lit by the line centred at ``x0`` and blurred by the detection PSF
(circular on the sample grid); its column ``x`` lands on canvas column
``x + (R - 1) x0`` of the ``wc = round(R W)`` ring, a fractional offset by
band-limited (phase-ramp) placement, a rounded one exactly. The PSF is
separable, so with ``s_y`` the sample convolved along y, in the rfft
domain of the canvas rows::

    C[y, k] = sum_a s_y[y, a] A[a, k],   A = (Gx^T E) * (Ill^T F)

with ``Gx[x, a]`` the circulant detection profile, ``Ill[x0, a]`` the
brightness-scaled line at ``x0``, ``E[x, k] = exp(-2 i pi k x / wc)`` and
``F[x0, k] = exp(-2 i pi k off(x0) / wc)``: three dense products, ~1 s at
2048^2 in complex128 on the card.

**Closed form** (``method="analytic"``): each sample column ``a`` adds
``s_y[., a]`` times the rescan kernel ``H(v) = sum_t e(t) det(v + (R-1) t)``
placed at ``R a`` on the canvas ring::

    C[y, k] = (sum_a s_y[y, a] exp(-2 i pi k R a / wc)) D[k] E[k]

``D`` the detection profile's and ``E`` the (R - 1)-stretched line's
transforms on the ring. It differs from the scan only through circular
wrap near the x-edges.

Binning 1 only; another binning raises.
"""

from __future__ import annotations

import torch

from benchmark.reference import plain


def canvas_mean(sample: torch.Tensor, config: dict, traffic: dict,
                precision: str = "float64") -> torch.Tensor:
    """The noise-free canvas ``[H, round(R W)]`` of ``sample`` [H, W]."""
    prec = plain.Precision(precision)
    if config["binning"] != 1:
        raise NotImplementedError("the plain reference takes binning 1")
    h, w = sample.shape
    r = float(traffic["rescan_factor"])
    wc = int(round(r * w))
    dev = sample.device
    kk = torch.arange(wc // 2 + 1, dtype=torch.float64, device=dev)
    exc, dep = plain.line_profiles(w, config, dev)
    eff = (config["brightness"] * exc
           * torch.exp(-config["depletion"] * dep)).to(prec.real)
    gx = plain.detection_profile(w, config["sigma_det"], dev).to(prec.real)
    s_y = plain.conv_axis(sample.to(torch.float64),
                          plain.detection_profile(h, config["sigma_det"], dev),
                          0, prec)
    c = plain.coords(w, dev)
    if traffic["method"] == "analytic":
        place = plain.phases(kk[None, :] * r * torch.arange(
            w, dtype=torch.float64, device=dev)[:, None] / wc, prec)
        d_hat = (gx[:, None] * plain.phases(
            kk[None, :] * c[:, None] / wc, prec)).sum(0)
        e_hat = (eff[:, None] * plain.phases(
            -kk[None, :] * (r - 1.0) * c[:, None] / wc, prec)).sum(0)
        spec = prec.mm(s_y, place) * (d_hat * e_hat).to(prec.complex)
    elif traffic["method"] == "scan":
        x = torch.arange(w, device=dev)
        idx = (x[:, None] - x[None, :] + w // 2) % w     # [x or x0, a]
        gx_mat = gx[idx]                                 # Gx[x, a]
        ill = eff[(x[None, :] - x[:, None] + w // 2) % w]  # Ill[x0, a]
        off = (r - 1.0) * x.to(torch.float64)
        if traffic["reassignment"] == "rounded":
            off = torch.round(off)
        e_mat = plain.phases(kk[None, :] * x[:, None].to(torch.float64)
                             / wc, prec)
        f_mat = plain.phases(kk[None, :] * off[:, None] / wc, prec)
        a_map = prec.mm(gx_mat.T, e_mat) * prec.mm(ill.T, f_mat)
        spec = prec.mm(s_y, a_map)
    else:
        raise ValueError(f"unknown method {traffic['method']!r}")
    return torch.fft.irfft(spec, n=wc, dim=-1)

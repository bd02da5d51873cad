"""Plain reference of the report's four-arm fused dose-matched sweep (the
publication's figures 1 and 4: BASELINE config 4 with the fusion and RL
half of config 5), for the ``report_sweep`` driver. Plain PyTorch in
float64; it imports nothing of the program.

Each depletion power ``s`` runs four arms at one per-pixel photodose
budget; the ledgers (exposure, emitted signal, scan steps) are
``dose_sweep.sweep``'s, the rescanned line arm taking the line arm's and
ISM the point arm's. With ``V`` orientations at the angles ``v pi / V``:

* **point**: the descanned image ``B corr(sample, K)`` restored by
  Richardson-Lucy (RL) with ``K``;
* **line**: ``V`` views, each the sample rotated by ``-theta``, imaged
  ``B corr(., K_line)`` and rotated back by ``+theta``; fused by
  multi-view RL with the kernels ``K_line`` rotated by ``+theta``;
* **rescan**: ``V`` canvases, each the closed-form rescanned canvas
  (``rescan_image.canvas_mean``'s closed form, binning 1) of the sample
  rotated by ``-theta``; fused on the sample grid by operator RL,
  ``est <- est sum_v A_v^T(d_v / A_v est) / sum_v A_v^T(1)``, whose
  adjoint is the exact transpose: the scatter transpose of the bilinear
  gather (not a rotation by ``+theta``) and the transpose of the canvas
  map (the y-correlation and the phase placement read backwards);
* **ism**: the rescanned point-STED canvas ``B conv(place_R(sample), H)``
  with ``H(v) = sum_t eff(t) det(v + (R - 1) t)`` on the ``round(R H) x
  round(R W)`` ring, deconvolved by RL with ``H / sum(H)`` and divided by
  ``sum(H)``.

The FWHM columns are those of each arm's RL-restored point response by
the same protocol (ISM's divided by ``R``): the restored views of a
centred point source ``corr(delta, K)`` (point, line), its rotated
canvases (rescan), its ISM canvas. The FRC columns
(``frc_resolution``) come from two independent Poisson draws of each
arm's means, restored alike (``pairs`` such pairs per arm and power):
radial FRC at 64 rings, the 1/7 criterion.

Where this follows the port's conventions rather than the publication's
description (the upstream's code is not in this repository):

* bilinear rotation about ``(H // 2, W // 2)`` with zero fill, the four
  corners weighted ``w_y w_x``, angles exact in float64;
* RL starts from the data's mean (operator RL: the canvases' mean times
  ``R / B``), and its ratio is pinned to 0 where the prediction is at or
  below ``1e-6`` times the data's mean magnitude (operator RL: the first
  canvas's), the port's guard ``_EPS``; operator RL divides by ``sum_v
  A_v^T(1)`` clamped at ``1e-6``;
* FRC: rings of the rfft2 half-plane by radius ``min(floor(r / 0.5 *
  64), 63)``, the DC ring and empty rings dropped; NaN where the curve
  never falls below 1/7, 2 px where it starts below.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import dose_sweep, plain

EPS = 1e-6          # RL's guard scale and the operator's normaliser floor
RINGS = 64
THRESHOLD = 1.0 / 7.0
ARMS = ("point", "line", "rescan", "ism")


class Rotation:
    """Bilinear rotation of [..., H, W] images by ``theta`` about ``(H //
    2, W // 2)`` (counter-clockwise in y-down array coordinates; each
    output pixel gathers its four source corners, zero outside), and its
    exact transpose ``T`` (each corner's weighted value scattered back)."""

    def __init__(self, h: int, w: int, theta: float, device, prec):
        self.shape, self.prec = (h, w), prec
        c, s = math.cos(theta), math.sin(theta)
        y = plain.coords(h, device)[:, None]
        x = plain.coords(w, device)[None, :]
        src_y = (c * y + s * x + h // 2).expand(h, w)
        src_x = (-s * y + c * x + w // 2).expand(h, w)
        idx, wts = [], []
        y0, x0 = torch.floor(src_y), torch.floor(src_x)
        for iy, wy in ((y0, 1.0 - (src_y - y0)), (y0 + 1, src_y - y0)):
            for ix, wx in ((x0, 1.0 - (src_x - x0)), (x0 + 1, src_x - x0)):
                ok = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
                idx.append((iy.clamp(0, h - 1) * w
                            + ix.clamp(0, w - 1)).long().reshape(-1))
                wts.append(torch.where(ok, wy * wx, 0.0).reshape(-1))
        self.index = torch.stack(idx)                         # [4, H W]
        self.weight = prec.operand(torch.stack(wts))          # [4, H W]

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        flat = self.prec.operand(img).reshape(*img.shape[:-2], -1)
        out = (flat[..., self.index] * self.weight).sum(-2)
        return out.reshape(img.shape)

    def T(self, img: torch.Tensor) -> torch.Tensor:
        flat = self.prec.operand(img).reshape(-1, img.shape[-2]
                                              * img.shape[-1])
        out = torch.zeros_like(flat)
        for k in range(4):
            out.index_add_(1, self.index[k], flat * self.weight[k])
        return out.reshape(img.shape)


class CanvasMap:
    """The rescanned line-STED closed form, binning 1, ``[..., H, W] ->
    [..., H, Wc]`` with ``Wc = round(R W)``: the sample convolved along y
    with the detection profile, each column ``a`` placed at ``R a`` on the
    canvas ring with the rescan kernel ``D E`` (``rescan_image``), times
    the brightness; and its transpose ``T``."""

    def __init__(self, h: int, w: int, cfg: dict, depletion: float,
                 brightness: float, r: float, device, prec):
        self.prec, self.bright = prec, brightness
        self.wc = wc = int(round(r * w))
        kk = torch.arange(wc // 2 + 1, dtype=torch.float64, device=device)
        exc, dep = plain.line_profiles(w, cfg, device)
        eff = exc * torch.exp(-depletion * dep)
        gx = plain.detection_profile(w, cfg["sigma_det"], device)
        c = plain.coords(w, device)[:, None]
        d_hat = (gx[:, None] * plain.phases(kk * c / wc, prec)).sum(0)
        e_hat = (eff[:, None] * plain.phases(-kk * (r - 1.0) * c / wc,
                                             prec)).sum(0)
        self.de = prec.operand(d_hat * e_hat)                      # [K]
        self.place = plain.phases(kk[None, :] * r * torch.arange(
            w, dtype=torch.float64, device=device)[:, None] / wc, prec)
        self.det_y = plain.detection_profile(h, cfg["sigma_det"], device)
        # irfft's weight of each one-sided mode in a real inner product
        self.twice = torch.full_like(kk, 2.0)
        self.twice[0] = 1.0
        if wc % 2 == 0:
            self.twice[-1] = 1.0

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        s_y = plain.conv_axis(img, self.det_y, -2, self.prec)
        spec = self.prec.mm(s_y, self.place) * self.de
        return self.bright * torch.fft.irfft(spec, n=self.wc, dim=-1)

    def T(self, canvas: torch.Tensor) -> torch.Tensor:
        # <g, irfft(X)> = (1 / Wc) sum_k twice_k Re(X_k conj(G_k)),
        # G = rfft(g): read the placement and the y-convolution backwards
        g_hat = torch.fft.rfft(self.prec.operand(canvas), dim=-1)
        back = self.prec.mm(g_hat.conj() * (self.twice * self.de),
                            self.place.T).real
        back = back * (self.bright / self.wc)
        return _corr_axis(back, self.det_y, -2, self.prec)


def _corr_axis(x, profile, dim, prec):
    """Circular correlation along ``dim`` with a profile centred at ``n //
    2``: the transpose of ``plain.conv_axis``."""
    n = x.shape[dim]
    k = torch.fft.rfft(torch.fft.ifftshift(prec.operand(profile), dim=-1))
    shape = [1] * x.dim()
    shape[dim] = k.numel()
    spec = torch.fft.rfft(prec.operand(x), dim=dim) * k.conj().reshape(shape)
    return torch.fft.irfft(spec, n=n, dim=dim)


def _dft(nc: int, turns, device, prec, rows: int = None):
    """``exp(-2 i pi k t / nc)`` for canvas modes ``k`` [rows] and grid
    offsets ``turns`` [n]: [rows, n] (``rows`` defaults to ``nc``)."""
    k = torch.arange(rows or nc, dtype=torch.float64, device=device)
    return plain.phases(k[:, None] * turns[None, :] / nc, prec)


def ism_parts(shape, cfg: dict, depletion: float, r: float, device, prec):
    """The ISM closed form's pieces on the ``round(R H) x round(R W)``
    canvas (binning 1): the placement DFTs ``py`` [Hc, H], ``px`` [W, Kx]
    and the system kernel's spectrum ``D E`` [Hc, Kx]."""
    h, w = shape
    hc, wc = int(round(r * h)), int(round(r * w))
    kx = wc // 2 + 1
    exc, dep = plain.point_profiles(shape, cfg, device)
    eff = exc * torch.exp(-depletion * dep)
    det = (plain.detection_profile(h, cfg["sigma_det"], device)[:, None]
           * plain.detection_profile(w, cfg["sigma_det"], device)[None, :])
    cy, cx = plain.coords(h, device), plain.coords(w, device)
    ay = torch.arange(h, dtype=torch.float64, device=device)
    ax = torch.arange(w, dtype=torch.float64, device=device)
    d_hat = prec.mm(prec.mm(_dft(hc, cy, device, prec), det),
                    _dft(wc, cx, device, prec, kx).T)
    e_hat = prec.mm(prec.mm(_dft(hc, -(r - 1.0) * cy, device, prec), eff),
                    _dft(wc, -(r - 1.0) * cx, device, prec, kx).T)
    return (_dft(hc, r * ay, device, prec),
            _dft(wc, r * ax, device, prec, kx).T, d_hat * e_hat,
            (hc, wc))


def ism_canvas(sample, cfg, depletion, r, brightness, prec, parts=None):
    """The noise-free ISM canvas of ``sample`` [H, W]."""
    py, px, de, canvas = parts or ism_parts(tuple(sample.shape), cfg,
                                            depletion, r, sample.device, prec)
    s_hat = prec.mm(prec.mm(py, sample), px)
    return brightness * torch.fft.irfft2(s_hat * de, s=canvas)


def ism_kernel(parts) -> torch.Tensor:
    """The centred ISM system kernel ``H`` on the canvas."""
    _, _, de, canvas = parts
    return torch.fft.fftshift(torch.fft.irfft2(de, s=canvas))


def richardson_lucy(data, psfs, iters: int, prec) -> torch.Tensor:
    """Multi-view RL on the sample grid: ``est <- est mean_v[(d_v / (est
    (*) psf_v)) (*) flip(psf_v)]`` from the data's mean, with the guard."""
    tiny = EPS * data.abs().mean()
    est = data.mean().expand(data.shape[-2:]).clone()
    for _ in range(iters):
        fwd = plain.convolve2(est[None], psfs, prec)
        ratio = torch.where(fwd > tiny, data / torch.maximum(fwd, tiny), 0.0)
        est = est * plain.correlate2(ratio, psfs, prec).mean(0)
    return est


def operator_rl(canvases, views, canvas_map, r: float, brightness: float,
                iters: int) -> torch.Tensor:
    """Operator RL of the canvases [V, H, Wc] onto the sample grid:
    ``A_v = canvas_map . views[v]``, ``A_v^T = views[v].T . canvas_map.T``."""
    def fwd(est):
        return torch.stack([canvas_map(rot(est)) for rot in views])

    def adj(y):
        back = canvas_map.T(y)
        return sum(rot.T(b) for rot, b in zip(views, back))

    tiny = EPS * canvases[0].abs().mean()
    norm = adj(torch.ones_like(canvases)).clamp_min(EPS)
    est = (canvases.mean() * r / brightness).expand(
        views[0].shape).clone()
    for _ in range(iters):
        pred = fwd(est)
        ratio = torch.where(pred > tiny, canvases / torch.maximum(pred, tiny),
                            0.0)
        est = est * adj(ratio) / norm
    return est


def frc_curve(img1: torch.Tensor, img2: torch.Tensor, rings: int = RINGS,
              precision: str = "float64") -> tuple[np.ndarray, np.ndarray]:
    """Radial FRC of two acquisitions of one field: the kept rings' mean
    frequencies (cycles/px) and the correlation on each. ``precision=
    "float32"`` computes it as a float32 program would: the spectra in
    complex64, the products and ring sums in float32; ``"tf32"`` is its
    control, each product's operands rounded to TF32 besides."""
    if precision == "float32":
        real, operand = torch.float32, (lambda z: z)
    else:
        prec = plain.Precision(precision)
        real, operand = prec.real, prec.operand
    a = img1.to(real)
    b = img2.to(a.device, real)
    h, w = a.shape
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    rad = np.sqrt(fy * fy + fx * fx).ravel()
    ring = np.minimum((rad / 0.5 * rings).astype(np.int64), rings - 1)
    counts = np.bincount(ring, minlength=rings)
    freqs = np.bincount(ring, weights=rad, minlength=rings) / np.maximum(
        counts, 1)
    keep = counts > 0
    keep[0] = False
    f1 = operand(torch.fft.rfft2(a - a.mean()).flatten())
    f2 = operand(torch.fft.rfft2(b - b.mean()).flatten())
    idx = torch.from_numpy(ring).to(a.device)

    def ring_sum(v):
        return torch.zeros(rings, dtype=real, device=a.device).index_add_(
            0, idx, v).double().cpu().numpy()[keep]

    num = ring_sum((f1 * f2.conj()).real)
    den = np.sqrt(ring_sum(f1.abs() ** 2) * ring_sum(f2.abs() ** 2))
    return freqs[keep], num / np.maximum(den, 1e-30)


def resolution_of(freqs: np.ndarray, curve: np.ndarray,
                  threshold: float = THRESHOLD) -> float:
    """The resolution (px) a curve gives: ``1 / k`` at its first fall
    below ``threshold``, interpolated linearly between rings; NaN where it
    never falls below, 2 where it starts below."""
    below = curve < threshold
    if below[0]:
        return 2.0
    cross = np.flatnonzero(~below[:-1] & below[1:])
    if cross.size == 0:
        return math.nan
    i = cross[0]
    t = (curve[i] - threshold) / max(curve[i] - curve[i + 1], 1e-30)
    return float(1.0 / (freqs[i] + t * (freqs[i + 1] - freqs[i])))


def frc_resolution(img1: torch.Tensor, img2: torch.Tensor,
                   rings: int = RINGS, threshold: float = THRESHOLD,
                   precision: str = "float64") -> float:
    """Radial FRC resolution (px) of two acquisitions of one field: NaN
    where the curve never falls below ``threshold``, 2 where it starts
    below."""
    return resolution_of(*frc_curve(img1, img2, rings, precision),
                         threshold)


def _fwhms(kernel: torch.Tensor) -> tuple[float, float]:
    """(FWHM along y, along x) through the centre of a centred kernel."""
    k = kernel.cpu().numpy()
    h, w = k.shape
    return dose_sweep.fwhm(k[:, w // 2]), dose_sweep.fwhm(k[h // 2, :])


class Arms:
    """One power's four arms: their means (what an acquisition draws
    from), and the restorations that turn means or draws into the arm's
    image."""

    def __init__(self, sample, config, s: float, bright_p: float,
                 bright_l: float, prec):
        dev, shape = sample.device, tuple(sample.shape)
        self.prec, self.iters = prec, config["fusion_iters"]
        v = config["orientations"]
        h, w = shape
        self.r_rescan = float(config["rescan"]["rescan_factor"])
        self.r_ism = float(config["ism"]["rescan_factor"])
        s_real = sample.to(prec.real)
        self.delta = torch.zeros(shape, dtype=prec.real, device=dev)
        self.delta[h // 2, w // 2] = 1.0

        _, _, _, self.k_point = dose_sweep._kernel_point(
            shape, config["point"], s, dev, prec)
        self.k_point = self.k_point.to(prec.real)
        _, _, _, k_line = dose_sweep._kernel_line(shape, config["line"], s,
                                                  dev, prec)
        self.rot_in = [Rotation(h, w, -u * math.pi / v, dev, prec)
                       for u in range(v)]
        self.rot_out = [Rotation(h, w, u * math.pi / v, dev, prec)
                        for u in range(v)]
        self.k_views = torch.stack([rot(k_line.to(prec.real))
                                    for rot in self.rot_out])
        rotated = torch.stack([rot(s_real) for rot in self.rot_in])
        self.canvas = CanvasMap(h, w, config["line"], s, bright_l,
                                self.r_rescan, dev, prec)
        self.bright_l = bright_l
        self.ism = ism_parts(shape, config["point"], s, self.r_ism, dev, prec)
        h_ism = ism_kernel(self.ism)
        self.h_sum = h_ism.sum()
        self.h_ism = (h_ism / self.h_sum)[None]
        self.means = {
            "point": bright_p * plain.correlate2(s_real, self.k_point, prec),
            # each view in its own frame, as drawn
            "line": bright_l * plain.correlate2(rotated, k_line.to(
                prec.real)[None], prec),
            "rescan": self.canvas(rotated),
            "ism": ism_canvas(s_real, config["point"], s, self.r_ism,
                              bright_p, prec, self.ism),
        }
        # the centred point source's noise-free acquisitions: the point
        # and line arms' as their kernels' models, the rescan arm's at the
        # run's brightness, ISM's at the base brightness
        delta_in = torch.stack([rot(self.delta) for rot in self.rot_in])
        self.responses = {
            "point": plain.correlate2(self.delta, self.k_point, prec),
            "line": plain.correlate2(self.delta[None], self.k_views, prec),
            "rescan": self.canvas(delta_in),
            "ism": ism_canvas(self.delta, config["point"], s, self.r_ism,
                              config["point"]["brightness"], prec, self.ism),
        }

    def restore(self, arm: str, acquired: torch.Tensor,
                response: bool = False) -> torch.Tensor:
        """The arm's image from its acquisition (means or draws; a point
        response's are already in the sample frame)."""
        if arm == "point":
            return richardson_lucy(acquired[None], self.k_point[None],
                                   self.iters, self.prec)
        if arm == "line":
            views = acquired if response else torch.stack(
                [rot(a) for rot, a in zip(self.rot_out, acquired)])
            return richardson_lucy(views, self.k_views, self.iters,
                                   self.prec)
        if arm == "rescan":
            return operator_rl(acquired, self.rot_in, self.canvas,
                               self.r_rescan, self.bright_l, self.iters)
        return richardson_lucy(acquired[None], self.h_ism, self.iters,
                               self.prec) / self.h_sum


def sweep(sample: torch.Tensor, config: dict, powers,
          precision: str = "float64",
          generator: torch.Generator | None = None, pairs: int = 1) -> dict:
    """Per arm (``ARMS``): ``image`` [B, ...] (the restored means),
    ``exposure``, ``emitted_signal``, ``num_steps``, ``fwhm_x``,
    ``fwhm_y`` [B] and, with ``generator``, ``frc_resolution`` [B, pairs]
    of ``pairs`` pairs of Poisson draws of the means drawn from it, each
    restored, and ``frc_pairs`` [B, 2, ...] (the first pair's images); on
    ``sample``'s device."""
    prec = plain.Precision(precision)
    dev = sample.device
    ledgers = dose_sweep.sweep(sample, config, powers, precision)
    brights = {arm: [config[arm]["brightness"] * e
                     for e in ledgers[arm]["exposure"].tolist()]
               for arm in ("point", "line")}
    out = {arm: {"image": [], "fwhm_x": [], "fwhm_y": [],
                 "frc_resolution": [], "frc_pairs": []} for arm in ARMS}
    for i, s in enumerate(powers):
        arms = Arms(sample, config, float(s), brights["point"][i],
                    brights["line"][i], prec)
        for arm in ARMS:
            col = out[arm]
            col["image"].append(arms.restore(arm, arms.means[arm]))
            scale = arms.r_ism if arm == "ism" else 1.0
            fy, fx = _fwhms(arms.restore(arm, arms.responses[arm],
                                         response=True))
            col["fwhm_y"].append(fy / scale)
            col["fwhm_x"].append(fx / scale)
            if generator is not None:
                mean = arms.means[arm].clamp_min(0.0)
                res = []
                for _ in range(pairs):
                    pair = torch.stack([arms.restore(arm, torch.poisson(
                        mean, generator=generator)) for _ in range(2)])
                    res.append(frc_resolution(*pair) / scale)
                    if len(res) == 1:
                        col["frc_pairs"].append(pair)
                col["frc_resolution"].append(res)
    result = {}
    for arm in ARMS:
        led = ledgers["line" if arm == "rescan" else
                      "point" if arm == "ism" else arm]
        cols = {k: led[k] for k in ("exposure", "emitted_signal",
                                    "num_steps")}
        cols["image"] = torch.stack(out[arm]["image"])
        for k in ("fwhm_x", "fwhm_y", "frc_resolution"):
            if out[arm][k]:
                cols[k] = torch.tensor(out[arm][k], dtype=torch.float64,
                                       device=dev)
        if out[arm]["frc_pairs"]:
            cols["frc_pairs"] = torch.stack(out[arm]["frc_pairs"])
        result[arm] = cols
    return result

"""The yardstick's arithmetic: the card's peak rates, and the work that a
kernel's function needs on a cell's shapes, counted from the configuration
alone.

Nothing here reads the program's arguments or imports the program, so the
count stays the same whatever later implements a kernel. Which mode K1
runs in (class residues or NUFFT spreading) and whether it runs at all
come from a frozen copy of the rescan engine's routing arithmetic
(``_illum_band``, ``_rational_step`` and ``_k1_windows`` in
``rescan_line_sted_torch/imaging/rescan.py`` as of this benchmark), held to
it by ``benchmark/tests/test_bench_work.py``; the work itself is counted
from the Gaussians' supports, not from the windows' padded widths.
"""

from __future__ import annotations

# One NVIDIA H100 SXM (data sheet, dense rates) at its full 700 W.
PEAK_TF32 = 495e12       # FLOP/s in TF32 on the tensor cores
PEAK_BYTES = 3.35e12     # HBM3 bytes/s

NUFFT_TAPS = 8           # spreading taps per position, both parities


def support(sigma: float, pad: int = 5) -> int:
    """Half-width (px) bounding a Gaussian of width ``sigma``."""
    return int(6.5 * float(sigma)) + pad


def rational_step(step: float, chunk: int):
    """``(p, q)`` with ``step == p / q``, q <= 8 dividing ``chunk``; None
    where no such q exists (the NUFFT mode)."""
    for q in range(1, 9):
        if chunk % q == 0 and abs(step * q - round(step * q)) < 1e-9:
            return int(round(step * q)), q
    return None


def canvas_width(width: int, rescan_factor: float, binning: int) -> int:
    return int(round(rescan_factor * width)) // binning


def k1_windows(config: dict, traffic: dict):
    """``(d_in, d_out, mode, q)`` of the banded scan on these shapes, mode
    "class" (placement classes, q of them) or "nufft" (two parity
    canvases); None where the scan has no band windows."""
    w = config["field"][1]
    chunk, b = config["chunk"], config["binning"]
    r = float(traffic["rescan_factor"])
    s_exc, s_det = support(config["sigma_exc"]), support(config["sigma_det"])
    d_in = -(-(chunk + 2 * s_exc) // 128) * 128
    d_out = -(-(chunk + 2 * (s_exc + s_det)) // 128) * 128
    if d_in >= w or d_out >= w or chunk % b or ((d_out - chunk) // 2) % b:
        return None
    step = (r - 1.0) / b
    mode = traffic["reassignment"]
    rounded = mode == "rounded" or (
        mode == "auto" and abs(step - round(step)) < 1e-9)
    pq = (None, 1) if rounded else rational_step(step, chunk)
    taps = NUFFT_TAPS if pq is None else 0
    wc = canvas_width(w, r, b)
    if chunk % 8 or (d_out // b + max(taps // 2 - 1, 0) + 7) // 8 * 8 + 8 > wc:
        return None
    if pq is None:
        return d_in, d_out, "nufft", 2
    return d_in, d_out, "class", pq[1]


def k1_work(config: dict, traffic: dict) -> dict:
    """The work that K1's function needs on one image, whatever implements
    it: ``conv`` the FMAs of each scan position's frame, its lit columns
    (``2 support(sigma_exc) + 1``) times the detection taps (``2
    support(sigma_det) + 1``) in each of its rows; ``taps`` the NUFFT
    spreading FMAs, each column the frame lights (lit and taps less one)
    spread over ``NUFFT_TAPS`` canvas columns (irrational R only);
    ``bytes`` the y-convolved sample read once and the canvas written
    once. Band windows padded to 128 columns, placement classes and
    folded canvases are the implementation's and are not counted."""
    mode = k1_windows(config, traffic)[2]
    h, w = config["field"]
    hb = h // config["binning"]
    lit = 2 * support(config["sigma_exc"]) + 1
    taps = 2 * support(config["sigma_det"]) + 1
    spread = w * (lit + taps - 1) * hb * NUFFT_TAPS if mode == "nufft" else 0
    wc = canvas_width(w, float(traffic["rescan_factor"]), config["binning"])
    return {"conv": w * lit * taps * hb, "taps": spread,
            "bytes": 4 * (h * w + hb * wc)}


def k1_least_s(config: dict, traffic: dict) -> float:
    """K1's least time on this card: its FMAs (convolution and taps) as
    three TF32 passes at the tensor cores' peak, the least that keeps
    float32's accuracy, or its bytes at the memory rate, whichever is
    longer."""
    n = k1_work(config, traffic)
    ops = 3.0 * 2.0 * (n["conv"] + n["taps"]) / PEAK_TF32
    return max(ops, n["bytes"] / PEAK_BYTES)


def k2c_least_s(config: dict, traffic: dict) -> float:
    """K2c's least time on one image's canvas: each rate read once and each
    count written once (4 bytes each) at the memory rate."""
    h, w = config["field"]
    b = config["binning"]
    n = (h // b) * canvas_width(w, float(traffic["rescan_factor"]), b)
    return 8.0 * n / PEAK_BYTES

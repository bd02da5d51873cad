"""The least time of BASELINE config 5's rescanned fusion (the
``fusion_image`` driver's call), counted from the configuration alone, as
``work.k1_work`` counts K1: nothing here reads the program's arguments or
imports the program.

One call applies the stacked V-view operator ``A`` (each view: the sample
rotated, convolved along y with the detection profile, each column placed
on the canvas with the rescan kernel) once to acquire, ``A^T`` once for
RL's normaliser, and ``A`` and ``A^T`` once in each iteration. Each
application, per view, takes per sample pixel the rotation's 4 taps, the
detection's ``2 support(sigma_det) + 1`` taps along y, and the canvas
rescan kernel's taps over the placed columns: the detection's along x,
widened by the excitation's ``2 support(sigma_exc)`` stretched by
``R - 1``. The bytes: per iteration the canvases read once and the
estimate read and written once (float32). The dense phase products that
the port computes the placement with are the implementation's and are not
counted, so no faster formulation can read over 100%.
"""

from __future__ import annotations

from benchmark.work import PEAK_BYTES, PEAK_TF32, canvas_width, support


def fusion_work(config: dict) -> dict:
    """``fma``: the FMAs of one call; ``bytes``: its least traffic."""
    h, w = config["field"]
    line, rescan = config["line"], config["rescan"]
    r, b = float(rescan["rescan_factor"]), rescan["binning"]
    det = 2 * support(line["sigma_det"]) + 1
    canvas_taps = det + (r - 1.0) * 2 * support(line["sigma_exc"])
    per_view = h * w * (4 + det + canvas_taps)
    iters = config["fusion_iters"]
    applications = 2 * iters + 2    # A and A^T each iteration, acquire, norm
    views = config["orientations"]
    canvases = views * (h // b) * canvas_width(w, r, b)
    return {"fma": applications * views * per_view,
            "bytes": iters * 4 * (canvases + 2 * h * w)}


def fusion_least_s(config: dict, traffic: dict) -> float:
    """The call's least time on this card: its FMAs as three TF32 passes
    at the tensor cores' peak, the least that keeps float32's accuracy, or
    its bytes at the memory rate, whichever is longer."""
    n = fusion_work(config)
    return max(3.0 * 2.0 * n["fma"] / PEAK_TF32, n["bytes"] / PEAK_BYTES)

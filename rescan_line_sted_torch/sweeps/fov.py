"""Resolution / FOV sweep (port of the JAX package's ``sweeps/fov.py``;
BASELINE config 5, final stage).

For each field-of-view size: acquire multi-orientation line-STED views
of a point-emitter lattice, fuse them with Richardson-Lucy, and measure
the restored resolution on the lattice points near the centre and the
wall-clock time.

The JAX package jits one program per size and times its first call
(``compile_s``) and its second (``wall_s``). The port has no trace to
compile: ``compile_s`` is the first call's time, with the host tables
and plans that later calls find cached, and ``wall_s`` the second's, each
bracketed by a device sync. Both calls see the same draws, as the JAX
function calls its program twice with one key: the generator's state is
restored before the second call. The patches around the lattice points
are cut with one gather and measured with one batched ``fwhm_2d``; the
values reach the host once per size, when the record is built.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from rescan_line_sted_torch.algorithms.metrics import fwhm_2d
from rescan_line_sted_torch.algorithms.richardson_lucy import (
    richardson_lucy_views,
)
from rescan_line_sted_torch.config import Grid, LineSTEDGeometry
from rescan_line_sted_torch.data import samples
from rescan_line_sted_torch.device import resolve
from rescan_line_sted_torch.device import host_table
from rescan_line_sted_torch.imaging.orientations import (
    multi_orientation_line_sted,
)


def fused_views(sample, params, geom, angles, rl_iters: int,
                generator: torch.Generator | None = None):
    """One size's work: the views at ``angles`` fused by ``rl_iters`` RL
    iterations. Returns ``(fused [H, W], kernels [V, H, W])`` on the
    sample's device, with no host read."""
    views, kernels = multi_orientation_line_sted(
        sample, params, geom, angles, generator=generator,
        device=sample.device)
    return richardson_lucy_views(views, kernels, num_iter=rl_iters), kernels


def lattice_fwhm(fused: torch.Tensor, kernels: torch.Tensor,
                 spacing: int) -> torch.Tensor:
    """``[fused_fwhm_y, fused_fwhm_x, view_kernel_fwhm_y,
    view_kernel_fwhm_x]`` on ``fused``'s device: the fused FWHMs are the
    NaN-mean over the lattice points at and next to the centre (one
    point's restored FWHM is noisy under Poisson draws), each measured on
    the ``spacing``-wide patch around it; the kernel's on view 0."""
    size = fused.shape[-1]
    half = spacing // 2
    c = half + spacing * ((size // 2 - half) // spacing)
    centers = [c] + [c + d for d in (-spacing, spacing)
                     if half <= c + d < size - half]
    # patch origins, clamped into the image as ``lax.dynamic_slice`` does
    starts = np.clip(np.array(centers) - half, 0, size - 2 * half)
    span = starts[:, None] + np.arange(2 * half)[None, :]          # [n, 2h]
    rows = host_table(np.repeat(span, len(centers), 0), fused.device)
    cols = host_table(np.tile(span, (len(centers), 1)), fused.device)
    patches = fused[rows[:, :, None], cols[:, None, :]]        # [P, 2h, 2h]
    fy, fx = fwhm_2d(patches)
    ky, kx = fwhm_2d(kernels[0])
    return torch.stack([fy.nanmean(), fx.nanmean(), ky, kx])


def resolution_fov_sweep(
    sizes: tuple[int, ...],
    params,
    num_angles: int = 4,
    rl_iters: int = 40,
    generator: torch.Generator | None = None,
    spacing: int = 24,
    device=None,
) -> list[dict]:
    """One record per FOV size: fused FWHM, the view kernel's FWHM, scan
    steps and wall times, computed on ``device`` (None: the CUDA card,
    raising without one; pass ``device="cpu"`` for the CPU).
    ``generator`` draws shot noise; None gives noise-free views."""
    device = resolve(device)
    angles = torch.arange(num_angles, dtype=torch.float32) * (
        math.pi / num_angles)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    records = []
    for size in sizes:
        geom = LineSTEDGeometry(Grid(size, size), chunk=min(32, size))
        sample = samples.sparse_points((size, size), spacing=spacing,
                                       device=device)
        state = None if generator is None else generator.get_state()
        times = []
        for _ in range(2):
            if state is not None:
                generator.set_state(state)
            sync()
            t0 = time.perf_counter()
            fused, kernels = fused_views(sample, params, geom, angles,
                                         rl_iters, generator)
            sync()
            times.append(time.perf_counter() - t0)
        fy, fx, ky, kx = lattice_fwhm(fused, kernels, spacing).tolist()
        records.append({
            "fov": size,
            "scan_steps": size * num_angles,
            "fused_fwhm_y": fy,
            "fused_fwhm_x": fx,
            "view_kernel_fwhm_y": ky,
            "view_kernel_fwhm_x": kx,
            "wall_s": times[1],
            "compile_s": times[0],
        })
    return records

"""Scan-process animations (port of the JAX package's
``pipelines/animation.py``; the reference publication's animated figures).

The reference's web figures animate the acquisition: the raw camera frame at
each scan position next to the accumulating detected image. This pipeline
renders the same thing as an animated GIF from the engine's per-step camera
frames (`imaging/frames.py`) and the progressive detected image, both
computed on ``device`` (None: the CUDA card) and copied to the host once.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from rescan_line_sted_torch.config import (
    Grid,
    LineSTEDGeometry,
    LineSTEDParams,
)
from rescan_line_sted_torch.data import samples
from rescan_line_sted_torch.device import resolve
from rescan_line_sted_torch.imaging import line_sted_image
from rescan_line_sted_torch.imaging.frames import line_sted_camera_frames
from rescan_line_sted_torch.io.checkpoint import to_numpy
from rescan_line_sted_torch.utils.observability import emit_metrics


def _to_rgb(img: np.ndarray, vmax: float) -> np.ndarray:
    """Map a nonnegative image to magma RGB uint8 (grey without
    matplotlib)."""
    try:
        from matplotlib import cm
        rgba = cm.magma(np.clip(img / max(vmax, 1e-30), 0.0, 1.0))
        return (rgba[..., :3] * 255).astype(np.uint8)
    except ImportError:
        g = (np.clip(img / max(vmax, 1e-30), 0.0, 1.0) * 255).astype(np.uint8)
        return np.stack([g, g, g], axis=-1)


def line_scan_animation(out_dir: str, size: int = 128, depletion: float = 8.0,
                        num_frames: int = 32, seed: int = 0,
                        frame_ms: int = 80, device=None) -> dict:
    """Animated GIF: camera frame | accumulating descanned line-STED image.

    The JAX pipeline draws both with one key; here each call gets a
    generator seeded with ``seed``, so both draw from the same seed.
    """
    dev = resolve(device)
    grid = Grid(size, size)
    geom = LineSTEDGeometry(grid, chunk=min(32, size))
    params = LineSTEDParams.create(depletion=depletion, brightness=200.0)
    sample = samples.siemens_star((size, size), device=dev)

    positions = np.linspace(0, size - 1, num_frames).astype(np.int32)
    cams, full = to_numpy((
        line_sted_camera_frames(
            sample, params, geom, positions,
            torch.Generator(dev).manual_seed(seed), device=dev),
        line_sted_image(sample, params, geom,
                        torch.Generator(dev).manual_seed(seed),
                        device=dev).image))

    cam_vmax = float(cams.max())
    img_vmax = float(full.max())
    frames = []
    for i, x0 in enumerate(positions):
        acc = np.zeros_like(full)
        acc[:, : x0 + 1] = full[:, : x0 + 1]  # image acquired so far
        left = _to_rgb(cams[i], cam_vmax)
        right = _to_rgb(acc, img_vmax)
        gap = np.zeros((size, 4, 3), np.uint8)
        frames.append(np.concatenate([left, gap, right], axis=1))

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "line_scan_animation.gif")
    try:
        from PIL import Image
        pil_frames = [Image.fromarray(f) for f in frames]
        pil_frames[0].save(path, save_all=True, append_images=pil_frames[1:],
                           duration=frame_ms, loop=0)
    except ImportError:
        np.savez(path + ".npz", frames=np.stack(frames))
        path += ".npz"
    metrics = {"pipeline": "animation", "frames": num_frames, "path": path}
    emit_metrics(metrics, os.path.join(out_dir, "metrics.jsonl"))
    return metrics

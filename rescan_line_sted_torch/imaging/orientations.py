"""Multi-orientation line-STED acquisition (port of the JAX package's
``imaging/orientations.py``; BASELINE config 5).

The descanned line-STED system kernel is anisotropic (STED-sharp along
the scan axis x, diffraction-limited along the line axis y), so several
scan orientations are acquired and fused with multi-view Richardson-Lucy
(``algorithms.richardson_lucy_views``) into an isotropic image.

Convention: the view at angle theta scans along the direction theta
(radians, CCW in array coordinates). The sample is rotated by -theta,
acquired with the x-scan engine, and the image rotated back by +theta;
the view's kernel in the sample frame is the x-scan kernel rotated by
+theta.

The JAX package vmaps rotate-acquire-derotate over the angles. The port
batches the analytic method: the rotations are one call each way and the
acquisition is ``line_sted.analytic_images`` over [V, H, W], so a noisy
call draws every view in ONE launch of K2c on the card. The scan method
loops over the angles through ``line_sted_image(method="scan")`` with its
defaults, as the JAX package does: collapsed noise, so a noisy call draws
each view once (one launch of K2c per view on the card).

Randomness: one generator draws the views in order, where the JAX package
splits one key per view, so noisy views agree with it in distribution
only.
"""

from __future__ import annotations

import torch

from rescan_line_sted_torch.device import as_sample, resolve
from rescan_line_sted_torch.imaging import analytic
from rescan_line_sted_torch.imaging.line_sted import (
    analytic_images,
    line_sted_image,
)
from rescan_line_sted_torch.physics import models
from rescan_line_sted_torch.utils.rotate import rotate_image


def orientation_kernels(shape: tuple[int, int], params, angles,
                        device=None) -> torch.Tensor:
    """Per-view centred system kernels [V, H, W] for RL fusion, on
    ``device`` (None: the CUDA card, raising without one)."""
    base = analytic.line_system_kernel(shape, params, resolve(device))
    return rotate_image(base, angles)


def multi_orientation_line_sted(
    sample,
    params,
    geom,
    angles,
    generator: torch.Generator | None = None,
    method: str = "analytic",
    device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Acquire descanned line-STED views of ``sample`` [H, W] at each of
    ``angles`` [V] (radians).

    Returns ``(views [V, H, W], kernels [V, H, W])``, both in the sample
    frame, ready for ``richardson_lucy_views``. ``sample`` is taken as
    ``line_sted_image`` takes it (None ``device``: the CUDA card). The
    analytic method draws all views at once, the scan method view after
    view.
    """
    sample = as_sample(sample, geom.grid.shape, device)
    angles = torch.as_tensor(angles, dtype=torch.float32, device="cpu")
    models.line_model(params)           # raises on a JAX package model
    rotated = rotate_image(sample, -angles)                       # [V, H, W]
    if method == "analytic":
        images = analytic_images(rotated, params, generator)
    elif method == "scan":
        images = torch.stack([
            line_sted_image(s, params, geom, generator, method="scan",
                            device=sample.device).image
            for s in rotated])
    else:
        raise ValueError(f"unknown method {method!r}")
    views = rotate_image(images, angles)
    kernels = orientation_kernels(tuple(sample.shape), params, angles,
                                  sample.device)
    return views, kernels

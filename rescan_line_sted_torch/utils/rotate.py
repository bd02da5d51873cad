"""Bilinear image rotation for multi-orientation acquisition (port of the
JAX package's ``utils/rotate.py``).

The JAX package rotates with ``jax.scipy.ndimage.map_coordinates`` and
vmaps over the angles; the port takes a batch of angles in one call and
computes the same four-corner gather:

* source coordinates ``cos*y + sin*x + cy`` and ``-sin*y + cos*x + cx``
  (inverse mapping about ``(h//2, w//2)``);
* per axis ``lower = floor(c)``, ``upper = c - lower`` and ``1 - upper``;
* a corner counts only where its index, before any clamp, lies in
  ``[0, size)``; it adds 0 otherwise (zero fill);
* the corners summed in the order (y0, x0), (y0, x1), (y1, x0), (y1, x1),
  each as ``(w_y * w_x) * value``.

``torch.nn.functional.grid_sample`` is not used: its normalisation of the
coordinates to [-1, 1] and back moves them by ~(W-1)/2 * 6e-8 px in
float32, which misses the 1e-5 bar at 512^2 and above.

The coordinates are exact, not the JAX package's float32: ``cos`` and
``sin`` of the angles are taken on the host in float64 (numpy) and sent
to the device as one pinned table, and the coordinate grid, the source
coordinates, ``floor`` and each axis's weights are computed in float64;
each corner's weight ``w_y * w_x`` is rounded to float32 once. In float32
a source coordinate reaches ~1448 px at 2048^2, where one ulp is 1.2e-4
px: the rotated Siemens star then lies 1.5e-4 of its maximum off the
exact bilinear rotation at 2048^2 and 2.8e-5 at 512^2 (the JAX package's
own reading there), against the float32 images' 1e-5 bar. The values
gathered and their weighted sum stay float32, in the order above.
"""

from __future__ import annotations

import numpy as np
import torch

from rescan_line_sted_torch import device as devices


def rotate_image(img: torch.Tensor, theta) -> torch.Tensor:
    """Rotate ``img`` [..., H, W] by ``theta`` radians about the grid
    centre: counter-clockwise in (y-down) array coordinates, bilinear,
    zero fill outside the input.

    ``theta`` is a number or a tensor of angles; its shape broadcasts
    against ``img``'s leading dimensions, so [H, W] by [V] angles gives
    [V, H, W] and [V, H, W] by [V] rotates each image by its own angle.
    The result lies on ``img``'s device.
    """
    h, w = img.shape[-2:]
    shape, corners = rotation_corners(h, w, theta, img.device)
    batch = torch.broadcast_shapes(img.shape[:-2], shape)
    flat = img.expand(*batch, h, w).reshape(-1, h * w)
    out = None
    for idx, weight, valid in corners:
        idx = idx.expand(*batch, h * w).reshape(-1, h * w)
        val = torch.where(valid, flat.gather(1, idx).reshape(*batch, h, w),
                          0.0)
        term = weight * val
        out = term if out is None else out + term
    return out


def rotation_corners(h: int, w: int, theta, device) -> tuple:
    """What a rotation by ``theta`` gathers, built once on ``device``:
    the angles' shape and, per corner in summation order, the flat source
    index [..., H*W] (clamped), the weight ``w_y * w_x`` (taken in float64,
    rounded to float32 once) and the validity mask [..., H, W] (leading
    dimensions: the angles'). Linear operators that rotate by fixed angles
    build it once (``algorithms/fusion``)."""
    theta = torch.as_tensor(theta, dtype=torch.float64, device="cpu").numpy()
    trig = devices.host_table(np.stack([np.cos(theta), np.sin(theta)]),
                              device)
    cos, sin = trig[0][..., None, None], trig[1][..., None, None]
    cy, cx = h // 2, w // 2
    # float64 coordinates and axis weights (the module's docstring)
    y = (torch.arange(h, dtype=torch.float64, device=device) - cy)[:, None]
    x = (torch.arange(w, dtype=torch.float64, device=device) - cx)[None, :]
    # inverse rotation: the source coordinates of each output pixel
    src_y = cos * y + sin * x + cy
    src_x = -sin * y + cos * x + cx

    def nodes(coord, size):
        lower = torch.floor(coord)
        upper = coord - lower
        index = lower.long()
        return [(index, 1 - upper, (index >= 0) & (index < size)),
                (index + 1, upper, (index + 1 >= 0) & (index + 1 < size))]

    corners = []
    for iy, wy, vy in nodes(src_y, h):
        for ix, wx, vx in nodes(src_x, w):
            idx = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
            corners.append((idx.reshape(*theta.shape, h * w),
                            (wy * wx).float(), vy & vx))
    return theta.shape, corners


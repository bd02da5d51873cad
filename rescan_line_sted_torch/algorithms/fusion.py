"""Operator-form Richardson-Lucy and rescanned-view fusion (port of the
JAX package's ``algorithms/fusion.py``).

``richardson_lucy_views`` covers views modelled by centred PSFs on the
sample grid. Rescanned line-STED views live on the canvas grid: their
forward model is the exact closed-form acquisition
(``analytic.rescan_canvas_mean``, any rescan factor, any binning), so
fusing them needs RL in linear-operator form:

    est <- est * [ sum_v A_v^T(data_v / A_v(est)) ] / [ sum_v A_v^T(1) ]

``A^T`` is the exact adjoint of the forward map, view rotation included:
the transpose of the bilinear rotation is its scatter adjoint, not a
rotation by the opposite angle. The JAX package takes it with
``jax.linear_transpose``; the port takes the vector-Jacobian product of
the same forward map with autograd (the map is linear, so the product is
``A^T y`` at any point, and autograd through the complex placement and
``irfft`` gives the real transpose). In the RL loop one autograd pass
returns ``A(est)`` and the function that applies ``A^T``, so no
iteration runs the forward map twice; ``rescan_fusion`` stacks its views
into one operator, so that pass serves every view at once (the eager ops
per iteration, not their size, set the time at small fields). An
operator's constants (the rotation's gather indices and weights, the
canvas's row matrix, column-phase kernels and placement phases) are
built once, when the operator is.

Nothing in the loops reads a value back to the host: the scale guard,
the normaliser and the extrapolation weight stay 0-d tensors. The JAX
package's ``fori_loop`` is a Python ``for`` here. The loops run on their
inputs' device; the acquisitions run the imaging engines, whose draws on
the card are kernel K2c (and whose scan method runs K1).
"""

from __future__ import annotations

import numpy as np
import torch

from rescan_line_sted_torch.algorithms.richardson_lucy import (
    richardson_lucy_views,
)
from rescan_line_sted_torch.device import as_sample, resolve
from rescan_line_sted_torch.imaging.analytic import _canvas_map
from rescan_line_sted_torch.imaging.rescan import rescanned_line_sted_image
from rescan_line_sted_torch.imaging.rescan_point import (
    rescan_point_system_kernel,
)
from rescan_line_sted_torch.parallel.mesh import gather_dtensors
from rescan_line_sted_torch.physics import models
from rescan_line_sted_torch.physics.noise import (
    derived_generators,
    maybe_poisson,
)
from rescan_line_sted_torch.utils.rotate import rotate_image, rotation_corners


_EPS = 1e-6        # RL's guard scale, the JAX package's default


class LinearOperator(tuple):
    """The ``(fwd, adj)`` pair of a linear map ``fwd`` on [H, W] images,
    ``adj`` its exact adjoint by autograd (also under ``torch.no_grad``).
    ``vjp(x)`` gives ``fwd(x)`` and the adjoint in one forward pass."""

    def __new__(cls, fwd, shape):
        def adj(y):
            return op.vjp(torch.zeros(shape, device=y.device))[1](y)

        op = super().__new__(cls, (fwd, adj))
        return op

    def vjp(self, x: torch.Tensor):
        """``(fwd(x), y -> A^T y)``; the adjoint function runs once."""
        with torch.enable_grad():
            x = x.detach().requires_grad_()
            out = self[0](x)

        def pull(y):
            return torch.autograd.grad(out, x, y)[0]

        return out.detach(), pull


def richardson_lucy_operator(
    data: list[torch.Tensor],
    operators: list[tuple],
    num_iter: int,
    init: torch.Tensor,
    eps: float = _EPS,
    accelerate: bool = False,
) -> torch.Tensor:
    """RL with per-view ``(forward, adjoint)`` linear-operator pairs.

    ``data[v]`` may live on any grid; ``operators[v] = (fwd, adj)`` maps
    the sample-grid estimate to that grid and back (a ``LinearOperator``
    gives both from one forward pass). ``init`` fixes the estimate's shape
    and device.

    ``accelerate=True`` applies each multiplicative update at a point
    extrapolated along the recent trajectory (Biggs-Andrews, Appl. Opt.
    36, 1766 (1997)), as ``richardson_lucy_views`` does, at one extra
    elementwise pass per iteration and no extra operator application.
    """
    tiny = eps * data[0].abs().mean().clamp_min(1e-30)
    return _operator_rl(data, operators, num_iter, init, tiny, eps,
                        accelerate)


def _operator_rl(data, operators, num_iter, init, tiny, eps, accelerate):
    """``richardson_lucy_operator``'s loop with the guard ``tiny`` given,
    so that one operator may stack several views."""
    norm = sum(adj(torch.ones_like(d)) for d, (_, adj) in zip(data, operators))
    norm = norm.clamp_min(eps)

    def apply(op, est):
        if isinstance(op, LinearOperator):
            return op.vjp(est)
        fwd, adj = op
        return fwd(est), adj

    def rl_update(est):
        acc = None
        for d, op in zip(data, operators):
            pred, adj = apply(op, est)
            ratio = torch.where(pred > tiny, d / torch.maximum(pred, tiny),
                                0.0)
            back = adj(ratio)
            acc = back if acc is None else acc + back
        return est * acc / norm

    if not accelerate:
        est = init
        for _ in range(num_iter):
            est = rl_update(est)
        return est

    x, x_prev, g_prev = init, init, torch.zeros_like(init)
    for _ in range(num_iter):
        g = x - x_prev
        num = (g * g_prev).sum()
        den = (g_prev * g_prev).sum().clamp_min(1e-30)
        alpha = (num / den).clamp(0.0, 0.999)
        y = torch.clamp_min(x + alpha * g, 0.0)
        x, x_prev, g_prev = rl_update(y), x, g
    return x


def _views_operator(canvas, geom, angles, device) -> LinearOperator:
    """The views at ``angles`` (numbers, or None for one unrotated view)
    stacked into one operator ``[H, W] -> [V, H/b, Wc]`` over a shared
    canvas map, so that one autograd pass serves every view. View v
    rotates by ``-angles[v]``: the four bilinear corners of every view are
    gathered at once, each weighted by ``w_y * w_x`` where its index lies
    in the grid and by 0 elsewhere (as ``rotate_image``'s zero fill), and
    summed in ``rotate_image``'s order; the gather's indices and weights
    are built here, once."""
    h, w = geom.grid.shape
    if angles is None:
        return LinearOperator(lambda est: canvas(est[None]), (h, w))
    _, corners = rotation_corners(h, w, [-float(a) for a in angles], device)
    index = torch.stack([c[0] for c in corners], dim=1).reshape(-1)
    weight = torch.stack([torch.where(c[2], c[1], 0.0) for c in corners],
                         dim=1)                               # [V, 4, H, W]

    def fwd(est):
        t = (weight * est.reshape(-1).gather(0, index).reshape(weight.shape)
             ).unbind(1)
        return canvas(((t[0] + t[1]) + t[2]) + t[3])

    return LinearOperator(fwd, (h, w))


def rescan_operator(geom, params, angle=None, device=None) -> LinearOperator:
    """``(forward, adjoint)`` of one rescanned line-STED view, built on
    ``device`` (None: the CUDA card, raising without one).

    forward: sample grid [H, W] -> canvas [H/b, round(R*W)/b], the exact
    acquisition mean for any R and binning; adjoint: its exact transpose
    (autograd). ``angle`` (radians, a number) composes a scan-axis
    rotation: the view scans along direction ``angle``.
    """
    dev = resolve(device)
    views = _views_operator(_canvas_map(params, geom, dev), geom,
                            None if angle is None else [angle], dev)
    return LinearOperator(lambda est: views[0](est)[0], geom.grid.shape)


@gather_dtensors
def multi_orientation_rescan(
    sample,
    params,
    geom,
    angles,
    generator: torch.Generator | None = None,
    method: str = "analytic",
    device=None,
) -> torch.Tensor:
    """Acquire rescanned line-STED canvases [V, H/b, R*W/b], one per angle
    of ``angles`` [V] (radians).

    The convention of ``imaging/orientations.py``: view v scans along
    direction ``angles[v]`` (the sample rotated by -angle and acquired
    with the x-scan engine); canvases stay in each view's scan frame, and
    the fusion operators fold the rotation back. ``sample`` is taken as
    ``rescanned_line_sted_image`` takes it (None ``device``: the CUDA
    card). The analytic method rotates and acquires all views at once and
    draws them in one call (K2c once on the card). The scan method runs
    ``rescanned_line_sted_image(method="scan")`` with its defaults view
    after view (K1 per view, then collapsed draws: K2c per view), each
    view with its own generator seeded from ``generator``. Noisy views
    agree with the JAX package's in distribution only.
    """
    sample = as_sample(sample, geom.grid.shape, device)
    angles = torch.as_tensor(angles, dtype=torch.float32, device="cpu")
    rotated = rotate_image(sample, -angles)                       # [V, H, W]
    if method == "analytic":
        models.line_model(params)       # raises on a JAX package model
        return maybe_poisson(generator,
                             _canvas_map(params, geom, sample.device)(rotated))
    if method != "scan":
        raise ValueError(f"unknown method {method!r}")
    gens = ([None] * len(rotated) if generator is None
            else derived_generators(generator, (len(rotated),)))
    return torch.stack([
        rescanned_line_sted_image(s, params, geom, g, method="scan",
                                  device=sample.device).image
        for s, g in zip(rotated, gens)])


@gather_dtensors
def rescan_fusion(
    canvases: torch.Tensor,
    params,
    geom,
    angles,
    num_iter: int,
    init: torch.Tensor | None = None,
    accelerate: bool = False,
) -> torch.Tensor:
    """Fuse multi-orientation rescanned canvases [V, H/b, Wc] into a
    sample-grid estimate [H, W], on the canvases' device.

    ``angles`` are numbers (they parameterise the per-view operators);
    ``accelerate`` turns on Biggs-Andrews extrapolation
    (``richardson_lucy_operator``). ``init`` defaults to the level that
    undoes the binning and the rescan stretch of the canvases' mean.
    """
    dev = canvases.device
    views = _views_operator(_canvas_map(params, geom, dev), geom, angles, dev)
    if init is None:
        # each canvas pixel sums binning^2 camera pixels spread over R*W/b
        # columns; undo both to land near the sample's mean intensity
        bright = max(np.float32(params.brightness), np.float32(1e-30))
        init = (canvases.mean() * float(geom.rescan_factor)
                / (np.float32(geom.binning ** 2) * bright)).expand(
                    geom.grid.shape).clone()
    # one stacked operator; the guard from the first view, as per view
    tiny = _EPS * canvases[0].abs().mean().clamp_min(1e-30)
    return _operator_rl([canvases], [views], num_iter, init, tiny, _EPS,
                        accelerate)


def ism_deconvolve(
    canvas: torch.Tensor,
    params,
    geom,
    num_iter: int = 30,
    accelerate: bool = False,
) -> torch.Tensor:
    """Deconvolve a rescanned point-STED (ISM) canvas with its system
    kernel, on the canvas's device.

    The canvas is exactly ``conv(place_2d(sample, R), H)`` with the
    nonnegative reassigned kernel ``H = rescan_point_system_kernel``, so
    canvas-grid RL applies and is stable. Returns the deconvolved
    canvas-grid estimate (the R-magnified image). ``params``:
    ``PointSTEDParams``; ``geom``: ``RescanPointGeometry`` (binning 1).
    """
    kern = rescan_point_system_kernel(geom, params, canvas.device)
    # RL's update is stationary at a sum(psf)-scaled estimate: deconvolve
    # with H / S and undo the S afterwards to keep absolute intensities
    s = kern.sum().clamp_min(1e-30)
    est = richardson_lucy_views(canvas[None], (kern / s)[None], num_iter,
                                accelerate=accelerate)
    return est / s

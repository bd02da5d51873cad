"""Instrument calibration by autodiff through the acquisition model (port
of the JAX package's ``algorithms/calibration.py``).

The noise-free engines take 0-d float32 tensors in any float field of
their params (``config.py``), so the acquisition forward model is
differentiable in the physics: PSF widths, depletion saturation and
brightness are fitted to measured data by gradient descent on the mean
squared error, with Adam on a softplus parameterisation.

``optax.adam`` becomes ``torch.optim.Adam`` with optax's defaults (betas
0.9 / 0.999, eps 1e-8 added after the square root, as torch adds it),
``jax.value_and_grad`` autograd, and the ``lax.scan`` over steps a Python
loop that reads nothing back to the host: the losses are collected in a
tensor on the data's device. A forward that carries no gradient to a
fitted field (a CUDA kernel without a backward, as on the per-step scan
routes, a noisy draw, or a field the model never reads) raises
``ValueError`` before the first step, where the JAX fit would step on a
zero gradient.
"""

from __future__ import annotations

import numpy as np
import torch

from rescan_line_sted_torch.config import (
    LineSTEDGeometry,
    LineSTEDParams,
    PointSTEDGeometry,
    PointSTEDParams,
)
from rescan_line_sted_torch.device import as_sample, host_table, resolve
from rescan_line_sted_torch.imaging.line_sted import line_sted_image
from rescan_line_sted_torch.imaging.point_sted import point_sted_image


def _as_data(data) -> torch.Tensor:
    """``data`` as float32: a tensor on its own device, anything else on
    the CUDA card (``device.resolve``)."""
    if isinstance(data, torch.Tensor):
        return data.to(torch.float32)
    return torch.as_tensor(np.asarray(data, np.float32), device=resolve(None))


def _initial(value, device) -> torch.Tensor:
    """A field's starting value as a 0-d float32 tensor on ``device``; a
    number goes through a pinned host table, so nothing syncs."""
    if isinstance(value, torch.Tensor):
        return value.detach().to(device, torch.float32)
    return host_table(np.float32(value), device)


def fit_acquisition_params(
    forward,
    data,
    init_params,
    fit_fields: tuple[str, ...],
    num_steps: int = 300,
    learning_rate: float = 5e-2,
):
    """Fit selected physics parameters of ANY acquisition forward model.

    ``forward(params) -> predicted image`` must compute with torch ops on
    the params' fields (every noise-free engine in ``imaging/``
    qualifies, the analytic rescan / ISM canvas means included). Fitted
    fields are kept positive via softplus; the rest stay at
    ``init_params``. The fitted fields live on ``data``'s device. Returns
    ``(fitted_params, losses [num_steps])``: the fitted fields as 0-d
    tensors and the loss of each step, taken before its update, on that
    device.
    """
    data = _as_data(data)
    dev = data.device
    theta = {}
    for f in fit_fields:
        v = _initial(getattr(init_params, f), dev)
        # softplus^{-1}, so the optimisation is unconstrained
        theta[f] = torch.log(torch.expm1(torch.clamp_min(v, 1e-4))) \
            .requires_grad_()

    def to_params():
        return init_params.replace(
            **{f: torch.nn.functional.softplus(t) for f, t in theta.items()})

    opt = torch.optim.Adam(list(theta.values()), lr=learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    losses = torch.empty(num_steps, dtype=torch.float32, device=dev)
    with torch.enable_grad():
        for i in range(num_steps):
            opt.zero_grad(set_to_none=True)
            loss = torch.mean(torch.square(forward(to_params()) - data))
            if i == 0 and not loss.requires_grad:
                raise ValueError(
                    f"the forward carries no gradient to {list(theta)}: "
                    "fit a noise-free forward built from torch ops")
            loss.backward()
            if i == 0:
                for f, t in theta.items():
                    if t.grad is None:
                        raise ValueError(
                            f"the forward carries no gradient to {f!r}")
            opt.step()
            losses[i] = loss.detach()
    with torch.no_grad():
        return to_params(), losses


def fit_line_sted_params(
    data,
    sample,
    init_params: LineSTEDParams,
    geom: LineSTEDGeometry,
    fit_fields: tuple[str, ...] = ("sigma_det", "depletion"),
    num_steps: int = 300,
    learning_rate: float = 5e-2,
) -> tuple[LineSTEDParams, torch.Tensor]:
    """Fit line-STED physics to a measured descanned image of ``sample``
    (the noise-free analytic engine, on ``data``'s device)."""
    data = _as_data(data)
    sample = as_sample(sample, geom.grid.shape, data.device)
    return fit_acquisition_params(
        lambda p: line_sted_image(sample, p, geom, device=data.device).image,
        data, init_params, fit_fields, num_steps, learning_rate)


def fit_point_sted_params(
    data,
    sample,
    init_params: PointSTEDParams,
    geom: PointSTEDGeometry,
    fit_fields: tuple[str, ...] = ("sigma_det", "depletion"),
    num_steps: int = 300,
    learning_rate: float = 5e-2,
) -> tuple[PointSTEDParams, torch.Tensor]:
    """Fit point-STED physics to a measured descanned image of ``sample``
    (the noise-free analytic engine, on ``data``'s device)."""
    data = _as_data(data)
    sample = as_sample(sample, geom.grid.shape, data.device)
    return fit_acquisition_params(
        lambda p: point_sted_image(sample, p, geom, device=data.device).image,
        data, init_params, fit_fields, num_steps, learning_rate)

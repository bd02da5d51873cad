"""Gradient-based MAP deconvolution (port of the JAX package's
``algorithms/map_deconv.py``).

An alternative to Richardson-Lucy for multi-view fusion: maximise the
Poisson log-likelihood of the views under the linear forward model, with
optional total-variation regularisation, by gradient descent on a
softplus-parameterised estimate:

    loss = sum_v sum_pixels [ A_v(est) - data_v * log A_v(est) ]
           + tv_weight * TV(est)

``optax.adam`` becomes ``torch.optim.Adam`` with optax's defaults (betas
0.9 / 0.999, eps 1e-8 added after the square root, as torch adds it),
``jax.value_and_grad`` autograd and the ``lax.scan`` over steps a Python
loop that reads nothing back: the losses are collected in a tensor. The
JAX package wraps the per-view model in ``jax.checkpoint`` to keep memory
flat for many views; at these sizes (a few [V, H, W] spectra per step)
the port needs no counterpart. It runs on its inputs' device.
"""

from __future__ import annotations

import torch

from rescan_line_sted_torch.kernels import fftconv


def _total_variation(img: torch.Tensor) -> torch.Tensor:
    dy = torch.diff(img, dim=-2)
    dx = torch.diff(img, dim=-1)
    return torch.sqrt(dy[..., :, :-1] ** 2 + dx[..., :-1, :] ** 2
                      + 1e-12).sum()


def map_deconvolve_views(
    data: torch.Tensor,
    psfs: torch.Tensor,
    num_steps: int = 200,
    learning_rate: float = 5e-2,
    tv_weight: float = 0.0,
    eps: float = 1e-6,
    init: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """MAP fusion of views [V, H, W] with centred per-view PSFs [V, H, W].

    Returns ``(estimate [H, W], losses [num_steps])``, the loss of each
    step taken before its update. Positivity via the parameterisation
    ``scale * softplus(theta)``; Adam.
    """
    otfs = fftconv.kernel_to_otf(psfs)
    shape = tuple(data.shape[-2:])
    scale = data.mean().clamp_min(eps)

    def unconstrained(theta):
        return scale * torch.nn.functional.softplus(theta)

    def loss_fn(theta):
        est = unconstrained(theta)
        pred = torch.maximum(fftconv.convolve_otf(est[None], otfs, shape),
                             eps * scale)
        nll = (pred - data * torch.log(pred)).sum()
        if tv_weight:
            nll = nll + tv_weight * _total_variation(est)
        return nll

    if init is None:
        theta = torch.zeros(shape, dtype=data.dtype, device=data.device)
    else:
        theta = torch.log(torch.expm1((init / scale).clamp_min(1e-6)))
    theta = theta.detach().requires_grad_()
    opt = torch.optim.Adam([theta], lr=learning_rate, betas=(0.9, 0.999),
                           eps=1e-8)
    losses = torch.empty(num_steps, dtype=data.dtype, device=data.device)
    with torch.enable_grad():
        for i in range(num_steps):
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(theta)
            loss.backward()
            opt.step()
            losses[i] = loss.detach()
    return unconstrained(theta).detach(), losses

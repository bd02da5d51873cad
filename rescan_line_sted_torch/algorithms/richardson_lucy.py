"""Richardson-Lucy deconvolution (port of the JAX package's
``algorithms/richardson_lucy.py``).

Multi-view fusion of acquisitions ``data_v = est (*) psf_v``:

    est <- est * (1/N) * sum_v [ (data_v / (est (*) psf_v)) (*) flip(psf_v) ]

The view axis is a batched leading dimension, so each half-step is ONE
batched ``torch.fft`` round trip over all views; the OTFs are built once
per call and the back-projection ``(*) flip(psf)`` is a spectral
conjugate (``fftconv.correlate_otf``). The JAX package's ``fori_loop`` is
a Python ``for`` here. Nothing in the loop reads a value back to the
host: the scale guard and the extrapolation weight stay 0-d tensors, so
on the card the loop queues its work without a sync. It runs on its
inputs' device.
"""

from __future__ import annotations

import torch

from rescan_line_sted_torch.kernels import fftconv
from rescan_line_sted_torch.parallel.mesh import gather_dtensors


@gather_dtensors
def richardson_lucy_views(
    data: torch.Tensor,
    psfs: torch.Tensor,
    num_iter: int,
    eps: float = 1e-6,
    init: torch.Tensor | None = None,
    accelerate: bool = False,
) -> torch.Tensor:
    """Multi-view RL fusion.

    ``data``: [V, H, W] acquired views; ``psfs``: [V, H, W] centred
    per-view system kernels (each view is modelled as ``est (*) psf_v``).
    Returns the fused estimate [H, W]; ``init`` defaults to the mean of
    ``data`` everywhere.

    ``accelerate=True`` applies each multiplicative update at a point
    extrapolated along the recent trajectory (Biggs-Andrews, Appl. Opt.
    36, 1766 (1997)), at the same one batched FFT round trip per
    iteration.
    """
    otfs = fftconv.kernel_to_otf(psfs)                  # [V, H, W//2+1]
    shape = tuple(data.shape[-2:])
    if init is None:
        init = data.mean().expand(shape).clone()
    # Scale-aware guard: where the forward model is ~0 (e.g. empty
    # background with a point sample) the ratio is pinned to 0 instead of
    # data/eps, which keeps the f32 iteration from blowing up to NaN.
    tiny = eps * data.abs().mean().clamp_min(1e-30)

    def rl_update(est):
        fwd = fftconv.convolve_otf(est[None], otfs, shape)       # [V, H, W]
        ratio = torch.where(fwd > tiny, data / torch.maximum(fwd, tiny), 0.0)
        back = fftconv.correlate_otf(ratio, otfs, shape)         # [V, H, W]
        return est * back.mean(0)

    if not accelerate:
        est = init
        for _ in range(num_iter):
            est = rl_update(est)
        return est

    x, x_prev, g_prev = init, init, torch.zeros_like(init)
    for _ in range(num_iter):
        # extrapolation weight from successive update directions
        g = x - x_prev
        num = (g * g_prev).sum()
        den = (g_prev * g_prev).sum().clamp_min(1e-30)
        alpha = (num / den).clamp(0.0, 0.999)
        y = torch.clamp_min(x + alpha * g, 0.0)
        x, x_prev, g_prev = rl_update(y), x, g
    return x


def richardson_lucy(
    data: torch.Tensor,
    psf: torch.Tensor,
    num_iter: int,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Single-view RL deconvolution of ``data`` [H, W] with a centred
    PSF."""
    return richardson_lucy_views(data[None], psf[None], num_iter, eps)

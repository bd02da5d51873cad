"""Per-scan-position camera frames (port of the JAX package's
``imaging/frames.py``).

The raw camera image at chosen scan positions (illuminate -> emit -> blur
-> shot noise, before any detection integration), for figures and
animations, with the scan engines' per-step math: the frame of position
``p`` is what kernel K4 bins and places for ``p``.
"""

from __future__ import annotations

import torch

from rescan_line_sted_torch.device import as_sample
from rescan_line_sted_torch.imaging.shifts import (
    shifted_images,
    shifted_profiles,
)
from rescan_line_sted_torch.kernels import fftconv
from rescan_line_sted_torch.physics import models
from rescan_line_sted_torch.physics import psf as psfs
from rescan_line_sted_torch.physics.noise import maybe_poisson


def line_sted_camera_frames(sample, params, geom, positions,
                            generator: torch.Generator | None = None,
                            device=None) -> torch.Tensor:
    """Camera frames [C, H, W] at the given column scan positions [C].
    ``sample`` goes to ``device`` as in the engines (None: the CUDA card);
    ``generator`` draws shot noise (K2c on the card), None = noise-free."""
    h, w = geom.grid.shape
    sample = as_sample(sample, (h, w), device)
    dev = sample.device
    eff = models.effective_line_profile(w, params, dev)
    otf_y = fftconv.profile_to_otf1d(
        psfs.detection_profile(h, params.sigma_det, dev))
    otf_x = fftconv.profile_to_otf1d(
        psfs.detection_profile(w, params.sigma_det, dev))
    sample_y = fftconv.convolve_otf1d(sample, otf_y, axis=-2, n=h)
    ill = shifted_profiles(eff, torch.as_tensor(positions, device=dev))
    mean = params.brightness * fftconv.convolve_otf1d(
        ill[:, None, :] * sample_y[None], otf_x, axis=-1, n=w)
    return maybe_poisson(generator, mean)


def point_sted_camera_frames(sample, params, geom, positions_yx,
                             generator: torch.Generator | None = None,
                             device=None) -> torch.Tensor:
    """Camera frames [C, H, W] at the given (y, x) scan positions [C, 2]."""
    shape = geom.grid.shape
    sample = as_sample(sample, shape, device)
    dev = sample.device
    eff = models.effective_point_psf(shape, params, dev)
    det_otf = fftconv.kernel_to_otf(
        psfs.detection_psf(shape, params.sigma_det, dev))
    ill = shifted_images(eff, torch.as_tensor(positions_yx, device=dev))
    mean = params.brightness * fftconv.convolve_otf(ill * sample, det_otf)
    return maybe_poisson(generator, mean)

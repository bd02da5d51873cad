"""Measurements and deconvolution: resolution metrics, Fourier Ring
Correlation and Richardson-Lucy.

Not ported yet (ROADMAP.md queue 1): ``richardson_lucy_operator``,
``rescan_operator``, ``multi_orientation_rescan``, ``rescan_fusion`` and
``ism_deconvolve`` (slice F); ``map_deconvolve_views`` and the
``fit_*`` calibration (slice I).
"""

from rescan_line_sted_torch.algorithms.frc import frc_curve, frc_resolution
from rescan_line_sted_torch.algorithms.metrics import (
    fwhm_1d,
    fwhm_2d,
    system_resolution_report,
)
from rescan_line_sted_torch.algorithms.richardson_lucy import (
    richardson_lucy,
    richardson_lucy_views,
)

__all__ = ["frc_curve", "frc_resolution", "fwhm_1d", "fwhm_2d",
           "richardson_lucy", "richardson_lucy_views",
           "system_resolution_report"]

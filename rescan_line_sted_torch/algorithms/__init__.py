"""Measurements: resolution metrics and Fourier Ring Correlation.

Not ported yet (ROADMAP.md queue 1): ``richardson_lucy`` and
``richardson_lucy_views`` (slice E); ``richardson_lucy_operator``,
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

__all__ = ["frc_curve", "frc_resolution", "fwhm_1d", "fwhm_2d",
           "system_resolution_report"]

"""Measurements and deconvolution: resolution metrics, Fourier Ring
Correlation, Richardson-Lucy (per view and in operator form), rescanned
view fusion, MAP deconvolution and instrument calibration.
"""

from rescan_line_sted_torch.algorithms.calibration import (
    fit_acquisition_params,
    fit_line_sted_params,
    fit_point_sted_params,
)
from rescan_line_sted_torch.algorithms.frc import frc_curve, frc_resolution
from rescan_line_sted_torch.algorithms.fusion import (
    ism_deconvolve,
    multi_orientation_rescan,
    rescan_fusion,
    rescan_operator,
    richardson_lucy_operator,
)
from rescan_line_sted_torch.algorithms.map_deconv import map_deconvolve_views
from rescan_line_sted_torch.algorithms.metrics import (
    fwhm_1d,
    fwhm_2d,
    system_resolution_report,
)
from rescan_line_sted_torch.algorithms.richardson_lucy import (
    richardson_lucy,
    richardson_lucy_views,
)

__all__ = ["fit_acquisition_params", "fit_line_sted_params",
           "fit_point_sted_params", "frc_curve", "frc_resolution",
           "fwhm_1d", "fwhm_2d",
           "ism_deconvolve", "map_deconvolve_views",
           "multi_orientation_rescan", "rescan_fusion", "rescan_operator",
           "richardson_lucy", "richardson_lucy_operator",
           "richardson_lucy_views", "system_resolution_report"]

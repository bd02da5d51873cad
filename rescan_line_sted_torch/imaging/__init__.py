"""Imaging engines: descanned point- and line-STED, rescanned line-STED and
rescanned point-STED (ISM), with the JAX package's public names.
"""

from rescan_line_sted_torch.imaging.analytic import (
    line_system_kernel,
    point_system_kernel,
    rescan_canvas_mean,
    rescan_system_kernel,
    rescan_x_kernels_rfft,
)
from rescan_line_sted_torch.imaging.boundary import (
    acquire_padded,
    apodize_sample,
)
from rescan_line_sted_torch.imaging.frames import (
    line_sted_camera_frames,
    point_sted_camera_frames,
)
from rescan_line_sted_torch.imaging.line_sted import line_sted_image
from rescan_line_sted_torch.imaging.point_sted import point_sted_image
from rescan_line_sted_torch.imaging.rescan import (
    optimal_rescan_factor,
    practical_rescan_factor,
    rescan_kernel_sigma,
    rescanned_line_sted_image,
)
from rescan_line_sted_torch.imaging.rescan_point import (
    optimal_rescan_factor_point,
    practical_rescan_factor_point,
    rescan_point_canvas_mean,
    rescan_point_system_kernel,
    rescanned_point_sted_image,
)

__all__ = ["acquire_padded", "apodize_sample", "line_sted_camera_frames",
           "line_sted_image", "line_system_kernel", "optimal_rescan_factor",
           "optimal_rescan_factor_point", "point_sted_camera_frames",
           "point_sted_image", "point_system_kernel",
           "practical_rescan_factor", "practical_rescan_factor_point",
           "rescan_canvas_mean", "rescan_kernel_sigma",
           "rescan_point_canvas_mean", "rescan_point_system_kernel",
           "rescan_system_kernel",
           "rescan_x_kernels_rfft", "rescanned_line_sted_image",
           "rescanned_point_sted_image"]

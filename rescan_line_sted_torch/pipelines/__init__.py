"""Figure-equivalent pipelines, the scan animation and the HTML report."""

from rescan_line_sted_torch.pipelines.figures import (
    comparison_pipeline,
    dose_sweep_pipeline,
    fov_pipeline,
    fusion_pipeline,
    ism_pipeline,
    rescan_pipeline,
)
from rescan_line_sted_torch.pipelines.animation import line_scan_animation
from rescan_line_sted_torch.pipelines.report import html_report

__all__ = ["comparison_pipeline", "dose_sweep_pipeline", "fov_pipeline",
           "fusion_pipeline", "html_report", "ism_pipeline",
           "line_scan_animation", "rescan_pipeline"]

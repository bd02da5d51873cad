"""Rescanned point-STED (ISM) in five lines, plus deconvolution::

    python -m rescan_line_sted_torch.examples.ism [--platform cpu]

The 2D-pixel-reassignment modality (imaging/rescan_point.py, beyond the
reference's line-rescan): acquire a magnified canvas with the closed-form
engine, then sharpen it further with system-kernel RL.
"""

import torch

import rescan_line_sted_torch as rls
from rescan_line_sted_torch.algorithms import ism_deconvolve
from rescan_line_sted_torch.data import samples
from rescan_line_sted_torch.examples import device_from_args
from rescan_line_sted_torch.imaging import (
    optimal_rescan_factor_point,
    practical_rescan_factor_point,
    rescanned_point_sted_image,
)


def main(argv=None):
    dev = device_from_args(argv, __doc__)
    size = 128
    sample = samples.siemens_star((size, size), device=dev)
    params = rls.PointSTEDParams.create(depletion=8.0, brightness=200.0)

    r_opt = float(optimal_rescan_factor_point(params, size))
    r_prac = float(practical_rescan_factor_point(params, size))
    print(f"theory-optimal rescan factor: {r_opt:.2f}; practical "
          f"(within 5% of optimal resolution): {r_prac:.2f}")

    geom = rls.RescanPointGeometry(rls.Grid(size, size),
                                   rescan_factor=round(r_prac, 2))
    res = rescanned_point_sted_image(sample, params, geom,
                                     torch.Generator(dev).manual_seed(0),
                                     device=dev)
    canvas = res.image.cpu().numpy()
    print(f"canvas {canvas.shape}, total photons {canvas.sum():.0f}, "
          f"scan steps {float(res.dose.num_steps):.0f}")

    est = ism_deconvolve(res.image, params, geom, num_iter=50).cpu().numpy()
    # energy concentration (peak/total) rises as RL sharpens the canvas;
    # report the ratio so the number is readable at any canvas size
    sharpen = (est.max() / est.sum()) / (canvas.max() / canvas.sum())
    print(f"RL deconvolution concentrates the canvas {sharpen:.1f}x "
          f"(peak/total {est.max() / est.sum():.2e} vs raw "
          f"{canvas.max() / canvas.sum():.2e})")


if __name__ == "__main__":
    main()

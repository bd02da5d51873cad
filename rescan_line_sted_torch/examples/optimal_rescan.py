"""Simulate at the theory-optimal (generally fractional) rescan factor::

    python -m rescan_line_sted_torch.examples.optimal_rescan [--platform cpu]

The rescan theory gives the sharpest canvas at R = 1 + sigma_det^2 /
sigma_ill_eff^2, which is almost never an integer. The analytic engine
simulates ANY R exactly (band-limited subpixel placement); this example
computes R*, the PRACTICAL recommendation (smallest R within 5% of the
optimal resolution -- the variance curve is very flat, so this is usually
severalfold smaller), and compares both against the naive R=2.
"""

import torch

import rescan_line_sted_torch as rls
from rescan_line_sted_torch.algorithms.metrics import fwhm_2d
from rescan_line_sted_torch.data import samples
from rescan_line_sted_torch.examples import device_from_args
from rescan_line_sted_torch.imaging import rescanned_line_sted_image
from rescan_line_sted_torch.imaging.analytic import rescan_system_kernel
from rescan_line_sted_torch.imaging.rescan import (
    optimal_rescan_factor,
    practical_rescan_factor,
)


def main(argv=None):
    dev = device_from_args(argv, __doc__)
    size = 256
    params = rls.RescanParams.create(depletion=4.0, brightness=200.0)
    r_opt = float(optimal_rescan_factor(params, size))
    r_prac = float(practical_rescan_factor(params, size))
    print(f"theory-optimal rescan factor R* = {r_opt:.3f}; "
          f"practical (within 5% of optimal resolution) R = {r_prac:.3f}")

    sample = samples.siemens_star((size, size), device=dev)
    for r in (2.0, round(r_prac, 3), round(r_opt, 3)):
        geom = rls.RescanGeometry(rls.Grid(size, size), rescan_factor=r)
        canvas = rescanned_line_sted_image(
            sample, params, geom, torch.Generator(dev).manual_seed(0),
            device=dev).image
        fy, fx = fwhm_2d(rescan_system_kernel(geom, params, device=dev))
        # canvas x is magnified by R: report sample-scale resolution
        print(f"R = {r:5.3f}: canvas {tuple(canvas.shape)}, "
              f"kernel FWHM x = {float(fx) / r:.2f} px (sample scale), "
              f"y = {float(fy):.2f} px, "
              f"photons = {float(canvas.sum()):.3e}")


if __name__ == "__main__":
    main()

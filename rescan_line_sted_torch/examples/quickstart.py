"""Quickstart: simulate, compare, fuse::

    python -m rescan_line_sted_torch.examples.quickstart [--platform cpu]

Each noisy call draws from a generator seeded with 0, as the JAX example
draws every call with one key.
"""

import math

import numpy as np
import torch

import rescan_line_sted_torch as rls
from rescan_line_sted_torch.algorithms import (
    richardson_lucy_views,
    system_resolution_report,
)
from rescan_line_sted_torch.data import siemens_star
from rescan_line_sted_torch.examples import device_from_args
from rescan_line_sted_torch.imaging import (
    line_sted_image,
    point_sted_image,
    rescanned_line_sted_image,
)
from rescan_line_sted_torch.imaging.orientations import (
    multi_orientation_line_sted,
)
from rescan_line_sted_torch.sweeps import dose_matched_sweep


def main(argv=None):
    dev = device_from_args(argv, __doc__)
    size = 256
    grid = rls.Grid(size, size)
    sample = siemens_star((size, size), device=dev)

    def gen():
        return torch.Generator(dev).manual_seed(0)

    # --- 1. one acquisition per modality, shot noise included -----------
    point = point_sted_image(
        sample, rls.PointSTEDParams.create(depletion=8.0, brightness=200.0),
        rls.PointSTEDGeometry(grid), gen(), device=dev)
    line = line_sted_image(
        sample, rls.LineSTEDParams.create(depletion=8.0, brightness=200.0),
        rls.LineSTEDGeometry(grid), gen(), device=dev)
    rescan = rescanned_line_sted_image(
        sample, rls.RescanParams.create(depletion=8.0, brightness=200.0),
        rls.RescanGeometry(grid, rescan_factor=2.0), gen(), device=dev)
    print(f"point {tuple(point.image.shape)} | line "
          f"{tuple(line.image.shape)} | rescan canvas "
          f"{tuple(rescan.image.shape)}")
    print(f"line-STED needs {int(line.dose.num_steps)} scan steps vs "
          f"{int(point.dose.num_steps)} for point-STED")

    # --- 2. resolution vs depletion power --------------------------------
    for s in (0.0, 4.0, 16.0):
        rep = system_resolution_report(
            (size, size), rls.PointSTEDParams.create(depletion=s),
            device=dev)
        print(f"s={s:5.1f}: point-STED FWHM = {float(rep.fwhm_x):.2f} px")

    # --- 3. the dose-matched comparison sweep ----------------------------
    sweep = dose_matched_sweep(
        sample,
        rls.PointSTEDParams.create(brightness=1.0),
        rls.LineSTEDParams.create(brightness=1.0),
        rls.PointSTEDGeometry(grid), rls.LineSTEDGeometry(grid),
        torch.linspace(0.0, 16.0, 8), dose_budget=100.0, generator=gen(),
        orientations=2, device=dev)
    print("sweep FWHM(point):",
          np.round(sweep.point.fwhm_x.cpu().numpy(), 2))
    print("sweep FWHM(line): ",
          np.round(sweep.line.fwhm_x.cpu().numpy(), 2))

    # --- 4. multi-orientation fusion to isotropic resolution -------------
    params = rls.LineSTEDParams.create(depletion=8.0, brightness=200.0)
    views, kernels = multi_orientation_line_sted(
        sample, params, rls.LineSTEDGeometry(grid),
        torch.tensor([0.0, math.pi / 2]), gen(), device=dev)
    fused = richardson_lucy_views(views, kernels, num_iter=50)
    print(f"fused image: {tuple(fused.shape)}, total signal "
          f"{float(fused.sum()):.3e}")
    print("done.")


if __name__ == "__main__":
    main()

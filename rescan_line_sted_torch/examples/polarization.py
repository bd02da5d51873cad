"""Polarization alignment physics through the pluggable model seam::

    python -m rescan_line_sted_torch.examples.polarization [--platform cpu]

Swapping the illumination model is a one-argument change; this example
shows why real STED systems interlock the quarter-wave plate with the
vortex phase mask (point) and use s-polarized interference (line):
misaligned polarization fills the depletion null and caps resolution.
"""

import math

import rescan_line_sted_torch as rls
from rescan_line_sted_torch.algorithms.metrics import fwhm_2d
from rescan_line_sted_torch.examples import device_from_args
from rescan_line_sted_torch.imaging.analytic import (
    line_system_kernel,
    point_system_kernel,
)
from rescan_line_sted_torch.physics import (
    InterferenceStripeModel,
    VectorialDonutModel,
)


def main(argv=None):
    dev = device_from_args(argv, __doc__)
    size = 128
    shape = (size, size)
    c = size // 2

    print("point STED, Richards-Wolf vectorial donut (NA 0.9, charge 1):")
    for pol in ("circular+", "circular-", "linear-x"):
        model = VectorialDonutModel(na=0.9, polarization=pol)
        p = rls.PointSTEDParams.create(depletion=16.0, model=model)
        null = float(model.depletion(shape, p, dev)[c, c])
        fy, fx = (float(v) for v in fwhm_2d(point_system_kernel(shape, p,
                                                                 dev)))
        # fwhm_2d returns NaN on contract violation: with the null 75%
        # filled, s=16 depletes the CENTER below the surrounding ring --
        # there is no on-axis peak left to measure. That is the physics,
        # not a bug.
        res = f"system FWHM {fx:.2f} px" if math.isfinite(fx) \
            else "no on-axis peak left (depletion self-defeats)"
        print(f"  {pol:10s}: on-axis null {null:8.2e}   {res}")

    print("line STED, two-beam interference stripe (wavelength 4 px):")
    for pol in ("s", "p"):
        model = InterferenceStripeModel(polarization=pol, wavelength_px=4.0)
        p = rls.LineSTEDParams.create(depletion=16.0, stripe_period=8.0,
                                      model=model)
        null = float(model.depletion(size, p, dev)[c])
        fy, fx = (float(v) for v in fwhm_2d(line_system_kernel(shape, p,
                                                                dev)))
        print(f"  {pol:10s}: null fill {null:8.2e}   cross-line FWHM "
              f"{fx:.2f} px")

    print("(co-handed circular / s-pol preserve the null; everything else "
          "trades resolution for nothing)")


if __name__ == "__main__":
    main()

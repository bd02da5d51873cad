"""Physics: PSF profiles, illumination models, dose, shot noise, with the
JAX package's public names."""

from rescan_line_sted_torch.physics.dose import (
    DoseReport,
    line_sted_dose,
    point_sted_dose,
)
from rescan_line_sted_torch.physics.models import (
    EnvelopedStripeModel,
    GaussianDonutModel,
    GaussianStripeModel,
    InterferenceStripeModel,
    PupilDonutModel,
    VectorialDonutModel,
)
from rescan_line_sted_torch.physics.noise import poisson_counts
from rescan_line_sted_torch.physics.psf import (
    detection_psf,
    donut_psf,
    effective_psf,
    gaussian_psf,
    line_excitation_profile,
    pinhole_mask,
    slit_profile,
    stripe_depletion_profile,
)

__all__ = ["DoseReport", "EnvelopedStripeModel", "GaussianDonutModel",
           "GaussianStripeModel", "InterferenceStripeModel",
           "PupilDonutModel", "VectorialDonutModel", "detection_psf",
           "donut_psf", "effective_psf", "gaussian_psf",
           "line_excitation_profile", "line_sted_dose", "pinhole_mask",
           "point_sted_dose", "poisson_counts", "slit_profile",
           "stripe_depletion_profile"]

"""Hopper kernels (K1-K6), their plain PyTorch versions, and the torch.fft
convolution helpers, with the JAX package's public names
(``poisson_pallas`` is the flat sampler K2c, ``poisson_flat``)."""

from rescan_line_sted_torch.kernels.fftconv import (
    convolve_otf,
    correlate_otf,
    fft_convolve,
    fft_correlate,
    kernel_to_otf,
)
from rescan_line_sted_torch.kernels.poisson import (
    poisson_flat,
    poisson_rows_tiered,
)
from rescan_line_sted_torch.kernels.rescan_accumulate import (
    rescan_accumulate,
    rescan_accumulate_reference,
)
from rescan_line_sted_torch.kernels.rescan_fused import rescan_fused

poisson_pallas = poisson_flat

__all__ = ["convolve_otf", "correlate_otf", "fft_convolve", "fft_correlate",
           "kernel_to_otf", "poisson_flat", "poisson_pallas",
           "poisson_rows_tiered", "rescan_accumulate",
           "rescan_accumulate_reference", "rescan_fused"]

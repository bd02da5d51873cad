"""Poisson shot noise (port of ``rescan_line_sted_tpu.physics.noise``).

Sums of independent Poisson variables are Poisson in the summed mean, so a
detection pipeline that only adds raw camera pixels may sample once from
the accumulated noise-free mean. A ``torch.Generator`` takes the place of
the JAX package's PRNG key; ``None`` means noise-free.
"""

from __future__ import annotations

import torch

from rescan_line_sted_torch.device import read_back
from rescan_line_sted_torch.kernels.poisson import poisson_flat
from rescan_line_sted_torch.utils.observability import span


@span("rls.k2c")
def poisson_counts(generator: torch.Generator,
                   mean: torch.Tensor) -> torch.Tensor:
    """Sample detected photon counts (float32). A CUDA ``mean`` runs the
    flat sampler kernel (K2c), a CPU ``mean`` its plain version; both clamp
    the mean at 0 and propagate NaN."""
    return poisson_flat(mean.contiguous(), generator)


def maybe_poisson(generator: torch.Generator | None,
                  mean: torch.Tensor) -> torch.Tensor:
    """Noise-free passthrough when ``generator is None``."""
    if generator is None:
        return mean
    return poisson_counts(generator, mean)


def derived_generators(generator: torch.Generator, shape: tuple):
    """Independent generators in nested lists of ``shape``, on
    ``generator``'s device, each seeded from one table of seeds drawn
    from ``generator`` (``torch.randint`` on its device; a CUDA
    generator's table is read back once). Stands for the JAX package's
    ``jax.random.split`` and ``fold_in``: a given generator state gives the
    same generators."""
    seeds = read_back(torch.randint(0, 2**62, tuple(shape),
                                    generator=generator,
                                    device=generator.device,
                                    dtype=torch.int64))

    def make(s):
        if isinstance(s, list):
            return [make(t) for t in s]
        return torch.Generator(generator.device).manual_seed(s)

    return make(seeds)

"""Port parity: the dose sweep's figure pipeline at its padded cases of
``tests/test_pipelines.py`` (48^2): the fused sweep with an open boundary
and the ISM arm, each against the JAX pipeline as
``tests/test_torch_sweep_pipeline.py`` holds its other cases."""

import pytest
import torch

from test_torch_sweep_pipeline import check_case

torch.set_num_threads(1)


@pytest.mark.parametrize("case", ["fused_padded", "ism_padded"])
def test_dose_sweep_pipeline_matches_jax(case, tmp_path):
    check_case(case, tmp_path)

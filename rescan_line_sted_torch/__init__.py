"""PyTorch + CUDA port of the line-STED simulation engine: descanned point-
and line-STED, rescanned line-STED and rescanned point-STED (ISM).

The JAX package ``rescan_line_sted_tpu`` beside this one is the reference.
This package imports torch and numpy only. Its hot path runs hand-written
CUDA kernels for Hopper (``csrc/``, built with nvcc at first use) on CUDA
tensors and their plain PyTorch versions on CPU tensors.

The port computes in float32 throughout: TF32 (a 10-bit mantissa) would
miss the engine's 1e-5 parity bar, so it is switched off here.
"""

import time

_T0 = time.perf_counter()   # the package's own import, timed to its end

import torch  # noqa: E402

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from rescan_line_sted_torch.config import (  # noqa: E402
    Grid,
    LineSTEDGeometry,
    LineSTEDParams,
    PointSTEDGeometry,
    PointSTEDParams,
    RescanGeometry,
    RescanParams,
    RescanPointGeometry,
)
from rescan_line_sted_torch.imaging import (  # noqa: E402
    line_sted_image,
    point_sted_image,
    rescanned_line_sted_image,
    rescanned_point_sted_image,
)
from rescan_line_sted_torch.utils.observability import SETUP  # noqa: E402

__all__ = ["Grid", "LineSTEDGeometry", "LineSTEDParams", "PointSTEDGeometry",
           "PointSTEDParams", "RescanGeometry", "RescanParams",
           "RescanPointGeometry", "line_sted_image", "point_sted_image",
           "rescanned_line_sted_image", "rescanned_point_sted_image"]

SETUP["import_s"] = time.perf_counter() - _T0

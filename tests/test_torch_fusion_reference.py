"""BASELINE config 5's rescanned fusion on the port against the float64
plain reference of the benchmark (``benchmark/reference/fusion_image.py``)
at a small field: the four views' canvases and their fused image, the
reference's stacked operator against its own transpose, and the port's
rotation against the exact bilinear rotation at 2048^2, where float32
rotation coordinates miss it by 1.5e-4 of the image's maximum."""

import dataclasses
import gc
import json
import math
import weakref
from pathlib import Path

import pytest
import torch

from benchmark import compare, samples
from benchmark.reference import fusion_image, plain, report_sweep
from rescan_line_sted_torch import Grid, LineSTEDParams, RescanGeometry
from rescan_line_sted_torch.algorithms import (
    fusion,
    multi_orientation_rescan,
    rescan_fusion,
)
from rescan_line_sted_torch.utils import rotate_image

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
# the benchmark's configuration (four views at R = 2, brightness 200) at a
# CPU test's field and a few iterations
CONFIG = dict(json.loads(
    (REPO / "benchmark" / "configs" / "fusion_rescan_2048.json").read_text()),
    field=[48, 48], fusion_iters=6)


@dataclasses.dataclass
class Case:
    sample: torch.Tensor
    canvases: torch.Tensor
    fused: torch.Tensor


def _port(sample, config) -> Case:
    params = LineSTEDParams.create(depletion=config["depletion"],
                                   **config["line"])
    geom = RescanGeometry(Grid(*config["field"]), **config["rescan"])
    v = config["orientations"]
    angles = tuple(u * math.pi / v for u in range(v))
    canvases = multi_orientation_rescan(
        sample, params, geom, torch.tensor(angles, dtype=torch.float32),
        device="cpu")
    return Case(sample, canvases, rescan_fusion(
        canvases, params, geom, angles, config["fusion_iters"]))


def _sample(kind):
    shape = tuple(CONFIG["field"])
    if kind == "star":
        return samples.siemens_star(shape, "cpu")
    return torch.rand(shape, generator=torch.Generator().manual_seed(3))


@pytest.mark.parametrize("kind", ["star", "uniform"])
def test_fusion_is_the_reference(kind):
    """The noise-free canvases (each view) and the fused image within 1e-5
    of the reference's: largest gap over the largest value."""
    got = _port(_sample(kind), CONFIG)
    ref = fusion_image.Fusion(got.sample, CONFIG)
    mean = ref.canvases()
    assert got.canvases.shape == mean.shape == (4, 48, 96)
    for view, want in zip(got.canvases, mean):
        assert compare.rel_err(view, want) < 1e-5
    assert compare.rel_err(got.fused, ref.restore(mean)) < 1e-5


def test_fusion_of_noisy_canvases_is_the_references():
    """The port's fusion of drawn canvases against the reference's fusion
    of the same canvases."""
    sample = _sample("star")
    ref = fusion_image.Fusion(sample, CONFIG)
    counts = torch.poisson(ref.canvases(),
                           generator=torch.Generator().manual_seed(4))
    params = LineSTEDParams.create(depletion=CONFIG["depletion"],
                                   **CONFIG["line"])
    geom = RescanGeometry(Grid(*CONFIG["field"]), **CONFIG["rescan"])
    angles = tuple(u * math.pi / 4 for u in range(4))
    got = rescan_fusion(counts.float(), params, geom, angles,
                        CONFIG["fusion_iters"])
    assert compare.rel_err(got, ref.restore(counts)) < 1e-5


def test_reference_operator_is_its_own_transpose():
    """The reference's stacked four-view operator ``A x = [canvas(R_v
    x)]_v`` against ``A^T y = sum_v R_v^T canvas^T(y_v)``: ``<A x, y> =
    <x, A^T y>`` to 1e-12 on a 20 x 24 field, where corners leave the
    grid."""
    config = dict(CONFIG, field=[20, 24])
    gen = torch.Generator().manual_seed(5)
    x = torch.rand(20, 24, generator=gen, dtype=torch.float64)
    ref = fusion_image.Fusion(x, config)
    y = torch.rand(4, 20, ref.canvas.wc, generator=gen, dtype=torch.float64)
    ax = ref.canvas(torch.stack([rot(x) for rot in ref.views]))
    aty = sum(rot.T(b) for rot, b in zip(ref.views, ref.canvas.T(y)))
    lhs, rhs = float((ax * y).sum()), float((x * aty).sum())
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


def test_rotation_at_2048_is_exact():
    """The port's rotation by pi / 4 of the 2048^2 Siemens star within
    1e-6 of the maximum of the float64 bilinear rotation (float32 source
    coordinates read 1.5e-4 here)."""
    sample = samples.siemens_star((2048, 2048), "cpu")
    want = report_sweep.Rotation(2048, 2048, math.pi / 4, "cpu",
                                 plain.Precision("float64"))(sample)
    got = rotate_image(sample, math.pi / 4)
    assert got.dtype == torch.float32
    assert compare.rel_err(got, want) < 1e-6


def test_operator_is_freed_without_the_cycle_collector():
    """A fusion operator and its rotation gather go with their last
    reference: no reference cycle holds them until a garbage collection
    (at 2048^2 each fused call would otherwise leave ~0.8 GB behind)."""
    params = LineSTEDParams.create(depletion=8.0, brightness=200.0)
    geom = RescanGeometry(Grid(32, 32), rescan_factor=2.0)
    canvas = fusion._canvas_map(params, geom, "cpu")
    gc.disable()
    try:
        op = fusion._views_operator(canvas, geom, [0.0, 0.7], "cpu")
        pred, pull = op.vjp(torch.rand(32, 32))
        assert pull(torch.ones_like(pred)).shape == (32, 32)
        assert op[1](torch.ones_like(pred)).shape == (32, 32)
        alive = weakref.ref(op[0])
        del op, pull
        assert alive() is None
    finally:
        gc.enable()

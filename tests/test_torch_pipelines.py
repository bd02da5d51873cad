"""Port parity: the figure pipelines and the scan animation
(``rescan_line_sted_torch.pipelines``) against the JAX package's, on the
CPU at the sizes of ``tests/test_pipelines.py`` (48^2); the dose sweep's
pipeline is in ``tests/test_torch_sweep_pipeline.py``.

Each pipeline runs in the port (``device="cpu"``) and in the JAX package
with the same arguments (the JAX runs cached within the file). The
noise-free metrics agree within 1e-5 relative. Both write the same
artifact file names and shapes; a noise-free TIFF (the sample) agrees
within 1e-5, and each noisy TIFF's total agrees with the JAX one's within 5
sigma of their Poisson difference (``|a - b| <= 5 sqrt(a + b)``). Also:
the panels without matplotlib and the animation without Pillow.
"""

import functools
import math
import os
import sys

import numpy as np
import pytest
import torch

from rescan_line_sted_torch.io import tif_to_array
from rescan_line_sted_torch.pipelines import (
    comparison_pipeline,
    dose_sweep_pipeline,
    fov_pipeline,
    fusion_pipeline,
    ism_pipeline,
    line_scan_animation,
    rescan_pipeline,
)
from rescan_line_sted_tpu import pipelines as J

torch.set_num_threads(1)
TOL = 1e-5
_ROOT = {}


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module", autouse=True)
def _root(tmp_path_factory):
    _ROOT["dir"] = tmp_path_factory.mktemp("pipelines")


@functools.lru_cache(maxsize=None)
def _jax(name: str):
    """The JAX pipeline ``name`` run once into its own directory:
    ``(out_dir, metrics)``."""
    out = str(_ROOT["dir"] / f"jax_{name}")
    return out, getattr(J, name)(out, **CASES[name])


CASES = {
    "comparison_pipeline": dict(size=48, dose_budget=50.0),
    "fusion_pipeline": dict(size=48, num_angles=2, rl_iters=10),
    "rescan_pipeline": dict(size=48),
    "ism_pipeline": dict(size=48, depletion=4.0),
    "fov_pipeline": dict(sizes=(48, 96), rl_iters=10),
}


def _port(fn, out, **kwargs):
    return fn(str(out), device="cpu", **kwargs)


def _files(d) -> set:
    return {f for f in os.listdir(d) if f != "sweep_ckpt"}


def _same_artifacts(got_dir, want_dir, noise_free=("sample",)):
    """Same file names; every TIFF of the same shape, the noise-free ones
    within TOL, the noisy ones' totals within 5 sigma."""
    assert _files(got_dir) == _files(want_dir)
    for name in _files(want_dir):
        if not name.endswith(".tif"):
            continue
        got = tif_to_array(os.path.join(got_dir, name))
        want = tif_to_array(os.path.join(want_dir, name))
        assert got.shape == want.shape and got.dtype == want.dtype, name
        assert np.isfinite(got).all(), name
        if name.rsplit("_", 1)[-1][:-4] in noise_free:
            assert rel(got, want) <= TOL, name
        else:
            a, b = float(got.sum(dtype=np.float64)), float(
                want.sum(dtype=np.float64))
            assert abs(a - b) <= 5 * math.sqrt(max(a + b, 1.0)), (name, a, b)


def _metrics_agree(got: dict, want: dict, noisy=()):
    assert set(got) == set(want)
    for k, v in want.items():
        if k in noisy:
            continue
        if isinstance(v, float):
            assert rel(got[k], v) <= TOL, k
        else:
            assert got[k] == v, k


def test_comparison_pipeline_matches_jax(tmp_path):
    want_dir, want = _jax("comparison_pipeline")
    got = _port(comparison_pipeline, tmp_path, **CASES["comparison_pipeline"])
    _metrics_agree(got, want)
    assert got["line_steps"] < got["point_steps"]
    _same_artifacts(tmp_path, want_dir)
    assert os.path.exists(tmp_path / "comparison.png")


@pytest.mark.parametrize("modality", ["descan", "rescan"])
def test_fusion_pipeline_matches_jax(tmp_path, modality):
    kwargs = dict(CASES["fusion_pipeline"], modality=modality)
    want_dir = str(_ROOT["dir"] / f"jax_fusion_{modality}")
    want = J.fusion_pipeline(want_dir, **kwargs)
    got = _port(fusion_pipeline, tmp_path, **kwargs)
    _metrics_agree(got, want)
    assert got["view_kernel_fwhm_x"] < got["view_kernel_fwhm_y"]
    _same_artifacts(tmp_path, want_dir)
    fused = tif_to_array(str(tmp_path / "fusion_fused_rl.tif"))
    assert fused.shape == (48, 48) and np.isfinite(fused).all()


def test_rescan_pipeline_matches_jax(tmp_path):
    want_dir, want = _jax("rescan_pipeline")
    got = _port(rescan_pipeline, tmp_path, **CASES["rescan_pipeline"])
    _metrics_agree(got, want, noisy=("descan_sum", "rescan_sum"))
    assert got["canvas_shape"] == [48, 96]
    for k in ("descan_sum", "rescan_sum"):
        a, b = got[k], want[k]
        assert abs(a - b) <= 5 * math.sqrt(a + b), k
    _same_artifacts(tmp_path, want_dir)


def test_ism_pipeline_matches_jax(tmp_path):
    want_dir, want = _jax("ism_pipeline")
    got = _port(ism_pipeline, tmp_path, **CASES["ism_pipeline"])
    _metrics_agree(got, want)
    assert got["canvas_shape"] == [96, 96]
    assert got["ism_sted_fwhm_sample_px"] < got["ism_confocal_fwhm_sample_px"]
    _same_artifacts(tmp_path, want_dir)


def test_fov_pipeline_matches_jax(tmp_path):
    """The records' noise-free columns (the view kernel's FWHMs, scan
    steps) within TOL; the fused FWHMs come from noisy views: finite and
    under the view kernel's wide axis, as the JAX test holds them."""
    want_dir, want = _jax("fov_pipeline")
    got = _port(fov_pipeline, tmp_path, **CASES["fov_pipeline"])
    assert _files(tmp_path) == _files(want_dir)
    assert len(got["records"]) == len(want["records"]) == 2
    for g, w in zip(got["records"], want["records"]):
        assert set(g) == set(w)
        assert g["fov"] == w["fov"] and g["scan_steps"] == w["scan_steps"]
        for k in ("view_kernel_fwhm_y", "view_kernel_fwhm_x"):
            assert rel(g[k], w[k]) <= TOL, k
        assert math.isfinite(g["fused_fwhm_x"])
        assert g["fused_fwhm_y"] < g["view_kernel_fwhm_y"]
        assert g["wall_s"] > 0 and g["compile_s"] > 0


def test_panels_without_matplotlib(tmp_path, monkeypatch):
    """Without matplotlib the pipelines write their TIFFs, npz files and
    metrics and skip the PNGs, as the JAX package does."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    comparison_pipeline(str(tmp_path), size=32, dose_budget=50.0,
                        device="cpu")
    dose_sweep_pipeline(str(tmp_path), size=32, num_powers=2, chunk=2,
                        fuse_orientations=False, device="cpu")
    files = _files(tmp_path)
    assert not any(f.endswith(".png") for f in files)
    assert {"comparison_point_sted.tif", "dose_sweep_curves.npz",
            "dose_sweep_images_line_smax.tif", "metrics.jsonl"} <= files


def test_line_scan_animation_matches_jax(tmp_path):
    from PIL import Image

    got = line_scan_animation(str(tmp_path / "port"), size=48, num_frames=6,
                              device="cpu")
    want = J.line_scan_animation(str(tmp_path / "jax"), size=48,
                                 num_frames=6)
    assert got["frames"] == want["frames"] == 6
    assert os.path.basename(got["path"]) == os.path.basename(want["path"])
    with Image.open(got["path"]) as im, Image.open(want["path"]) as jm:
        assert im.n_frames == jm.n_frames == 6
        assert im.size == jm.size == (48 * 2 + 4, 48)


def test_line_scan_animation_without_pillow(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    got = line_scan_animation(str(tmp_path), size=48, num_frames=6,
                              device="cpu")
    assert got["path"].endswith("line_scan_animation.gif.npz")
    frames = np.load(got["path"])["frames"]
    assert frames.shape == (6, 48, 48 * 2 + 4, 3) and frames.dtype == np.uint8
    assert frames[-1].any()


def test_pipelines_refuse_to_run_off_the_card_quietly():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        comparison_pipeline("unused", size=32)

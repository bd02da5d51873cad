"""Port parity: the dose sweep's figure pipeline
(``rescan_line_sted_torch.pipelines.dose_sweep_pipeline``) against the JAX
package's, on the CPU at the cases of ``tests/test_pipelines.py`` (48^2).

Each case runs in the port (``device="cpu"``) and in the JAX package with
the same arguments. The metrics and every curve of the npz agree within
1e-5 relative: the FWHMs of the fused sweeps' RL-restored responses are
columns that ``tests/test_torch_sweep.py`` holds at 1e-5 too. The images'
files and shapes match, their totals within 5 sigma (as in
``tests/test_torch_pipelines.py``, whose helpers this file uses). Also:
resuming gives identical metrics and runs no sweep, a partial resume
redraws a chunk bit for bit, a stale checkpoint raises, the ragged last
chunk; the padded fused sweep and the ISM arm run in
``tests/test_torch_sweep_pipeline_padded.py``.
"""

import os

import numpy as np
import pytest
import torch

from rescan_line_sted_torch.io import tif_to_array
from rescan_line_sted_torch.pipelines import dose_sweep_pipeline
from rescan_line_sted_torch.pipelines import figures as port_figures
from rescan_line_sted_tpu.pipelines import (
    dose_sweep_pipeline as jax_dose_sweep_pipeline,
)
from test_torch_pipelines import (
    TOL,
    _metrics_agree,
    _port,
    _same_artifacts,
    rel,
)

torch.set_num_threads(1)
SWEEP = dict(size=48, num_powers=4, chunk=2, dose_budget=50.0)
# the cases of tests/test_pipelines.py
SWEEPS = {
    "fused": SWEEP,
    "ragged": dict(size=48, num_powers=3, chunk=2, max_power=8.0,
                   dose_budget=50.0),
    "fused_padded": dict(size=48, num_powers=2, chunk=2, max_power=8.0,
                         dose_budget=50.0, orientations=2,
                         fuse_orientations=True, fusion_iters=15,
                         boundary="padded"),
    "ism_padded": dict(size=48, num_powers=4, chunk=2, dose_budget=50.0,
                       include_ism=True, boundary="padded"),
}
_ROOT = {}


@pytest.fixture(scope="module", autouse=True)
def _root(tmp_path_factory):
    _ROOT["dir"] = tmp_path_factory.mktemp("sweep_pipeline")


_PORT = {}


def _port_sweep(case):
    """The port's run of ``case`` (the parity test's, when it ran)."""
    if case not in _PORT:
        out = _ROOT["dir"] / f"port_{case}"
        _PORT[case] = out, _port(dose_sweep_pipeline, out, **SWEEPS[case])
    return _PORT[case]


def check_case(case, root):
    """Metrics and every curve of the npz, noise-free, within TOL; the
    images' files and shapes (cropped back to the requested field where
    padded, ISM on the R-magnified grid) and their totals. The two runs go
    under ``root``."""
    want_dir = str(root / f"jax_{case}")
    want = jax_dose_sweep_pipeline(want_dir, **SWEEPS[case])
    got_dir = root / f"port_{case}"
    got = _port(dose_sweep_pipeline, got_dir, **SWEEPS[case])
    _metrics_agree(got, want)
    _same_artifacts(got_dir, want_dir)
    cw = np.load(os.path.join(want_dir, "dose_sweep_curves.npz"))
    cg = np.load(got_dir / "dose_sweep_curves.npz")
    assert set(cg.files) == set(cw.files)
    for k in cw.files:
        assert cg[k].shape == (SWEEPS[case]["num_powers"],)
        assert rel(cg[k], cw[k]) <= TOL, k
    if case == "ism_padded":
        assert tif_to_array(
            str(got_dir / "dose_sweep_images_ism_smax.tif")).shape == (96, 96)
    if case == "fused_padded":
        np.testing.assert_allclose(got["line_fwhm_y_at_smax"],
                                   got["line_fwhm_x_at_smax"], rtol=0.05)
    return got_dir, got


# the padded cases run in tests/test_torch_sweep_pipeline_padded.py
@pytest.mark.parametrize("case", ["fused", "ragged"])
def test_dose_sweep_pipeline_matches_jax(case):
    _PORT[case] = check_case(case, _ROOT["dir"])


def test_dose_sweep_pipeline_resumes_without_running(monkeypatch):
    """Every chunk on disk: the rerun runs no sweep (the shapes come from
    the files) and gives identical metrics."""
    out, first = _port_sweep("fused")

    def refuse(*args, **kwargs):
        raise AssertionError("a resume must not run the sweep")

    monkeypatch.setattr(port_figures, "dose_matched_sweep", refuse)
    again = _port(dose_sweep_pipeline, out, **SWEEPS["fused"])
    assert again == first
    np.testing.assert_allclose(first["line_to_point_step_ratio"], 2.0 / 48,
                               rtol=1e-6)


def test_dose_sweep_pipeline_partial_resume_redraws_the_chunk(tmp_path):
    """With chunk 1 deleted the rerun draws it again from its own
    generator: its noisy images come back bit for bit."""
    _port(dose_sweep_pipeline, tmp_path, **SWEEPS["fused"])
    smax = tmp_path / "dose_sweep_images_line_smax.tif"
    before = smax.read_bytes()
    os.remove(tmp_path / "sweep_ckpt" / "chunk_00001.npz")
    _port(dose_sweep_pipeline, tmp_path, **SWEEPS["fused"])
    assert smax.read_bytes() == before
    assert port_figures.derived_generator(0, 1, "cpu").initial_seed() != \
        port_figures.derived_generator(0, 0, "cpu").initial_seed() != \
        port_figures.derived_generator(1, 0, "cpu").initial_seed()


def test_dose_sweep_pipeline_rejects_stale_checkpoints(tmp_path):
    kwargs = dict(size=48, num_powers=2, chunk=2, dose_budget=50.0,
                  fuse_orientations=False)
    _port(dose_sweep_pipeline, tmp_path, **kwargs)
    with pytest.raises(ValueError, match="different sweep settings"):
        _port(dose_sweep_pipeline, tmp_path, **{**kwargs, "dose_budget": 60.0})

"""Port parity: the command line (``python -m rescan_line_sted_torch``) and
the HTML report (``pipelines/report.py``) against the JAX package's, on
the CPU.

The CLI prints strict JSON (no NaN / Infinity) that agrees with the JAX
CLI's numbers within 1e-5 relative (the vectorial donut's on-axis nulls,
fractions of its unit peak, within 1e-5 of that peak); ``--multihost``
exits naming the roadmap's slice J; the CLI runs in a subprocess whose
``jax`` and ``rescan_line_sted_tpu`` imports are blocked. The report
has the JAX report's structure (one data URI per frame, three sliders, the
``wire(`` script), with matplotlib and without it (then its own PNG
encoder and an SVG chart).
"""

import base64
import io
import json
import os
import subprocess
import sys
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

from rescan_line_sted_torch.cli import _json_safe
from rescan_line_sted_torch.cli import main as cli_main
from rescan_line_sted_torch.io import tif_to_array
from rescan_line_sted_torch.pipelines import html_report
from rescan_line_sted_torch.pipelines.report import MAGMA, png_bytes
from rescan_line_sted_tpu.cli import main as jax_cli_main
from rescan_line_sted_tpu.pipelines import html_report as jax_html_report

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
REPORT = dict(size=48, num_powers=2, num_angles=2, rl_iters=5,
              scan_frames=3)
# JAX and its package made unimportable, then the port's CLI run as
# ``python -m rescan_line_sted_torch`` with the given arguments
BLOCKED = ("import runpy, sys\n"
           "for name in ('jax', 'jaxlib', 'flax', 'rescan_line_sted_tpu'):\n"
           "    sys.modules[name] = None\n"
           "sys.argv = ['rescan_line_sted_torch'] + sys.argv[1:]\n"
           "runpy.run_module('rescan_line_sted_torch', run_name='__main__')\n")


def strict_loads(s: str):
    def no_const(c):
        raise ValueError(f"non-RFC JSON constant in CLI output: {c}")
    return json.loads(s, parse_constant=no_const)


def _last_json(capsys):
    return strict_loads(capsys.readouterr().out.strip().splitlines()[-1])


def _agree(got: dict, want: dict):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, str) or v is None:
            assert got[k] == v, k
        elif k.endswith("_null"):   # a fraction of the donut's unit peak
            assert abs(got[k] - v) <= TOL * max(abs(v), 1.0), k
        else:
            assert abs(got[k] - v) <= TOL * abs(v), (k, got[k], v)


def test_cli_figure_comparison_matches_jax(tmp_path, capsys):
    args = ["figure", "comparison", "--size", "48", "--dose-budget", "50"]
    cli_main(["--platform", "cpu", *args, "--out", str(tmp_path / "p")])
    got = _last_json(capsys)
    jax_cli_main([*args, "--out", str(tmp_path / "j")])
    want = _last_json(capsys)
    assert got["pipeline"] == "comparison"
    _agree(got, want)
    assert tif_to_array(str(tmp_path / "p" / "comparison_point_sted.tif")
                        ).shape == (48, 48)
    assert sorted(os.listdir(tmp_path / "p")) == sorted(
        os.listdir(tmp_path / "j"))


def test_cli_psf_report_matches_jax(capsys):
    args = ["psf-report", "--size", "64", "--depletion", "8", "--vectorial"]
    cli_main(["--platform", "cpu", *args])
    got = _last_json(capsys)
    jax_cli_main(args)
    want = _last_json(capsys)
    _agree(got, want)
    assert got["point_fwhm_x"] < got["line_fwhm_y"]
    assert got["vectorial_circular_co_null"] < 1e-4 \
        < got["vectorial_circular_counter_null"]
    assert got["vectorial_circular_co_fwhm_x"] \
        < got["vectorial_circular_counter_fwhm_x"]


def test_cli_json_safe_maps_nonfinite_to_null():
    src = {"a": float("nan"), "b": float("inf"), "c": 1.5,
           "t": torch.tensor(float("nan")),
           "nested": [np.float32("nan"), np.float64(2.0), "7", 3, True,
                      None]}
    got = _json_safe(src)
    assert got["a"] is None and got["b"] is None and got["c"] == 1.5
    assert got["t"] is None and got["nested"][0] is None
    assert got["nested"][1:] == [2.0, "7", 3, True, None]
    strict_loads(json.dumps(got))


def test_cli_multihost_waits_for_slice_j(monkeypatch, capsys, caplog):
    """Slice J has landed: ``--multihost`` joins the launcher's ranks
    (``parallel.initialize_multihost``) and logs ``process r/n``; with no
    launcher's environment it is the JAX CLI's no-op, ``process 0/1``,
    and the report is the single-process one."""
    from rescan_line_sted_torch.parallel import is_initialized

    for var in ("RANK", "WORLD_SIZE", "SLURM_PROCID", "SLURM_NTASKS"):
        monkeypatch.delenv(var, raising=False)
    cli_main(["--platform", "cpu", "psf-report", "--size", "32"])
    single = strict_loads(capsys.readouterr().out.strip().splitlines()[-1])
    with caplog.at_level("INFO"):
        cli_main(["--multihost", "--platform", "cpu", "psf-report",
                  "--size", "32"])
    multi = strict_loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "multihost: process 0/1" in caplog.text
    assert multi == single and not is_initialized()


def test_cli_boundary_only_for_the_sweep(tmp_path):
    with pytest.raises(SystemExit, match="only wired into the 'sweep'"):
        cli_main(["--platform", "cpu", "figure", "comparison", "--boundary",
                  "padded", "--out", str(tmp_path)])


def test_cli_needs_a_card_unless_told(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["psf-report", "--size", "32"])


# a launcher's variables (``parallel.multihost._cluster_env``, ``_backend``,
# ``LOCAL_RANK``): inherited, ``--multihost`` would wait to join a world
CLUSTER_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                "MASTER_ADDR", "MASTER_PORT", "SLURM_PROCID", "SLURM_NTASKS")


def _blocked(*args, timeout=300):
    """The port's CLI in a child with JAX blocked. Its environment is this
    process's less the launcher's variables, with one OpenMP thread, so
    the child neither joins a world nor oversubscribes a host busy with
    other test workers; a child that outlives ``timeout`` fails the test
    with its stderr."""
    env = {k: v for k, v in os.environ.items() if k not in CLUSTER_VARS}
    env["OMP_NUM_THREADS"] = "1"
    try:
        return subprocess.run([sys.executable, "-c", BLOCKED, *args],
                              cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=timeout)
    except subprocess.TimeoutExpired as e:
        err = e.stderr.decode() if isinstance(e.stderr, bytes) else e.stderr
        pytest.fail(f"the CLI {list(args)} ran over {timeout} s; its "
                    f"stderr:\n{(err or '')[-3000:]}")


def test_cli_runs_with_jax_blocked(tmp_path):
    out = _blocked("--platform", "cpu", "psf-report", "--vectorial")
    assert out.returncode == 0, out.stderr[-3000:]
    rep = strict_loads(out.stdout.strip().splitlines()[-1])
    assert rep["depletion"] == 8.0 and rep["point_fwhm_x"] > 0
    multi = _blocked("--platform", "cpu", "--multihost", "psf-report",
                     "--vectorial")
    assert multi.returncode == 0, multi.stderr[-3000:]
    assert "multihost: process 0/1" in multi.stderr
    assert strict_loads(multi.stdout.strip().splitlines()[-1]) == rep


def test_cli_figure_all_with_jax_blocked(tmp_path):
    """Every figure of ``figure all``, small, in one process without JAX:
    one strict JSON line per figure."""
    out = _blocked("--platform", "cpu", "figure", "all", "--size", "32",
                   "--num-powers", "2", "--rl-iters", "3", "--num-angles",
                   "2", "--fov-sizes", "32", "--out", str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [strict_loads(s) for s in out.stdout.strip().splitlines()]
    assert [m["pipeline"] for m in lines] == [
        "comparison", "dose_sweep", "fusion", "rescan", "ism", "fov",
        "animation", "html_report"]
    assert (tmp_path / "index.html").exists()


@pytest.fixture(scope="module")
def jax_report(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_report")
    return out, jax_html_report(str(out), **REPORT)


def test_html_report_matches_jax(tmp_path, jax_report):
    want_dir, want = jax_report
    got = html_report(str(tmp_path), device="cpu", **REPORT)
    assert {k: got[k] for k in ("pipeline", "figures", "frames")} == \
        {k: want[k] for k in ("pipeline", "figures", "frames")}
    html = (tmp_path / "index.html").read_text()
    jhtml = (want_dir / "index.html").read_text()
    assert html.count("data:image/png;base64,") == got["frames"] == \
        jhtml.count("data:image/png;base64,")
    for s in ('<input type="range"', "wire(", "fig1-slider", "<h2>"):
        assert html.count(s) == jhtml.count(s), s
    assert html.count('<input type="range"') == 3
    assert got["bytes"] > 10_000
    assert sorted(os.listdir(tmp_path)) == sorted(os.listdir(want_dir))


def _data_uris(html: str) -> list[tuple[str, bytes]]:
    out = []
    for part in html.split("data:image/")[1:]:
        kind, rest = part.split(";base64,", 1)
        out.append((kind, base64.b64decode(rest[:rest.index('"')])))
    return out


def test_html_report_without_matplotlib(tmp_path, monkeypatch):
    """One data URI per frame: PNGs from the port's encoder (each row's
    panels at one height: the 48-row panels brought up to the ISM canvas's
    96) and the curves as SVG polylines."""
    from PIL import Image

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    got = html_report(str(tmp_path), device="cpu", **REPORT)
    html = (tmp_path / "index.html").read_text()
    uris = _data_uris(html)
    assert len(uris) == got["frames"] == 2 + 3 + 2 + 1
    assert html.count('<input type="range"') == 3 and "wire(" in html
    kinds = [k for k, _ in uris]
    assert kinds == ["png"] * (got["frames"] - 1) + ["svg+xml"]
    sizes = [Image.open(io.BytesIO(b)).size for _, b in uris[:-1]]
    # fig1: point, line, rescan (48 -> 96) and ISM (96) with 8-px gaps
    assert sizes[:2] == [(4 * 96 + 3 * 8, 96)] * 2
    assert sizes[2:] == [(2 * 48 + 8, 48)] * 5
    svg = ET.fromstring(uris[-1][1])
    polylines = svg.findall("{http://www.w3.org/2000/svg}polyline")
    assert len(polylines) >= 6


def test_png_encoder_is_lossless():
    from PIL import Image

    rgb = np.random.default_rng(0).integers(0, 256, (7, 13, 3), np.uint8)
    back = np.asarray(Image.open(io.BytesIO(png_bytes(rgb))))
    np.testing.assert_array_equal(back, rgb)


def test_magma_table_is_matplotlibs():
    from matplotlib import cm

    lut = np.round(cm.magma(np.arange(256) / 255.0)[:, :3] * 255)
    np.testing.assert_array_equal(MAGMA, lut.astype(np.uint8))

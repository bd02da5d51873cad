"""Port parity: the observability utilities
(``rescan_line_sted_torch.utils.observability``), the cases of
``tests/test_observability.py`` on the port, and the metrics JSON against
the JAX package's ``json_safe``."""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from rescan_line_sted_torch.kernels import _build
from rescan_line_sted_torch.utils import enable_compilation_cache
from rescan_line_sted_torch.utils.observability import (
    BUILD_DIR_ENV,
    Timer,
    debug_mode,
    emit_metrics,
    json_safe,
    time_fn,
    trace,
)
from rescan_line_sted_tpu.utils.observability import (
    json_safe as jax_json_safe,
)

torch.set_num_threads(1)


def test_timer():
    with Timer() as t:
        _ = sum(range(1000))
    assert t.elapsed > 0


def test_time_fn_separates_first_call():
    x = torch.ones(64, 64)
    steady, first = time_fn(lambda a: (torch.sin(a) * 2, {"b": a}), x,
                            iters=3)
    assert steady > 0 and first > 0


def test_emit_metrics_jsonl_and_csv(tmp_path):
    path = str(tmp_path / "m.jsonl")
    emit_metrics({"a": 1, "b": 2.5}, path)
    emit_metrics({"a": 3, "b": torch.tensor(4.5)}, path)
    lines = [json.loads(line) for line in open(path)]
    assert lines[0]["a"] == 1 and lines[1]["b"] == 4.5

    csv_path = str(tmp_path / "m.csv")
    emit_metrics({"x": 1.0, "y": 2.0}, csv_path)
    emit_metrics({"x": 3.0, "y": 4.0}, csv_path)
    rows = open(csv_path).read().strip().splitlines()
    assert rows[0] == "x,y" and len(rows) == 3


def test_emit_metrics_jsonl_is_rfc_compliant(tmp_path):
    path = str(tmp_path / "metrics.jsonl")
    emit_metrics({"fwhm": float("nan"), "ok": 1.5,
                  "t": torch.tensor(float("inf"))}, path)
    [line] = open(path).read().splitlines()

    def no_const(c):
        raise AssertionError(f"non-RFC constant in metrics.jsonl: {c}")

    rec = json.loads(line, parse_constant=no_const)
    assert rec["fwhm"] is None and rec["ok"] == 1.5 and rec["t"] is None


def test_json_safe_matches_jax():
    """The JAX package's cases give the same JSON; 0-d tensors go through
    float() (NaN -> null), other tensors pass through untouched."""
    src = {"a": float("nan"), "b": float("inf"), "c": 1.5,
           "nested": [np.float32("nan"), np.float64(2.0), "7", 3, True,
                      None, (np.float32(0.25),)]}
    assert json.dumps(json_safe(src)) == json.dumps(jax_json_safe(src))
    got = json_safe({"t": torch.tensor(2.5), "n": torch.tensor(float("nan")),
                     "i": torch.tensor(3)})
    assert got == {"t": 2.5, "n": None, "i": 3.0}
    vec = torch.ones(3)
    assert json_safe(vec) is vec


def test_debug_mode_catches_nan():
    with debug_mode():
        with pytest.raises(FloatingPointError):
            torch.log(torch.tensor(-1.0))
        # finite work and uninitialized factories pass
        torch.log(torch.tensor(2.0))
        torch.empty(4)
    # restored afterwards
    assert torch.isnan(torch.log(torch.tensor(-1.0)))


def test_debug_mode_catches_nan_inside_the_port():
    """A NaN produced inside a port function is caught at the op that makes
    it (here RL on NaN data, the first division)."""
    from rescan_line_sted_torch.algorithms import richardson_lucy_views

    data = torch.ones(1, 8, 8)
    data[0, 3, 3] = float("nan")
    psfs = torch.zeros(1, 8, 8)
    psfs[0, 4, 4] = 1.0
    with debug_mode():
        with pytest.raises(FloatingPointError):
            richardson_lucy_views(data, psfs, num_iter=2)
    assert torch.isnan(richardson_lucy_views(data, psfs, num_iter=2)).any()


def test_trace_writes_profile(tmp_path):
    d = str(tmp_path / "prof")
    with trace(d):
        (torch.ones(128, 128) * 2).sum()
    found = []
    for _, _, files in os.walk(d):
        found += files
    assert found == ["trace.json"]
    events = json.load(open(os.path.join(d, "trace.json")))["traceEvents"]
    assert any("mul" in e.get("name", "") for e in events)


def test_enable_compilation_cache_paths(monkeypatch, tmp_path):
    """An explicit path, the default inside the project tree and the
    environment override, each set as the kernels' and the TIFF codec's
    build directory."""
    from rescan_line_sted_torch.io.native import loader

    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.delenv(BUILD_DIR_ENV, raising=False)
    p = enable_compilation_cache(str(tmp_path / "cache"))
    assert p == str(tmp_path / "cache")
    assert _build.BUILD_DIR == Path(p)
    assert _build.library_path().parent == Path(p)
    assert loader.library_path().parent == Path(p)
    # default lands inside the project tree, git-ignored
    default = enable_compilation_cache()
    assert Path(default) == _build.DEFAULT_BUILD_DIR == Path(
        __file__).resolve().parents[1] / "rescan_line_sted_torch" / "_build"
    assert _build.BUILD_DIR == _build.DEFAULT_BUILD_DIR
    # the environment wins over an explicit path; empty counts as unset
    monkeypatch.setenv(BUILD_DIR_ENV, str(tmp_path / "env"))
    assert enable_compilation_cache(str(tmp_path / "x")) == str(
        tmp_path / "env")
    assert _build.BUILD_DIR == tmp_path / "env"
    monkeypatch.setenv(BUILD_DIR_ENV, "")
    assert enable_compilation_cache() == str(_build.DEFAULT_BUILD_DIR)


# --- the port's spans and counters (``span``, ``SETUP``) ---------------------

# the innermost port span each span opens in, per path on the CPU (64 x 256:
# the banded route needs a field wider than K1's 128-column windows), in a
# steady call: the entry's plan, built by the first call, leaves no class
# check, host table or plan build to a later one
NESTING = {
    "per_step": {"rls.image": None, "rls.image.tables": "rls.image",
                 "rls.image.yconv": "rls.image",
                 "rls.image.finish": "rls.image"},
    "nufft": {"rls.image": None, "rls.image.tables": "rls.image",
              "rls.image.yconv": "rls.image",
              "rls.image.finish": "rls.image"},
    "analytic": {"rls.image": None, "rls.image.tables": "rls.image",
                 "rls.image.products": "rls.image",
                 "rls.image.fft_placement": "rls.image.products",
                 "rls.k2c": "rls.image"},
    "sweep": {"rls.sweep": None, "rls.sweep.generators": "rls.sweep",
              "rls.read_back": "rls.sweep.generators",
              "rls.sweep.ledgers": "rls.sweep",
              "rls.sweep.point": "rls.sweep",
              "rls.sweep.line": "rls.sweep",
              "rls.k2c": ("rls.sweep.point", "rls.sweep.line"),
              "rls.sweep.columns": "rls.sweep",
              "rls.host_table": "rls.sweep.columns"},
    # the report's four-arm fused sweep with FRC (two powers: the rescan
    # arm's two canvas plans stay cached, so a steady call builds none)
    "fused": {"rls.sweep": None, "rls.sweep.generators": "rls.sweep",
              "rls.read_back": "rls.sweep.generators",
              "rls.sweep.ledgers": "rls.sweep",
              "rls.sweep.point": "rls.sweep",
              "rls.sweep.line": "rls.sweep",
              "rls.sweep.ism": "rls.sweep",
              "rls.sweep.rescan": "rls.sweep",
              "rls.fusion.rl": ("rls.sweep.point", "rls.sweep.line",
                                "rls.sweep.ism"),
              "rls.fusion.acquire": "rls.sweep.rescan",
              "rls.fusion.operator": "rls.sweep.rescan",
              "rls.fusion.build": "rls.sweep.rescan",
              "rls.fusion.adjoint": "rls.fusion.operator",
              "rls.frc": ("rls.sweep.point", "rls.sweep.line",
                          "rls.sweep.ism", "rls.sweep.rescan"),
              "rls.k2c": ("rls.sweep.point", "rls.sweep.line",
                          "rls.sweep.ism", "rls.fusion.acquire"),
              "rls.image.tables": ("rls.sweep.rescan", "rls.fusion.acquire"),
              "rls.image.products": ("rls.fusion.acquire",
                                     "rls.fusion.operator"),
              "rls.image.fft_placement": "rls.image.products",
              "rls.sweep.columns": "rls.sweep",
              "rls.host_table": ("rls.sweep.line", "rls.sweep.ism",
                                 "rls.fusion.acquire", "rls.fusion.build",
                                 "rls.sweep.columns")},
}
# (read-backs, host tables) per call, from the code's sites: none in a
# steady rescan call (K1's classes are checked on the host and every table
# is in the entry's plan); the sweep's seed table, and three host columns
# per arm plus the powers and the budget. The fused sweep at B = 2 powers:
# the seed table; 3 host columns for each of its 4 arms plus the powers
# and the budget (14), and for each power 22 trig and phase tables: the
# line arm's 6 (two acquisitions, each rotating the sample, its views and
# its kernels), ISM's 10 (the detection phases of its canvas, of each of
# its two deconvolutions' kernels, of the point source's canvas and of its
# deconvolution's kernel, two each), the rescan arm's 3 acquisition
# rotations and the 3 rotations its operators build: 14 + 22 * 2 = 58
COUNTS = {"per_step": (0, 0), "nufft": (0, 0), "analytic": (0, 0),
          "sweep": (1, 8), "fused": (1, 58)}
# spans per fused sweep at B = 2 powers: for each power the rescan arm
# acquires and fuses three times (its two acquisitions and the point
# source's canvases), each through an operator that builds its rotation
# once and applies its adjoint once for the normaliser and once in each of
# the 2 iterations: 3 * 2 acquisitions and builds, 3 * 2 * 3 adjoints;
# each acquisition and each operator's forward (the normaliser's and one
# an iteration) places its canvas by an FFT (R = 2): 3 * 2 * (1 + 3);
# each of the 4 arms takes one FRC per power: 4 * 2
FUSED = {"rls.fusion.acquire": 3 * 2, "rls.fusion.build": 3 * 2,
         "rls.fusion.adjoint": 3 * 2 * 3,
         "rls.image.fft_placement": 3 * 2 * (1 + 3), "rls.frc": 4 * 2}


def _spanned_call(path):
    """A steady call of ``path`` on the CPU (after one call that fills the
    caches), as a function of no arguments."""
    from rescan_line_sted_torch import (
        Grid,
        LineSTEDGeometry,
        LineSTEDParams,
        PointSTEDGeometry,
        PointSTEDParams,
        RescanGeometry,
        rescanned_line_sted_image,
    )
    from rescan_line_sted_torch.config import RescanPointGeometry
    from rescan_line_sted_torch.sweeps import dose_matched_sweep

    line = LineSTEDParams.create(sigma_exc=3.0, sigma_det=3.0,
                                 stripe_period=12.0, depletion=8.0,
                                 slit_halfwidth=4.0, brightness=1.0)
    gen = torch.Generator().manual_seed(7)
    if path == "fused":
        grid = Grid(32, 32)
        sample = torch.rand(32, 32, generator=gen)

        def call():
            return dose_matched_sweep(
                sample, PointSTEDParams.create(brightness=1.0),
                LineSTEDParams.create(brightness=1.0),
                PointSTEDGeometry(grid), LineSTEDGeometry(grid), [0.0, 4.0],
                100.0, generator=gen, orientations=2,
                rescan_geom=RescanGeometry(grid, rescan_factor=2.0),
                fuse_orientations=True, fusion_iters=2,
                ism_geom=RescanPointGeometry(grid, rescan_factor=2.0),
                frc=True, device="cpu")
    elif path == "sweep":
        grid = Grid(64, 64)
        point = PointSTEDParams.create(sigma_exc=3.0, sigma_det=3.0,
                                       sigma_dep=3.0, pinhole_radius=4.0,
                                       brightness=1.0)
        sample = torch.rand(64, 64, generator=gen)

        def call():
            return dose_matched_sweep(
                sample, point, line, PointSTEDGeometry(grid),
                LineSTEDGeometry(grid), [0.0, 4.0], 100.0, generator=gen,
                device="cpu")
    else:
        rf = 1.0 + np.pi / 16 if path == "nufft" else 1.5
        geom = RescanGeometry(Grid(64, 256), rescan_factor=rf, chunk=32)
        method = "analytic" if path == "analytic" else "scan"
        sample = torch.rand(64, 256, generator=gen)

        def call():
            return rescanned_line_sted_image(
                sample, line, geom, generator=gen, method=method,
                noise_mode="collapsed" if method == "analytic"
                else "per_step", device="cpu")
    call()
    return call


def _port_spans(path):
    """Each port span of one profiled call: ``(name, innermost enclosing
    port span or None)``."""
    from torch.profiler import ProfilerActivity, profile

    call = _spanned_call(path)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    out = []
    for e in prof.events():
        if not e.name.startswith("rls."):
            continue
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith("rls."):
            parent = parent.cpu_parent
        out.append((e.name, None if parent is None else parent.name))
    return out


@pytest.mark.parametrize("form", ["context", "decorator"])
def test_span_records_nothing_with_the_profiler_off(form, monkeypatch):
    """With the profiler off a span neither enters ``record_function`` nor
    changes what its body returns."""
    from rescan_line_sted_torch.utils.observability import span

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    if form == "context":
        with span("rls.test") as s:
            got = 6 * 7
        assert s._record is None
    else:
        got = span("rls.test")(lambda a, b=0: a * b)(6, b=7)
    assert got == 42


@pytest.mark.parametrize("form", ["context", "decorator"])
def test_span_lands_in_the_profilers_trace(form):
    from torch.profiler import ProfilerActivity, profile

    from rescan_line_sted_torch.utils.observability import span

    def body():
        with span("rls.test.inner"):
            return torch.ones(4).sum()

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if form == "context":
            with span("rls.test"):
                got = body()
        else:
            got = span("rls.test")(body)()
    assert float(got) == 4.0
    events = {e.name: e for e in prof.events()
              if e.name.startswith("rls.test")}
    assert set(events) == {"rls.test", "rls.test.inner"}
    assert events["rls.test.inner"].cpu_parent.name == "rls.test"


@pytest.mark.parametrize("path", sorted(NESTING))
def test_port_spans_nest_as_listed(path):
    """A steady CPU call of each rescan mode, a two-power sweep and a
    two-power fused four-arm sweep emits the spans of its path, each inside
    the span its stage belongs to."""
    found = _port_spans(path)
    want = NESTING[path]
    assert {name for name, _ in found} == set(want)
    for name, parent in found:
        ok = want[name] if isinstance(want[name], tuple) else (want[name],)
        assert parent in ok, (name, parent)


@pytest.mark.parametrize("path", sorted(COUNTS))
def test_port_counters_count_the_codes_sites(path):
    found = [name for name, _ in _port_spans(path)]
    assert (found.count("rls.read_back"),
            found.count("rls.host_table")) == COUNTS[path]


def test_fused_sweep_counts_operator_builds_and_frcs():
    found = [name for name, _ in _port_spans("fused")]
    assert {name: found.count(name) for name in FUSED} == FUSED


def test_setup_holds_import_and_library(monkeypatch):
    """``SETUP`` holds the package's import time, and the first
    ``_build.lib()`` adds the library's load time and whether it built
    (here with the build and the load stubbed: no nvcc on the CPU)."""
    import ctypes

    from rescan_line_sted_torch.utils.observability import SETUP

    assert 0.0 < SETUP["import_s"] < 600.0

    class Handle:
        def __getattr__(self, name):
            fn = type("Entry", (), {})()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build", lambda: Path("stub.so"))
    monkeypatch.setattr(ctypes, "CDLL", lambda path: Handle())
    saved = dict(SETUP)
    try:
        SETUP.pop("library_s", None)
        SETUP.pop("built", None)
        handle = _build.lib()
        assert isinstance(handle, Handle) and _build.lib() is handle
        assert 0.0 <= SETUP["library_s"] < 60.0
        assert SETUP["built"] == (not _build.library_path().exists())
    finally:
        SETUP.clear()
        SETUP.update(saved)

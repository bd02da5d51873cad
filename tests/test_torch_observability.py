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

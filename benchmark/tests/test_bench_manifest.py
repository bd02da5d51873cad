"""``BENCHMARK.json`` and the files it names: the contract's keys and
character sets, every cell's files found by name, and a cell added from
files alone."""

import json
import re
import shutil
import time
from pathlib import Path

import pytest

from benchmark import core

REPO = Path(__file__).resolve().parents[2]

MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(MANIFEST) == TOP
    assert MANIFEST["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert all(line(w) for w in MANIFEST["command"])
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fit_a_full_check_of_24_cells():
    s = MANIFEST["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    cells = 24
    check = (2 + 14 * cells) * (s + 60) + cells * 2 * 90 + 1200
    assert check <= 43200


@pytest.mark.parametrize("cfg", MANIFEST["configs"], ids=lambda c: c["name"])
def test_config_entry(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and line(cfg["why"]) and line(cfg["source"])
    assert cfg["file"].startswith(MANIFEST["paths"][0] + "/")
    assert all(NAME.match(k) for k in cfg["reduced"]) and len(cfg["reduced"]) <= 16
    body = json.loads((REPO / cfg["file"]).read_text())
    assert body["reduced"] == cfg["reduced"] and body["name"] == cfg["name"]
    # the field the CPU tests cut it to (``conftest.cut_to_small_fields``)
    small = body["small_field"]
    assert len(small) == 2 and all(type(n) is int and n > 0 for n in small)
    assert all(s <= f for s, f in zip(small, body["field"]))
    assert not any(k.endswith(("_dim", "_rank")) for k in cfg["reduced"])
    assert any(w["config"] == cfg["name"] for w in MANIFEST["workloads"])


@pytest.mark.parametrize("cell", MANIFEST["workloads"], ids=lambda w: w["name"])
def test_cell_entry_and_its_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] == 1 and line(cell["why"])
    spec = core.load_spec(cell["name"], MANIFEST)
    assert spec.workload["traffic"]["name"] == cell["traffic"]
    assert spec.workload["why"] == cell["why"]
    assert spec.driver_path(core.BENCH).is_file()
    assert spec.reference_path(core.BENCH).is_file()
    for m in spec.end_to_end + spec.per_layer:
        assert (core.BENCH / "metrics" / f"{m['name']}.py").is_file()
    assert "setup_s" in {m["name"] for m in spec.end_to_end}
    assert len(spec.end_to_end) >= 2 and spec.per_layer
    assert spec.workload["limits"]


def test_one_cell_per_config_and_traffic():
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    names = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(names) == len(set(names))


def test_metric_entries():
    e2e = MANIFEST["end_to_end"]
    assert "setup_s" in {m["name"] for m in e2e}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line(m["layer"])
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for m in e2e + MANIFEST["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")


def test_each_moved_metric_is_reported_where_its_mover_is_read():
    names = {w["name"] for w in MANIFEST["workloads"]}
    for m in MANIFEST["per_layer"]:
        assert set(m["workloads"]) <= names
        for cell in m["workloads"]:
            spec = core.load_spec(cell, MANIFEST)
            assert m["moves"] in {e["name"] for e in spec.end_to_end}, (
                m["name"], cell)


def test_roofline_names():
    for m in MANIFEST["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%" and m["better"] == "higher"


def test_a_cell_from_files_alone(bench_tree, cut_tree):
    """A new configuration, cell, metric and driver by new files and new
    entries only: the tree is cut to the new configuration's own small
    field, and the harness runs it without an edit."""
    manifest, bench = bench_tree
    cfg = json.loads((bench / "configs" / "line_sted_2048.json").read_text())
    cfg.update(name="line_sted_dummy", sigma_exc=2.5, small_field=[256, 512])
    (bench / "configs" / "line_sted_dummy.json").write_text(json.dumps(cfg))
    wl = json.loads((bench / "workloads" / "rescan_2048_analytic.json")
                    .read_text())
    wl.update(driver="dummy_image",
              traffic=dict(wl["traffic"], name="analytic_r2",
                           rescan_factor=2.0))
    (bench / "workloads" / "dummy_cell.json").write_text(json.dumps(wl))
    shutil.copy(bench / "drivers" / "rescan_image.py",
                bench / "drivers" / "dummy_image.py")
    shutil.copy(bench / "reference" / "rescan_image.py",
                bench / "reference" / "dummy_image.py")
    (bench / "metrics" / "calls_done.py").write_text(
        "def read(run):\n    return float(run.calls)\n")
    manifest["configs"].append(dict(
        name="line_sted_dummy", source="https://example.org/dummy",
        file="benchmark/configs/line_sted_dummy.json", reduced=[],
        why="a test's configuration"))
    manifest["workloads"].append(dict(
        name="dummy_cell", config="line_sted_dummy", traffic="analytic_r2",
        chips=1, why=wl["why"]))
    manifest["end_to_end"].append(dict(
        name="calls_done", unit="calls", better="higher", bound=0.05,
        source="host_clock", workloads=["dummy_cell"]))
    cut_tree(manifest, bench.parent)
    spec = core.load_spec("dummy_cell", manifest, bench)
    assert spec.config["field"] == [256, 512]
    res = core.run("dummy_cell", 5, 0.05, False, "cpu", time.perf_counter(),
                   manifest=manifest, bench=bench)
    assert res["correct"], res["checks"]
    # setup_s has no workloads list, so a new cell reports it unasked
    assert set(res["metrics"]) == {"calls_done", "setup_s"}
    assert res["metrics"]["calls_done"]["value"] == res["attempted"] >= 1


def test_a_configuration_without_its_small_field_is_named(bench_tree,
                                                          cut_tree):
    """A configuration file that lacks ``small_field`` stops the cut with
    a message that names the configuration and the key."""
    manifest, bench = bench_tree
    cfg = json.loads((bench / "configs" / "line_sted_2048.json").read_text())
    cfg.pop("small_field")
    cfg.update(name="line_sted_bare")
    (bench / "configs" / "line_sted_bare.json").write_text(json.dumps(cfg))
    manifest["configs"].append(dict(
        name="line_sted_bare", source="https://example.org/bare",
        file="benchmark/configs/line_sted_bare.json", reduced=[],
        why="a test's configuration"))
    with pytest.raises(ValueError, match="'line_sted_bare'.*'small_field'"):
        cut_tree(manifest, bench.parent)

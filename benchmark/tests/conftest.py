"""Fixtures of the benchmark's own tests (``python -m pytest
benchmark/tests``; ``tests/``'s suite does not collect them)."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def cut_to_small_fields(manifest, root):
    """Each configuration of ``manifest`` under ``root`` cut to the
    ``small_field`` its own file gives: the field at which the CPU tests
    run it, the smallest at which every fault reads above its limit."""
    for c in manifest["configs"]:
        path = root / c["file"]
        cfg = json.loads(path.read_text())
        if "small_field" not in cfg:
            raise ValueError(f"configuration {c['name']!r} ({c['file']}) "
                             "has no 'small_field' for the CPU tests")
        cfg["field"] = cfg["small_field"]
        path.write_text(json.dumps(cfg))


@pytest.fixture
def bench_tree(tmp_path):
    """A copy of the benchmark and ``BENCHMARK.json`` as they stand:
    ``(manifest, bench_dir)``."""
    bench = tmp_path / "benchmark"
    shutil.copytree(REPO / "benchmark", bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    return manifest, bench


@pytest.fixture
def small_tree(bench_tree):
    """``bench_tree`` with every configuration cut to its ``small_field``
    (``cut_to_small_fields``): ``(manifest, bench_dir)`` for ``core.run``."""
    manifest, bench = bench_tree
    cut_to_small_fields(manifest, bench.parent)
    return manifest, bench


@pytest.fixture
def cut_tree():
    """``cut_to_small_fields``, for a test that adds a configuration to a
    ``bench_tree`` before it is cut."""
    return cut_to_small_fields


@pytest.fixture
def card():
    """The CUDA card, or a skip where this machine has none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)

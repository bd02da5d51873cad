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

# the CPU tests' sizes, the smallest at which every fault reads above its
# limit: K1's band windows need a field wider than 128 columns, and the
# dispersion of n row or tile sums reads sqrt(n / 2) without draws (limit
# 10): 512 rows, 32 x 32 tiles of the sweep's 8 x 8
SMALL = {"line_sted_2048": [512, 512], "dose_sweep_256": [256, 256]}


@pytest.fixture
def small_tree(tmp_path):
    """A copy of the benchmark with every configuration's field cut to
    ``SMALL``: ``(manifest, bench_dir)`` for ``core.run``."""
    bench = tmp_path / "benchmark"
    shutil.copytree(REPO / "benchmark", bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in manifest["configs"]:
        path = tmp_path / c["file"]
        cfg = json.loads(path.read_text())
        cfg["field"] = SMALL[c["name"]]
        path.write_text(json.dumps(cfg))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    return manifest, bench


@pytest.fixture
def card():
    """The CUDA card, or a skip where this machine has none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)

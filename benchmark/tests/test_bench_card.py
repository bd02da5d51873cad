"""The readings limits are set from (``control.readings``): over its seeds
the program keeps every number under its limit, while the TF32 control and
each planted fault read above one. On the card at each cell's own sizes
(``python -m pytest benchmark/tests/test_bench_card.py -m cuda``), and on
the CPU at each configuration's ``small_field``."""

import json
from pathlib import Path

import pytest

from benchmark import control, core

REPO = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def _check(cell, readings):
    limits = core.load_spec(cell, MANIFEST).workload["limits"]
    for seed, variant, numbers in readings:
        over = [k for k, v in numbers.items() if not v <= limits[k]]
        if variant == "program":
            assert not over, (seed, numbers)
        else:
            assert over, (seed, variant, numbers)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_and_control_and_faults_fail(card, cell):
    _check(cell, control.readings(cell, (2**31 + 11, 12, 2**32 + 13),
                                  str(card)))


@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_and_control_and_faults_fail_on_the_cpu(small_tree,
                                                              cell):
    manifest, bench = small_tree
    _check(cell, control.readings(cell, (2**31 + 5,), "cpu",
                                  manifest=manifest, bench=bench))

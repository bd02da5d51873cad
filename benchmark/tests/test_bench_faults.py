"""A run at a small size on the CPU, with the timed path broken underneath
by each fault its driver plants (``FAULTS``), comes out not correct; the
same run unbroken comes out correct. Faults: the output left as it
started; half of the batch left out and the mean taken over the rest; one
answer altered where it is produced; the draws left out; in the rescan
cells, the noisy canvases' counts moved along their rows. (One chip: no
exchange between chips to leave out.)"""

import json
import time
from pathlib import Path

import pytest

from benchmark import core

REPO = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def _faults(cell):
    spec = core.load_spec(cell, MANIFEST)
    driver = core.load_module(spec.driver_path(core.BENCH),
                              f"bench_driver_{spec.workload['driver']}")
    return driver.FAULTS


CASES = [(c, f) for c in CELLS for f in [None, *_faults(c)]]


@pytest.mark.parametrize("cell, fault", CASES,
                         ids=[f"{c}-{f or 'sound'}" for c, f in CASES])
def test_fault_makes_the_run_incorrect(small_tree, cell, fault):
    manifest, bench = small_tree

    def plant(c):
        if fault is not None:
            c.entry = _faults(cell)[fault](c.entry)

    res = core.run(cell, 2**31 + 99, 0.01, False, "cpu", time.perf_counter(),
                   manifest=manifest, bench=bench, patch=plant)
    assert res["correct"] == (fault is None), res["checks"]
    if fault is not None:
        assert res["failed"] >= 1

"""Readings that the limits of ``correct`` are set from, at a cell's own
sizes: the program's sound numbers, its control's, and each planted
fault's, on several seeds in one process. The benchmark's own runs do not
run this.

    python benchmark/control.py --workload <cell> --seeds 1,2,3 \
        [--variants program,control,<fault>,...]

The program and each fault are read through the timed path itself
(``core.run`` with a short window, the fault planted by its ``patch``
from the driver's ``FAULTS``), so a reading is what a run's own check
reads. The control is the plain reference put in the program's place,
computed one step below the configuration's precision (TF32 products for
float32): it has to read above a limit that sound runs keep under. Every
reading is one JSON line on standard output: ``{"seed", "variant",
"numbers"}``, each number the worst over the run's rows.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import core  # noqa: E402

WINDOW_S = 1.0   # a reading's window: long enough to keep a run's outputs


def readings(name: str, seeds, device: str = "cuda:0", manifest=None,
             bench: Path = core.BENCH, variants=None):
    """Yield ``(seed, variant, numbers)`` for the program ("program"),
    the control ("control") and each fault named in ``variants`` (every
    one by default)."""
    manifest = manifest or core.read_json(bench.parent / "BENCHMARK.json")
    spec = core.load_spec(name, manifest, bench)
    driver = core.load_module(spec.driver_path(bench),
                              f"bench_driver_{spec.workload['driver']}")
    variants = variants or ["program", "control", *driver.FAULTS]
    for seed in seeds:
        for variant in variants:
            if variant == "control":
                yield seed, variant, control(spec, driver, seed, device, bench)
                continue
            fault = driver.FAULTS[variant] if variant != "program" else None

            def plant(cell, fault=fault):
                if fault is not None:
                    cell.entry = fault(cell.entry)

            res = core.run(name, seed, WINDOW_S, False, device,
                           time.perf_counter(), manifest=manifest,
                           bench=bench, patch=plant)
            yield seed, variant, {k: c["value"]
                                  for k, c in res["checks"].items()}


def control(spec, driver, seed: int, device: str, bench: Path) -> dict:
    """The control's numbers: the reference in the program's place."""
    reference = core.load_module(spec.reference_path(bench),
                                 f"bench_reference_{spec.workload['driver']}")
    cell = driver.Cell(spec.config, spec.workload, seed, core.Device(
        device).device)
    return core.worst(cell.control(reference))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variants", default="")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    variants = [v for v in args.variants.split(",") if v] or None
    for seed, variant, numbers in readings(args.workload, seeds,
                                           variants=variants):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "variant": variant, "numbers": numbers}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

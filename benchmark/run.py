"""Run one cell of the port's benchmark once, on the card this process sees.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics, both as the last line of standard output, one JSON
object (``core.run``). Each number compared for ``correct`` is printed
beside its limit as the last lines of standard error, and under
``checks``, last in the line. The process drives the card alone, with one
thread for torch's CPU operations (steadier from run to run on the
host-bound sweep: ``PERF.md``). Exits 2, printing no result,
without a CUDA card or with fewer cards than the cell asks for, and 3
where JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()   # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import core  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    manifest = core.read_json(core.REPO / "BENCHMARK.json")
    spec = core.load_spec(args.workload, manifest)
    import torch

    chips = spec.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)        # one process, one CPU thread: steadier
    result = core.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda:0", T0, manifest=manifest)
    found = core.forbidden_modules()
    if found:
        print(f"benchmark: loaded {', '.join(found)}: the port's run may "
              "import neither JAX nor the JAX package", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        ok = c["value"] <= c["limit"]           # NaN fails
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if ok else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(finite(result)))
    return 0


def finite(x):
    """``x`` with every non-finite number as null (strict JSON)."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


if __name__ == "__main__":
    sys.exit(main())

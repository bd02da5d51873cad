"""``run.py`` without a card, in a tree that holds only the benchmark, and
the imports of the harness: no JAX or JAX package anywhere it loads, and
nothing of the program in the plain references."""

import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

from benchmark import core

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "benchmark"


def _python(code, cwd=REPO, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _blocked(names, body):
    """Python source that refuses to import any module whose top-level
    name (the part before the first dot) is one of ``names``, then runs
    ``body``."""
    return textwrap.dedent(f"""
        import sys
        BLOCKED = {tuple(names)!r}

        class Blocker:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Blocker())
        sys.path.insert(0, {str(REPO)!r})
    """) + textwrap.dedent(body)


def test_run_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "rescan_2048_per_step", "--seed", str(2**31 + 7), "--seconds", "1",
         "--trace", "0"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 2, proc.stderr
    assert proc.stdout == ""
    assert "CUDA card" in proc.stderr


def test_run_fails_in_a_tree_of_the_benchmark_alone(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    for trace in ("0", "1"):
        proc = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload",
             "dose_sweep_256", "--seed", "3", "--seconds", "1", "--trace",
             trace], cwd=tmp_path, capture_output=True, text=True,
            timeout=300)
        assert proc.returncode != 0
        assert proc.stdout == ""


def test_harness_loads_no_jax_nor_the_jax_package():
    files = sorted(str(p) for d in ("drivers", "metrics", "reference")
                   for p in (BENCH / d).glob("*.py"))
    proc = _python(_blocked(core.FORBIDDEN, f"""
        import importlib.util
        import benchmark.run, benchmark.core, benchmark.trace
        import benchmark.control, benchmark.readers, benchmark.work
        for i, f in enumerate({files!r}):
            spec = importlib.util.spec_from_file_location(f"m{{i}}", f)
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        from benchmark import core
        assert core.forbidden_modules() == [], core.forbidden_modules()
        print("ok")
    """))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_references_import_nothing_of_the_program():
    files = sorted(str(p) for p in (BENCH / "reference").glob("*.py"))
    proc = _python(_blocked(core.FORBIDDEN + ("rescan_line_sted_torch",), f"""
        import importlib.util
        import benchmark.compare, benchmark.samples
        for i, f in enumerate({files!r}):
            spec = importlib.util.spec_from_file_location(f"r{{i}}", f)
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        print(sorted(m for m in sys.modules
                     if m.split(".")[0] == "rescan_line_sted_torch"))
    """))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import types

    for name in ("jaxtyping", "rescan_line_sted_tpu_extra", "flaxen.x"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    before = core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "rescan_line_sted_tpu.config",
                        types.ModuleType("rescan_line_sted_tpu.config"))
    assert set(core.forbidden_modules()) - set(before) == {
        "rescan_line_sted_tpu"}
    assert "jaxtyping" not in core.forbidden_modules()

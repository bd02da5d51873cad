"""The port's examples (``rescan_line_sted_torch/examples``), each run as a
user runs it, ``python -m rescan_line_sted_torch.examples.<name> --platform
cpu``, in a subprocess where ``jax`` and ``rescan_line_sted_tpu`` cannot be
imported; and the port's host-side modules imported the same way."""

import glob
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(
    os.path.basename(p)[:-3] for p in glob.glob(
        os.path.join(ROOT, "rescan_line_sted_torch", "examples", "*.py"))
    if not p.endswith("__init__.py"))
# every JAX example has its port
WAITING: set[str] = set()
BLOCK = ("import runpy, sys\n"
         "for name in ('jax', 'jaxlib', 'flax', 'rescan_line_sted_tpu'):\n"
         "    sys.modules[name] = None\n")


def _run(code: str, *args):
    return subprocess.run([sys.executable, "-c", BLOCK + code, *args],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)


def test_every_jax_example_is_ported():
    jax_examples = {os.path.basename(p)[:-3] for p in glob.glob(
        os.path.join(ROOT, "examples", "*.py"))}
    assert set(EXAMPLES) == jax_examples - WAITING


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_without_jax(name):
    out = _run("sys.argv = [sys.argv[0]] + sys.argv[1:]\n"
               f"runpy.run_module('rescan_line_sted_torch.examples.{name}', "
               "run_name='__main__')\n", "--platform", "cpu")
    assert out.returncode == 0, f"{name}:\n{out.stdout[-2000:]}\n" \
                                f"{out.stderr[-2000:]}"
    assert out.stdout.strip(), "examples narrate what they compute"


def test_host_side_modules_import_without_jax():
    modules = ["rescan_line_sted_torch.cli", "rescan_line_sted_torch.io",
               "rescan_line_sted_torch.io.native",
               "rescan_line_sted_torch.pipelines",
               "rescan_line_sted_torch.utils.observability",
               *(f"rescan_line_sted_torch.examples.{n}" for n in EXAMPLES)]
    out = _run("import importlib\n"
               f"for m in {modules!r}:\n"
               "    importlib.import_module(m)\n"
               "bad = [m for m in sys.modules if sys.modules[m] is not None "
               "and m.split('.')[0] in ('jax', 'flax', "
               "'rescan_line_sted_tpu')]\n"
               "sys.exit(1 if bad else 0)\n")
    assert out.returncode == 0, out.stdout + out.stderr

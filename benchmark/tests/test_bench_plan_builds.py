"""``plan_builds_per_call.image`` on a synthetic trace: the entry's plan
builds per call, 0 where the calls build none, and None without a trace,
without the entry's span or where the program keeps no plans."""

import sys
import types

import pytest

from benchmark import core, trace

READER = core.load_module(core.BENCH / "metrics"
                          / "plan_builds_per_call.image.py",
                          "bench_metric_plan_builds_per_call_image")


def _x(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _run(events, calls):
    return types.SimpleNamespace(trace=trace.Trace(events, calls=calls))


@pytest.fixture
def program(monkeypatch):
    """The program's module that keeps the plans, with ``plan_cache``."""
    module = types.ModuleType(READER.PLANS_MODULE)
    module.plan_cache = lambda maxsize: None
    monkeypatch.setitem(sys.modules, READER.PLANS_MODULE, module)
    return module


def test_builds_per_call(program):
    """Three calls: the first builds two plans (one nested in the other's
    ``rls.image.tables``), the others none; a build before the stretch is
    left out."""
    events = [
        _x("rls.plan_build", -40, 10),
        _x("bench.call", 0, 100), _x("bench.call", 100, 100),
        _x("bench.call", 200, 100),
        _x("rls.image", 0, 90), _x("rls.image.tables", 5, 40),
        _x("rls.plan_build", 10, 20), _x("rls.plan_build", 50, 10),
        _x("rls.image", 100, 90), _x("rls.image.tables", 105, 2),
        _x("rls.image", 200, 90), _x("rls.image.tables", 205, 2),
        _x("kernel_a", 60, 20, "kernel"),
    ]
    assert READER.read(_run(events, 3)) == pytest.approx(2 / 3)


def test_zero_where_the_plans_serve_every_call(program):
    events = [_x("bench.call", 0, 100), _x("rls.image", 0, 90),
              _x("rls.image.tables", 5, 2), _x("kernel_a", 10, 5, "kernel")]
    assert READER.read(_run(events, 1)) == 0.0


def test_none_without_a_trace_the_entry_or_the_plans(program, monkeypatch):
    assert READER.read(types.SimpleNamespace(trace=None)) is None
    sweep = [_x("bench.call", 0, 100), _x("rls.sweep", 0, 90)]
    assert READER.read(_run(sweep, 1)) is None
    image = [_x("bench.call", 0, 100), _x("rls.image", 0, 90)]
    del program.plan_cache                 # a program before the plans
    assert READER.read(_run(image, 1)) is None
    monkeypatch.delitem(sys.modules, READER.PLANS_MODULE)
    assert READER.read(_run(image, 1)) is None

"""The readers of the port's spans (``spans.py``) on a synthetic trace:
the union of a span's intervals, the card's idle time under it, counts
per call, and None without a trace or without the span."""

import sys
import types

import pytest

from benchmark import spans, trace


def _x(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _trace():
    """Two calls, 0-100 and 100-200 us. Call 1: ``rls.image`` 0-90 with
    two ``rls.image.tables`` 10-30 and 20-40 (overlapping: 30 us of
    union), one ``rls.read_back`` and one ``rls.host_table``. Call 2:
    ``rls.image`` 100-190 with ``rls.image.tables`` 110-120 and another
    ``rls.host_table``. Before and after the stretch, spans and kernels
    that the readers leave out. Kernels at 25-35 and 150-180."""
    events = [
        _x("bench.call", 0, 100), _x("bench.call", 100, 100),
        _x("rls.image", 0, 90), _x("rls.image.tables", 10, 20),
        _x("rls.image.tables", 20, 20), _x("rls.read_back", 50, 5),
        _x("rls.host_table", 60, 2),
        _x("rls.image", 100, 90), _x("rls.image.tables", 110, 10),
        _x("rls.host_table", 160, 2),
        _x("rls.image.tables", -50, 40), _x("rls.host_table", 250, 2),
        _x("rls.image.tables", 195, 30),          # clipped at the end: 5 us
        _x("aten::mul", 12, 3, "cpu_op"),
        _x("kernel_a", 25, 10, "kernel"), _x("kernel_b", 150, 30, "kernel"),
        _x("kernel_c", 300, 10, "kernel"),
    ]
    return trace.Trace(events, calls=2)


def _run(t):
    return types.SimpleNamespace(trace=t)


def test_union_in_ms_per_call():
    t = _trace()
    assert spans.intervals(t, "rls.image.tables") == [[10, 40], [110, 120],
                                                       [195, 200]]
    # (30 + 10 + 5) us over two calls
    assert spans.span_ms(_run(t), "rls.image.tables") == pytest.approx(
        45e-3 / 2)
    assert spans.span_ms(_run(t), "rls.image") == pytest.approx(180e-3 / 2)
    # two names: their union
    assert spans.span_ms(_run(t), "rls.read_back", "rls.host_table") == \
        pytest.approx(9e-3 / 2)


def test_idle_under_a_span():
    t = _trace()
    # idle under tables: 10-25 and 35-40, 110-120, 195-200: 35 us of 200
    assert spans.idle_share(_run(t), "rls.image.tables") == pytest.approx(
        100.0 * 35 / 200)
    # the whole call span: 0-25, 35-90, 100-150, 180-190
    assert spans.idle_share(_run(t), "rls.image") == pytest.approx(
        100.0 * 140 / 200)
    assert spans.intersect([(0, 10), (20, 30)], [(5, 25)]) == [(5, 10),
                                                              (20, 25)]


def test_counts_per_call():
    t = _trace()
    run = _run(t)
    assert spans.per_call(run, "rls.host_table", "rls.image") == 1.0
    assert spans.per_call(run, "rls.read_back", "rls.image") == 0.5
    # a counter the program never hit, where it records its root: 0
    assert spans.per_call(run, "rls.k2c", "rls.image") == 0.0


def test_none_without_a_trace_or_the_span():
    run = _run(None)
    assert spans.span_ms(run, "rls.image") is None
    assert spans.idle_share(run, "rls.image") is None
    assert spans.per_call(run, "rls.read_back", "rls.image") is None
    t = _trace()
    assert spans.span_ms(_run(t), "rls.k1") is None
    assert spans.idle_share(_run(t), "rls.k1") is None
    # a program without its root span counts nothing
    assert spans.per_call(_run(t), "rls.read_back", "rls.sweep") is None


def test_idle_share_none_without_the_card():
    events = [_x("bench.call", 0, 100), _x("rls.image", 0, 90),
              _x("rls.image.tables", 10, 20)]
    assert spans.idle_share(_run(trace.Trace(events, calls=1)),
                            "rls.image.tables") is None


def test_setup_readings(monkeypatch):
    module = types.ModuleType(spans.SETUP_MODULE)
    monkeypatch.setitem(sys.modules, spans.SETUP_MODULE, module)
    assert spans.setup("import_s") is None           # no SETUP: a parent
    module.SETUP = {"import_s": 0.25}
    assert spans.setup("import_s") == 0.25
    assert spans.setup("library_s") is None

"""Rates, percentiles, rooflines and the trace reduction, over every call
of a window."""

import importlib.util
from types import SimpleNamespace

import pytest

from benchmark import peaks, tracing
from benchmark.tests import fixture_cell


def reader(name):
    path = fixture_cell.BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("m_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def fake_run(calls, start=0.0, trace=None):
    return SimpleNamespace(
        calls=calls, window_start=start, window_s=calls[-1][1] - start,
        cells=sum(c[2] for c in calls), db_bytes=sum(c[3] for c in calls),
        setup_s=7.5, trace=trace,
    )


def test_ceiling():
    assert peaks.CELLS_PER_S == pytest.approx(6.0826e12, rel=1e-4)
    assert peaks.bound_seconds(6.0826e12, 1) == pytest.approx(1.0, rel=1e-4)
    assert peaks.bound_seconds(1, 3.35e12) == pytest.approx(1.0)
    assert peaks.roofline_pct(6.0826e12, 0, 2.0) == pytest.approx(50.0, rel=1e-4)
    assert peaks.roofline_pct(10, 0, 0.0) is None


def test_gcups_over_the_whole_window():
    # three calls; the window runs from its start to the last return,
    # gaps between calls included
    calls = [(1.0, 2.0, 4e9, 0), (2.5, 3.0, 2e9, 0), (3.0, 5.0, 4e9, 0)]
    assert reader("gcups")(fake_run(calls, start=1.0)) == pytest.approx(10 / 4)


def test_percentiles_over_all_calls():
    calls = [(0.0, x / 1e3, 0, 0) for x in range(1, 101)]
    run = fake_run(calls)
    assert reader("query_p50_ms")(run) == pytest.approx(50.5)
    assert reader("query_p95_ms")(run) == pytest.approx(95.05)
    assert peaks.percentile([3, 1, 2], 0) == 1
    assert peaks.percentile([3, 1, 2], 100) == 3
    assert reader("setup_s")(run) == 7.5


def events():
    ms = 1_000_000
    return [
        ("window", False, 0, 100 * ms, 0),
        ("call", False, 0, 40 * ms, 0),
        ("engine", False, 5 * ms, 35 * ms, 0),
        ("client", False, 40 * ms, 50 * ms, 0),
        ("call", False, 50 * ms, 100 * ms, 0),
        ("aten::add", False, 51 * ms, 52 * ms, 0),
        ("pyopal::ragged_kernel<0, false>(int)", True, 10 * ms, 30 * ms, 0),
        ("Memcpy DtoH (Device -> Pageable)", True, 30 * ms, 32 * ms, 0),
        ("void k(int)", True, 60 * ms, 90 * ms, 0),
        ("outside", True, 120 * ms, 130 * ms, 0),
    ]


def test_trace_summary():
    s = tracing.Summary(events(), tracing.span_names())
    assert s.window_s == pytest.approx(0.1)
    assert s.busy_s == pytest.approx(0.052)
    assert s.kernel_s == pytest.approx(0.05)
    assert s.calls == 2
    assert s.call_busy_s == pytest.approx([0.022, 0.030])
    idle = s.idle_gaps
    assert idle["engine"] == pytest.approx(0.008)
    assert idle["call"] == pytest.approx(0.010 + 0.020)
    assert idle["client"] == pytest.approx(0.010)
    assert sum(idle.values()) == pytest.approx(0.1 - 0.052)
    assert set(s.device_ops) == {"pyopal::ragged_kernel<0, false>", "Memcpy DtoH", "k"}


def test_layer_readers_on_a_trace():
    s = tracing.Summary(events(), tracing.span_names())
    run = fake_run([(0.0, 0.04, 6.0826e9, 0), (0.05, 0.1, 6.0826e9, 0)], trace=s)
    assert reader("device_idle_pct.gcups")(run) == pytest.approx(48.0)
    assert reader("host_ms.query")(run) == pytest.approx(((40 - 22) + (50 - 30)) / 2)
    assert reader("kernel_roofline.gcups")(run) == pytest.approx(100 * 0.002 / 0.05, rel=1e-4)
    untraced = fake_run([(0.0, 1.0, 1, 1)])
    for name in ("device_idle_pct.query", "host_ms.gcups", "kernel_roofline.query"):
        assert reader(name)(untraced) is None

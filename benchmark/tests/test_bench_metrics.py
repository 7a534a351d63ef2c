"""The metric arithmetic: a rate is all work over all time, the p95 is over
all calls, idle is the union of device intervals, the breakdown names the
innermost host span, and the readers read nothing where there is nothing."""

import numpy as np
import pytest

from csbench import registry
from csbench.trace import TraceRecord, breakdown, busy_us
from csbench.workload import Run


def _run(kind="column_calls", walls=None, window=None, trace=None, work=None,
         kind_name="NVIDIA H100 80GB HBM3"):
    walls = [0.07] * 10 if walls is None else walls
    return Run(params={"points": 1024, "atmosphere": {"levels": 20}}, kind=kind, setup_s=12.5,
               window_s=sum(walls) if window is None else window, unit_s=walls,
               units=len(walls), attempted=len(walls), failed=0,
               device={"kind": kind_name}, trace=trace, work=work or {})


def read(name, run):
    return registry.reader(name).read(run)


def test_rate_is_all_work_over_all_time():
    walls = list(np.linspace(0.05, 0.09, 40))
    run = _run(walls=walls, window=sum(walls) + 0.5)    # time between calls counts
    assert read("columns_per_s", run) == pytest.approx(40 / (sum(walls) + 0.5))
    assert read("column_steps_per_s", run) is None
    sweep = _run(kind="sweep", walls=[0.036] * 8, window=0.3, work={"columns": 1024})
    assert read("column_steps_per_s", sweep) == pytest.approx(8 * 1024 / 0.3)
    assert read("setup_s", run) == 12.5


def test_p95_is_over_every_call():
    walls = [0.07] * 95 + [0.2] * 5
    run = _run(walls=walls)
    assert read("call_ms.p95", run) == pytest.approx(np.percentile(np.array(walls) * 1e3, 95))
    run = _run(walls=[0.07] * 94 + [0.2] * 6)
    assert read("call_ms.p95", run) == pytest.approx(200.0)


def test_idle_is_a_union_of_intervals():
    assert busy_us([(0, 10), (5, 15), (20, 30), (21, 22)]) == 25
    rec = TraceRecord(device=[("radau_kernel<0>", 0.0, 60.0), ("aten::add", 50.0, 70.0),
                              ("olr_kernel", 80.0, 90.0)],
                      host=[("bench.call", 0.0, 100.0), ("aten::copy_", 72.0, 78.0)],
                      window=(0.0, 100.0), units=2)
    run = _run(trace=rec)
    assert read("device_idle_pct.columns", run) == pytest.approx(20.0)
    assert read("radau.device_ms", run) == pytest.approx(0.030)
    assert read("march.device_ms", run) == pytest.approx(0.005)
    assert read("torch_ops.device_ms", run) == pytest.approx(0.010)
    assert read("launches_per_call", run) == 1.5
    b = breakdown(rec)
    assert b["device_ops"][0] == ["radau_kernel<0>", pytest.approx(60e-6)]
    assert b["idle_gaps"][0] == ["aten::copy_", pytest.approx(10e-6)]


def test_readers_read_nothing_without_a_trace_or_a_known_card():
    run = _run()
    for name in ("radau.device_ms", "radau.roofline_pct", "linesum.roofline_pct",
                 "torch_ops.device_ms", "device_idle_pct.columns", "mfu.columns"):
        assert read(name, run) is None
    rec = TraceRecord(device=[("window_kernel<3>", 0.0, 50.0)], host=[], window=(0.0, 100.0),
                      units=1)
    other = _run(trace=rec, kind_name="some other card",
                 work={"linesum_triples_per_call": 1e6, "linesum_bytes_per_call": 1e3})
    assert read("linesum.roofline_pct", other) is None
    assert read("linesum.device_ms", other) == pytest.approx(0.05)


def test_rooflines_stay_under_100_for_work_the_time_allows():
    # 4e11 FP32 operations take at least 6 ms at 67 TFLOP/s: 12 ms of kernel is 50%
    rec = TraceRecord(device=[("window_kernel<3>", 0.0, 12000.0)], host=[],
                      window=(0.0, 20000.0), units=1)
    run = _run(trace=rec, work={"linesum_triples_per_call": 4e11 / 6.0,
                                "linesum_bytes_per_call": 1e9})
    share = read("linesum.roofline_pct", run)
    assert share == pytest.approx(100.0 * (4e11 / 67e12) / 0.012)
    assert 0 < read("mfu.columns", run) < share

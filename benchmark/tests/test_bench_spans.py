"""The readers of the program's spans and counters: idle time inside a host
span, host time clipped to the window, division by the units, and nothing
read where a run holds no such span or the program has no registry."""

import sys
import types

import pytest

from csbench import registry, spans
from csbench.trace import TraceRecord
from csbench.workload import Run


def _run(kind, rec):
    return Run(params={}, kind=kind, setup_s=1.0, window_s=1.0, unit_s=[0.1] * 4, units=4,
               attempted=4, failed=0, device={"kind": "NVIDIA H100 80GB HBM3"}, trace=rec)


def read(name, run):
    return registry.reader(name).read(run)


def _rec(units=2):
    # window 0-100 us; device busy 10-30, 25-40 and 60-70; two calls' host
    # spans, the first starting before the window
    return TraceRecord(device=[("radau_kernel<0, true>", 10.0, 30.0), ("aten::add", 25.0, 40.0),
                               ("radau_kernel<1, true>", 60.0, 70.0)],
                       host=[("cs.radiate", -20.0, 45.0), ("cs.radiate", 50.0, 80.0),
                             ("aten::add", 20.0, 26.0), ("cs.adjust", 40.0, 60.0)],
                       window=(0.0, 100.0), units=units)


@pytest.fixture
def program(monkeypatch):
    """A stub of the program's registry."""
    snap = {"counters": {"radau.attempts": 4000, "radau.steps": 3000, "launch.radau.emission": 9},
            "spans": {"cs.radau.cache": {"n": 2, "device_ms": 6.0, "self_device_ms": 2.0},
                      "cs.radau.monoflux": {"n": 2, "device_ms": 100.0, "self_device_ms": 14.0},
                      "cs.heating.opacity": {"n": 8, "device_ms": 80.0, "self_device_ms": 80.0},
                      "cs.heating.spectral": {"n": 8, "device_ms": None, "self_device_ms": None}}}
    monkeypatch.setattr(spans, "snapshot", lambda: snap)
    return snap


def test_idle_inside_a_span_and_host_time_clipped_to_the_window():
    rec = _rec()
    inside = spans.host_intervals(rec, "cs.radiate")
    assert inside == [(0.0, 45.0), (50.0, 80.0)]
    # busy 10-40 within the first, 60-70 within the second
    assert spans.idle_us_inside(rec, inside) == pytest.approx(15.0 + 20.0)
    run = _run("column_calls", rec)
    assert read("radiate.host_ms", run) == pytest.approx((45.0 + 30.0) / 1e3 / 2)
    assert read("radiate.idle_ms", run) == pytest.approx(35.0 / 1e3 / 2)
    assert read("adjust.idle_ms.sweep", _run("sweep", rec)) == pytest.approx(
        (20.0 - 0.0) / 1e3 / 2)


def test_values_divide_by_the_units(program):
    for units in (1, 4):
        run = _run("column_calls", _rec(units))
        assert read("radau.attempts_per_call", run) == pytest.approx(4000 / units)
        # 30 us of the kernel over 4000 attempts: 7,500 ps each, whatever the units
        assert read("radau.ps_per_attempt", run) == pytest.approx(30.0 * 1e6 / 4000)
        assert read("radau.cache.device_ms", run) == pytest.approx(6.0 / units)
        assert read("radau.assembly.device_ms", run) == pytest.approx(14.0 / units)
        sweep = _run("sweep", _rec(units))
        assert read("heating.opacity.device_ms.sweep", sweep) == pytest.approx(80.0 / units)
        assert read("radiate.host_ms", run) == pytest.approx(75.0 / 1e3 / units)


def test_nothing_read_without_such_a_span(program):
    bare = TraceRecord(device=[("aten::add", 0.0, 10.0)], host=[("aten::add", 0.0, 10.0)],
                       window=(0.0, 100.0), units=3)
    run, sweep = _run("column_calls", bare), _run("sweep", bare)
    for name in ("radiate.host_ms", "radiate.idle_ms", "radau.ps_per_attempt"):
        assert read(name, run) is None
    assert read("adjust.idle_ms.sweep", sweep) is None
    # a span that ran on no card, and a span the run did not record
    assert read("heating.spectral.device_ms.sweep", sweep) is None
    program["spans"].pop("cs.radau.cache")
    assert read("radau.cache.device_ms", run) is None
    # the wrong kind, and no trace
    assert read("heating.opacity.device_ms.sweep", run) is None
    assert read("radau.cache.device_ms", sweep) is None
    for name in ("radau.attempts_per_call", "radau.assembly.device_ms", "radiate.idle_ms",
                 "adjust.idle_ms.sweep"):
        assert read(name, _run("column_calls", None)) is None
        assert read(name, _run("sweep", None)) is None


def test_a_program_without_a_registry_reads_none(monkeypatch):
    """An earlier tree's profiling module has no ``snapshot``: the readers
    read None and raise nothing."""
    old = types.ModuleType("clearsky_tpu_torch.utils.profiling")
    monkeypatch.setitem(sys.modules, "clearsky_tpu_torch.utils.profiling", old)
    assert spans.snapshot() is None
    run = _run("column_calls", _rec())
    for name in ("radau.attempts_per_call", "radau.ps_per_attempt", "radau.cache.device_ms",
                 "radau.assembly.device_ms"):
        assert read(name, run) is None
    assert read("heating.opacity.device_ms.sweep", _run("sweep", _rec())) is None

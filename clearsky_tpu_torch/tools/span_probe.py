"""The cost of the program's spans when tracing is on: the wall of a
benchmark cell's calls (or sweep steps) under a CPU-activity
``torch.profiler``, with the program's spans, their timing events and the
Radau kernel's counts on, and with them all off, in turns (on, off, off,
on, ...).

    python3 clearsky_tpu_torch/tools/span_probe.py [--cells A B] [--units 50] [--rounds 2]
    python3 clearsky_tpu_torch/tools/span_probe.py --breakdown [--cells A B] [--seconds 8]

Each cell is set up from the benchmark's files (``benchmark/``: its
configuration and traffic, the kinds' inputs, the absorber's program
object) at seed 1: a column cell's unit is one ``radiate`` call on a new
column whose band fluxes reach the host; a sweep cell's a step, run in
refresh periods of ``run_sweep`` that end in a synchronise. ``--units`` is
rounded up to whole periods. One ``probe`` JSON line a cell, after the
card's name and power limit: the wall ms a unit of every turn, on and off,
their medians and the spans' share of the wall.

``--breakdown`` runs each cell once through the benchmark's own run
(``--trace 1``: set-up, the traced window, the check) and prints, a unit of
the traced window, every span's count, device ms and self device ms, the
program's counters, the device's busy ms (the union of its operations), the
wall and the device operations.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path[:0] = [os.path.join(ROOT, "benchmark"), ROOT]

from clearsky_tpu_torch.utils import profiling  # noqa: E402

CELLS = ("co2_column.radau_radiate", "co2_h2o_sweep.b1024", "co2_column.radaueq_radiate",
         "co2_column.rcm_sweep_b256")


def _emit(**fields):
    print("probe " + json.dumps(fields), flush=True)


def _column_unit(cell, dev):
    """(a function of k that runs the k-th call, the units a call)."""
    from csbench import system

    params, plugins = cell["params"], cell["plugins"]
    atm = params["atmosphere"]
    x = plugins["kind"]._inputs(params, 1)
    absorber = plugins["absorber"].program(x["pars"], x["grid"], dev, params)
    core = system.core(params["core"])
    fS = lambda v: torch.full_like(v, x["S0"])

    def run(k):
        F = system.radiate(x["Pe"], atm["g"], x["column"](16 + k), atm["mu"], fS,
                           atm["albedo"], absorber, core)
        torch.stack([F.F_up, F.F_down, F.F_net]).cpu()

    return run, 1


def _sweep_unit(cell, dev):
    from csbench import system

    params, plugins = cell["params"], cell["plugins"]
    atm, r = params["atmosphere"], params["rcm"]
    x = plugins["kind"]._inputs(params, 1)
    absorber = plugins["absorber"].program(x["pars"], x["grid"], dev, params)
    model = system.rcm(x["Pe"], x["Te"], atm["g"], atm["mu"],
                       lambda v: torch.full_like(v, x["S0"]), atm["albedo"], atm["cp"],
                       r["cs"], absorber, r["radmul"])
    f = torch.as_tensor(x["factors"], dtype=torch.float32, device=dev)
    state = {"T": torch.as_tensor(x["T0"], dtype=torch.float32, device=dev), "A": None}

    def run(k):
        state["T"], state["A"] = system.sweep_period(model, f, r["dt_s"], r["period"],
                                                     state["T"], state["A"], atm["cp"],
                                                     atm["mu"])
        torch.cuda.synchronize(dev)

    return run, r["period"]


def _turn(run, calls: int, spans: bool) -> float:
    """Wall ms of ``calls`` calls under a CPU-activity profiler, the
    program's spans on or off."""
    saved = profiling.span, profiling.recording
    if not spans:
        profiling.span = lambda name, like=None: profiling._NULL
        profiling.recording = lambda: False
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            t0 = time.perf_counter()
            for k in range(calls):
                run(k)
            wall = time.perf_counter() - t0
    finally:
        profiling.span, profiling.recording = saved
        profiling.reset()
    return wall * 1e3


def breakdown(cell, name, seconds, dev):
    """One traced run of the cell, its spans and counters a unit."""
    from csbench import workload
    from csbench.trace import busy_us

    profiling.reset()
    run = workload.run_cell(cell, 2147700001, seconds, True, dev, time.perf_counter())
    rec, snap = run.trace, profiling.snapshot()
    u = rec.units
    spans = {k: {"n": v["n"] / u,
                 "device_ms": None if v["device_ms"] is None else v["device_ms"] / u,
                 "self_device_ms": None if v["self_device_ms"] is None
                 else v["self_device_ms"] / u}
             for k, v in snap["spans"].items()}
    host = {}
    lo, hi = rec.window
    for n, s, e in rec.host:
        if n.startswith("cs.") and e > lo and s < hi:
            host[n] = host.get(n, 0.0) + (min(e, hi) - max(s, lo)) / 1e3 / u
    _emit(cell=name, units=u, busy_ms=busy_us([(s, e) for _, s, e in rec.device]) / 1e3 / u,
          wall_ms=rec.window_us / 1e3 / u, device_ops=len(rec.device) / u, spans=spans,
          host_ms=host, counters={k: v / u for k, v in snap["counters"].items()
                                  if not k.startswith("launch.")},
          checks=run.checks)


def main(argv=None):
    from csbench import registry

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", nargs="*", default=list(CELLS))
    ap.add_argument("--units", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--breakdown", action="store_true")
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    _emit(part="env", card=torch.cuda.get_device_name(dev), nvidia_smi=smi.stdout.strip())
    spec = registry.load_spec()
    for name in args.cells:
        cell = registry.cell(spec, name)
        if args.breakdown:
            breakdown(cell, name, args.seconds, dev)
            continue
        kind = cell["params"]["kind"]
        run, per = (_column_unit if kind == "column_calls" else _sweep_unit)(cell, dev)
        calls = -(-args.units // per)
        for k in range(3):
            run(k)
        torch.cuda.synchronize(dev)
        ms = {True: [], False: []}
        for r in range(args.rounds):
            for on in ((True, False) if r % 2 == 0 else (False, True)):
                ms[on].append(_turn(run, calls, on) / (calls * per))
        on, off = statistics.median(ms[True]), statistics.median(ms[False])
        _emit(cell=name, units=calls * per, ms_per_unit_on=ms[True], ms_per_unit_off=ms[False],
              median_on=on, median_off=off, spans_share_pct=100.0 * (on - off) / off)
        del run
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

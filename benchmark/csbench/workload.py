"""The general generator's shared parts: one run of a cell from its
parameters and a seed, through the traffic kind the mix names.

A traffic kind is a file of its own, ``kinds/<kind>.py``, found by the mix's
``kind``; it builds the program's objects, runs set-up and the window with
the helpers here, and judges what the window produced with the reference of
the core (``cores/<name>.py``) and of the absorber (``absorbers/<name>.py``)
the cell names. A kind's module gives ``run(cell, seed, seconds, trace, dev,
t_start) -> Run`` and ``control(cell, seed, dev, dtype) -> {number:
value}``.

Set-up makes the inputs, builds the program's objects and runs the
traffic's own shapes once (every kernel built, every plan uploaded); the
window then runs the traffic for ``seconds``. Afterwards the device's peak
memory is read, the program's state is freed, and the plain reference
judges what the window produced.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import time

import torch

from . import catalog
from .reference.linesum import in_cut_counts
from .trace import WINDOW_SPAN, TraceRecord, from_profiler

__all__ = ["Run", "run_cell", "control_readings", "judge", "m_of_peak", "period_error",
           "CONTROL_DTYPE"]

# the control's precision: the one below the configurations' float32
CONTROL_DTYPE = torch.bfloat16


@dataclasses.dataclass
class Run:
    """What a run measured, for the metric readers: the walls of the
    window's calls (or sweep periods), its units (calls, or sweep steps),
    its length, the set-up, the traced window (or None) and the work counts
    of the roofline readers."""

    params: dict
    kind: str
    setup_s: float
    window_s: float
    unit_s: list
    units: int
    attempted: int
    failed: int
    device: dict
    trace: TraceRecord | None = None
    work: dict = dataclasses.field(default_factory=dict)
    checks: dict = dataclasses.field(default_factory=dict)
    check_s: float = 0.0


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def tables(params):
    """The configuration's catalogs: ([(par, conc)], reference line table)."""
    cat = params["catalog"]
    pars = [(catalog.make_par(g["molecule"], g["lines"], cat["seed"] + g.get("seed_offset", 0)),
             g["conc"]) for g in cat["gases"]]
    tab = catalog.merge_tables([catalog.line_table(p, c) for p, c in pars])
    return pars, tab


def stellar(params, grid):
    """The stellar spectral flux at the top: the configuration's flux over
    cos(zenith), spread evenly over the grid's span."""
    st = params["star"]
    return st["flux_W_m2"] / math.cos(st["zenith"]) / float(grid[-1] - grid[0])


def linesum_work(tab, grid, cut: float, states: float) -> dict:
    """The line sum's work over ``states`` (T, P) states on ``grid``: the
    in-cut (line, state, point) triples, and the catalog's bytes read and
    the cross-sections' bytes written (float32)."""
    pairs = in_cut_counts(tab["nu"], grid, cut)
    return {"triples": float(pairs) * states,
            "bytes": float(len(tab["nu"]) * 8 * 4 + states * len(grid) * 4)}


class Profiler:
    """torch.profiler over the first ``seconds`` of a window, in memory; its
    own seconds count from the moment it is tracing (starting the profiler
    takes time of its own)."""

    def __init__(self, on: bool, seconds: float):
        self.on, self.seconds = on, seconds
        self.prof = self.span = None
        self.units = 0
        self.record = None
        self.t0 = 0.0

    def start(self):
        if not self.on:
            return
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.span = record_function(WINDOW_SPAN)
        self.span.__enter__()
        self.t0 = time.perf_counter()

    def tick(self):
        """One unit done; stop once the traced part of the window is over."""
        if self.prof is None:
            return
        self.units += 1
        if time.perf_counter() - self.t0 >= self.seconds:
            self.stop()

    def stop(self):
        if self.prof is None:
            return
        self.span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.record = from_profiler(self.prof, self.units)
        self.prof = None


def window(seconds: float, step, profiler: Profiler):
    """Run ``step(i)`` until ``seconds`` have passed, once at least; (walls,
    window s). A traced window starts its profiler first."""
    walls = []
    profiler.start()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    i = 0
    while True:
        ts = time.perf_counter()
        if ts >= deadline and i:
            break
        step(i)
        te = time.perf_counter()
        walls.append(te - ts)
        profiler.tick()
        i += 1
    length = time.perf_counter() - t0
    profiler.stop()
    return walls, length


def device_info(dev) -> dict:
    if dev.type == "cuda":
        return dict(platform="gpu", kind=torch.cuda.get_device_name(dev), count=1,
                    memory_peak_bytes=int(torch.cuda.max_memory_allocated(dev)))
    return dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=0)


def free(dev):
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- the judge

def m_of_peak(pairs) -> float:
    """The largest gap between the judged and the reference spectra, each
    call's over the peak of its reference: ``pairs`` of tensors [calls,
    levels, K] (judged, reference)."""
    err = 0.0
    for got, ref in pairs:
        got, ref = got.double().cpu(), ref.double().cpu()
        peak = ref.abs().amax(dim=(1, 2))
        err = max(err, float(((got - ref).abs().amax(dim=(1, 2)) / peak).max()))
    return err


def period_error(got, ref, start) -> float:
    """The largest gap between the judged and the reference temperatures
    after a period, over the checked columns' cells, in units of the largest
    change the reference makes over the period (a state left unchanged
    reads 1)."""
    got, ref, start = (torch.as_tensor(x, dtype=torch.float64).cpu() for x in (got, ref, start))
    return float((got - ref).abs().max() / (ref - start).abs().max())


def judge(values: dict, limits: dict, failed: int = 0, attempted: int = 1):
    """(correct, checks): every number compared beside its limit, and
    whether each is within it with nothing failed and something attempted.
    A number that is not finite is not within its limit."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in values.items()}
    correct = (all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                   for c in checks.values()) and failed == 0 and attempted > 0)
    return bool(correct), checks


# ---------------------------------------------------------------- entry

def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device, t_start: float) -> Run:
    """One run of a cell (as ``registry.cell`` gives it): set-up, the window,
    the check, by the cell's traffic kind."""
    return cell["plugins"]["kind"].run(cell, seed, seconds, trace, torch.device(device), t_start)


def control_readings(cell: dict, seed: int, device) -> dict:
    """The control's verdict on the inputs a run of ``seed`` checks: the
    reference computed in ``CONTROL_DTYPE`` put in the program's place,
    judged as a run is judged. {"correct", "checks"}."""
    values = cell["plugins"]["kind"].control(cell, seed, torch.device(device), CONTROL_DTYPE)
    correct, checks = judge(values, cell["params"]["check"]["limits"])
    return {"correct": correct, "checks": checks}

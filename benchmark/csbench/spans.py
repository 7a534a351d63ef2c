"""The program's own spans and counters (``clearsky_tpu_torch.utils.profiling``)
as the per-layer readers take them: the registry's snapshot (span device ms,
counters), and the program's ``cs.*`` host spans in a traced window joined
with the device intervals on the profiler's clock. A program without them
(a tree older than its registry) reads None, not an error.

In a benchmark process the program records spans and its kernels' counts
only while the profiler records, so the registry covers the traced window's
units, the ``units`` of ``run.trace``.
"""

from __future__ import annotations

import numpy as np

from .trace import _union

__all__ = ["snapshot", "span_ms", "counter", "host_intervals", "idle_us_inside"]


def snapshot():
    """The program's registry (``{"counters", "spans"}``), or None where the
    program has none."""
    try:
        from clearsky_tpu_torch.utils.profiling import snapshot as program_snapshot
    except ImportError:
        return None
    return program_snapshot()


def _traced(run) -> bool:
    return run.trace is not None and run.trace.units > 0


def span_ms(run, name: str, key: str = "device_ms"):
    """A span's ``key`` ("device_ms" or "self_device_ms") a unit of the
    traced window, None where the run recorded no such span on the card."""
    if not _traced(run):
        return None
    snap = snapshot()
    got = None if snap is None else snap["spans"].get(name)
    if not got or got.get(key) is None:
        return None
    return got[key] / run.trace.units


def counter(run, name: str):
    """A counter's count over the traced window (None where the program has
    no such counter or it read 0)."""
    if not _traced(run):
        return None
    snap = snapshot()
    got = None if snap is None else snap["counters"].get(name)
    return got or None


def host_intervals(rec, name: str) -> list:
    """The host spans named ``name`` of a trace record, clipped to its window
    [(start, end) us]."""
    lo, hi = rec.window
    return [(max(s, lo), min(e, hi)) for n, s, e in rec.host
            if n == name and e > lo and s < hi]


def idle_us_inside(rec, intervals) -> float:
    """The device's idle time inside ``intervals`` [us]: their length less
    the union of the device operations' intervals within them."""
    busy = np.array(_union([(s, e) for _, s, e in rec.device]), dtype=np.float64).reshape(-1, 2)
    idle = 0.0
    for a, b in intervals:
        covered = np.minimum(busy[:, 1], b) - np.maximum(busy[:, 0], a)
        idle += (b - a) - float(covered[covered > 0].sum())
    return idle

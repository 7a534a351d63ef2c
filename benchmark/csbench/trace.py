"""The profiler's record of a traced window, reduced to what the per-layer
readers take: device intervals by name, host spans, the window, and the
idle gaps between device work labelled by what the host was doing."""

from __future__ import annotations

import dataclasses
import re

import numpy as np

__all__ = ["WINDOW_SPAN", "TraceRecord", "from_profiler", "busy_us", "breakdown"]

WINDOW_SPAN = "bench.window"


@dataclasses.dataclass
class TraceRecord:
    """Device operations (name, start, end) and host spans (name, start,
    end) in microseconds of the profiler's clock; ``window`` the traced
    window's (start, end); ``units`` the calls or steps it holds."""

    device: list
    host: list
    window: tuple
    units: int

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def device_us(self, pattern: str | None = None, exclude: str | None = None) -> float:
        """Summed duration of the device operations whose name matches
        ``pattern`` (all with None) and not ``exclude``."""
        inc = re.compile(pattern) if pattern else None
        exc = re.compile(exclude) if exclude else None
        return sum(e - s for n, s, e in self.device
                   if (inc is None or inc.search(n)) and not (exc and exc.search(n)))


def from_profiler(prof, units: int) -> TraceRecord:
    """The record of a ``torch.profiler.profile`` whose traced work ran
    inside a ``record_function(WINDOW_SPAN)``."""
    import torch

    device, host, window = [], [], None
    for e in prof.events():
        span = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.name == WINDOW_SPAN:
            # the host's span (the device's copy of the annotation is no operation)
            if e.device_type != torch.autograd.DeviceType.CUDA:
                window = span[1:]
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            device.append(span)
        else:
            host.append(span)
    if window is None:
        raise RuntimeError(f"the profile holds no {WINDOW_SPAN} span")
    device = [(n, max(s, window[0]), min(e, window[1])) for n, s, e in device
              if e > window[0] and s < window[1]]
    return TraceRecord(device=device, host=host, window=window, units=units)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    return sum(b - a for a, b in _union(intervals))


def short_name(name: str, width: int = 120) -> str:
    """A device operation's name without its return type, anonymous
    namespace and argument list, at most ``width`` characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i:
            name = name[:i]
            break
    return name[:width].strip()


def breakdown(rec: TraceRecord, n: int = 10) -> dict:
    """The ``n`` device operations that took most time [s], and the ``n``
    longest idle gaps of the device [s], each named by the innermost host
    span at its middle."""
    per = {}
    for name, s, e in rec.device:
        name = short_name(name)
        per[name] = per.get(name, 0.0) + (e - s) * 1e-6
    ops = sorted(per.items(), key=lambda kv: -kv[1])[:n]
    busy = _union([(s, e) for _, s, e in rec.device])
    edges = [rec.window[0]] + [x for iv in busy for x in iv] + [rec.window[1]]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
    if rec.host:
        names = [h[0] for h in rec.host]
        hs = np.array([h[1] for h in rec.host])
        he = np.array([h[2] for h in rec.host])
    idle = []
    for a, b in gaps:
        label = "host"
        if rec.host:
            mid = 0.5 * (a + b)
            inside = np.nonzero((hs <= mid) & (he >= mid))[0]
            if len(inside):
                label = names[inside[np.argmin((he - hs)[inside])]]
        idle.append([label, (b - a) * 1e-6])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": idle}

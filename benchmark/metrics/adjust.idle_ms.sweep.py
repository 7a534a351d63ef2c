"""adjust.idle_ms.sweep: device ms a sweep step in which the device is idle
while the host is inside the convective adjustment (the program's host span
``cs.adjust``: a host loop over the levels), from the traced window."""

from csbench import spans


def read(run):
    if run.trace is None or run.kind != "sweep" or not run.trace.units:
        return None
    inside = spans.host_intervals(run.trace, "cs.adjust")
    if not inside:
        return None
    return spans.idle_us_inside(run.trace, inside) / 1e3 / run.trace.units

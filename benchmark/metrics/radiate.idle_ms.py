"""radiate.idle_ms: device ms a call in which the device is idle while the
host is inside ``radiate`` (the program's host span ``cs.radiate``), from
the traced window."""

from csbench import spans


def read(run):
    if run.trace is None or run.kind != "column_calls" or not run.trace.units:
        return None
    inside = spans.host_intervals(run.trace, "cs.radiate")
    if not inside:
        return None
    return spans.idle_us_inside(run.trace, inside) / 1e3 / run.trace.units

"""radiate.host_ms: host ms a call inside ``radiate`` (the program's host
span ``cs.radiate``, clipped to the traced window): the call less the
benchmark's own loop and the fluxes' copy to the host."""

from csbench import spans


def read(run):
    if run.trace is None or run.kind != "column_calls" or not run.trace.units:
        return None
    inside = spans.host_intervals(run.trace, "cs.radiate")
    if not inside:
        return None
    return sum(b - a for a, b in inside) / 1e3 / run.trace.units

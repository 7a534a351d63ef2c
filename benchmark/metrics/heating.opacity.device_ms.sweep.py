"""heating.opacity.device_ms.sweep: device ms a sweep step of the heating's
opacity (the program's span ``cs.heating.opacity``: node temperatures, the
cache's node sigma and the layer optical depth)."""

from csbench import spans


def read(run):
    return spans.span_ms(run, "cs.heating.opacity") if run.kind == "sweep" else None

"""heating.spectral.device_ms.sweep: device ms a sweep step of the heating's
spectral part (the program's span ``cs.heating.spectral``: the heating
operator, its full-float32 product with the net flux, the spectral sum)."""

from csbench import spans


def read(run):
    return spans.span_ms(run, "cs.heating.spectral") if run.kind == "sweep" else None

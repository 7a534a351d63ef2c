"""radau.assembly.device_ms: device ms a call of the Radau core's flux
assembly around its legs (the self time of the program's span
``cs.radau.monoflux``: Planck at the levels, the stream sums, the beam's
exp, flip and cat; the legs are its children)."""

from csbench import spans


def read(run):
    if run.kind != "column_calls":
        return None
    return spans.span_ms(run, "cs.radau.monoflux", "self_device_ms")

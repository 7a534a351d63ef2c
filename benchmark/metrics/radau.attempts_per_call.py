"""radau.attempts_per_call: the Radau kernel's lane-attempts a call (accepted
and rejected steps of every lane of every leg), as the kernel counts them
itself (``radau.attempts``, summed a warp at a time while traced)."""

from csbench import spans


def read(run):
    if run.kind != "column_calls":
        return None
    n = spans.counter(run, "radau.attempts")
    return None if n is None else n / run.trace.units

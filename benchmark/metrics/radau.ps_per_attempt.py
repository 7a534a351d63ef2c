"""radau.ps_per_attempt: the Radau kernel's device ps a lane-attempt: its
device time in the traced window over the attempts it counted there
(``radau.attempts``)."""

from csbench import spans

KERNELS = r"radau_kernel"


def read(run):
    if run.kind != "column_calls":
        return None
    n = spans.counter(run, "radau.attempts")
    us = run.trace.device_us(KERNELS) if n else 0.0
    return us * 1e6 / n if us > 0 else None

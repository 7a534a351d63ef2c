"""radau.device_ms: device ms a call of the adaptive Radau kernel
(``csrc/radau.cu``: the emission and depth legs), from the traced window."""

KERNELS = r"radau_kernel"


def read(run):
    if run.trace is None or run.kind != "column_calls":
        return None
    us = run.trace.device_us(KERNELS)
    return us / 1e3 / run.trace.units if us > 0 else None

"""linesum.device_ms: device ms a call of the line-sum kernels
(``csrc/linesum.cu``: K1's modes, the window kernel's, the near-core
correction), from the traced window."""

KERNELS = r"linesum_kernel|window_kernel|correction_gather_kernel"


def read(run):
    if run.trace is None or run.kind != "column_calls":
        return None
    us = run.trace.device_us(KERNELS)
    return us / 1e3 / run.trace.units if us > 0 else None

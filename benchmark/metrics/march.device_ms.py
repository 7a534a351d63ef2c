"""march.device_ms: device ms a call of the march kernels (``csrc/march.cu``:
K2's olr_kernel and K3's monoflux_kernel), from the traced window."""

KERNELS = r"(?<!fused_)(?:olr_kernel|monoflux_kernel)"


def read(run):
    if run.trace is None or run.kind != "column_calls":
        return None
    us = run.trace.device_us(KERNELS)
    return us / 1e3 / run.trace.units if us > 0 else None

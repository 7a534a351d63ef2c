"""march.device_ms.sweep: device ms a sweep step of the march kernel K3
(``monoflux_kernel``, the columns folded into its lanes)."""

KERNELS = r"(?<!fused_)(?:olr_kernel|monoflux_kernel)"


def read(run):
    if run.trace is None or run.kind != "sweep":
        return None
    us = run.trace.device_us(KERNELS)
    return us / 1e3 / run.trace.units if us > 0 else None

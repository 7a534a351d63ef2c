"""linesum.device_ms.sweep: device ms a sweep step of the line-sum kernels
(the refresh's, once a period, averaged over the period's steps)."""

KERNELS = r"linesum_kernel|window_kernel|correction_gather_kernel"


def read(run):
    if run.trace is None or run.kind != "sweep":
        return None
    us = run.trace.device_us(KERNELS)
    return us / 1e3 / run.trace.units if us > 0 else None

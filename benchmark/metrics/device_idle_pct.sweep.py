"""device_idle_pct.sweep: the share of the traced sweep window in which no
operation ran on the device [%]."""

from csbench.trace import busy_us


def read(run):
    if run.trace is None or run.kind != "sweep" or not run.trace.device:
        return None
    busy = busy_us([(s, e) for _, s, e in run.trace.device])
    return 100.0 * (1.0 - busy / run.trace.window_us)

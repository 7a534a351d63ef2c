"""device_idle_pct.columns: the share of the traced window in which no
operation ran on the device [%], 1 - (union of device intervals) / window."""

from csbench.trace import busy_us


def read(run):
    if run.trace is None or run.kind != "column_calls" or not run.trace.device:
        return None
    busy = busy_us([(s, e) for _, s, e in run.trace.device])
    return 100.0 * (1.0 - busy / run.trace.window_us)

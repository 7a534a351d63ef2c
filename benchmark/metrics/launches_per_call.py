"""launches_per_call: device operations (kernels, copies, fills) a call in
the traced window."""


def read(run):
    if run.trace is None or run.kind != "column_calls" or not run.trace.device:
        return None
    return len(run.trace.device) / run.trace.units

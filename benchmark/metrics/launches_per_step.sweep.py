"""launches_per_step.sweep: device operations (kernels, copies, fills) a
sweep step in the traced window."""


def read(run):
    if run.trace is None or run.kind != "sweep" or not run.trace.device:
        return None
    return len(run.trace.device) / run.trace.units

"""column_steps_per_s: column-steps of the sweep completed in the window over
the window's seconds (whole refresh periods, each ending in a synchronise)."""


def read(run):
    if run.kind != "sweep":
        return None
    return run.units * run.work["columns"] / run.window_s

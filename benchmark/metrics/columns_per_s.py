"""columns_per_s: column flux evaluations completed in the window over the
window's seconds (a closed loop of one client; a call ends when its band
fluxes reach the host)."""


def read(run):
    if run.kind != "column_calls":
        return None
    return run.units / run.window_s

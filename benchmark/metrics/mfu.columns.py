"""mfu.columns: the whole call's share of the card's peak [%]: the least time
of the work the benchmark counts in a call (the Radau lanes' steps and the
line sum's triples, as ``radau.roofline_pct`` and ``linesum.roofline_pct``
count them) over the call's wall time in the traced window. It bounds the
kernels' rooflines from the call's side: a kernel taken off the path leaves
its own roofline silent, not this."""

import importlib.util
from pathlib import Path

from csbench.peaks import least_seconds, peaks_for


def _sibling(name):
    path = Path(__file__).with_name(f"{name}.py")
    spec = importlib.util.spec_from_file_location("bench_mfu_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read(run):
    peaks = peaks_for(run.device.get("kind", ""))
    if run.trace is None or peaks is None or run.kind != "column_calls":
        return None
    w = run.work
    least = least_seconds(peaks, flop=w["linesum_triples_per_call"]
                          * _sibling("linesum.roofline_pct").FLOP_PER_TRIPLE,
                          nbytes=w["linesum_bytes_per_call"])
    steps = w.get("radau_steps_per_call")
    if steps:
        per = _sibling("radau.roofline_pct").PER_STEP
        least += least_seconds(peaks, flop=sum(steps[k] * per[k][0] for k in steps),
                               sfu=sum(steps[k] * per[k][1] for k in steps))
    return 100.0 * least / (run.trace.window_us * 1e-6 / run.trace.units)

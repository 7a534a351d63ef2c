"""linesum.roofline_pct: the line-sum kernels' share of their roofline [%]:
the least time for the line sum a call needs, over those kernels' device
time a call.

The work is counted by the benchmark from its own catalog, grid and the
core's states: every (line, state, point) triple within the cut, at 6 FP32
operations each, a floor of the far-wing form any route evaluates there
(the Lorentzian-like rational in dnu^2 on per-(state, line) coefficients,
its division and the accumulation; FMA as 2); bytes: the catalog read and
the cross-sections written once, in float32.
"""

from csbench.peaks import least_seconds, peaks_for

KERNELS = r"linesum_kernel|window_kernel|correction_gather_kernel"
FLOP_PER_TRIPLE = 6.0


def read(run):
    peaks = peaks_for(run.device.get("kind", ""))
    if run.trace is None or peaks is None or "linesum_triples_per_call" not in run.work:
        return None
    us = run.trace.device_us(KERNELS)
    if us <= 0:
        return None
    least = least_seconds(peaks, flop=run.work["linesum_triples_per_call"] * FLOP_PER_TRIPLE,
                          nbytes=run.work["linesum_bytes_per_call"])
    return 100.0 * least / (us * 1e-6 / run.trace.units)

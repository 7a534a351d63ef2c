"""radau.roofline_pct: the Radau kernel's share of its roofline [%]: the least
time the card could take for the work, over the kernel's device time a call.

The work is the algorithm's, not a design's: the accepted steps an
error-controlled Radau IIA(5) integration of each lane needs at the
program's tolerance, as the benchmark's reference counts them on its sampled
lanes, scaled to all lanes of a call; times a per-step count of what any
implementation must compute in a step:

* emission (dI/dx = rate (B - I)): three stage evaluations, each ln P of the
  abscissa (a log2), exp of the interpolated ln sigma and of the Planck
  exponent, and one reciprocal (of mu T (1 - e^-x) together): 4 special-
  function results a stage, 12 a step; FP32: the stages' interpolation,
  rate and Planck products (~20 operations each), two simplified Newton
  iterations in the eigenbasis of the collocation matrix (~40 each), the
  error estimate and the step controller (~30): 150 a step;
* depth (dtau/dx = rate): a log2 and an exp a stage, 6 a step; FP32 90.

Bytes: the cache's ln sigma read once, and the levels' values written once.
Every count is a floor (FMA counted as 2 operations, special functions as
results), so the share reads low rather than above 100%.
"""

from csbench.peaks import least_seconds, peaks_for

KERNELS = r"radau_kernel"
PER_STEP = {"emission": (150.0, 12.0), "depth": (90.0, 6.0)}   # (FP32 operations, SFU results)


def read(run):
    peaks = peaks_for(run.device.get("kind", ""))
    steps = run.work.get("radau_steps_per_call")
    if run.trace is None or peaks is None or not steps:
        return None
    us = run.trace.device_us(KERNELS)
    if us <= 0:
        return None
    flop = sum(steps[k] * PER_STEP[k][0] for k in steps)
    sfu = sum(steps[k] * PER_STEP[k][1] for k in steps)
    n_nu = run.params["points"]
    levels = run.params["atmosphere"]["levels"]
    lanes = run.work["radau_lanes_per_call"]
    nbytes = 4.0 * (run.work["linesum_states"] * n_nu + levels * sum(lanes.values()))
    least = least_seconds(peaks, flop=flop, sfu=sfu, nbytes=nbytes)
    return 100.0 * least / (us * 1e-6 / run.trace.units)

"""call_ms.p95: the 95th percentile of every call's wall time in the window
[ms] (numpy's linear interpolation between order statistics)."""

import numpy as np


def read(run):
    if run.kind != "column_calls" or not run.unit_s:
        return None
    return float(np.percentile(np.asarray(run.unit_s) * 1e3, 95))

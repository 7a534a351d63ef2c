"""radau.cache.device_ms: device ms a call of the Radau core's column cache
(the program's span ``cs.radau.cache``: the line sum of its 256 states, then
the log, clamp and where over ln sigma)."""

from csbench import spans


def read(run):
    return spans.span_ms(run, "cs.radau.cache") if run.kind == "column_calls" else None

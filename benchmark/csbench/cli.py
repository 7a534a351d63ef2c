"""The benchmark's command line: one cell, one seed, one run.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``
(``busy_s`` and ``window_s`` of the traced window with ``--trace 1``),
``breakdown`` with ``--trace 1``, and last ``checks``: every number the
check compared, with its limit (also the last lines of standard error).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import registry, workload
from .trace import breakdown, busy_us

__all__ = ["main", "execute", "FORBIDDEN"]

# top-level module names that may not be loaded in the process that prints
FORBIDDEN = ("jax", "jaxlib", "flax", "clearsky_tpu")


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _parse(argv):
    p = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def execute(cell: dict, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """Run the cell and assemble its result line (a dict, ``checks`` last)."""
    run = workload.run_cell(cell, seed, seconds, trace, device, t_start)
    correct, checks = workload.judge(run.checks, cell["params"]["check"]["limits"],
                                     run.failed, run.attempted)
    metrics = {}
    for m in (cell["per_layer"] if trace else cell["end_to_end"]):
        value = registry.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = dict(run.device)
    out = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        rec = run.trace
        device["busy_s"] = busy_us([(s, e) for _, s, e in rec.device]) * 1e-6
        device["window_s"] = rec.window_us * 1e-6
        out["breakdown"] = breakdown(rec)
    out["checks"] = checks
    print(f"run setup_s {run.setup_s!r} window_s {run.window_s!r} units {run.units} "
          f"reference_s {run.check_s!r} quarters {quarters(run.unit_s)}", file=sys.stderr)
    return out


def quarters(walls) -> list:
    """Calls (or periods) a second in each quarter of the window's calls, by
    their summed walls: a rate that falls over the window shows here."""
    n = len(walls) // 4
    if n == 0:
        return []
    return [round(n / sum(walls[i * n:(i + 1) * n]), 4) for i in range(4)]


def main(argv, t_start: float) -> int:
    args = _parse(argv)
    spec = registry.load_spec()
    cell = registry.cell(spec, args.workload)
    chips = int(cell["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", t_start)
    bad = forbidden_loaded()
    if bad:
        print(f"modules loaded that the benchmark may not load: {bad}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0

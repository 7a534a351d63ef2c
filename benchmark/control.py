#!/usr/bin/env python3
"""The control of a cell's check, at the cell's own size: the plain
reference computed in bfloat16 (the precision below the configurations'
float32) in the program's place, judged by the same judge as a run, on each
seed given. Prints one JSON line a seed: ``correct`` (false is what the
control has to read) and each number beside its limit.

    python3 benchmark/control.py --workload <name> --seeds 1 2 3

The benchmark's runs do not run it; ``tests/test_bench_control.py`` runs it
at a small size.
"""

import argparse
import json
import os
import sys

if __name__ == "__main__":
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [here, os.path.dirname(here)]
    import torch

    from csbench import registry, workload

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args()
    cell = registry.cell(registry.load_spec(), args.workload)
    dev = "cuda:0" if torch.cuda.is_available() else "cpu"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        got = workload.control_readings(cell, seed, dev)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "dtype": str(workload.CONTROL_DTYPE).removeprefix("torch."), **got}),
              flush=True)

#!/usr/bin/env python3
"""Run one cell of the benchmark once, from the root of a checkout:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

See ``benchmark/README.md``.
"""

import os
import sys
import time

T_START = time.perf_counter()

if __name__ == "__main__":
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    sys.path[:0] = [here, root]
    from csbench.cli import main

    sys.exit(main(sys.argv[1:], T_START))

"""The ``.par`` parsers' probe: the native C++ parser (``native``) beside
the numpy path (``spectra.par.parse_par_numpy``) on chip_smoke's mix
files, in host seconds.

    python3 clearsky_tpu_torch/tools/par_probe.py [--seed N] [--repeats R] [--dir DIR]

Writes the mix phase's two HITRAN files (40,000 synthetic CO2 and 20,000
H2O lines, seeds seed + 40 and seed + 41, as ``chip_smoke.phase_mix``
does) under DIR (default ``build/par_probe``), builds the native library
if it is not built (its build time reported apart), then times each
parser on each file R times (default 5) after one untimed call, and
``read_par(strings=False)`` as a whole, which takes the native parser
where it is built. One ``probe`` JSON line per (file, parser): the
median and least seconds, and whether the numeric columns agree exactly.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from clearsky_tpu_torch import native  # noqa: E402
from clearsky_tpu_torch.spectra import synthetic as syn  # noqa: E402
from clearsky_tpu_torch.spectra.par import parse_par_numpy, read_par  # noqa: E402

N_CO2, N_H2O = 40000, 20000   # chip_smoke's N_CO2_MIX, N_H2O_MIX
KEYS = ("M", "I", "nu", "S", "A", "ga", "gs", "Epp", "na", "da")


def timed(fn, repeats: int):
    fn()
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        ts.append(time.perf_counter() - t0)
    return out, statistics.median(ts), min(ts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--dir", default=os.path.join(ROOT, "build", "par_probe"))
    args = ap.parse_args(argv)
    os.makedirs(args.dir, exist_ok=True)
    paths = {"co2": os.path.join(args.dir, "co2.par"), "h2o": os.path.join(args.dir, "h2o.par")}
    syn.write_par(paths["co2"], syn.synthetic_co2_par(N_CO2, seed=args.seed + 40))
    syn.write_par(paths["h2o"], syn.synthetic_h2o_par(N_H2O, seed=args.seed + 41))
    built = native.library_path().is_file()
    t0 = time.perf_counter()
    ok = native.native_available()
    print("probe " + json.dumps(dict(part="native_build", available=ok, already_built=built,
                                     seconds=time.perf_counter() - t0)))
    if not ok:
        return 1
    for name, path in paths.items():
        ref, med_np, min_np = timed(lambda: parse_par_numpy(path, strings=False), args.repeats)
        got, med_nat, min_nat = timed(lambda: native.parse_par_native(path), args.repeats)
        same = all(np.array_equal(ref[k], got[k]) for k in KEYS)
        _, med_rp, min_rp = timed(lambda: read_par(path, strings=False), args.repeats)
        for parser, med, least in (("numpy", med_np, min_np), ("native", med_nat, min_nat),
                                   ("read_par_strings_false", med_rp, min_rp)):
            print("probe " + json.dumps(dict(part="parse", file=name, lines=len(ref["nu"]),
                                             bytes=os.path.getsize(path), parser=parser,
                                             median_s=med, min_s=least, repeats=args.repeats,
                                             columns_equal=same)))
        print("probe " + json.dumps(dict(part="speedup", file=name,
                                         numpy_over_native=med_np / med_nat)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

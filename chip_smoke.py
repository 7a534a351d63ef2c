#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N]

Run from the repository root on a machine with a CUDA card, nvcc and PyTorch
built for CUDA. The first run compiles the kernels of
``clearsky_tpu_torch/csrc`` into ``build/clearsky_tpu_torch/``. Each phase
prints one line that starts with its name:

  env     card name and power limit (nvidia-smi), torch and CUDA versions,
          the TF32 flags (both set False: the float32 matrix products stay
          float32)
  build   seconds to build (or load) the kernel libraries
  kernel  one line per kernel and mode: the float32 kernel against its plain
          PyTorch version in float64 on the same inputs (error and bar), the
          median time of kernel and plain float32 version (CUDA events), and
          the kernel's bound (the least time the card could take for the same
          work: the larger of the bytes moved at 3.35 TB/s and the FP32
          operations at 67 TFLOP/s, counted on this run's data). K1's split
          mode at 16 states x 2^15 points and at the main path's shape; the
          stencil-near route's FARALL mode and correction at the RCM's shape
          (20 edge states x 16,384 points); the coarse-far route's COARSE and
          FINE_STENCIL modes and weighted correction at the main shape (57
          Lobatto states x 2^19 points), its FINE mode at 57 x 2^20
  routes  the line sum through each route at the main shape (grouped,
          stencil, coarse) and at the RCM's (grouped, stencil): CUDA-event
          ms per call of sigma_from_lines_auto (first to last launch, host
          gaps included; ``profile`` has the device's busy time), the
          kernel launches by mode, the
          error against the float64 exact line sum at the JAX package's bars
          for that route (for the stencil-based routes at least twice their
          plain float32 version's error, which the region-1 pole sets at low
          pressure), and the route "auto" takes
  main    the full-size main path (synthetic 5,599-line CO2 catalog built
          with the constructors' defaults, float32 on the card; 2^19 points,
          20 levels, 5 streams): outgoing and radiate on the "auto" route,
          outgoing on "grouped" (band OLR within 1e-4 of auto's), and
          outgoing at 2^20 points (where the stencil geometry rejects and
          the coarse route's fine pass runs in the kernel)
  counts  the kernels' launch counts over each part of the main path:
          ``main`` (the calls above) and ``rcm`` (RCM.create and
          3 x (update_absorber, step) at 16,384 points)
  rcm     milliseconds of each of those steps (the first one cold), and
          the heating of the last state against the plain float64 version
  sanity  a near-transparent and a gray column through the OLR kernel
  table   the baked-table path at the main path's width: the bake of a Gas
          (12 T x 24 ln P domain, 18 line sums of 16 states on the coarse
          route: seconds and launches by mode) and its split_precision(16);
          the fused kernels K6 (outgoing's 57 Lobatto nodes) and K7
          (radiate's 38) against their plain float64 versions on the same
          split operands; outgoing and radiate on the split Gas through the
          entry points (wall time, and the launch counts of that path: only
          K6 and K7); the table band OLR against the DirectGas one of
          ``main``; a split Gas beside a gray gas, which takes the unfused
          route (raw_sigma, K2)
  mix     HITRAN files at full-catalog size: co2.par (40,000 synthetic CO2
          lines), h2o.par (20,000 H2O lines) and CO2-CO2.cia, written from
          the seed and read back by the port's readers; the MultiGas (CO2 at
          4e-4, H2O through fC(T, P)) on 2^19 points over 10-3000 cm^-1 and
          the main column's 57 states, whose route auto must take
          segmented (route, segments, pack bytes, budget); ``kernel`` lines
          for K1-seg on the mix and K4 (lane) and K5 (gathered) on its CO2
          catalog at 4 states and at the main path's 57 (K1-seg's 8 state
          tiles, K5's 19 groups of 3 states); outgoing and radiate on
          (MultiGas, CIA) and outgoing without the CIA (only K1-seg and
          K2/K3 launch); the RCM
          on the mix at 16,384 points (the route auto prints there, and K3;
          heating against the float64 version); outgoing on the CO2 catalog
          with strategy "lane" and "gathered" (their kernel and K2 only,
          band OLR within 1e-4 of auto's); the CIA in float32 against
          float64, and its share of outgoing (the host bind at the stack's
          creation, the pair's sigma on the card); and ms per call of the default segmented route, one K1
          launch over the whole catalog and the coarse route at the mix
          shape
  phco2   the dense-CO2 column (the sub-Lorentzian phco2 line shape, cut 500
          cm^-1) at the production shape: ``kernel`` lines for each phco2
          instance where the main path runs it (the split mode, COARSE,
          FINE_STENCIL and the chi correction at 57 states x 2^19, FINE at
          57 x 2^20), and for FARALL, K1-seg, K4 and K5 at 16 states x
          2^15, each against its float64 plain version (on a sample of
          blocks that holds the band centres where the whole grid would take
          minutes); outgoing and radiate on "auto" (the coarse route) and
          outgoing on "grouped" and at 2^20 (only phco2 instances and K2/K3
          launch; band OLR of grouped and auto within 1e-4); the strategies'
          entry points at 2^15; the bake of a phco2 Gas; and outgoing on a
          voigt_ref DirectGas against float64
  rce     RCM.create on the phco2 DirectGas at 16,384 points, 20 edge levels,
          radmul 2, from a dry adiabat (285 K, Tstrat 160 K), then run for 60
          hourly steps (refresh every 6, adjustment every step, records every
          10): ms per step cold and warm, the refresh route and launch
          counts, each record's heating and temperatures against the same
          run in float64, and step_n against three steps
  profile for each main-path, table-path, route and mix call, its unprofiled
          wall time beside the device time that torch.profiler traces (CUDA
          activity), each kernel's share (K1 by mode) and the device's idle
          share, 1 - device / wall; it runs after the launch counts are read

Then the card's name and power limit, one JSON line ``{"kernels": [...]}``
and, last, the line ``{"ok": true, "device": {...}}``. Any failed check
raises, and the script exits non-zero; it exits non-zero without printing a
result when no CUDA device is present.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_LINES = 5599
N_NU_MAIN = 2**19
N_NU_FINE = 2**20
N_NU_KERNEL = 2**15
N_STATES_KERNEL = 16
N_NU_RCM = 16384
N_LEVELS = 20
G, MU, CP, PS, PT = 9.8, 0.044, 850.0, 1e5, 10.0
CONC = 0.95
RCM_DT = 3600.0  # s
# the mix: HITRAN-format files of synthetic CO2 and H2O lines and a CO2-CO2
# continuum, merged on 2^19 points over 10-3000 cm^-1 (lines read within
# the cut of that range)
N_CO2_MIX, N_H2O_MIX = 40000, 20000
MIX_NU = (10.0, 3000.0)
MIX_CO2 = 4e-4
N_MIX_KERNEL_STATES = 4
_LINESUM = "clearsky_tpu_torch/csrc/linesum.cu"
_PALLAS = "clearsky_tpu/ops/linesum_pallas.py"
KERNELS = {
    "linesum": (_LINESUM, f"{_PALLAS}:223"),                 # split mode
    "linesum_farall": (_LINESUM, f"{_PALLAS}:451"),          # wmode farall
    "linesum_fine": (_LINESUM, f"{_PALLAS}:427"),            # wmode fine
    "linesum_fine_stencil": (_LINESUM, f"{_PALLAS}:459"),    # wmode fine_stencil
    "linesum_coarse": (_LINESUM, f"{_PALLAS}:478"),          # wmode coarse
    "stencil_correction": (_LINESUM, f"{_PALLAS}:1233"),     # _stencil_apply
    "linesum_segmented": (_LINESUM, f"{_PALLAS}:658"),       # K1-seg, _pallas_sigma_segmented
    "linesum_lane": (_LINESUM, f"{_PALLAS}:1473"),           # K4, _kernel_resident
    "linesum_gathered": (_LINESUM, f"{_PALLAS}:1517"),       # K5, _kernel
    "olr_march": ("clearsky_tpu_torch/csrc/march.cu", "clearsky_tpu/rt/march_pallas.py:158"),
    "monoflux_march": ("clearsky_tpu_torch/csrc/march.cu", "clearsky_tpu/rt/march_pallas.py:94"),
    "fused_olr": ("clearsky_tpu_torch/csrc/fused_table.cu", "clearsky_tpu/rt/fused_table.py:74"),
    "fused_monoflux": ("clearsky_tpu_torch/csrc/fused_table.cu",
                       "clearsky_tpu/rt/fused_table.py:94"),
    # the phco2 family's instances (chi on y: the phco2 far tile :349, tile_near :315)
    "linesum_phco2": (_LINESUM, f"{_PALLAS}:223"),             # split mode
    "linesum_phco2_farall": (_LINESUM, f"{_PALLAS}:451"),
    "linesum_phco2_fine": (_LINESUM, f"{_PALLAS}:427"),
    "linesum_phco2_fine_stencil": (_LINESUM, f"{_PALLAS}:459"),
    "linesum_phco2_coarse": (_LINESUM, f"{_PALLAS}:478"),
    "stencil_correction_phco2": (_LINESUM, f"{_PALLAS}:1233"),
    "linesum_phco2_segmented": (_LINESUM, f"{_PALLAS}:658"),
    "linesum_phco2_lane": (_LINESUM, f"{_PALLAS}:1473"),
    "linesum_phco2_gathered": (_LINESUM, f"{_PALLAS}:1517"),
}
# K1's template modes (csrc/linesum.cu ``Mode``) by the kernel names above
MODE_KERNEL = {"voigt_split": "linesum", "farall": "linesum_farall", "fine": "linesum_fine",
               "fine_stencil": "linesum_fine_stencil", "coarse": "linesum_coarse",
               "segmented": "linesum_segmented", "lane": "linesum_lane",
               "gathered": "linesum_gathered", "phco2_split": "linesum_phco2",
               "phco2_farall": "linesum_phco2_farall", "phco2_fine": "linesum_phco2_fine",
               "phco2_fine_stencil": "linesum_phco2_fine_stencil",
               "phco2_coarse": "linesum_phco2_coarse",
               "phco2_segmented": "linesum_phco2_segmented", "phco2_lane": "linesum_phco2_lane",
               "phco2_gathered": "linesum_phco2_gathered"}
PHCO2_KERNELS = {k for k in KERNELS if "phco2" in k}
LIBRARIES = ("linesum", "march", "fused_table")
TABLE_DOMAIN = ((150.0, 350.0), 12, (0.9 * PT, 1.01 * PS), 24)
TABLE_SPLIT = 16
# the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W), and
# its special-function units: 16 results (an exp2, a reciprocal) per SM and
# clock, 132 SMs at the 1,980 MHz boost clock
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12
MUFU_S = 16 * 132 * 1.98e9
# FP32 operations counted in csrc/linesum.cu, a division as one: per
# (point, line) pair the two-float dnu, |dnu|, D and the masks; per state
# the region-1 tile and its accumulation; a smoothstep; and Re w(x + iy)
# by region (the common t and t^2, then regions 1-4, the small-y repair)
PAIR_OPS, R1_OPS, SMOOTH_OPS = 6, 9, 10
W4_COMMON, W4_REGION, W4_SMALL_Y = 9, (14, 28, 76, 116), 25
CORRECTION_OPS = 22   # x, the explicit region 1, the product, the atomic add
# the phco2 family: per pair the selection of chi's piece; per state the
# explicit region 1 on (dnu ia, y0 chi), and chi's exponent with expf's FP32
# part (its exp2 counts against the special-function units, per state and
# pair beyond 3 cm^-1, where chi is not 1)
PH_PAIR_OPS, PH_R1_OPS, CHI_OPS = 3, 18, 10
# the dense-CO2 (phco2) column: phco2's default cut, the dry adiabat of a
# 285 K surface, and a radiative-convective run of 60 hourly steps with a
# refresh every 6 and an adjustment every step, recorded every 10
PHCO2_CUT, TS_RCE = 500.0, 285.0
RCE_STEPS, RCE_UPDATE, RCE_RECORD = 60, 6, 10
# synthetic_co2_par's band centres: the sampled blocks include them
BAND_CENTRES = (667.4, 961.0, 1063.7, 2349.1)
SAMPLE_STRIDE = 16


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str):
    if not ok:
        raise CheckFailed(what)


def emit(phase: str, **fields):
    print(f"{phase} " + json.dumps(fields, sort_keys=False), flush=True)


def cuda_ms(fn, n: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` over ``n`` CUDA-event-timed calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def one_call(fn):
    """(result, CUDA-event milliseconds) of one call of ``fn``."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    r = fn()
    b.record()
    b.synchronize()
    return r, a.elapsed_time(b)


def wall_ms(fn, n: int = 3) -> float:
    """Median host milliseconds per call of ``fn``, each ending in a synchronize."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def bound(ops: float, nbytes: float, exps: float = 0.0) -> dict:
    """The least time of a kernel's work: the largest of its FP32 operations
    at the card's peak, its exponentials at the special-function units'
    rate and its bytes (each input read once, each output written once) at
    its memory rate; ``bound_unit`` says which (fp32, sfu, hbm)."""
    t = {"fp32": 1e3 * ops / FP32_OPS_S, "sfu": 1e3 * exps / MUFU_S,
         "hbm": 1e3 * nbytes / HBM_BYTES_S}
    unit = max(t, key=t.get)
    return dict(bound_ms=t[unit], bound_by="bytes" if unit == "hbm" else "operations",
                bound_unit=unit, bound_ops=float(ops), bound_exps=float(exps),
                bound_bytes=float(nbytes))


def nbytes(*xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs)


def pairs_within(grid, pos, hi, lo=None) -> int:
    """(point, line) pairs with lo < |dnu| <= hi (numpy, float64)."""
    def upto(d):
        return int((np.searchsorted(pos, grid + d, side="right")
                    - np.searchsorted(pos, grid - d, side="left")).sum())
    return upto(hi) - (0 if lo is None else upto(lo))


def w4_ops(x, y) -> float:
    """FP32 operations of Re w(x + iy) over the elements of x, y, by region."""
    ax = x.abs()
    s = ax + y
    r1 = s >= 15.0
    r2 = ~r1 & (s >= 5.5)
    r3 = ~r1 & ~r2 & (y >= 0.195 * ax - 0.176)
    r4 = ~(r1 | r2 | r3)
    ops = W4_COMMON * x.numel() + W4_SMALL_Y * int((y < 0.01).sum())
    return float(ops + sum(c * int(m.sum()) for c, m in zip(W4_REGION, (r1, r2, r3, r4))))


def near_w4_ops(grid, pos, ia, y0, d_near: float, max_elems: int = 2**25, T=None) -> float:
    """Operations of the w4 tiles of the (point, line) pairs within d_near,
    for every state (ia, y0: [n_states, n_lines] on the card; with the
    states' temperatures ``T``, y = y0 chi(dnu, T) as the phco2 family has
    it), in runs of lines of at most ``max_elems`` (pair, state) elements."""
    lo = np.searchsorted(grid, pos - d_near, side="left")
    hi = np.searchsorted(grid, pos + d_near, side="right")
    csum = np.cumsum(hi - lo)
    per = max(1, max_elems // ia.shape[0])
    total, a = 0.0, 0
    while a < len(pos):
        before = int(csum[a - 1]) if a else 0
        b = max(a + 1, int(np.searchsorted(csum, before + per, side="right")))
        cnt = hi[a:b] - lo[a:b]
        line = np.repeat(np.arange(a, b), cnt)
        point = (np.arange(cnt.sum()) - np.repeat(np.cumsum(cnt) - cnt, cnt)
                 + np.repeat(lo[a:b], cnt))
        keep = np.abs(grid[point] - pos[line]) <= d_near
        line, dnu = line[keep], (grid[point] - pos[line])[keep]
        if line.size:
            dev = ia.device
            li = torch.as_tensor(line, device=dev)
            d = torch.as_tensor(dnu, dtype=torch.float32, device=dev)[None, :]
            x = d * ia[:, li]
            y = y0[:, li].expand_as(x)
            if T is not None:
                from clearsky_tpu_torch.ops.lineshape import chi_phco2

                y = y * chi_phco2(d, T[:, None])
            total += w4_ops(x, y) + 2.0 * x.numel()
        a = b
    return total


def column(Pe, Ts: float = 288.0):
    """Dry adiabat from a surface at Ts with a 160 K floor on the edge
    pressures Pe."""
    from clearsky_tpu_torch.constants import R_GAS

    return np.maximum(Ts * (Pe / PS) ** (R_GAS / (MU * CP)), 160.0)


def grid_for(lines, n):
    nu64 = lines.positions64()
    return np.linspace(max(nu64.min() - 25.0, 1.0), nu64.max() + 25.0, n)


def counts_reset():
    """Set every kernel wrapper's launch count to 0."""
    from clearsky_tpu_torch.ops.linesum_cuda import sigma_lines, stencil_correction
    from clearsky_tpu_torch.rt.march_cuda import olr_march, monoflux_march
    from clearsky_tpu_torch.rt.fused_table_cuda import fused_olr, fused_monoflux

    for w in (sigma_lines, stencil_correction, olr_march, monoflux_march, fused_olr,
              fused_monoflux):
        w.launches = 0
    stencil_correction.launches_phco2 = 0
    for k in sigma_lines.launches_by_mode:
        sigma_lines.launches_by_mode[k] = 0


def counts_read() -> dict:
    """Launches per kernel of ``KERNELS`` (K1 by mode) since the last reset."""
    from clearsky_tpu_torch.ops.linesum_cuda import sigma_lines, stencil_correction
    from clearsky_tpu_torch.rt.march_cuda import olr_march, monoflux_march
    from clearsky_tpu_torch.rt.fused_table_cuda import fused_olr, fused_monoflux

    out = {k: sigma_lines.launches_by_mode[m] for m, k in MODE_KERNEL.items()}
    out.update(stencil_correction=stencil_correction.launches,
               stencil_correction_phco2=stencil_correction.launches_phco2,
               olr_march=olr_march.launches,
               monoflux_march=monoflux_march.launches, fused_olr=fused_olr.launches,
               fused_monoflux=fused_monoflux.launches)
    return out


def phase_env(dev):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[dev.index or 0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card, flush=True)
    emit("env", nvidia_smi=card, name=torch.cuda.get_device_name(dev),
         torch=torch.__version__, cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    return card


def phase_build():
    """Build every library at once (one nvcc each), then load them."""
    from concurrent.futures import ThreadPoolExecutor
    from clearsky_tpu_torch.utils.cuda_build import build_library, load_library

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        list(pool.map(build_library, LIBRARIES))
    for name in LIBRARIES:
        load_library(name)
    emit("build", seconds=round(time.perf_counter() - t0, 3), libraries=list(LIBRARIES))


def cut_edges(plan, pos64):
    """Grid points with a line within two float32 roundings of the cut.

    The kernel and the plain float32 version decide |dnu| <= cut on a
    float32 dnu (ulp 1.9e-6 at 25 cm^-1), the float64 version on a float64
    one, so a line that close to the cut may count in one and not in the
    other. ``grid_for`` puts both end points of its grid on such a boundary.
    """
    tol = 2.0 * float(np.spacing(np.float32(plan.cut)))
    nu = plan.nu
    e = np.concatenate([pos64 - plan.cut, pos64 + plan.cut])
    k = np.searchsorted(nu, e)
    edge = np.zeros(len(nu), dtype=bool)
    for kk in (k - 1, k):
        ok = (kk >= 0) & (kk < len(nu))
        kk, ee = kk[ok], e[ok]
        edge[kk[np.abs(nu[kk] - ee) <= tol]] = True
    return edge


def at_edges(ref, ref32, edge):
    """The float64 reference with the plain float32 version at the cut edges."""
    e = torch.as_tensor(edge, device=ref.device)
    return torch.where(e, ref32.double(), ref)


def check_sigma(out, ref, edge=None, ref32=None):
    """max abs and max rel error of a float32 line sum against float64, and
    whether it holds the bar (rtol 2e-3 where |sigma| > 1e-35, atol 1e-32).

    At the grid points ``edge`` (see :func:`cut_edges`) the reference is the
    plain float32 version ``ref32``, which decides the cut as the kernel does.
    """
    if edge is not None:
        ref = at_edges(ref, ref32, edge)
    m = ref.abs() > 1e-35
    err = (out.double() - ref).abs()
    max_rel = float((err[m] / ref[m].abs()).max())
    ok = bool((err[m] <= 1e-32 + 2e-3 * ref[m].abs()).all()) and bool((err[~m] < 1e-30).all())
    return float(err.max()), max_rel, ok


def of_peak(out, ref) -> float:
    """max |out - ref| over each state's peak |ref|."""
    return float(((out.double() - ref).abs() / ref.abs().amax(dim=1, keepdim=True)).max())


def linesum_bytes(plan_points: int, n_lines: int, coef, win, n_states: int, n_out: int) -> int:
    """Bytes of one K1 launch: grid (two-float), line positions, pack and
    window table read once, sigma written once."""
    return 8 * plan_points + 8 * n_lines + nbytes(coef, win) + 4 * n_states * n_out


def kernel_linesum(par, seed, dev):
    """K1 against the plain line sum: voigt (split), lorentz, doppler (single sweep)."""
    from clearsky_tpu_torch.spectra.lines import SpectralLines
    from clearsky_tpu_torch.ops.linesum import build_line_window_plan, sigma_from_lines
    from clearsky_tpu_torch.ops.linesum_cuda import sigma_lines, _prepare

    l64 = SpectralLines.from_par_dict(par, dtype=torch.float64, device=dev)
    l32 = l64.to(torch.float32)
    nu = grid_for(l64, N_NU_KERNEL)
    plan = build_line_window_plan(nu, l64.positions64(), 25.0)
    rng = np.random.default_rng(seed + 1)
    T = rng.uniform(180.0, 300.0, N_STATES_KERNEL)
    P = np.geomspace(10.0, PS, N_STATES_KERNEL)
    args64 = [torch.tensor(x, dtype=torch.float64, device=dev) for x in (T, P, CONC * P)]
    args32 = [x.float() for x in args64]
    edge = cut_edges(plan, l64.positions64())
    for shape in ("voigt", "lorentz", "doppler"):
        out = sigma_lines(plan, l32, *args32, shape=shape)
        torch.cuda.synchronize()
        ref = sigma_from_lines(plan, l64, *args64, shape=shape)
        ref32 = sigma_from_lines(plan, l32, *args32, shape=shape)
        max_abs, max_rel, ok = check_sigma(out, ref, edge, ref32)
        # the kernel alone (operands prepared once), the wrapper with its
        # coefficient pack, and the plain float32 version
        ms = cuda_ms(_prepare(plan, l32, *args32, shape))
        wrapper_ms = cuda_ms(lambda: sigma_lines(plan, l32, *args32, shape=shape))
        plain_ms = cuda_ms(lambda: sigma_from_lines(plan, l32, *args32, shape=shape), n=10,
                           warmup=1)
        mode = "voigt_split" if shape == "voigt" else shape
        emit("kernel", kernel="linesum", mode=mode, points=N_NU_KERNEL,
             states=N_STATES_KERNEL, lines=l64.n_lines, max_abs_err=max_abs,
             max_rel_err=max_rel, bar="rtol 2e-3 where |sigma| > 1e-35 (atol 1e-32)",
             cut_edge_points=int(edge.sum()), ms=ms, wrapper_ms=wrapper_ms,
             plain_ms=plain_ms, plain_shape="same")
        check(ok, f"line-sum kernel ({mode}) disagrees with the plain version: "
                  f"max rel {max_rel:.3e}")


def main_states(dev, Ts: float = 288.0):
    """outgoing's 57 Lobatto-node states of the main column (surface at
    ``Ts``), float32 on the card."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.atmosphere.profile import formprofile
    from clearsky_tpu_torch.rt.discretized import lobatto_pressures

    Pe = ct.pressuregrid(PT, PS, N_LEVELS)
    Pg = torch.tensor(Pe, dtype=torch.float32, device=dev)
    Pf = lobatto_pressures(Pg, 3).reshape(-1)
    Tf = formprofile(Pg, column(Pe, Ts))(Pf)
    return Tf, Pf, CONC * Pf


def kernel_linesum_main_shape(par, dev, report):
    """K1's split mode at the main path's shape (outgoing's 57 Lobatto-node
    states, 2^19 points: 8 state tiles, the last with one real state)
    against the plain line sum on the same inputs: float64, and float32 at
    the cut edges. Returns what the later phases reuse: the catalogs, the
    plan, the states and the two references."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops.linesum import sigma_from_lines, voigt_coefficients, _line_params
    from clearsky_tpu_torch.ops.linesum_cuda import _prepare, pack_coefficients, MODES

    l64 = ct.SpectralLines.from_par_dict(par, dtype=torch.float64, device=dev)
    lines = l64.to(torch.float32)
    plan = ct.DirectGas.from_lines(lines, CONC, grid_for(lines, N_NU_MAIN)).plan
    states = main_states(dev)
    launch = _prepare(plan, lines, *states, "voigt")
    out = launch()
    torch.cuda.synchronize()
    args64 = [x.double() for x in states]
    ref, plain_f64_ms = one_call(lambda: sigma_from_lines(plan, l64, *args64, shape="voigt"))
    ref32, plain_ms = one_call(lambda: sigma_from_lines(plan, lines, *states, shape="voigt"))
    pos = lines.positions64()
    edge = cut_edges(plan, pos)
    max_abs, max_rel, ok = check_sigma(out, ref, edge, ref32)
    ms = cuda_ms(launch)
    n = int(states[0].shape[0])
    S, alpha, gamma = _line_params(lines, *states)
    ia, y0 = voigt_coefficients(S, alpha, gamma)[1:3]
    d_near = float(torch.clamp(15.0 * alpha.max(), max=plan.cut))
    pairs = pairs_within(plan.nu, pos, plan.cut)
    near = pairs_within(plan.nu, pos, d_near)
    ops = (pairs * PAIR_OPS + (pairs - near) * n * R1_OPS
           + near_w4_ops(plan.nu, pos, ia, y0, d_near))
    coef = pack_coefficients(MODES["voigt"], S, alpha, gamma)
    b = bound(ops, linesum_bytes(plan.n_blocks * plan.block, lines.n_lines, coef,
                                 plan.device_arrays(dev)["win"], n, plan.n_nu))
    emit("kernel", kernel="linesum", mode="voigt_split", points=N_NU_MAIN, states=n,
         lines=lines.n_lines, max_abs_err=max_abs, max_rel_err=max_rel,
         bar="rtol 2e-3 where |sigma| > 1e-35 (atol 1e-32)", cut_edge_points=int(edge.sum()),
         ms=ms, plain_ms_one_call=plain_ms, plain_f64_ms_one_call=plain_f64_ms,
         in_cut_pairs=pairs, near_pairs=near, plain_shape="same", **b)
    check(ok, f"line-sum kernel at the main-path shape disagrees with the plain version: "
              f"max rel {max_rel:.3e}")
    report["linesum"] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, library_ms=None,
                             shape=f"{n} states x {N_NU_MAIN} points", **b)
    return dict(l64=l64, lines=lines, plan=plan, states=states, ref=ref, ref32=ref32,
                edge=edge)


def _mode_operands(lines, states):
    """S, alpha, the voigt coefficients and the 7-value pack of the windowed modes."""
    from clearsky_tpu_torch.ops.linesum import voigt_coefficients, _line_params
    from clearsky_tpu_torch.ops.linesum_cuda import pack_coefficients, WINDOW_MODES

    S, alpha, gamma = _line_params(lines, *states)
    co = voigt_coefficients(S, alpha, gamma)
    return alpha, co, pack_coefficients(WINDOW_MODES["farall"], S, alpha, gamma)


def _windowed_line(name, mode, blocks64, windows, n_out, lines, l64, states, z, d_near,
                   pair_ops, n_points, report, extra=None):
    """One windowed K1 mode against its float64 plain version (of each
    state's peak, bar 1e-5: float32 accumulation), timed beside the plain
    float32 version, with its bound."""
    from clearsky_tpu_torch.ops import linesum_strategies as ls
    from clearsky_tpu_torch.ops.linesum import two_float
    from clearsky_tpu_torch.ops.linesum_cuda import launch_mode, WINDOW_MODES, _zones

    dev = states[0].device
    alpha, co, coef = _mode_operands(lines, states)
    _, co64, _ = _mode_operands(l64, [x.double() for x in states])
    hi, lo = two_float(blocks64)
    grid = {"nu_hi": torch.as_tensor(hi.reshape(-1), device=dev),
            "nu_lo": torch.as_tensor(lo.reshape(-1), device=dev),
            "win": torch.as_tensor(windows, dtype=torch.int32, device=dev)}
    n = int(states[0].shape[0])
    zones = _zones(**z)
    launch = lambda: launch_mode(WINDOW_MODES[mode], grid, lines, coef, n, n_out, zones,
                                 d_near)
    out = launch()
    torch.cuda.synchronize()
    d64 = None if d_near is None else d_near.double()
    ref = ls.sigma_mode_plain(mode, blocks64, windows, l64, co64, z, d64)[:, :n_out]
    err = of_peak(out, ref)
    max_abs = float((out.double() - ref).abs().max())
    del ref
    ms = cuda_ms(launch)
    plain = lambda: ls.sigma_mode_plain(mode, blocks64, windows, lines, co, z, d_near)
    plain_ms = cuda_ms(plain, n=3, warmup=1)
    b = bound(pair_ops(co), linesum_bytes(n_points, lines.n_lines, coef, grid["win"], n, n_out))
    emit("kernel", kernel=MODE_KERNEL[mode], mode=mode, points=n_out, states=n,
         lines=lines.n_lines, err_of_peak=err, max_abs_err=max_abs,
         bar="1e-5 of each state's peak", ms=ms, plain_ms=plain_ms, plain_shape="same",
         **(extra or {}), **b)
    check(bool(torch.isfinite(out).all()) and err < 1e-5,
          f"K1 mode {mode} off its float64 plain version by {err:.3e} of peak")
    report[name] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, library_ms=None,
                        shape=f"{n} states x {n_out} points", **b)
    return out


def _correction_line(name, geom, lines, l64, states, n_nu, peak, weight, report,
                     record=True):
    """The near-core correction against its float64 plain version, measured
    against each state's peak cross-section (bar 1e-4: float32 rounding
    next to the region-1 pole at x^2 = 1/2 + y^2, and atomic adds)."""
    from clearsky_tpu_torch.ops import linesum_strategies as ls
    from clearsky_tpu_torch.ops.linesum_cuda import stencil_correction

    dev = states[0].device
    _, co, _ = _mode_operands(lines, states)
    _, co64, _ = _mode_operands(l64, [x.double() for x in states])
    n = int(states[0].shape[0])
    launch = lambda: stencil_correction(torch.zeros((n, n_nu), device=dev), geom, co, 25.0,
                                        weight)
    out = launch()
    torch.cuda.synchronize()
    ref = ls.stencil_correction_plain(geom, co64, 25.0, n_nu, weight)
    err = float(((out.double() - ref).abs() / peak).max())
    max_abs = float((out.double() - ref).abs().max())
    del ref
    ms = cuda_ms(launch)
    plain_ms = cuda_ms(lambda: ls.stencil_correction_plain(geom, co, 25.0, n_nu, weight), n=3,
                       warmup=1)
    # the evaluations this run's data needs: x^2 <= 225 and |dnu_hi| <= cut
    # at points inside the grid
    hi = torch.as_tensor(geom.dnu_hi, device=dev)
    lo = torch.as_tensor(geom.dnu_lo, device=dev)
    q = torch.as_tensor(geom.q, device=dev)
    inside = ((q[None, :] * geom.K + torch.arange(2 * geom.K, device=dev)[:, None]) < n_nu) \
        & (hi.abs() <= 25.0)
    ops = 0.0
    for s in range(n):
        x = co[1][s][None, :] * hi + co[1][s][None, :] * lo
        m = inside & (x * x <= 225.0)
        ops += w4_ops(x[m], co[2][s].expand_as(x)[m]) + CORRECTION_OPS * int(m.sum())
    if weight is not None:
        ops += SMOOTH_OPS * int(inside.sum())
    # dnu hi and lo, the int32 rows, (Sia, ia, y0) read once; sigma read
    # and written once
    L = geom.q.shape[0]
    b = bound(ops, 8 * hi.numel() + 4 * L + 12 * n * L + 8 * n * n_nu)
    emit("kernel", kernel="stencil_correction", weighted=weight is not None, points=n_nu,
         states=n, lines=lines.n_lines, K=geom.K, err_of_peak_sigma=err, max_abs_err=max_abs,
         bar="1e-4 of each state's peak sigma", ms=ms, plain_ms=plain_ms, plain_shape="same",
         **b)
    check(bool(torch.isfinite(out).all()) and err < 1e-4,
          f"stencil correction off its float64 plain version by {err:.3e} of peak sigma")
    if record:
        report[name] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, library_ms=None,
                            shape=f"{n} states x {n_nu} points, K = {geom.K}", **b)


def kernel_stencil(par, dev, report):
    """The stencil-near route's kernels at the RCM's shape: FARALL and the
    correction for the 20 edge states of the column at 16,384 points."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops import linesum_strategies as ls
    from clearsky_tpu_torch.ops.linesum import sigma_from_lines

    l64 = ct.SpectralLines.from_par_dict(par, dtype=torch.float64, device=dev)
    lines = l64.to(torch.float32)
    plan = ct.DirectGas.from_lines(lines, CONC, grid_for(lines, N_NU_RCM)).plan
    check(ls.route(plan, lines) == "stencil", "the RCM grid does not take the stencil route")
    geom = ls.stencil_geometry(plan, lines)
    Pe = ct.pressuregrid(PT, PS, N_LEVELS)
    states = [torch.tensor(x, dtype=torch.float32, device=dev)
              for x in (column(Pe), Pe, CONC * Pe)]
    pos = lines.positions64()
    pairs = pairs_within(plan.nu, pos, plan.cut)
    n = len(Pe)
    out = _windowed_line("linesum_farall", "farall", plan.nu_blocks, plan.windows(), plan.n_nu,
                         lines, l64, states, {"cut": plan.cut}, None,
                         lambda co: pairs * (PAIR_OPS + n * R1_OPS),
                         plan.n_blocks * plan.block, report, dict(in_cut_pairs=pairs))
    # and at the bar of the grouped check, with the float32 reference at the cut edges
    _, co64, _ = _mode_operands(l64, [x.double() for x in states])
    _, co32, _ = _mode_operands(lines, states)
    ref = ls.sigma_mode_plain("farall", plan.nu_blocks, plan.windows(), l64, co64,
                              {"cut": plan.cut})[:, :plan.n_nu]
    ref32 = ls.sigma_mode_plain("farall", plan.nu_blocks, plan.windows(), lines, co32,
                                {"cut": plan.cut})[:, :plan.n_nu]
    _, max_rel, ok = check_sigma(out, ref, cut_edges(plan, pos), ref32)
    check(ok, f"K1 mode farall off its float64 plain version: max rel {max_rel:.3e}")
    exact = sigma_from_lines(plan, l64, *[x.double() for x in states])
    _correction_line("stencil_correction", geom, lines, l64, states, plan.n_nu,
                     exact.abs().amax(dim=1, keepdim=True), None, report, record=False)
    return dict(l64=l64, lines=lines, plan=plan, states=states, ref=exact,
                ref32=sigma_from_lines(plan, lines, *states), edge=cut_edges(plan, pos))


def kernel_coarse(ms_main, par, dev, report):
    """The coarse-far route's kernels: COARSE, FINE_STENCIL and the weighted
    correction at the main shape (57 states x 2^19), FINE at 57 x 2^20."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops import linesum_strategies as ls

    lines, l64, plan, states = (ms_main[k] for k in ("lines", "l64", "plan", "states"))
    pos = lines.positions64()
    n = int(states[0].shape[0])
    params = ls.coarse_params(plan, ls.AUTO_COARSE_FRAC)
    geom = ls.coarse_geometry(plan, lines, params)
    check(geom.stencil is not None, "the main grid's coarse route has no stencil fine pass")
    z = geom.zones
    d_far, h, n_cc, c_ratio = params
    cgrid = geom.coarse_blocks.reshape(-1)[:n_cc]
    coarse_pairs = pairs_within(cgrid, pos, z["cut"], z["d_lo"])
    _windowed_line("linesum_coarse", "coarse", geom.coarse_blocks, geom.coarse_windows, n_cc,
                   lines, l64, states, z, None,
                   lambda co: coarse_pairs * (PAIR_OPS + 2 * SMOOTH_OPS + n * (R1_OPS + 1)),
                   geom.coarse_blocks.size, report,
                   dict(coarse_points=n_cc, h=h, d_far=d_far, in_zone_pairs=coarse_pairs))
    mid = pairs_within(plan.nu, pos, z["cut_f"])
    ann = pairs_within(plan.nu, pos, z["cut"], math.sqrt(z["R1"]))
    _windowed_line("linesum_fine_stencil", "fine_stencil", geom.fine_blocks, geom.fine_windows,
                   plan.n_nu, lines, l64, states, z, None,
                   lambda co: (mid + ann) * (PAIR_OPS + SMOOTH_OPS + n * (R1_OPS + 1)),
                   geom.fine_blocks.size, report, dict(mid_pairs=mid, annulus_pairs=ann))
    peak = ms_main["ref"].abs().amax(dim=1, keepdim=True)
    _correction_line("stencil_correction", geom.stencil, lines, l64, states, plan.n_nu, peak,
                     (z["D1"], z["D2"]), report)

    # FINE: the in-kernel fine pass, where the stencil rejects (K > 64)
    plan20 = ct.DirectGas.from_lines(lines, CONC, grid_for(lines, N_NU_FINE)).plan
    check(ls.route(plan20, lines) == "coarse" and ls.stencil_geometry(plan20, lines) is None,
          "the 2^20 grid does not take the coarse route with the in-kernel fine pass")
    g20 = ls.coarse_geometry(plan20, lines, ls.coarse_params(plan20, ls.AUTO_COARSE_FRAC))
    z20 = g20.zones
    alpha, co, _ = _mode_operands(lines, states)
    from clearsky_tpu_torch.ops.linesum_cuda import near_distance

    d_near = near_distance(alpha, z20["cut_f"])
    dn = float(d_near)
    mid20 = pairs_within(plan20.nu, pos, z20["cut_f"])
    near20 = pairs_within(plan20.nu, pos, dn)
    ann20 = pairs_within(plan20.nu, pos, z20["cut"], math.sqrt(z20["R1"]))
    _windowed_line(
        "linesum_fine", "fine", g20.fine_blocks, g20.fine_windows, plan20.n_nu, lines, l64,
        states, z20, d_near,
        lambda co: ((mid20 + ann20) * (PAIR_OPS + SMOOTH_OPS) + (mid20 - near20 + ann20) * n
                    * (R1_OPS + 1) + near_w4_ops(plan20.nu, pos, co[1], co[2], dn)
                    + near20 * n * 2),
        g20.fine_blocks.size, report, dict(mid_pairs=mid20, near_pairs=near20,
                                           annulus_pairs=ann20, d_near=dn))


def phase_routes(data, strategies, expect_auto):
    """The line sum through each route of ``strategies`` on the catalog,
    plan and states of ``data``, against the float64 exact sum at the JAX
    package's bars for that route."""
    from clearsky_tpu_torch.ops import linesum_strategies as ls
    from clearsky_tpu_torch.ops.linesum import sigma_from_lines_auto

    lines, plan, states = data["lines"], data["plan"], data["states"]
    ref = at_edges(data["ref"], data["ref32"], data["edge"])
    pk = ref.abs().amax(dim=1, keepdim=True)
    # FARALL (and FINE_STENCIL's mid zone) add region 1 over each line's
    # core, where it has a pole at x^2 = 1/2 + y^2 of height Sia 0.2821 / y;
    # the correction takes it out again. In float32 the pole's position
    # rounds, and at the low-pressure states (10 Pa, y ~ 5e-3) that, not
    # the summation order, sets the error of both stencil-based routes. Their
    # of-peak bar is therefore at least twice the error of the route's own
    # plain float32 version against the same exact sum.
    def plain_err(fn):
        out, ms = one_call(fn)
        e = (((out.double() - ref).abs() / pk).amax(dim=1, keepdim=True), ms)
        del out
        return e

    plain = {}
    if "stencil" in strategies:
        plain["stencil"] = plain_err(lambda: ls.sigma_stencil_plain(plan, lines, *states))
    if "coarse" in strategies:
        coarse = ls._resolve(plan, lines, "voigt", "coarse")[1]
        plain["coarse"] = plain_err(lambda: ls.sigma_coarse_plain(plan, lines, *states, coarse))
    auto = ls.route(plan, lines)
    calls = {}
    grouped_err = None
    for strategy in strategies:
        check(ls.route(plan, lines, "voigt", strategy) == strategy,
              f"strategy {strategy} does not take its own route at the main shape")
        fn = lambda s=strategy: sigma_from_lines_auto(plan, lines, *states, strategy=s)
        counts_reset()
        out = fn()
        torch.cuda.synchronize()
        launches = {k: v for k, v in counts_read().items() if v}
        ms = cuda_ms(fn)
        err = (out.double() - ref).abs()
        rel = err / ref.abs().clamp(min=1e-300)
        e_state = (err / pk).amax(dim=1, keepdim=True)
        e_peak = float(e_state.max())
        bars = {}
        if strategy == "grouped":
            _, max_rel, ok = check_sigma(out, data["ref"], data["edge"], data["ref32"])
            grouped_err = e_peak
            bars["rtol 2e-3 where |sigma| > 1e-35"] = (max_rel, ok)
        elif strategy == "stencil":
            bar = torch.clamp(2.0 * plain[strategy][0], min=max(2.0 * grouped_err, 1e-6))
            bars["of peak < max(2 x grouped's, 1e-6, 2 x plain float32's)"] = (
                e_peak, bool((e_state < bar).all()))
            r2 = float(rel[ref.abs() > 1e-2 * pk].max())
            bars["rtol 2e-3 where |sigma| > 1e-2 peak"] = (r2, r2 < 2e-3)
            z = float(out.abs()[ref.abs() <= 1e-35].max()) if bool((ref.abs() <= 1e-35).any()) \
                else 0.0
            bars["|sigma| < 1e-30 where exact <= 1e-35"] = (z, z < 1e-30)
        else:
            r4 = float(rel[ref.abs() > 1e-4 * pk].max())
            r6 = float(rel[ref.abs() > 1e-6 * pk].max())
            N_col = 1e4 / pk
            dtr = torch.exp(-N_col * out.double()) - torch.exp(-N_col * ref)
            t_pt, t_band = float(dtr.abs().max()), float(dtr.mean(dim=1).abs().max())
            bars.update({"rel 2e-3 where |sigma| > 1e-4 peak": (r4, r4 < 2e-3),
                         "of peak < max(1e-5, 2 x plain float32's)": (
                             e_peak, bool((e_state < torch.clamp(2.0 * plain[strategy][0],
                                                                 min=1e-5)).all())),
                         "rel 5e-2 where |sigma| > 1e-6 peak": (r6, r6 < 5e-2),
                         "transmittance at peak tau 1e4 < 5e-3": (t_pt, t_pt < 5e-3),
                         "band mean transmittance < 1e-5": (t_band, t_band < 1e-5)})
        del out, err, rel
        emit("routes", strategy=strategy, auto_route=auto, points=plan.n_nu,
             states=int(states[0].shape[0]), cuda_event_ms_per_call=ms, launches=launches,
             err_of_peak=e_peak, bars={k: v[0] for k, v in bars.items()},
             **({} if strategy not in plain else {
                 "plain_f32_err_of_peak": float(plain[strategy][0].max()),
                 "plain_f32_ms_one_call": plain[strategy][1]}))
        for k, (v, ok) in bars.items():
            check(ok, f"route {strategy}: {k} fails at {v:.3e}")
        calls[f"sigma_{strategy}_{plan.n_nu}"] = fn
    check(auto == expect_auto, f"auto takes {auto} at {plan.n_nu} points, not {expect_auto}")
    return calls


def kernel_march(seed, dev, report):
    """K2 and K3 on the adversarial 20-level column at 2^19 points, 5 streams."""
    from clearsky_tpu_torch.rt.discretized import _olr_march, _monoflux_march
    from clearsky_tpu_torch.rt.march_cuda import olr_march, monoflux_march
    from clearsky_tpu_torch.utils.quadrature import stream_nodes

    L, N = N_LEVELS - 1, N_NU_MAIN
    rng = np.random.default_rng(seed + 2)
    # transparent (0, 1e-9), series-branch (1e-4), ordinary and opaque layers
    tau = rng.exponential(0.5, (L, N))
    tau[0], tau[1], tau[2] = 0.0, 1e-9, 1e-4
    tau[-1, : N // 3] = 1e4
    B = 0.5 + rng.random((L + 1, N))
    S = rng.random(N)
    a = 0.5 * rng.random(N)
    x32 = [torch.tensor(x, dtype=torch.float32, device=dev) for x in (tau, B, S, a)]
    x64 = [x.double() for x in x32]
    m, W = stream_nodes(5)
    ct = math.cos(0.841)

    olr_k = olr_march(x32[0], x32[1], m, W)
    up_k, dn_k = monoflux_march(*x32, ct, m, W)
    torch.cuda.synchronize()
    olr_r = _olr_march(x64[0], x64[1], m, W)
    up_r, dn_r = _monoflux_march(*x64, ct, m, W)
    err = lambda k, r: float((k.double() - r).abs().max())
    abs_olr, abs_up, abs_dn = err(olr_k, olr_r), err(up_k, up_r), err(dn_k, dn_r)
    e_olr = abs_olr / float(olr_r.abs().max())
    e_up, e_dn = abs_up / float(up_r.abs().max()), abs_dn / float(dn_r.abs().max())
    bar = 3.5e-6
    ms_olr = cuda_ms(lambda: olr_march(x32[0], x32[1], m, W))
    plain_olr = cuda_ms(lambda: _olr_march(x32[0], x32[1], m, W))
    ms_mono = cuda_ms(lambda: monoflux_march(*x32, ct, m, W))
    plain_mono = cuda_ms(lambda: _monoflux_march(*x32, ct, m, W))
    # ~20 FP32 operations per (layer, point, stream) a sweep: the layer's
    # transmission exp, the series/exp split of 1 - e^-tau and the source
    b_olr = bound(20 * L * N * 5, nbytes(x32[0], x32[1], olr_k))
    b_mono = bound(2 * 20 * L * N * 5, nbytes(*x32, up_k, dn_k))
    common = dict(layers=L, points=N, streams=5, bar=f"{bar} of peak", plain_shape="same")
    emit("kernel", kernel="olr_march", err_of_peak=e_olr, max_abs_err=abs_olr,
         ms=ms_olr, plain_ms=plain_olr, **common, **b_olr)
    emit("kernel", kernel="monoflux_march", err_up_of_peak=e_up, err_down_of_peak=e_dn,
         max_abs_err=max(abs_up, abs_dn), ms=ms_mono, plain_ms=plain_mono, **common, **b_mono)
    check(e_olr < bar, f"OLR march kernel error {e_olr:.3e} of peak exceeds {bar}")
    check(max(e_up, e_dn) < bar,
          f"flux march kernel error {max(e_up, e_dn):.3e} of peak exceeds {bar}")
    shape = f"{L} layers x {N} points, 5 streams"
    report["olr_march"] = dict(max_abs_err=abs_olr, ms=ms_olr, plain_ms=plain_olr,
                               library_ms=None, shape=shape, **b_olr)
    report["monoflux_march"] = dict(max_abs_err=max(abs_up, abs_dn), ms=ms_mono,
                                    plain_ms=plain_mono, library_ms=None, shape=shape, **b_mono)


def phase_main(par, dev):
    """outgoing and radiate at the full size through the entry points, the
    catalog built with the constructors' defaults."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.constants import SIGMA_SB
    from clearsky_tpu_torch.ops import linesum_strategies as ls

    lines = ct.SpectralLines.from_par_dict(par)
    check(lines.device.type == "cuda" and lines.dtype == torch.float32,
          f"the default catalog is {lines.dtype} on {lines.device}, not float32 on the card")
    nu = grid_for(lines, N_NU_MAIN)
    gas = ct.DirectGas.from_lines(lines, CONC, nu)
    check(gas.strategy == "auto" and ls.route(gas.plan, lines) == "coarse",
          "the main DirectGas does not take the coarse route")
    Pe = ct.pressuregrid(PT, PS, N_LEVELS)
    Te = column(Pe)
    olr = ct.outgoing(Pe, G, Te, MU, gas)
    torch.cuda.synchronize()
    check(olr.shape == (N_NU_MAIN,), f"OLR spectrum has shape {tuple(olr.shape)}")
    check(bool(torch.isfinite(olr).all()), "OLR spectrum is not finite")
    nu64 = gas.nu.double()
    band = float(ct.trapz(nu64, olr.double()))
    bb = SIGMA_SB * Te[-1] ** 4
    check(0.0 < band < bb, f"band OLR {band} is not in (0, sigma Ts^4 = {bb})")
    ms_out = wall_ms(lambda: ct.outgoing(Pe, G, Te, MU, gas))

    grouped = ct.DirectGas.from_lines(lines, CONC, nu, strategy="grouped")
    olr_g = ct.outgoing(Pe, G, Te, MU, grouped)
    torch.cuda.synchronize()
    band_g = float(ct.trapz(nu64, olr_g.double()))
    rel = abs(band - band_g) / band_g
    ms_out_g = wall_ms(lambda: ct.outgoing(Pe, G, Te, MU, grouped))

    span = float(nu[-1] - nu[0])
    S0 = 340.0 / math.cos(0.841)
    fS = lambda v: torch.full_like(v, S0 / span)
    F = ct.radiate(Pe, G, Te, MU, fS, 0.1, gas)
    torch.cuda.synchronize()
    for k in ("F_up", "F_down", "F_net"):
        check(bool(torch.isfinite(getattr(F, k)).all()), f"radiate {k} is not finite")
    check(tuple(F.M_up.shape) == (N_LEVELS, N_NU_MAIN), "radiate M_up has the wrong shape")
    ms_rad = wall_ms(lambda: ct.radiate(Pe, G, Te, MU, fS, 0.1, gas))

    gas20 = ct.DirectGas.from_lines(lines, CONC, grid_for(lines, N_NU_FINE))
    olr20 = ct.outgoing(Pe, G, Te, MU, gas20)
    torch.cuda.synchronize()
    band20 = float(ct.trapz(gas20.nu.double(), olr20.double()))
    check(bool(torch.isfinite(olr20).all()) and 0.0 < band20 < bb,
          f"band OLR at 2^20 points {band20} is not finite or not in (0, sigma Ts^4)")
    ms_out20 = wall_ms(lambda: ct.outgoing(Pe, G, Te, MU, gas20))
    emit("main", lines=lines.n_lines, catalog=f"{lines.dtype} on {lines.device}",
         points=N_NU_MAIN, levels=N_LEVELS, streams=5, route=ls.route(gas.plan, lines),
         nu_range=[float(nu[0]), float(nu[-1])], band_olr_W_m2=band,
         grouped_band_olr_W_m2=band_g, auto_vs_grouped_band_rel=rel, bar=1e-4,
         sigma_Ts4_W_m2=float(bb), outgoing_ms_per_call=ms_out,
         grouped_outgoing_ms_per_call=ms_out_g,
         F_net_toa_W_m2=float(F.F_net[0]), F_up_toa_W_m2=float(F.F_up[0]),
         F_down_surface_W_m2=float(F.F_down[-1]), radiate_ms_per_call=ms_rad,
         points_2e20=N_NU_FINE, band_olr_2e20_W_m2=band20, outgoing_2e20_ms_per_call=ms_out20)
    check(rel < 1e-4, f"auto and grouped band OLR differ by {rel:.3e}")
    return {"outgoing": lambda: ct.outgoing(Pe, G, Te, MU, gas),
            "outgoing_grouped": lambda: ct.outgoing(Pe, G, Te, MU, grouped),
            "radiate": lambda: ct.radiate(Pe, G, Te, MU, fS, 0.1, gas),
            "outgoing_2e20": lambda: ct.outgoing(Pe, G, Te, MU, gas20)}, olr


def phase_sanity(dev):
    """Transparent and gray columns through the OLR kernel."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.constants import R_GAS, SIGMA_SB, N_AVOGADRO
    from scipy.integrate import quad

    nu = np.concatenate([ct.logrange(1e-6, 1e5, 10000, 4), [1e6]])
    Ts = 290.0
    gas = ct.GrayGas.create(1e-35, nu, dtype=torch.float32, device=dev)
    olr = float(ct.trapz(gas.nu, ct.outgoing(np.array([1.0, 1e3, 1e5]), G, Ts, MU, gas)))
    bb = SIGMA_SB * Ts**4
    e_tr = abs(olr - bb) / bb
    # Pierrehumbert eq. 4.32 on a dry adiabat, one vertical beam
    g2, mu2, cp2, ps2, ts2, sigma = 10.0, 0.01, 1e3, 1e5, 300.0, 1e-26
    gray = ct.GrayGas.create(sigma, nu, dtype=torch.float32, device=dev)
    fT = lambda P: ts2 * (P / ps2) ** (R_GAS / (mu2 * cp2))
    o = ct.outgoing(ps2, g2, fT, mu2, gray, Ptop=1e-6, nlobatto=3, nlevels=256, vertical=True)
    got = float(ct.trapz(gray.nu, o))
    tau_inf = 1e-4 * sigma * N_AVOGADRO / (mu2 * g2) * ps2
    gam = R_GAS / (mu2 * cp2)
    I, _ = quad(lambda t: np.exp(-t) * t ** (4 * gam), 0, tau_inf, limit=500)
    ref = SIGMA_SB * ts2**4 * (np.exp(-tau_inf) + tau_inf ** (-4 * gam) * I)
    e_gray = abs(got - ref) / ref
    emit("sanity", transparent_olr_W_m2=olr, sigma_T4_W_m2=bb, transparent_rel_err=e_tr,
         gray_olr_W_m2=got, gray_analytic_W_m2=float(ref), gray_rel_err=e_gray)
    check(e_tr < 1e-4, f"transparent OLR off sigma T^4 by {e_tr:.3e}")
    check(e_gray < 0.01, f"gray OLR off the analytic value by {e_gray:.3e}")


def phase_rcm(par, dev):
    """RCM.create and 3 x (update_absorber, step) at 16,384 points.

    Returns the model (its absorber refreshed for the last temperatures), the
    host milliseconds of each step and the grid, for :func:`check_rcm`.
    """
    import clearsky_tpu_torch as ct

    lines = ct.SpectralLines.from_par_dict(par, dtype=torch.float32, device=dev)
    nu = grid_for(lines, N_NU_RCM)
    Pe = ct.pressuregrid(PT, PS, N_LEVELS)
    span = float(nu[-1] - nu[0])
    S0 = 340.0 / math.cos(0.841)
    fS = lambda v: torch.full_like(v, S0 / span)
    fmu = lambda T, P: MU
    fcp = lambda T, P: CP

    gas = ct.DirectGas.from_lines(lines, CONC, nu)
    rcm = ct.RCM.create(Pe, column(Pe), G, fmu, fS, 0.1, fcp, 1e7, gas, radmul=2)
    torch.cuda.synchronize()
    ms_steps = []  # the first step pays one-time set-up (plan upload, library load)
    for _ in range(3):
        t0 = time.perf_counter()
        rcm = ct.step(ct.update_absorber(rcm), RCM_DT)
        torch.cuda.synchronize()
        ms_steps.append(1e3 * (time.perf_counter() - t0))
    check(bool(torch.isfinite(rcm.T).all()), "RCM temperatures are not finite")
    return ct.update_absorber(rcm), ms_steps, lines, nu


def check_rcm(rcm, ms_steps, lines, nu):
    """The RCM's heating on the card against the plain float64 version."""
    import clearsky_tpu_torch as ct

    H = ct.heating(rcm).double().cpu()
    # the plain float64 version of the same state (cell and edge
    # temperatures), on the host
    gas64 = ct.DirectGas.from_lines(lines.to(torch.float64, "cpu"), CONC, nu)
    to64 = lambda x: x.double().cpu()
    ref = dataclasses.replace(
        rcm, Pe=to64(rcm.Pe), P=to64(rcm.P), T=to64(rcm.T), Pr=to64(rcm.Pr),
        S_nu=to64(rcm.S_nu), a_nu=to64(rcm.a_nu),
        A=ct.AcceleratedAbsorber.create(to64(rcm.A.T), to64(rcm.Pe), gas64))
    H_ref = ct.heating(ref)
    err = float((H - H_ref).abs().max() / H_ref.abs().max())
    emit("rcm", points=N_NU_RCM, edge_levels=N_LEVELS, radmul=2, steps=3, dt_s=RCM_DT,
         ms_per_step=ms_steps, T_min_K=float(rcm.T.min()), T_max_K=float(rcm.T.max()),
         heating_err_of_peak=err, heating_peak_K_per_day=float(H_ref.abs().max() * 86400))
    check(err < 5e-3, f"RCM heating on the card off the float64 version by {err:.3e} of peak")


def phase_table_bake(par, dev):
    """Bake a Gas at the main path's width on the card and split it."""
    import clearsky_tpu_torch as ct

    lines = ct.SpectralLines.from_par_dict(par, dtype=torch.float32, device=dev)
    nu = grid_for(lines, N_NU_MAIN)
    dom = ct.AtmosphericDomain.create(*TABLE_DOMAIN)
    counts_reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gas = ct.Gas.from_lines(lines, CONC, nu, dom)
    torch.cuda.synchronize()
    bake_s = time.perf_counter() - t0
    launches = {k: v for k, v in counts_read().items() if v}
    gs = gas.split_precision(TABLE_SPLIT)
    check(bool(torch.isfinite(gas.coeffs).all()), "the baked coefficients are not finite")
    check(tuple(gs.coeffs.shape) == (TABLE_SPLIT, N_NU_MAIN)
          and tuple(gs.coeffs_tail.shape) == (dom.nT * dom.nP - TABLE_SPLIT, N_NU_MAIN),
          "split_precision gave the wrong shapes")
    emit("table", step="bake", points=N_NU_MAIN, nT=dom.nT, nP=dom.nP, states=dom.nT * dom.nP,
         bake_seconds=bake_s, launches=launches, split_lead_rows=TABLE_SPLIT,
         coeff_bytes_full=gas.coeffs.numel() * 4,
         coeff_bytes_split=gs.coeffs.numel() * 4 + gs.coeffs_tail.numel() * 2)
    calls = -(-dom.nT * dom.nP // 16)
    check(launches == {"linesum_fine_stencil": calls, "linesum_coarse": calls,
                       "stencil_correction": calls},
          f"the bake did not take the coarse route once per batch: {launches}")
    return gs


def kernel_fused(gs, dev, report):
    """K6 (57 nodes) and K7 (38 nodes) against their float64 plain versions
    on the same split operands, at the main column."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.atmosphere.profile import formprofiles
    from clearsky_tpu_torch.rt import fused_table as tft
    from clearsky_tpu_torch.rt.fused_table_cuda import fused_olr, fused_monoflux
    from clearsky_tpu_torch.utils.quadrature import stream_nodes

    Pe = ct.pressuregrid(PT, PS, N_LEVELS)
    Pg = torch.tensor(Pe, dtype=torch.float32, device=dev)
    fT, fmu = formprofiles(Pg, column(Pe), MU)
    m, W = stream_nodes(5)
    lead, tail = gs.coeffs, gs.coeffs_tail
    to64 = lambda *xs: [x.double() for x in xs]
    bar = 1e-4
    L, N = N_LEVELS - 1, N_NU_MAIN
    rows = lead.shape[0] + tail.shape[0]
    common = dict(layers=L, points=N, streams=5, lead_rows=lead.shape[0],
                  tail_rows=tail.shape[0], bar=f"{bar} of peak (tau rtol {bar}, atol 1e-10)",
                  plain_shape="same")

    bl, bt, wq, B = tft._column_operands(gs, Pg, G, fT, fmu, 3)
    out = fused_olr(lead, tail, bl, bt, wq, B, m, W)
    torch.cuda.synchronize()
    lead64, bl64, wq64, B64 = to64(lead, bl, wq, B)
    ref = tft._fused_olr_plain(lead64, tail, bl64, bt, wq64, B64, m, W)
    abs_olr = float((out.double() - ref).abs().max())
    e_olr = abs_olr / float(ref.abs().max())
    del ref, lead64
    ms = cuda_ms(lambda: fused_olr(lead, tail, bl, bt, wq, B, m, W))
    plain = cuda_ms(lambda: tft._fused_olr_plain(lead, tail, bl, bt, wq, B, m, W))
    # two operations per (node, row, point) FMA, then the march
    nodes = int(bl.shape[0])
    b = bound(2 * nodes * rows * N + 20 * L * N * 5, nbytes(lead, tail, bl, bt, wq, B, out))
    emit("kernel", kernel="fused_olr", nodes=nodes, err_of_peak=e_olr,
         max_abs_err=abs_olr, ms=ms, plain_ms=plain, **common, **b)
    check(bool(torch.isfinite(out).all()) and e_olr < bar,
          f"fused OLR kernel error {e_olr:.3e} of peak exceeds {bar}")
    report["fused_olr"] = dict(max_abs_err=abs_olr, ms=ms, plain_ms=plain, library_ms=None,
                               shape=f"{nodes} nodes x {N_NU_MAIN} points", **b)

    bl, bt, wq, B = tft._column_operands(gs, Pg, G, fT, fmu, 2)
    span = float(gs.nu[-1] - gs.nu[0])
    S = torch.full_like(gs.nu, 340.0 / span)
    a = torch.full_like(gs.nu, 0.1)
    ct_ = math.cos(0.841)
    up, dn, tau = fused_monoflux(lead, tail, bl, bt, wq, B, S, a, ct_, m, W)
    torch.cuda.synchronize()
    lead64, bl64, wq64, B64, S64, a64 = to64(lead, bl, wq, B, S, a)
    up_r, dn_r, tau_r = tft._fused_monoflux_plain(lead64, tail, bl64, bt, wq64, B64, S64, a64,
                                                  ct_, m, W)
    err = lambda k, r: float((k.double() - r).abs().max())
    abs_up, abs_dn = err(up, up_r), err(dn, dn_r)
    e_up, e_dn = abs_up / float(up_r.abs().max()), abs_dn / float(dn_r.abs().max())
    # tau of all-zero table columns is ~1e-308 in float64 and 0 in float32:
    # rtol with the JAX test's atol 1e-10 (tests/test_fused_table.py)
    tau_err = (tau.double() - tau_r).abs()
    tau_ok = bool((tau_err <= bar * tau_r.abs() + 1e-10).all())
    big = tau_r.abs() > 1e-10
    tau_rel = float((tau_err[big] / tau_r[big].abs()).max())
    del up_r, dn_r, tau_r, tau_err, lead64
    ms = cuda_ms(lambda: fused_monoflux(lead, tail, bl, bt, wq, B, S, a, ct_, m, W))
    plain = cuda_ms(lambda: tft._fused_monoflux_plain(lead, tail, bl, bt, wq, B, S, a, ct_,
                                                      m, W))
    nodes = int(bl.shape[0])
    b = bound(2 * nodes * rows * N + 2 * 20 * L * N * 5,
              nbytes(lead, tail, bl, bt, wq, B, S, a, up, dn, tau))
    emit("kernel", kernel="fused_monoflux", nodes=nodes, err_up_of_peak=e_up,
         err_down_of_peak=e_dn, tau_max_rel_err=tau_rel, max_abs_err=max(abs_up, abs_dn),
         ms=ms, plain_ms=plain, **common, **b)
    check(max(e_up, e_dn) < bar and tau_ok,
          f"fused flux kernel error {max(e_up, e_dn):.3e} of peak, tau {tau_rel:.3e}")
    report["fused_monoflux"] = dict(max_abs_err=max(abs_up, abs_dn), ms=ms, plain_ms=plain,
                                    library_ms=None,
                                    shape=f"{nodes} nodes x {N_NU_MAIN} points", **b)


def phase_table(gs, dev, direct_olr):
    """outgoing and radiate on the split Gas through the entry points, with
    the launch counts of that path; then a split Gas beside a gray gas."""
    import clearsky_tpu_torch as ct

    Pe = ct.pressuregrid(PT, PS, N_LEVELS)
    Te = column(Pe)
    span = float(gs.nu[-1] - gs.nu[0])
    fS = lambda v: torch.full_like(v, 340.0 / math.cos(0.841) / span)
    counts_reset()
    olr = ct.outgoing(Pe, G, Te, MU, gs)
    F = ct.radiate(Pe, G, Te, MU, fS, 0.1, gs)
    torch.cuda.synchronize()
    counts = counts_read()
    emit("counts", path="table", **counts)
    check(counts["fused_olr"] > 0 and counts["fused_monoflux"] > 0,
          "the table path did not launch the fused kernels")
    check(all(v == 0 for k, v in counts.items() if not k.startswith("fused_")),
          "the table path launched a kernel of the direct path")
    check(olr.shape == (N_NU_MAIN,) and bool(torch.isfinite(olr).all()),
          "table OLR spectrum is not finite or has the wrong shape")
    for k in ("F_up", "F_down", "F_net", "M_up", "M_down", "tau"):
        check(bool(torch.isfinite(getattr(F, k)).all()), f"table radiate {k} is not finite")
    # bands in float64: a float32 sum of 2^19 terms cannot resolve them
    nu64 = gs.nu.double()
    band = float(ct.trapz(nu64, olr.double()))
    direct_band = float(ct.trapz(nu64, direct_olr.double()))
    rel = abs(band - direct_band) / direct_band
    spectral = float((olr - direct_olr).abs().max() / direct_olr.abs().max())
    ms_out = wall_ms(lambda: ct.outgoing(Pe, G, Te, MU, gs))
    ms_rad = wall_ms(lambda: ct.radiate(Pe, G, Te, MU, fS, 0.1, gs))

    gray = ct.GrayGas.create(1e-35, gs.nu.double().cpu().numpy(), dtype=torch.float32,
                             device=dev)
    counts_reset()
    olr_mix = ct.outgoing(Pe, G, Te, MU, gs, gray)
    torch.cuda.synchronize()
    mix = {k: v for k, v in counts_read().items() if v}
    band_mix = float(ct.trapz(nu64, olr_mix.double()))
    emit("table", step="entry_points", band_olr_W_m2=band, direct_band_olr_W_m2=direct_band,
         band_rel_diff=rel, bar=1e-3, spectral_max_diff_of_peak=spectral,
         outgoing_ms_per_call=ms_out, radiate_ms_per_call=ms_rad,
         F_net_toa_W_m2=float(F.F_net[0]), F_down_surface_W_m2=float(F.F_down[-1]),
         mixed_stack_band_olr_W_m2=band_mix, mixed_stack_counts=mix)
    check(rel < 1e-3, f"table band OLR {band} off the direct one {direct_band} by {rel:.3e}")
    check(mix.get("olr_march", 0) > 0 and "fused_olr" not in mix,
          "the mixed stack did not take the unfused route (raw_sigma, K2)")
    check(abs(band_mix - band) < 1e-4 * band, "the mixed stack's band OLR is off the table's")
    calls = {"table_outgoing": lambda: ct.outgoing(Pe, G, Te, MU, gs),
             "table_radiate": lambda: ct.radiate(Pe, G, Te, MU, fS, 0.1, gs)}
    return calls, counts


# --- the mix: HITRAN files, a gas mixture at full-catalog size, CIA ----------

def fc_h2o(T, P):
    """The water concentration fC(T, P) of the mix: moist near the surface,
    dry aloft and in the cold."""
    return 1e-6 + 0.02 * (P / PS) ** 2 * torch.clamp((T - 160.0) / 130.0, 0.0, 1.0)


def write_mix_files(seed: int, directory: str) -> dict:
    """co2.par (40,000 CO2 lines), h2o.par (20,000 H2O lines) and
    CO2-CO2.cia in HITRAN's formats, made from ``seed``."""
    from clearsky_tpu_torch.spectra import synthetic as syn

    paths = {k: os.path.join(directory, f) for k, f in
             (("co2", "co2.par"), ("h2o", "h2o.par"), ("cia", "CO2-CO2.cia"))}
    syn.write_par(paths["co2"], syn.synthetic_co2_par(N_CO2_MIX, seed=seed + 40))
    syn.write_par(paths["h2o"], syn.synthetic_h2o_par(N_H2O_MIX, seed=seed + 41))
    syn.write_cia(paths["cia"], syn.synthetic_co2_cia(seed=seed + 42))
    return paths


def mix_states(dev):
    """The main column's 57 Lobatto states, and four of them (the lowest
    and highest pressures and two between) for the kernel lines."""
    T, P, _ = main_states(dev)
    pick = torch.as_tensor(np.linspace(0, T.shape[0] - 1, N_MIX_KERNEL_STATES).round(),
                           dtype=torch.int64, device=dev)
    check(float(P[pick].min()) == float(P.min()) and float(P[pick].max()) == float(P.max()),
          "the kernel states miss the column's extreme pressures")
    return (T, P), (T[pick].contiguous(), P[pick].contiguous())


def phase_mix_build(seed, dev, directory):
    """Write and read the files, build the mixture with the default
    constructors, and report the route auto takes at the main column."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops import linesum_strategies as ls

    t0 = time.perf_counter()
    paths = write_mix_files(seed, directory)
    t1 = time.perf_counter()
    lo, hi = MIX_NU[0] - 25.0, MIX_NU[1] + 25.0
    co2 = ct.SpectralLines.from_par(paths["co2"], numin=lo, numax=hi)
    h2o = ct.SpectralLines.from_par(paths["h2o"], numin=lo, numax=hi)
    check(co2.device.type == "cuda" and co2.dtype == torch.float32,
          "the catalogs read with the defaults are not float32 on the card")
    nu = np.linspace(*MIX_NU, N_NU_MAIN)
    mg = ct.MultiGas.from_lines([(co2, MIX_CO2), (h2o, fc_h2o)], nu)
    cia = ct.CIATables.from_file(paths["cia"], singles=True)
    t2 = time.perf_counter()
    (T, P), states4 = mix_states(dev)
    n = int(T.shape[0])
    plan, lines = mg.plan, mg.lines
    route, L_seg = ls._resolve(plan, lines, "voigt", "auto", n)
    budget = ls.resident_budget(dev)
    pack = ls._resident_bytes_est(lines.n_lines, plan.slab, ls._grouped_lane_cost("voigt", "auto", n))
    stencil_pack = ls._resident_bytes_est(lines.n_lines, plan.slab,
                                          ls._grouped_lane_cost("voigt", "stencil", n))
    segs = ls.segments(plan, lines.n_lines, L_seg) if route == "segmented" else []
    pos = lines.positions64()
    emit("mix", step="build", co2_lines=co2.n_lines, h2o_lines=h2o.n_lines,
         merged_lines=lines.n_lines, cia_ranges=len(cia.grids) + len(cia.singles_data),
         write_seconds=t1 - t0, read_and_build_seconds=t2 - t1, points=N_NU_MAIN,
         nu_range=list(MIX_NU), states=n, route=route, segment_lines=L_seg,
         segments=len(segs), segment_lines_each=[s.b - s.a for s in segs],
         pack_bytes=pack, stencil_pack_bytes=stencil_pack, budget_bytes=budget,
         slab=plan.slab, window_pairs=pairs_within(plan.nu, pos, plan.cut))
    check(lines.n_lines >= 50000, f"the mix has {lines.n_lines} lines, not >= 50,000")
    check(route == "segmented", f"auto takes {route} on the mix, not segmented")
    return dict(co2=co2, h2o=h2o, mg=mg, cia=cia, nu=nu, states=(T, P), states4=states4,
                L_seg=L_seg, paths=paths)


def _seg_bound(plan, lines, S, alpha, gamma, L_seg, n):
    """K1-seg's bound on this run's data: per segment, the split mode's
    pairs (region 1 beyond the segment's own d_near, w4 by region within
    it), its grid, positions, pack and windows read once; sigma written
    once."""
    from clearsky_tpu_torch.ops import linesum_strategies as ls
    from clearsky_tpu_torch.ops.linesum import voigt_coefficients

    pos = lines.positions64()
    ops, nb = 0.0, 4 * n * plan.n_nu
    for s in ls.segments(plan, lines.n_lines, L_seg):
        grid = plan.nu[s.blo * plan.block: s.blo * plan.block + s.n_out]
        p = pos[s.a:s.b]
        a_, g_ = alpha[:, s.a:s.b], gamma[:, s.a:s.b]
        d_near = float(torch.clamp(15.0 * a_.max(), max=plan.cut))
        ia, y0 = voigt_coefficients(S[:, s.a:s.b], a_, g_)[1:3]
        pairs = pairs_within(grid, p, plan.cut)
        near = pairs_within(grid, p, d_near)
        ops += (pairs * PAIR_OPS + (pairs - near) * n * R1_OPS
                + near_w4_ops(grid, p, ia, y0, d_near))
        tiles = -(-n // 8)
        nb += (8 * (s.bhi - s.blo) * plan.block + 8 * (s.b - s.a)
               + 4 * 7 * 8 * tiles * (s.b - s.a) + 8 * (s.bhi - s.blo))
    return bound(ops, nb)


def _full_bound(plan, lines, S, alpha, gamma, n, layout_bytes):
    """K4/K5's bound on this run's data: w4 by region at every in-cut pair
    and state, and the two-float dnu per pair; the layout's bytes read
    once and sigma written once."""
    from clearsky_tpu_torch.ops.linesum import voigt_coefficients

    pos = lines.positions64()
    ia, y0 = voigt_coefficients(S, alpha, gamma)[1:3]
    pairs = pairs_within(plan.nu, pos, plan.cut)
    ops = pairs * PAIR_OPS + near_w4_ops(plan.nu, pos, ia, y0, plan.cut)
    return bound(ops, layout_bytes + 8 * plan.n_blocks * plan.block + 4 * n * plan.n_nu)


def _mix_line(name, out, ref, ref32, edge, ms, plain_ms, b, report, **extra):
    max_abs, max_rel, ok = check_sigma(out, ref, edge, ref32)
    n, n_nu = out.shape
    emit("kernel", kernel=name, points=n_nu, states=n, max_abs_err=max_abs, max_rel_err=max_rel,
         bar="rtol 2e-3 where |sigma| > 1e-35 (atol 1e-32)", cut_edge_points=int(edge.sum()),
         ms=ms, plain_ms_one_call=plain_ms, plain_shape="same", **extra, **b)
    check(ok, f"{name} at {n} states disagrees with its float64 plain version: "
              f"max rel {max_rel:.3e}")
    if report is None:
        return
    report[name] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, library_ms=None,
                        shape=f"{n} states x {n_nu} points", **b)


def kernel_mix(mix, dev, states, report=None):
    """K1-seg on the mix, K4 and K5 on its CO2 catalog at ``states`` (T, P)
    on 2^19 points, each against its float64 plain version (float32 at the
    cut edges). At the main path's 57 states K1-seg runs 8 state tiles in
    each segment and K5 19 groups of 3 states, as on the main path; those
    lines go in ``report``. K4's float64 sum is K5's reference too: both
    plain versions are the exact profile over each block's window, and a
    float64 gather of 57 states' slabs would take 33 GB."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops import linesum_cuda as lc
    from clearsky_tpu_torch.ops import linesum_strategies as ls
    from clearsky_tpu_torch.ops.linesum import _line_params

    mg, L_seg = mix["mg"], mix["L_seg"]
    T4, P4 = states
    n = int(T4.shape[0])
    x64 = (T4.double(), P4.double())
    # K1-seg on the mixture, its per-state concentrations folded per line
    lines, plan = mg.lines, mg.plan
    c32 = mg._conc(T4, P4)
    out = lc.sigma_segmented(plan, lines, T4, P4, P4, L_seg, conc=c32)
    torch.cuda.synchronize()

    # the kernels alone: each segment's pack built beforehand
    prepared = []
    for seg, grid in lc._segment_windows(plan, lines.n_lines, L_seg, dev):
        sub = ls._slice_lines(lines, seg.a, seg.b)
        S, a, g = _line_params(sub, T4, P4, P4, c32[:, seg.a:seg.b])
        prepared.append((seg, grid, sub, lc.pack_coefficients(0, S, a, g),
                         lc.near_distance(a, plan.cut)))
    acc = torch.zeros((n, plan.n_nu), device=dev)

    def kernels_only():
        acc.zero_()
        for seg, grid, sub, coef, d_near in prepared:
            lc.launch_mode(0, grid, sub, coef, n, seg.n_out, lc._zones(plan.cut), d_near,
                           out=acc[:, seg.blo * plan.block:], count_as="segmented")

    ms = cuda_ms(kernels_only)
    wrapper_ms = cuda_ms(lambda: lc.sigma_segmented(plan, lines, T4, P4, P4, L_seg, conc=c32))
    n_segs = len(prepared)
    del prepared, acc
    ref = ls.sigma_segmented_plain(plan, lines.to(torch.float64), *x64, x64[1], L_seg,
                                   conc=mg._conc(*x64))
    ref32, plain_ms = one_call(lambda: ls.sigma_segmented_plain(plan, lines, T4, P4, P4, L_seg,
                                                                conc=c32))
    edge = cut_edges(plan, lines.positions64())
    S, a, g = _line_params(lines, T4, P4, P4, c32)
    b = _seg_bound(plan, lines, S, a, g, L_seg, n)
    _mix_line("linesum_segmented", out, ref, ref32, edge, ms, plain_ms, b, report,
              lines=lines.n_lines, segments=n_segs, segment_lines=L_seg, state_tiles=-(-n // 8),
              wrapper_ms=wrapper_ms)
    del out, ref, ref32

    # K4 and K5 on the CO2 catalog
    co2 = mix["co2"]
    cplan = ct.DirectGas.from_lines(co2, MIX_CO2, mix["nu"], strategy="lane").plan
    Pp4 = MIX_CO2 * P4
    x64 = (T4.double(), P4.double(), Pp4.double())
    edge = cut_edges(cplan, co2.positions64())
    S, a, g = _line_params(co2, T4, P4, Pp4)
    grid = cplan.device_arrays(dev)
    ref = None
    for name, kern, plain in (("linesum_lane", lc.sigma_lane, ls.sigma_lane_plain),
                              ("linesum_gathered", lc.sigma_gathered, ls.sigma_gathered_plain)):
        out = kern(cplan, co2, T4, P4, Pp4)
        torch.cuda.synchronize()
        if name == "linesum_lane":
            lay = ls.lane_layout(cplan, co2, S, a, g)
            win = torch.as_tensor(lay.windows, dtype=torch.int32, device=dev)
            st, cn = win[:, 0].contiguous(), win[:, 1].contiguous()
            launch = lambda: lc.launch_fullprofile("voigt", False, grid, lay.nu, lay.nu_lo,
                                                   lay.S, lay.alpha, lay.gamma, st, cn,
                                                   lay.nu.shape[0], cplan.cut, cplan.n_nu)
            layout_bytes = 8 * lay.nu.shape[0] + 12 * n * lay.nu.shape[0] + 8 * cplan.n_blocks
            extra = dict(lines_padded=int(lay.nu.shape[0]))
        else:
            # the wrapper's state groups, each one's slabs gathered beforehand
            step = lc.gather_group(cplan)
            cn = grid["win"][:, 1].contiguous()
            acc = torch.empty((n, cplan.n_nu), device=dev)
            groups = [(i, ls.gathered_slabs(cplan, co2, S[i:i + step], a[i:i + step],
                                            g[i:i + step])) for i in range(0, n, step)]
            slab_pad = groups[0][1].slab_pad

            def launch():
                for i, gs in groups:
                    lc.launch_fullprofile("voigt", True, grid, gs.nu, gs.nu_lo, gs.S, gs.alpha,
                                          gs.gamma, cn, cn, slab_pad, cplan.cut, cplan.n_nu,
                                          out=acc[i:i + gs.S.shape[0]])

            slab_bytes = 12 * n * cplan.n_blocks * slab_pad
            layout_bytes = (slab_bytes + len(groups) * (8 * cplan.n_blocks * slab_pad
                                                        + 4 * cplan.n_blocks))
            extra = dict(slab_pad=slab_pad, gathered_slab_bytes=slab_bytes,
                         gathered_slab_bytes_per_state=slab_bytes // n,
                         mix_slab_bytes_per_state=12 * plan.n_blocks
                         * (-(-plan.slab // 128) * 128),
                         states_per_launch=step, launches_per_call=len(groups))
        ms = cuda_ms(launch, n=3, warmup=1)
        if name == "linesum_gathered":
            del groups, acc
        wrapper_ms = cuda_ms(lambda: kern(cplan, co2, T4, P4, Pp4), n=3, warmup=1)
        if ref is None:
            ref = ls.sigma_lane_plain(cplan, co2.to(torch.float64), *x64)
        ref32, plain_ms = one_call(lambda: plain(cplan, co2, T4, P4, Pp4))
        b = _full_bound(cplan, co2, S, a, g, n, layout_bytes)
        _mix_line(name, out, ref, ref32, edge, ms, plain_ms, b, report, lines=co2.n_lines,
                  wrapper_ms=wrapper_ms, float64_reference="sigma_lane_plain", **extra)
        del out, ref32


def phase_mix_entry(mix, dev):
    """outgoing and radiate on (MultiGas, CIA tables) at 2^19 points with the
    default constructors, and outgoing without the CIA, each with its own
    launch counts."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.constants import SIGMA_SB
    from clearsky_tpu_torch.ops import linesum_strategies as ls

    mg, cia, nu = mix["mg"], mix["cia"], mix["nu"]
    Pe = ct.pressuregrid(PT, PS, N_LEVELS)
    Te = column(Pe)
    span = float(nu[-1] - nu[0])
    fS = lambda v: torch.full_like(v, 340.0 / math.cos(0.841) / span)
    calls = {"mix_outgoing": lambda: ct.outgoing(Pe, G, Te, MU, mg, cia),
             "mix_radiate": lambda: ct.radiate(Pe, G, Te, MU, fS, 0.1, mg, cia),
             "mix_outgoing_without_cia": lambda: ct.outgoing(Pe, G, Te, MU, mg)}
    out, counts = {}, {}
    for name, fn in calls.items():
        counts_reset()
        out[name] = fn()
        torch.cuda.synchronize()
        counts[name] = {k: v for k, v in counts_read().items() if v}
    olr, F, olr_lines = out.values()
    nu64 = torch.as_tensor(nu, device=dev)
    band, band_lines = (float(ct.trapz(nu64, x.double())) for x in (olr, olr_lines))
    bb = SIGMA_SB * Te[-1] ** 4
    ms = {k: wall_ms(fn) for k, fn in calls.items()}
    emit("mix", step="entry_points", points=N_NU_MAIN, levels=N_LEVELS, streams=5,
         routes={k: ls.route(mg.plan, mg.lines, "voigt", "auto", n_states=n)
                 for k, n in (("outgoing", 57), ("radiate", 38))}, band_olr_W_m2=band, band_olr_without_cia_W_m2=band_lines, sigma_Ts4_W_m2=float(bb),
         F_net_toa_W_m2=float(F.F_net[0]), F_down_surface_W_m2=float(F.F_down[-1]),
         ms_per_call=ms, launches=counts)
    for k in ("F_up", "F_down", "F_net"):
        check(bool(torch.isfinite(getattr(F, k)).all()), f"mix radiate {k} is not finite")
    check(bool(torch.isfinite(olr).all()) and 0.0 < band <= band_lines < bb,
          f"mix band OLR with CIA {band}, without {band_lines}: not 0 < with <= without < "
          f"sigma Ts^4")
    # each call launches the route auto takes at its own number of states
    # (outgoing: 57 Lobatto states, radiate: 38), and its march
    routes = {}
    for name, march, n in (("mix_outgoing", "olr_march", 57), ("mix_radiate", "monoflux_march", 38),
                           ("mix_outgoing_without_cia", "olr_march", 57)):
        routes[name] = ls.route(mg.plan, mg.lines, "voigt", "auto", n_states=n)
        check(set(counts[name]) == ROUTE_KERNELS[routes[name]] | {march},
              f"{name} launched {counts[name]}, not only the {routes[name]} route and {march}")
    check(routes["mix_outgoing"] == "segmented", "outgoing on the mix does not run segmented")
    total = {}
    for c in counts.values():
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    return dict(Pe=Pe, Te=Te), calls, total


def phase_mix_rcm(mix, dev):
    """RCM.create and 3 x (update_absorber, step) on the mixture and its CIA
    at 16,384 points; returns what :func:`check_mix_rcm` needs."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops import linesum_strategies as ls

    nu = np.linspace(*MIX_NU, N_NU_RCM)
    mg = ct.MultiGas.from_lines([(mix["co2"], MIX_CO2), (mix["h2o"], fc_h2o)], nu)
    Pe = ct.pressuregrid(PT, PS, N_LEVELS)
    route = ls.route(mg.plan, mg.lines, "voigt", "auto", n_states=N_LEVELS)
    span = float(nu[-1] - nu[0])
    fS = lambda v: torch.full_like(v, 340.0 / math.cos(0.841) / span)
    rcm = ct.RCM.create(Pe, column(Pe), G, lambda T, P: MU, fS, 0.1, lambda T, P: CP, 1e7, mg,
                        mix["cia"], radmul=2)
    ms_steps = []
    for _ in range(3):
        t0 = time.perf_counter()
        rcm = ct.step(ct.update_absorber(rcm), RCM_DT)
        torch.cuda.synchronize()
        ms_steps.append(1e3 * (time.perf_counter() - t0))
    check(bool(torch.isfinite(rcm.T).all()), "mix RCM temperatures are not finite")
    return ct.update_absorber(rcm), ms_steps, mg, route


# the kernels each route launches (csrc/linesum.cu), by KERNELS name
ROUTE_KERNELS = {"segmented": {"linesum_segmented"}, "grouped": {"linesum"},
                 "stencil": {"linesum_farall", "stencil_correction"},
                 "coarse": {"linesum_coarse", "linesum_fine_stencil", "stencil_correction"},
                 "lane": {"linesum_lane"}, "gathered": {"linesum_gathered"}}


def check_mix_rcm(rcm, ms_steps, mg, route, cia):
    """The mix RCM's heating on the card against the plain float64 version
    of the same state: its cross-sections cached on the card through a
    callable absorber (the exact line sum of the float64 catalog with the
    same per-line concentrations, plus the float64 CIA pair), its march on
    the host."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.absorption.cia import CIA
    from clearsky_tpu_torch.ops.linesum import sigma_from_lines

    dev = rcm.nu.device
    H = ct.heating(rcm).double()
    m64 = dataclasses.replace(mg, lines=mg.lines.to(torch.float64))
    nu64 = torch.as_tensor(mg.plan.nu, device=dev)
    pair = CIA.pair(cia.bind(mg.plan.nu, dtype=torch.float64, device=dev), m64.components())

    def sigma64(nu, T, P):
        T, P = T[..., 0], P[..., 0]
        return (sigma_from_lines(m64.plan, m64.lines, T, P, P, conc=m64._conc(T, P))
                + pair.sigma(T, P))

    zero = ct.GrayGas.create(0.0, mg.plan.nu, dtype=torch.float64, device=dev)
    A = ct.AcceleratedAbsorber.create(rcm.A.T.double(), rcm.Pe.double(), zero, sigma64)
    check(torch.equal(A.nu, nu64), "the reference grid is not the mix grid")
    # the cross-sections are cached on the card; the march runs on the host
    # (the kernels take float32 only)
    host = lambda x: x.double().cpu()
    A = dataclasses.replace(A, ln_sigma=host(A.ln_sigma), lnP=host(A.lnP), T=host(A.T),
                            nu=host(A.nu))
    ref = dataclasses.replace(rcm, Pe=host(rcm.Pe), P=host(rcm.P), T=host(rcm.T),
                              Pr=host(rcm.Pr), S_nu=host(rcm.S_nu), a_nu=host(rcm.a_nu), A=A)
    H_ref = ct.heating(ref)
    err = float((H.cpu() - H_ref).abs().max() / H_ref.abs().max())
    emit("mix", step="rcm", points=N_NU_RCM, edge_levels=N_LEVELS, route=route,
         lines=mg.lines.n_lines, ms_per_step=ms_steps, T_min_K=float(rcm.T.min()),
         T_max_K=float(rcm.T.max()), heating_err_of_peak=err,
         heating_peak_K_per_day=float(H_ref.abs().max() * 86400))
    check(err < 5e-3, f"mix RCM heating off the float64 version by {err:.3e} of peak")


def phase_mix_strategies(mix, entry, dev):
    """outgoing on the CO2 catalog as DirectGas with strategy "lane" and
    "gathered": each launches its own kernel and K2 only, and its band OLR
    is within 1e-4 of auto's. Returns the launch counts of the two runs."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops import linesum_strategies as ls

    co2, nu, Pe, Te = mix["co2"], mix["nu"], entry["Pe"], entry["Te"]
    nu64 = torch.as_tensor(nu, device=dev)
    auto = ct.DirectGas.from_lines(co2, MIX_CO2, nu)
    n = int(mix["states"][0].shape[0])
    auto_route = ls.route(auto.plan, co2, "voigt", "auto", n_states=n)
    band_auto = float(ct.trapz(nu64, ct.outgoing(Pe, G, Te, MU, auto).double()))
    counts, out = {}, {}
    for strategy in ("lane", "gathered"):
        gas = ct.DirectGas.from_lines(co2, MIX_CO2, nu, strategy=strategy)
        check(ls.route(gas.plan, co2, "voigt", strategy, n_states=n) == strategy,
              f"strategy {strategy} does not take its own route on the CO2 catalog")
        counts_reset()
        olr, ms = one_call(lambda: ct.outgoing(Pe, G, Te, MU, gas))
        torch.cuda.synchronize()
        got = {k: v for k, v in counts_read().items() if v}
        counts[strategy] = got
        band = float(ct.trapz(nu64, olr.double()))
        rel = abs(band - band_auto) / band_auto
        out[strategy] = dict(band_olr_W_m2=band, rel_to_auto=rel, outgoing_ms_one_call=ms,
                             launches=got)
        check(set(got) == {f"linesum_{strategy}", "olr_march"},
              f"outgoing on strategy {strategy} launched {got}")
        check(rel < 1e-4, f"band OLR on {strategy} off auto's by {rel:.3e}")
    emit("mix", step="strategies", lines=co2.n_lines, auto_route=auto_route,
         auto_band_olr_W_m2=band_auto, bar=1e-4, **out)
    return counts


def phase_mix_cia(mix, dev):
    """CIA in float32 on the card: the mix stack's sigma is finite, and the
    CIA pair's sigma agrees with float64 (same grid) within 1e-5 where that
    exceeds 1e-30 of its peak and float32's smallest normal number (the
    cross-section itself, ~1e-31 cm^2 at its peak here, leaves float32's
    range 1e-30 below it). The bound tables are float64 whatever the dtype
    asked for (``BoundCIA``), so this checks the float32 conversion
    (``cia_xsec_scaled``) and the final cast, not a float32 table. At the
    mix's 4e-4 of CO2 the continuum moves the band OLR by ~1e-9 of it,
    below float32's resolution, so the OLR check runs on a CO2-rich column
    (the CO2 catalog at 0.95): band OLR with the CIA is below band OLR
    without it. Also the CIA's share of a mix ``outgoing``: the host's bind
    of the tables to the grid (the stack's creation, at every call) and
    the pair's sigma at the 57 states on the card."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.absorption.absorbers import unify_absorbers
    from clearsky_tpu_torch.absorption.cia import CIA
    from clearsky_tpu_torch.constants import LOSCHMIDT

    mg, cia = mix["mg"], mix["cia"]
    T4, P4 = mix["states4"]
    stack = unify_absorbers((mg, cia))
    sig = stack.sigma(T4, P4)
    s32 = stack.cias[0].sigma(T4, P4)
    grid32 = mg.nu.double().cpu().numpy()
    pair64 = CIA.pair(cia.bind(grid32, dtype=torch.float64, device=dev), mg.components())
    s64 = pair64.sigma(T4.double(), P4.double())
    torch.cuda.synchronize()
    tiny = torch.finfo(torch.float32).tiny
    m = (s64 > 1e-30 * s64.max()) & (s64 > tiny)
    rel = float(((s32.double() - s64).abs()[m] / s64[m]).max())
    rich = ct.DirectGas.from_lines(mix["co2"], 0.95, mix["nu"])
    Pe = ct.pressuregrid(PT, PS, N_LEVELS)
    Te = column(Pe)
    nu64 = torch.as_tensor(mix["nu"], device=dev)
    band = {k: float(ct.trapz(nu64, ct.outgoing(Pe, G, Te, MU, *a).double()))
            for k, a in (("with_cia", (rich, cia)), ("without_cia", (rich,)))}
    T, P = mix["states"]
    share = dict(stack_create_wall_ms_with_cia=wall_ms(lambda: unify_absorbers((mg, cia))),
                 stack_create_wall_ms_without_cia=wall_ms(lambda: unify_absorbers((mg,))),
                 cia_sigma_cuda_event_ms_57_states=cuda_ms(lambda: stack.cias[0].sigma(T, P)),
                 cia_k_cuda_event_ms_57_states=cuda_ms(
                     lambda: stack.cias[0].tables.k(T, scale=math.log(LOSCHMIDT))))
    emit("mix", step="cia_float32", states=int(T4.shape[0]), stack_finite=bool(
        torch.isfinite(sig).all()), cia_peak_cm2=float(s64.max()),
         cia_min_compared_cm2=float(s64[m].min()), points_compared=int(m.sum()),
         max_rel_err=rel, bar=1e-5, cia_f32_zero_where_f64_compared=int((s32[m] == 0).sum()),
         points_above_1e30_of_peak_below_f32_normal=int(
             ((s64 > 1e-30 * s64.max()) & (s64 <= tiny)).sum()),
         co2_rich_band_olr_W_m2=band, **share)
    check(bool(torch.isfinite(sig).all()), "the mix stack's float32 sigma is not finite")
    check(bool((s32[m] > 0).all()) and rel < 1e-5,
          f"float32 CIA off float64 by {rel:.3e} (or zero where float64 is not)")
    check(band["with_cia"] < band["without_cia"],
          f"the CIA does not lower the CO2-rich band OLR: {band}")


def phase_mix_l2(mix, dev):
    """The L2 hypothesis at the mix shape: ms per call of the default
    (segmented) route, one K1 launch over the whole catalog and the coarse
    route, taken in turns, twice."""
    from clearsky_tpu_torch.ops import linesum_strategies as ls
    from clearsky_tpu_torch.ops.linesum_cuda import sigma_routed

    mg = mix["mg"]
    T, P = mix["states"]
    n = int(T.shape[0])
    conc = mg._conc(T, P)
    big = 2**40
    cases = {"segmented_default": dict(), "grouped_whole": dict(strategy="grouped",
                                                                 resident_limit=big),
             "coarse_forced": dict(strategy="coarse", resident_limit=big)}
    calls = {}
    for name, kw in cases.items():
        route = ls.route(mg.plan, mg.lines, "voigt", kw.get("strategy", "auto"), n_states=n,
                         resident_limit=kw.get("resident_limit"))
        check(route == name.split("_")[0], f"{name} takes the route {route}")
        calls[name] = lambda kw=kw: sigma_routed(mg.plan, mg.lines, T, P, P, conc=conc, **kw)
    rounds = [{name: cuda_ms(fn, n=5, warmup=1) for name, fn in calls.items()} for _ in range(2)]
    emit("mix", step="l2_routes", states=n, points=N_NU_MAIN, lines=mg.lines.n_lines,
         budget_bytes=ls.resident_budget(dev), cuda_event_ms_per_call_round1=rounds[0],
         cuda_event_ms_per_call_round2=rounds[1])
    return {f"mix_sigma_{k}": v for k, v in calls.items()}


# --- the dense-CO2 column: the phco2 line shape and radiative-convective ------
# --- equilibrium ---------------------------------------------------------------

def phco2_grid(lines, n):
    """The catalog's span, phco2's cut beyond each end (at least 1 cm^-1)."""
    nu64 = lines.positions64()
    return np.linspace(max(nu64.min() - PHCO2_CUT, 1.0), nu64.max() + PHCO2_CUT, n)


def sample_blocks(blocks64, stride: int = SAMPLE_STRIDE) -> np.ndarray:
    """Every ``stride``-th block of a block grid and the blocks that hold the
    catalog's band centres: the sample the float64 references of the cut-500
    line sums are computed on (the whole grid would take minutes)."""
    idx = set(range(0, blocks64.shape[0], stride))
    for c in BAND_CENTRES:
        b = int(np.searchsorted(blocks64[:, -1], c))
        if b < blocks64.shape[0] and blocks64[b, 0] <= c:
            idx.add(b)
    return np.array(sorted(idx), dtype=np.int64)


def sampled(out, idx, block: int, n_out: int):
    """A kernel's output [n, n_out] on the sampled blocks, [n, len(idx) block],
    with the mask of the points that lie on the grid."""
    n = out.shape[0]
    nb = -(-n_out // block)
    full = torch.nn.functional.pad(out, (0, nb * block - n_out)).reshape(n, nb, block)
    cols = torch.as_tensor(idx, device=out.device)
    pts = (idx[:, None] * block + np.arange(block)[None, :]).reshape(-1)
    return full[:, cols].reshape(n, -1), torch.as_tensor(pts < n_out, device=out.device)


def subplan(plan, idx):
    """The plan on the sampled blocks only (for the exact plain sum there)."""
    nb = np.asarray(plan.nu_blocks, np.float64)[idx]
    return dataclasses.replace(plan, nu=nb.reshape(-1), nu_blocks=nb, n_blocks=len(idx),
                               start=plan.start[idx], count=plan.count[idx], _on_device={},
                               _geometry={})


def pairs_beyond(grid, pos, hi, lo=3.0) -> int:
    """(point, line) pairs with max(lo, 3) < |dnu| <= hi: where chi is not 1."""
    return pairs_within(grid, pos, hi, max(lo, 3.0)) if hi > max(lo, 3.0) else 0


def segment_budget(plan, lines, n: int, k: int = 3) -> int:
    """The smallest residency budget (in steps of 4 KiB) at which K1's pack
    of ``n`` states is cut into segments of at least a k-th of the catalog."""
    from clearsky_tpu_torch.ops import linesum_strategies as ls

    want = -(-lines.n_lines // k // ls.CHUNK) * ls.CHUNK
    return next(lim for lim in range(2**16, 2**31, 2**12)
                if ls._segment_cap("phco2", "grouped", n, lim, plan.slab) >= want)


def _phco2_operands(lines, states, shape="phco2"):
    """alpha, the voigt coefficients (co), the phco2 family's 3-value pack of
    the windowed modes and chi's rates."""
    from clearsky_tpu_torch.ops import linesum_strategies as ls
    from clearsky_tpu_torch.ops.linesum_cuda import chi_rates, pack_coefficients, window_mode
    from clearsky_tpu_torch.ops.linesum import _line_params, effective_alpha

    S, alpha, gamma = _line_params(lines, *states)
    alpha = effective_alpha(shape, alpha)
    a, co = ls.coefficients(lines, *states, shape=shape)
    return a, co, pack_coefficients(window_mode("farall", shape), S, alpha, gamma), \
        chi_rates(states[0])


def _phco2_mode_line(name, mode, blocks64, windows, n_out, lines, l64, states, z, d_near,
                     ops_exps, report, stride=SAMPLE_STRIDE, extra=None):
    """A phco2 instance of a windowed K1 mode against its float64 plain
    version on a sample of blocks (bar 1e-5 of each state's peak there:
    float32 accumulation), timed beside the plain float32 version on the
    same sample, with its bound on the whole grid."""
    from clearsky_tpu_torch.ops import linesum_strategies as ls
    from clearsky_tpu_torch.ops.linesum import two_float
    from clearsky_tpu_torch.ops.linesum_cuda import launch_mode, window_mode, _zones

    dev = states[0].device
    _, co, coef, bcoef = _phco2_operands(lines, states)
    x64 = [x.double() for x in states]
    _, co64, _, _ = _phco2_operands(l64, x64)
    hi, lo = two_float(blocks64)
    grid = {"nu_hi": torch.as_tensor(hi.reshape(-1), device=dev),
            "nu_lo": torch.as_tensor(lo.reshape(-1), device=dev),
            "win": torch.as_tensor(windows, dtype=torch.int32, device=dev)}
    n = int(states[0].shape[0])
    m = window_mode(mode, "phco2")
    zones = _zones(**z)
    launch = lambda: launch_mode(m, grid, lines, coef, n, n_out, zones, d_near, bcoef=bcoef)
    out = launch()
    torch.cuda.synchronize()
    idx = sample_blocks(blocks64, stride)
    B = blocks64.shape[1]
    got, valid = sampled(out, idx, B, n_out)
    d64 = None if d_near is None else d_near.double()
    ref = ls.sigma_mode_plain(mode, blocks64[idx], windows[idx], l64, co64, z, d64, T=x64[0])
    err = float(((got.double() - ref).abs()[:, valid]
                 / ref[:, valid].abs().amax(dim=1, keepdim=True)).max())
    max_abs = float((got.double() - ref).abs()[:, valid].max())
    del ref
    ms = cuda_ms(launch, n=5)
    _, plain_ms = one_call(lambda: ls.sigma_mode_plain(mode, blocks64[idx], windows[idx], lines,
                                                       co, z, d_near, T=states[0]))
    ops, exps = ops_exps
    b = bound(ops, linesum_bytes(blocks64.size, lines.n_lines, coef, grid["win"], n, n_out)
              + bcoef.numel() * 4, exps)
    shape = f"{n} states x {n_out} points"
    emit("kernel", kernel=name, mode=f"phco2_{mode}", points=n_out, states=n,
         lines=lines.n_lines, err_of_peak=err, max_abs_err=max_abs,
         bar="1e-5 of each state's peak on the sample", ms=ms, plain_ms=plain_ms,
         plain_shape=f"sampled blocks: {len(idx)} of {blocks64.shape[0]} (every {stride}th "
                     "and the band centres)", **(extra or {}), **b)
    check(bool(torch.isfinite(out).all()) and err < 1e-5,
          f"K1 mode phco2_{mode} off its float64 plain version by {err:.3e} of peak")
    report[name] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, library_ms=None,
                        shape=shape, plain_sample=f"{len(idx)} of {blocks64.shape[0]} blocks",
                        **b)
    return out


def _exact_sampled_check(name, out, plan, idx, l64, lines, states, shape, report, ms, b,
                         extra=None):
    """An exact-profile kernel (the split mode) on the sampled blocks against
    the float64 plain line sum there (rtol 2e-3 where |sigma| > 1e-35;
    float32 at the cut edges), the plain float32 sum timed on the same
    sample. Returns each state's peak of the float64 sum on the sample."""
    from clearsky_tpu_torch.ops.linesum import sigma_from_lines

    sub = subplan(plan, idx)
    got, valid = sampled(out, idx, plan.block, plan.n_nu)
    x64 = [x.double() for x in states]
    ref = sigma_from_lines(sub, l64, *x64, shape=shape)
    ref32, plain_ms = one_call(lambda: sigma_from_lines(sub, lines, *states, shape=shape))
    edge = cut_edges(sub, lines.positions64()) & valid.cpu().numpy()
    v = valid
    max_abs, max_rel, ok = check_sigma(got[:, v], ref[:, v], edge[v.cpu().numpy()],
                                       ref32[:, v])
    n = out.shape[0]
    emit("kernel", kernel=name, shape_profile=shape, points=plan.n_nu, states=n,
         lines=lines.n_lines, max_abs_err=max_abs, max_rel_err=max_rel,
         bar="rtol 2e-3 where |sigma| > 1e-35 (atol 1e-32) on the sample",
         cut_edge_points=int(edge.sum()), ms=ms, plain_ms_one_call=plain_ms,
         plain_shape=f"sampled blocks: {len(idx)} of {plan.n_blocks}", **(extra or {}), **b)
    check(ok, f"{name} disagrees with its float64 plain version: max rel {max_rel:.3e}")
    if report is not None:
        report[name] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, library_ms=None,
                            shape=f"{n} states x {plan.n_nu} points",
                            plain_sample=f"{len(idx)} of {plan.n_blocks} blocks", **b)
    return ref[:, v].abs().amax(dim=1, keepdim=True)


def _phco2_split_ops(grid, pos, ia, y0, T, d_near, cut, n):
    """FP32 operations and exponentials of the phco2 split mode on this
    data: region 1 with chi beyond d_near, w4 (y = y0 chi) within it."""
    pairs = pairs_within(grid, pos, cut)
    near = pairs_within(grid, pos, d_near)
    beyond3 = pairs_beyond(grid, pos, cut)
    ops = (pairs * (PAIR_OPS + PH_PAIR_OPS) + (pairs - near) * n * PH_R1_OPS
           + beyond3 * n * CHI_OPS + near_w4_ops(grid, pos, ia, y0, d_near, T=T))
    return ops, beyond3 * n, dict(in_cut_pairs=pairs, near_pairs=near,
                                  pairs_beyond_3_cm=beyond3)


def kernel_phco2(par, dev, report):
    """The phco2 family's K1 instances at the shapes where the main path
    runs them: the split mode (outgoing on "grouped"), COARSE, FINE_STENCIL
    and the chi correction (auto) at 57 states x 2^19, FINE (auto at 2^20)
    at 57 x 2^20; each against its float64 plain version on a sample of
    blocks that includes the band centres."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops import linesum_strategies as ls
    from clearsky_tpu_torch.ops.linesum_cuda import _prepare, near_distance, pack_coefficients, MODES
    from clearsky_tpu_torch.ops.linesum import _line_params

    l64 = ct.SpectralLines.from_par_dict(par, dtype=torch.float64, device=dev)
    lines = l64.to(torch.float32)
    plan = ct.DirectGas.from_lines(lines, CONC, phco2_grid(lines, N_NU_MAIN), shape="phco2").plan
    states = main_states(dev, TS_RCE)
    n = int(states[0].shape[0])
    pos = lines.positions64()
    T = states[0]

    # the split mode (the "grouped" route)
    launch = _prepare(plan, lines, *states, "phco2")
    out = launch()
    torch.cuda.synchronize()
    ms = cuda_ms(launch, n=5)
    S, alpha, gamma = _line_params(lines, *states)
    a, co, _, bcoef = _phco2_operands(lines, states)
    d_near = float(torch.clamp(15.0 * a.max(), max=plan.cut))
    ops, exps, pairs = _phco2_split_ops(plan.nu, pos, co[1], co[2], T, d_near, plan.cut, n)
    coef = pack_coefficients(MODES["phco2"], S, alpha, gamma)
    b = bound(ops, linesum_bytes(plan.n_blocks * plan.block, lines.n_lines, coef,
                                 plan.device_arrays(dev)["win"], n, plan.n_nu) + bcoef.numel() * 4,
              exps)
    idx = sample_blocks(plan.nu_blocks)
    peak = _exact_sampled_check("linesum_phco2", out, plan, idx, l64, lines, states, "phco2",
                                report, ms, b, dict(mode="phco2_split", d_near=d_near, **pairs))
    del out

    # the coarse route's passes
    name, params = ls._resolve(plan, lines, "phco2", "auto", n)
    check(name == "coarse", f"phco2's auto takes {name} at 57 states x 2^19, not coarse")
    geom = ls.coarse_geometry(plan, lines, params)
    check(geom.stencil is not None, "the phco2 main grid's coarse route has no stencil pass")
    z = geom.zones
    d_far, h, n_cc, c_ratio = params
    cgrid = geom.coarse_blocks.reshape(-1)[:n_cc]
    cp = pairs_within(cgrid, pos, z["cut"], z["d_lo"])
    cp3 = pairs_beyond(cgrid, pos, z["cut"], z["d_lo"])
    _phco2_mode_line("linesum_phco2_coarse", "coarse", geom.coarse_blocks, geom.coarse_windows,
                     n_cc, lines, l64, states, z, None,
                     (cp * (PAIR_OPS + PH_PAIR_OPS + 2 * SMOOTH_OPS + n * (PH_R1_OPS + 1))
                      + cp3 * n * CHI_OPS, cp3 * n), report, stride=4,
                     extra=dict(coarse_points=n_cc, h=h, d_far=d_far, in_zone_pairs=cp))
    mid = pairs_within(plan.nu, pos, z["cut_f"])
    ann = pairs_within(plan.nu, pos, z["cut"], math.sqrt(z["R1"]))
    mid3 = pairs_beyond(plan.nu, pos, z["cut_f"])
    fine = _phco2_mode_line(
        "linesum_phco2_fine_stencil", "fine_stencil", geom.fine_blocks, geom.fine_windows,
        plan.n_nu, lines, l64, states, z, None,
        ((mid + ann) * (PAIR_OPS + PH_PAIR_OPS + SMOOTH_OPS + n * (PH_R1_OPS + 1))
         + (mid3 + ann) * n * CHI_OPS, (mid3 + ann) * n), report,
        extra=dict(mid_pairs=mid, annulus_pairs=ann, K=geom.stencil.K))
    del fine
    # the chi correction, on the whole grid, against each state's peak on
    # the sample (which holds the band centres)
    _phco2_correction_line(geom.stencil, lines, l64, states, plan, peak, (z["D1"], z["D2"]),
                           report)

    # FINE: the in-kernel fine pass, where the stencil rejects (K > 64)
    plan20 = ct.DirectGas.from_lines(lines, CONC, phco2_grid(lines, N_NU_FINE),
                                     shape="phco2").plan
    name20, params20 = ls._resolve(plan20, lines, "phco2", "auto", n)
    check(name20 == "coarse" and ls.stencil_geometry(plan20, lines) is None,
          "the phco2 2^20 grid does not take the coarse route with the in-kernel fine pass")
    g20 = ls.coarse_geometry(plan20, lines, params20)
    z20 = g20.zones
    dn = near_distance(a, z20["cut_f"])
    mid20 = pairs_within(plan20.nu, pos, z20["cut_f"])
    near20 = pairs_within(plan20.nu, pos, float(dn))
    ann20 = pairs_within(plan20.nu, pos, z20["cut"], math.sqrt(z20["R1"]))
    mid20_3 = pairs_beyond(plan20.nu, pos, z20["cut_f"])
    _phco2_mode_line(
        "linesum_phco2_fine", "fine", g20.fine_blocks, g20.fine_windows, plan20.n_nu, lines,
        l64, states, z20, dn,
        ((mid20 + ann20) * (PAIR_OPS + PH_PAIR_OPS + SMOOTH_OPS)
         + (mid20 - near20 + ann20) * n * (PH_R1_OPS + 1) + (mid20_3 + ann20) * n * CHI_OPS
         + near_w4_ops(plan20.nu, pos, co[1], co[2], float(dn), T=T) + near20 * n * 2,
         (mid20_3 + ann20) * n), report,
        extra=dict(mid_pairs=mid20, near_pairs=near20, annulus_pairs=ann20, d_near=float(dn)))
    return dict(lines=lines, l64=l64, plan=plan, states=states)


def _phco2_correction_line(geom, lines, l64, states, plan, peak, weight, report):
    """The correction's chi instance against its float64 plain version on
    the whole grid, measured against each state's peak cross-section (bar
    1e-4, as the voigt instance's)."""
    from clearsky_tpu_torch.ops import linesum_strategies as ls
    from clearsky_tpu_torch.ops.linesum_cuda import stencil_correction

    dev = states[0].device
    _, co, _, _ = _phco2_operands(lines, states)
    x64 = [x.double() for x in states]
    _, co64, _, _ = _phco2_operands(l64, x64)
    n, n_nu = int(states[0].shape[0]), plan.n_nu
    launch = lambda: stencil_correction(torch.zeros((n, n_nu), device=dev), geom, co, plan.cut,
                                        weight, T=states[0])
    out = launch()
    torch.cuda.synchronize()
    ref = ls.stencil_correction_plain(geom, co64, plan.cut, n_nu, weight, T=x64[0])
    err = float(((out.double() - ref).abs() / peak).max())
    max_abs = float((out.double() - ref).abs().max())
    del ref
    ms = cuda_ms(launch)
    plain_ms = cuda_ms(lambda: ls.stencil_correction_plain(geom, co, plan.cut, n_nu, weight,
                                                           T=states[0]), n=3, warmup=1)
    hi = torch.as_tensor(geom.dnu_hi, device=dev)
    lo = torch.as_tensor(geom.dnu_lo, device=dev)
    q = torch.as_tensor(geom.q, device=dev)
    inside = ((q[None, :] * geom.K + torch.arange(2 * geom.K, device=dev)[:, None]) < n_nu) \
        & (hi.abs() <= plan.cut)
    # the farthest the correction acts from a line (x^2 <= 225 at some
    # state): below 3 cm^-1 chi is 1 there, which the kernel computes anyway
    reach, ops = 0.0, 0.0
    for s in range(n):
        x = co[1][s][None, :] * hi + co[1][s][None, :] * lo
        m = inside & (x * x <= 225.0)
        if bool(m.any()):
            reach = max(reach, float((hi + lo).abs()[m].max()))
        ops += w4_ops(x[m], co[2][s].expand_as(x)[m]) + (CORRECTION_OPS + 2) * int(m.sum())
    ops += (SMOOTH_OPS + PH_PAIR_OPS) * int(inside.sum())
    L = geom.q.shape[0]
    b = bound(ops, 8 * hi.numel() + 4 * L + 12 * n * L + 8 * n * n_nu)
    emit("kernel", kernel="stencil_correction_phco2", weighted=weight is not None, points=n_nu,
         states=n, lines=lines.n_lines, K=geom.K, reach_cm=reach, err_of_peak_sigma=err,
         max_abs_err=max_abs, bar="1e-4 of each state's peak sigma", ms=ms, plain_ms=plain_ms,
         plain_shape="same", **b)
    check(bool(torch.isfinite(out).all()) and err < 1e-4,
          f"chi correction off its float64 plain version by {err:.3e} of peak sigma")
    report["stencil_correction_phco2"] = dict(
        max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, library_ms=None,
        shape=f"{n} states x {n_nu} points, K = {geom.K}", **b)


def kernel_phco2_strategies(par, seed, dev, report):
    """The phco2 instances the strategies run, at 16 states x 2^15 (not
    auto's route here): FARALL (explicit "stencil") with the correction,
    K1-seg (a budget that cuts the catalog into segments), K4 ("lane") and
    K5 ("gathered"), each against its float64 plain version on the whole
    grid. Returns the plan and states for the strategies' entry points."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops import linesum_cuda as lc
    from clearsky_tpu_torch.ops import linesum_strategies as ls
    from clearsky_tpu_torch.ops.linesum import _line_params, sigma_from_lines

    l64 = ct.SpectralLines.from_par_dict(par, dtype=torch.float64, device=dev)
    lines = l64.to(torch.float32)
    plan = ct.DirectGas.from_lines(lines, CONC, phco2_grid(lines, N_NU_KERNEL), shape="phco2",
                                   strategy="stencil").plan
    rng = np.random.default_rng(seed + 5)
    Tn = rng.uniform(160.0, 285.0, N_STATES_KERNEL)
    Pn = np.geomspace(PT, PS, N_STATES_KERNEL)
    x64 = [torch.tensor(x, dtype=torch.float64, device=dev) for x in (Tn, Pn, CONC * Pn)]
    states = [x.float() for x in x64]
    n, pos, T = N_STATES_KERNEL, lines.positions64(), states[0]
    check(ls.route(plan, lines, "phco2", "stencil", n) == "stencil",
          "explicit stencil does not take its route at 16 x 2^15")
    # FARALL and the correction
    pairs = pairs_within(plan.nu, pos, plan.cut)
    p3 = pairs_beyond(plan.nu, pos, plan.cut)
    _phco2_mode_line("linesum_phco2_farall", "farall", plan.nu_blocks, plan.windows(), plan.n_nu,
                     lines, l64, states, {"cut": plan.cut}, None,
                     (pairs * (PAIR_OPS + PH_PAIR_OPS + n * PH_R1_OPS) + p3 * n * CHI_OPS,
                      p3 * n), report, stride=1, extra=dict(in_cut_pairs=pairs))
    exact = sigma_from_lines(plan, l64, *x64, shape="phco2")
    ref32 = sigma_from_lines(plan, lines, *states, shape="phco2")
    edge = cut_edges(plan, pos)
    S, alpha, gamma = _line_params(lines, *states)
    _, co, _, bcoef = _phco2_operands(lines, states)
    # K1-seg: three segments
    budget = segment_budget(plan, lines, n)
    L_seg = ls._resolve(plan, lines, "phco2", "grouped", n, budget)[1]
    segs = ls.segments(plan, lines.n_lines, L_seg)
    prepared = []
    for seg, grid in lc._segment_windows(plan, lines.n_lines, L_seg, dev):
        sub = ls._slice_lines(lines, seg.a, seg.b)
        Ss, As, Gs = _line_params(sub, *states)
        prepared.append((seg, grid, sub, lc.pack_coefficients(7, Ss, As, Gs),
                         lc.near_distance(As, plan.cut)))
    acc = torch.zeros((n, plan.n_nu), device=dev)

    def seg_launch():
        acc.zero_()
        for seg, grid, sub, coef, d_near in prepared:
            lc.launch_mode(7, grid, sub, coef, n, seg.n_out, lc._zones(plan.cut), d_near,
                           out=acc[:, seg.blo * plan.block:], count_as="phco2_segmented",
                           bcoef=bcoef)

    seg_launch()
    torch.cuda.synchronize()
    out = acc.clone()
    ms = cuda_ms(seg_launch, n=5)
    ops, nbytes, exps = 0.0, 4 * n * plan.n_nu, 0.0
    for sg in segs:
        g = plan.nu[sg.blo * plan.block: sg.blo * plan.block + sg.n_out]
        d_near = float(torch.clamp(15.0 * alpha[:, sg.a:sg.b].max(), max=plan.cut))
        o, e, _ = _phco2_split_ops(g, pos[sg.a:sg.b], co[1][:, sg.a:sg.b], co[2][:, sg.a:sg.b],
                                   T, d_near, plan.cut, n)
        ops, exps = ops + o, exps + e
        nbytes += (8 * (sg.bhi - sg.blo) * plan.block + 8 * (sg.b - sg.a)
                   + 4 * 3 * 8 * -(-n // 8) * (sg.b - sg.a) + 8 * (sg.bhi - sg.blo))
    b = bound(ops, nbytes + bcoef.numel() * 4, exps)
    _, plain_ms = one_call(lambda: ls.sigma_segmented_plain(plan, lines, *states, L_seg,
                                                            shape="phco2"))
    _mix_line("linesum_phco2_segmented", out, exact, ref32, edge, ms, plain_ms, b, report,
              segments=len(segs), segment_lines=L_seg, budget_bytes=budget)
    # K4 and K5: w4 (y = y0 chi) at every in-cut pair and state
    full_ops = (pairs * (PAIR_OPS + PH_PAIR_OPS) + p3 * n * CHI_OPS
                + near_w4_ops(plan.nu, pos, co[1], co[2], plan.cut, T=T))
    for kind, kern in (("lane", lc.sigma_lane), ("gathered", lc.sigma_gathered)):
        out = kern(plan, lines, *states, shape="phco2")
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: kern(plan, lines, *states, shape="phco2"), n=3, warmup=1)
        plain = ls.sigma_lane_plain if kind == "lane" else ls.sigma_gathered_plain
        _, plain_ms = one_call(lambda: plain(plan, lines, *states, shape="phco2"))
        slab_pad = -(-plan.slab // 128) * 128
        if kind == "lane":
            lay_bytes = (8 + 12 * n) * ls.lane_layout(plan, lines, S, alpha, gamma).nu.shape[0]
        else:
            lay_bytes = (8 + 12 * n) * plan.n_blocks * slab_pad
        b = bound(full_ops, lay_bytes + 8 * plan.n_blocks * plan.block + 8 * plan.n_blocks
                  + 4 * n * plan.n_nu, p3 * n)
        _mix_line(f"linesum_phco2_{kind}", out, exact, ref32, edge, ms, plain_ms, b, report)
    return dict(lines=lines, plan=plan, states=states)


def phase_phco2(par, dev):
    """The dense-CO2 main path at the production shape: a phco2 DirectGas
    (constructor defaults) on 2^19 points over the catalog +- 500 cm^-1, the
    20-level column of a 285 K surface, 5 streams: outgoing and radiate on
    "auto" (the coarse route), outgoing on "grouped" (band OLR within 1e-4
    of auto's) and outgoing at 2^20 points (the in-kernel fine pass)."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.constants import SIGMA_SB
    from clearsky_tpu_torch.ops import linesum_strategies as ls

    lines = ct.SpectralLines.from_par_dict(par)
    nu = phco2_grid(lines, N_NU_MAIN)
    gas = ct.DirectGas.from_lines(lines, CONC, nu, shape="phco2")
    grouped = ct.DirectGas.from_lines(lines, CONC, nu, shape="phco2", strategy="grouped")
    gas20 = ct.DirectGas.from_lines(lines, CONC, phco2_grid(lines, N_NU_FINE), shape="phco2")
    routes = {f"{k}_{n}": ls.route(g.plan, lines, "phco2", "auto", n_states=n)
              for k, g in (("2e19", gas), ("2e20", gas20)) for n in (57, 38)}
    check(set(routes.values()) == {"coarse"}, f"phco2's auto does not route coarse: {routes}")
    Pe = ct.pressuregrid(PT, PS, N_LEVELS)
    Te = column(Pe, TS_RCE)
    span = float(nu[-1] - nu[0])
    fS = lambda v: torch.full_like(v, 340.0 / math.cos(0.841) / span)
    calls = {"phco2_outgoing": lambda: ct.outgoing(Pe, G, Te, MU, gas),
             "phco2_radiate": lambda: ct.radiate(Pe, G, Te, MU, fS, 0.1, gas),
             "phco2_outgoing_grouped": lambda: ct.outgoing(Pe, G, Te, MU, grouped),
             "phco2_outgoing_2e20": lambda: ct.outgoing(Pe, G, Te, MU, gas20)}
    counts_reset()
    out = {k: fn() for k, fn in calls.items()}
    torch.cuda.synchronize()
    counts = counts_read()
    launched = {k for k, v in counts.items() if v}
    emit("counts", path="phco2", **counts)
    check(launched <= PHCO2_KERNELS | {"olr_march", "monoflux_march"},
          f"the phco2 path launched {launched - PHCO2_KERNELS}")
    for k in ("linesum_phco2", "linesum_phco2_coarse", "linesum_phco2_fine_stencil",
              "linesum_phco2_fine", "stencil_correction_phco2", "olr_march", "monoflux_march"):
        check(counts[k] > 0, f"kernel {k} was not launched on the phco2 path")
    olr, F, olr_g, olr20 = out.values()
    nu64 = gas.nu.double()
    band, band_g = (float(ct.trapz(nu64, x.double())) for x in (olr, olr_g))
    band20 = float(ct.trapz(gas20.nu.double(), olr20.double()))
    bb = SIGMA_SB * Te[-1] ** 4
    rel = abs(band - band_g) / band_g
    for k in ("F_up", "F_down", "F_net"):
        check(bool(torch.isfinite(getattr(F, k)).all()), f"phco2 radiate {k} is not finite")
    check(bool(torch.isfinite(olr).all()) and bool(torch.isfinite(olr_g).all())
          and 0.0 < band < bb and 0.0 < band20 < bb, "phco2 OLR not finite or out of range")
    ms = {k: wall_ms(fn) for k, fn in calls.items()}
    emit("phco2", step="entry_points", lines=lines.n_lines,
         catalog=f"{lines.dtype} on {lines.device}", points=N_NU_MAIN, levels=N_LEVELS,
         streams=5, cut=PHCO2_CUT, nu_range=[float(nu[0]), float(nu[-1])], routes=routes,
         band_olr_W_m2=band, grouped_band_olr_W_m2=band_g, auto_vs_grouped_band_rel=rel,
         bar=1e-4, band_olr_2e20_W_m2=band20, sigma_Ts4_W_m2=float(bb),
         F_net_toa_W_m2=float(F.F_net[0]), F_down_surface_W_m2=float(F.F_down[-1]),
         wall_ms_per_call=ms, grouped_over_auto=ms["phco2_outgoing_grouped"]
         / ms["phco2_outgoing"])
    check(rel < 1e-4, f"phco2 auto and grouped band OLR differ by {rel:.3e}")
    return calls, counts


def phase_phco2_strategies(par, dev, strat):
    """The strategies' entry points at 57 Lobatto states x 2^15: outgoing on
    DirectGas(strategy="stencil", "lane", "gathered") (band OLR within 1e-4
    of auto's) and the routed line sum at a budget that cuts the catalog
    into segments (within 1e-5 of peak of the one-launch sum); counted on
    their own."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops import linesum_strategies as ls
    from clearsky_tpu_torch.ops.linesum_cuda import sigma_routed

    lines = strat["lines"]
    nu = phco2_grid(lines, N_NU_KERNEL)
    Pe = ct.pressuregrid(PT, PS, N_LEVELS)
    Te = column(Pe, TS_RCE)
    nu64 = torch.as_tensor(nu, device=dev)
    auto = ct.DirectGas.from_lines(lines, CONC, nu, shape="phco2")
    band_auto = float(ct.trapz(nu64, ct.outgoing(Pe, G, Te, MU, auto).double()))
    T, P, _ = main_states(dev, TS_RCE)
    counts, res = {}, {}
    for strategy in ("stencil", "lane", "gathered"):
        gas = ct.DirectGas.from_lines(lines, CONC, nu, shape="phco2", strategy=strategy)
        check(ls.route(gas.plan, lines, "phco2", strategy, n_states=57) == strategy,
              f"phco2 strategy {strategy} does not take its own route")
        counts_reset()
        olr = ct.outgoing(Pe, G, Te, MU, gas)
        torch.cuda.synchronize()
        got = {k: v for k, v in counts_read().items() if v}
        counts[strategy] = got
        band = float(ct.trapz(nu64, olr.double()))
        res[strategy] = dict(band_olr_W_m2=band, rel_to_auto=abs(band - band_auto) / band_auto,
                             launches=got)
        want = {"stencil": {"linesum_phco2_farall", "stencil_correction_phco2"},
                "lane": {"linesum_phco2_lane"}, "gathered": {"linesum_phco2_gathered"}}[strategy]
        check(set(got) == want | {"olr_march"}, f"phco2 outgoing on {strategy} launched {got}")
        check(res[strategy]["rel_to_auto"] < 1e-4,
              f"phco2 band OLR on {strategy} off auto's by {res[strategy]['rel_to_auto']:.3e}")
    plan = auto.plan
    budget = segment_budget(plan, lines, 57)
    check(ls.route(plan, lines, "phco2", "grouped", 57, budget) == "segmented",
          "the phco2 budget does not cut the catalog into segments at 57 states")
    C = torch.full_like(P, CONC)
    one = sigma_routed(plan, lines, T, P, C * P, shape="phco2", strategy="grouped")
    counts_reset()
    seg = sigma_routed(plan, lines, T, P, C * P, shape="phco2", strategy="grouped",
                       resident_limit=budget)
    torch.cuda.synchronize()
    counts["segmented"] = {k: v for k, v in counts_read().items() if v}
    err = of_peak(seg, one.double())
    res["segmented"] = dict(budget_bytes=budget, err_of_peak_vs_one_launch=err,
                            launches=counts["segmented"])
    check(set(counts["segmented"]) == {"linesum_phco2_segmented"}
          and counts["segmented"]["linesum_phco2_segmented"] > 1,
          f"the phco2 segmented route launched {counts['segmented']}")
    check(err < 1e-5, f"phco2 segmented sigma off the one-launch sum by {err:.3e} of peak")
    emit("phco2", step="strategies", points=N_NU_KERNEL, states=57,
         auto_band_olr_W_m2=band_auto, bar=1e-4, **res)
    total = {}
    for c in counts.values():
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    return total


def phase_phco2_bake(par, dev):
    """A phco2 Gas baked on the table phase's domain at 2^19 points (its
    bake on phco2's auto route): seconds and launches by mode; one node's
    sigma against the DirectGas sigma at that node."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops import linesum_strategies as ls

    lines = ct.SpectralLines.from_par_dict(par)
    nu = phco2_grid(lines, N_NU_MAIN)
    dom = ct.AtmosphericDomain.create(*TABLE_DOMAIN)
    counts_reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gas = ct.Gas.from_lines(lines, CONC, nu, dom, shape="phco2")
    torch.cuda.synchronize()
    bake_s = time.perf_counter() - t0
    launches = {k: v for k, v in counts_read().items() if v}
    calls = -(-dom.nT * dom.nP // 16)
    check(ls.route(ct.DirectGas.from_lines(lines, CONC, nu, shape="phco2").plan, lines, "phco2",
                   "auto", 16) == "coarse", "the phco2 bake's batches do not route coarse")
    check(launches == {"linesum_phco2_fine_stencil": calls, "linesum_phco2_coarse": calls,
                       "stencil_correction_phco2": calls},
          f"the phco2 bake did not take the coarse route once per batch: {launches}")
    direct = ct.DirectGas.from_lines(lines, CONC, nu, shape="phco2")
    iT, iP = dom.nT // 2, dom.nP // 2
    T = torch.tensor([dom.T[iT]], dtype=torch.float32, device=dev)
    P = torch.tensor([dom.P[iP]], dtype=torch.float32, device=dev)
    tab, dir_ = gas.raw_sigma(T, P)[0].double(), direct.raw_sigma(T, P)[0].double()
    m = dir_ > 1e-6 * dir_.max()
    rel = float(((tab - dir_).abs()[m] / dir_[m]).max())
    emit("table", step="phco2_bake", points=N_NU_MAIN, nT=dom.nT, nP=dom.nP,
         bake_seconds=bake_s, launches=launches, node_T_K=float(T), node_P_Pa=float(P),
         node_max_rel_vs_direct=rel, bar="1e-2 where sigma > 1e-6 of its peak")
    check(bool(torch.isfinite(gas.coeffs).all()), "the phco2 table is not finite")
    check(rel < 1e-2, f"the phco2 table at a node is off the direct sigma by {rel:.3e}")


def _host_reference_gas(lines64, plan, shape, nu):
    """A float64 absorber on the host whose cross-sections are the plain
    exact line sum on the card (the kernel wrappers take float32 only):
    a zero gray gas beside the callable."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops.linesum import sigma_from_lines

    dev = lines64.device

    def sigma64(nu_, T, P):
        Tc, Pc = T[..., 0].to(dev), P[..., 0].to(dev)
        return (CONC * sigma_from_lines(plan, lines64, Tc, Pc, CONC * Pc, shape)).cpu()

    return ct.GrayGas.create(0.0, nu, dtype=torch.float64, device="cpu"), sigma64


def phase_voigt_ref(par, dev):
    """outgoing on a voigt_ref DirectGas (constructor defaults, 2^19 points)
    against float64: the plain exact line sum on the card, the march on the
    host. Counted on its own: the voigt instances and K2 only."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops import linesum_strategies as ls

    lines = ct.SpectralLines.from_par_dict(par)
    nu = grid_for(lines, N_NU_MAIN)
    gas = ct.DirectGas.from_lines(lines, CONC, nu, shape="voigt_ref")
    route = ls.route(gas.plan, lines, "voigt_ref", "auto", 57)
    check(route == ls.route(gas.plan, lines, "voigt", "auto", 57) == "coarse",
          "voigt_ref does not route as voigt")
    Pe = ct.pressuregrid(PT, PS, N_LEVELS)
    Te = column(Pe)
    counts_reset()
    olr = ct.outgoing(Pe, G, Te, MU, gas)
    torch.cuda.synchronize()
    launched = {k: v for k, v in counts_read().items() if v}
    l64 = ct.SpectralLines.from_par_dict(par, dtype=torch.float64, device=dev)
    ref = ct.outgoing(Pe, G, Te, MU, *_host_reference_gas(l64, gas.plan, "voigt_ref", nu))
    nu64 = torch.as_tensor(nu)
    band, band_ref = float(ct.trapz(nu64, olr.double().cpu())), float(ct.trapz(nu64, ref))
    rel = abs(band - band_ref) / band_ref
    spec = float((olr.double().cpu() - ref).abs().max() / ref.abs().max())
    voigt = float(ct.trapz(nu64, ct.outgoing(Pe, G, Te, MU, ct.DirectGas.from_lines(
        lines, CONC, nu)).double().cpu()))
    # the spectrum carries the coarse split's error where sigma is small
    # (5e-2 relative where it exceeds 1e-6 of peak, the route's bar), so the
    # bar is the band's, as for auto against grouped
    emit("voigt_ref", points=N_NU_MAIN, route=route, launches=launched, band_olr_W_m2=band,
         float64_band_olr_W_m2=band_ref, band_rel=rel, bar=1e-4,
         spectral_max_diff_of_peak=spec, voigt_band_olr_W_m2=voigt)
    check(set(launched) == {"linesum_coarse", "linesum_fine_stencil", "stencil_correction",
                            "olr_march"}, f"voigt_ref outgoing launched {launched}")
    check(rel < 1e-4, f"voigt_ref band OLR off float64 by {rel:.3e}")


def phase_rce(par, dev):
    """A dense-CO2 column to radiative-convective equilibrium: RCM.create on
    a phco2 DirectGas at 16,384 points over the catalog +- 500 cm^-1, 20
    edge levels, radmul 2, from DryAdiabat(285 K, 1e5 Pa, 850, 0.044,
    Tstrat=160); run 60 hourly steps, the absorber refreshed every 6, the
    convective adjustment every step, recorded every 10. Against the same
    run in float64 (cross-sections by the plain exact line sum on the card,
    march on the host): each record's heating within 5e-3 of its peak, the
    temperatures within the bound that implies, sum of dt 5e-3 max|H|."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops import linesum_strategies as ls

    lines = ct.SpectralLines.from_par_dict(par)
    nu = phco2_grid(lines, N_NU_RCM)
    gas = ct.DirectGas.from_lines(lines, CONC, nu, shape="phco2")
    name, params = ls._resolve(gas.plan, lines, "phco2", "auto", N_LEVELS)
    geom = ls.coarse_geometry(gas.plan, lines, params)
    fine = "fine_stencil" if geom.stencil is not None else "fine"
    check(name == "coarse", f"the RCM's refresh takes {name}, not the coarse route")
    Pe = ct.pressuregrid(PT, PS, N_LEVELS)
    adiabat = ct.DryAdiabat.create(TS_RCE, PS, CP, MU, Tstrat=160.0)
    Te = adiabat(Pe).numpy()
    span = float(nu[-1] - nu[0])
    fS = lambda v: torch.full_like(v, 340.0 / math.cos(0.841) / span)
    fmu, fcp = (lambda T, P: MU), (lambda T, P: CP)
    rcm = ct.RCM.create(Pe, Te, G, fmu, fS, 0.1, fcp, 1e7, gas, radmul=2)
    torch.cuda.synchronize()
    kw = dict(update_every=RCE_UPDATE, adjust_every=1, cp=CP, mu=MU, record_every=RCE_RECORD)
    t0 = time.perf_counter()
    ct.run(rcm, RCM_DT, 1, **kw)
    torch.cuda.synchronize()
    cold_ms = 1e3 * (time.perf_counter() - t0)
    counts_reset()
    t0 = time.perf_counter()
    out, hist = ct.run(rcm, RCM_DT, RCE_STEPS, **kw)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = counts_read()
    launched = {k for k, v in counts.items() if v}
    emit("counts", path="rce", **counts)
    check(launched <= PHCO2_KERNELS | {"monoflux_march"},
          f"the RCE run launched {launched - PHCO2_KERNELS}")
    for k in ("linesum_phco2_coarse", f"linesum_phco2_{fine}", "monoflux_march"):
        check(counts[k] > 0, f"kernel {k} was not launched by the RCE run")
    refreshes = RCE_STEPS // RCE_UPDATE
    check(counts["linesum_phco2_coarse"] == refreshes,
          f"{counts['linesum_phco2_coarse']} coarse launches for {refreshes} refreshes")
    check(bool(torch.isfinite(hist).all()) and hist.shape == (RCE_STEPS // RCE_RECORD, N_LEVELS),
          "the RCE history is not finite or has the wrong shape")
    warm_step_ms = [wall_ms(lambda: ct.step(rcm, RCM_DT)),
                    wall_ms(lambda: ct.update_absorber(rcm))]
    # step_n is three steps, bit for bit
    a, b_ = ct.step_n(rcm, RCM_DT, 3), rcm
    for _ in range(3):
        b_ = ct.step(b_, RCM_DT)
    check(torch.equal(a.T, b_.T), "step_n(rcm, dt, 3) is not three steps")

    # the float64 run on the host
    l64 = ct.SpectralLines.from_par_dict(par, dtype=torch.float64, device=dev)
    zero, sigma64 = _host_reference_gas(l64, gas.plan, "phco2", nu)
    r64 = ct.RCM.create(Pe, Te, G, fmu, fS, 0.1, fcp, 1e7, zero, sigma64, radmul=2)
    t0 = time.perf_counter()
    out64, hist64 = ct.run(r64, RCM_DT, RCE_STEPS, **kw)
    ref_s = time.perf_counter() - t0
    # each record's heating: both pipelines at the float32 run's recorded
    # temperatures, each absorber refreshed there
    lnPe, lnP = torch.log(rcm.Pe), torch.log(rcm.P)
    from clearsky_tpu_torch.utils.interp import interp_linear

    H_err, H_peak = [], []
    for Tk in hist:
        Tk64 = Tk.double().cpu()
        H32 = ct.heating(rcm, Tk, rcm.A.update(interp_linear(lnPe, lnP, Tk))).double().cpu()
        Te64 = interp_linear(torch.log(r64.Pe), torch.log(r64.P), Tk64)
        H64 = ct.heating(r64, Tk64, r64.A.update(Te64))
        H_peak.append(float(H64.abs().max()))
        H_err.append(float((H32 - H64).abs().max()) / H_peak[-1])
    dT = (hist.double().cpu() - hist64).abs().amax(dim=1)
    steps = RCE_RECORD * np.arange(1, hist.shape[0] + 1)
    T_bound = steps * RCM_DT * 5e-3 * max(H_peak)
    emit("rce", points=N_NU_RCM, edge_levels=N_LEVELS, radmul=2, steps=RCE_STEPS,
         dt_s=RCM_DT, update_every=RCE_UPDATE, adjust_every=1, record_every=RCE_RECORD,
         refresh_route=name, fine_pass=fine, coarse_params=list(params),
         cold_first_step_ms=cold_ms, run_seconds=run_s,
         ms_per_step_with_refresh_and_adjustment=1e3 * run_s / RCE_STEPS,
         warm_step_ms=warm_step_ms[0], refresh_ms=warm_step_ms[1],
         float64_run_seconds=ref_s, T_surface_K=[float(hist[0, -1]), float(hist[-1, -1])],
         T_top_K=[float(hist[0, 0]), float(hist[-1, 0])],
         heating_err_of_peak=H_err, heating_peak_K_per_day=[86400 * h for h in H_peak],
         T_max_abs_diff_K=dT.tolist(), T_bound_K=T_bound.tolist(),
         bar="heating 5e-3 of peak; T within sum dt 5e-3 max|H|")
    check(max(H_err) < 5e-3, f"RCE heating off float64 by {max(H_err):.3e} of peak")
    check(bool((dT.numpy() <= T_bound).all()),
          f"RCE temperatures off float64 by {dT.tolist()} K, bound {T_bound.tolist()}")
    return {"rce_run_6_steps": lambda: ct.run(rcm, RCM_DT, RCE_UPDATE, **kw),
            "rce_step": lambda: ct.step(rcm, RCM_DT)}, counts


def _busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


# K1's template instances by mode number (csrc/linesum.cu ``Mode``) and its
# accumulate flag (K1-seg), K4/K5 by their shape and gathered flag, the
# correction by its chi flag, in the demangled (linesum_kernel<3, false>) or
# mangled (linesum_kernelILi3ELb0E) name
_K1_MODE = {0: "linesum", 3: "linesum_farall", 4: "linesum_fine", 5: "linesum_fine_stencil",
            6: "linesum_coarse", 7: "linesum_phco2", 8: "linesum_phco2_farall",
            9: "linesum_phco2_fine", 10: "linesum_phco2_fine_stencil",
            11: "linesum_phco2_coarse"}
_PHCO2_SHAPE = 7
_K1_NAME = re.compile(r"linesum_kernel(?:<|ILi)(\d+)(?:, ?(true|false)|ELb([01]))?")
_FULL_NAME = re.compile(r"fullprofile_kernel(?:<|ILi)(\d+)(?:, ?(true|false)|ELb([01]))")
_CORRECTION_NAME = re.compile(r"stencil_correction_kernel(?:<(true|false)>|ILb([01])E)")
_OTHER_KERNELS = {k: re.compile(rf"\b{v}\b") for k, v in (
    ("olr_march", "olr_kernel"), ("monoflux_march", "monoflux_kernel"),
    ("fused_olr", "fused_olr_kernel"), ("fused_monoflux", "fused_monoflux_kernel"))}


def _kernel_of(name: str):
    m = _K1_NAME.search(name)
    if m:
        fam = "phco2_" if int(m.group(1)) == _PHCO2_SHAPE else ""
        if m.group(2) == "true" or m.group(3) == "1":
            return f"linesum_{fam}segmented"
        return _K1_MODE.get(int(m.group(1)), "linesum_other")
    m = _FULL_NAME.search(name)
    if m:
        fam = "phco2_" if int(m.group(1)) == _PHCO2_SHAPE else ""
        kind = "gathered" if m.group(2) == "true" or m.group(3) == "1" else "lane"
        return f"linesum_{fam}{kind}"
    m = _CORRECTION_NAME.search(name)
    if m:
        return "stencil_correction_phco2" if "true" in m.groups() or "1" in m.groups() \
            else "stencil_correction"
    for k, p in _OTHER_KERNELS.items():
        if p.search(name):
            return k
    return None


def phase_profile(calls, n: int = 3):
    """Where the device time of each main-path call goes (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    for name, fn in calls.items():
        wall = wall_ms(fn, n=n)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        check(len(evs) > 0, f"the profiler traced no device activity in {name}")
        device = _busy_us([(e.time_range.start, e.time_range.end) for e in evs]) / n / 1e3
        per_kernel = {}
        for e in evs:
            k = _kernel_of(e.name)
            if k is not None:
                per_kernel[k] = per_kernel.get(k, 0.0) + e.time_range.elapsed_us() / n / 1e3
        emit("profile", call=name, calls=n, wall_ms_per_call=wall,
             device_ms_per_call=device, device_ops_per_call=len(evs) / n,
             kernel_ms_per_call=per_kernel, idle_share=1.0 - device / wall)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.spectra.synthetic import synthetic_co2_par

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = phase_env(dev)
    phase_build()
    par = synthetic_co2_par(N_LINES, seed=args.seed)
    report = {}
    kernel_linesum(par, args.seed, dev)
    ms_main = kernel_linesum_main_shape(par, dev, report)
    kernel_coarse(ms_main, par, dev, report)
    rcm_shape = kernel_stencil(par, dev, report)
    route_calls = phase_routes(ms_main, ("grouped", "stencil", "coarse"), "coarse")
    route_calls.update(phase_routes(rcm_shape, ("grouped", "stencil"), "stencil"))
    del ms_main, rcm_shape
    kernel_march(args.seed, dev, report)

    # the counts cover the main path alone, each part read right after it
    # runs: the entry points, then the RCM steps; not the checks that follow
    counts_reset()
    calls, direct_olr = phase_main(par, dev)
    main_counts = counts_read()
    emit("counts", path="main", **main_counts)
    counts_reset()
    rcm_run = phase_rcm(par, dev)
    rcm_counts = counts_read()
    emit("counts", path="rcm", **rcm_counts)
    for k in ("linesum", "linesum_fine", "linesum_fine_stencil", "linesum_coarse",
              "stencil_correction", "olr_march", "monoflux_march"):
        check(main_counts[k] > 0, f"kernel {k} was not launched on the main path")
    for k in ("linesum_farall", "stencil_correction", "monoflux_march"):
        check(rcm_counts[k] > 0, f"kernel {k} was not launched by the RCM steps")
    counts = {k: main_counts[k] + rcm_counts[k] for k in main_counts}
    check_rcm(*rcm_run)
    phase_sanity(dev)
    rcm = rcm_run[0]
    calls["rcm_step"] = lambda: ct.step(ct.update_absorber(rcm), RCM_DT)
    calls["rcm_heating"] = lambda: ct.heating(rcm)

    # the baked-table path, counted on its own
    gs = phase_table_bake(par, dev)
    kernel_fused(gs, dev, report)
    table_calls, table_counts = phase_table(gs, dev, direct_olr)
    for k in ("fused_olr", "fused_monoflux"):
        counts[k] = table_counts[k]
    calls.update(table_calls)
    calls.update(route_calls)

    # the mix: HITRAN files at full-catalog size; each part of its main path
    # counted on its own
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        mix = phase_mix_build(args.seed, dev, tmp)
    kernel_mix(mix, dev, mix["states4"])
    kernel_mix(mix, dev, mix["states"], report)
    entry, mix_calls, mix_counts = phase_mix_entry(mix, dev)
    counts_reset()
    rcm_mix = phase_mix_rcm(mix, dev)
    rcm_mix_counts = {k: v for k, v in counts_read().items() if v}
    emit("counts", path="mix_rcm", route=rcm_mix[3], **rcm_mix_counts)
    check(set(rcm_mix_counts) == ROUTE_KERNELS[rcm_mix[3]] | {"monoflux_march"},
          f"the mix RCM on the {rcm_mix[3]} route launched {rcm_mix_counts}")
    check_mix_rcm(*rcm_mix, mix["cia"])
    strategy_counts = phase_mix_strategies(mix, entry, dev)
    for part in (mix_counts, rcm_mix_counts, *strategy_counts.values()):
        for k, v in part.items():
            counts[k] += v
    emit("counts", path="mix", **{k: v for k, v in mix_counts.items()},
         lane=strategy_counts["lane"], gathered=strategy_counts["gathered"])
    for k in ("linesum_segmented", "linesum_lane", "linesum_gathered"):
        check(counts[k] > 0, f"kernel {k} was not launched on the mix's main path")
    phase_mix_cia(mix, dev)
    calls.update(mix_calls)
    calls.update(phase_mix_l2(mix, dev))
    del mix, entry, rcm_mix

    # the dense-CO2 column: the phco2 instances at the main path's shapes,
    # then each part of its main path counted on its own
    kernel_phco2(par, dev, report)
    strat = kernel_phco2_strategies(par, args.seed, dev, report)
    ph_calls, ph_counts = phase_phco2(par, dev)
    strat_counts = phase_phco2_strategies(par, dev, strat)
    phase_phco2_bake(par, dev)
    phase_voigt_ref(par, dev)
    rce_calls, rce_counts = phase_rce(par, dev)
    for part in (ph_counts, strat_counts, rce_counts):
        for k, v in part.items():
            counts[k] += v
    for k in sorted(PHCO2_KERNELS):
        check(counts[k] > 0, f"kernel {k} was not launched on the phco2 and rce paths")
    calls.update(ph_calls)
    calls.update(rce_calls)
    phase_profile(calls)

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    kernels = [{"name": k, "route": "cuda", "source": source, "replaces": replaces,
                "launches": counts[k], **{f: report[k][f] for f in keys}}
               for k, (source, replaces) in KERNELS.items()]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

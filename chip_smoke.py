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
  profile for each main-path, table-path and route call, its unprofiled
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
_LINESUM = "clearsky_tpu_torch/csrc/linesum.cu"
_PALLAS = "clearsky_tpu/ops/linesum_pallas.py"
KERNELS = {
    "linesum": (_LINESUM, f"{_PALLAS}:223"),                 # split mode
    "linesum_farall": (_LINESUM, f"{_PALLAS}:451"),          # wmode farall
    "linesum_fine": (_LINESUM, f"{_PALLAS}:427"),            # wmode fine
    "linesum_fine_stencil": (_LINESUM, f"{_PALLAS}:459"),    # wmode fine_stencil
    "linesum_coarse": (_LINESUM, f"{_PALLAS}:478"),          # wmode coarse
    "stencil_correction": (_LINESUM, f"{_PALLAS}:1233"),     # _stencil_apply
    "olr_march": ("clearsky_tpu_torch/csrc/march.cu", "clearsky_tpu/rt/march_pallas.py:158"),
    "monoflux_march": ("clearsky_tpu_torch/csrc/march.cu", "clearsky_tpu/rt/march_pallas.py:94"),
    "fused_olr": ("clearsky_tpu_torch/csrc/fused_table.cu", "clearsky_tpu/rt/fused_table.py:74"),
    "fused_monoflux": ("clearsky_tpu_torch/csrc/fused_table.cu",
                       "clearsky_tpu/rt/fused_table.py:94"),
}
# K1's template modes (csrc/linesum.cu ``Mode``) by the kernel names above
MODE_KERNEL = {"voigt_split": "linesum", "farall": "linesum_farall", "fine": "linesum_fine",
               "fine_stencil": "linesum_fine_stencil", "coarse": "linesum_coarse"}
LIBRARIES = ("linesum", "march", "fused_table")
TABLE_DOMAIN = ((150.0, 350.0), 12, (0.9 * PT, 1.01 * PS), 24)
TABLE_SPLIT = 16
# the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W)
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12
# FP32 operations counted in csrc/linesum.cu, a division as one: per
# (point, line) pair the two-float dnu, |dnu|, D and the masks; per state
# the region-1 tile and its accumulation; a smoothstep; and Re w(x + iy)
# by region (the common t and t^2, then regions 1-4, the small-y repair)
PAIR_OPS, R1_OPS, SMOOTH_OPS = 6, 9, 10
W4_COMMON, W4_REGION, W4_SMALL_Y = 9, (14, 28, 76, 116), 25
CORRECTION_OPS = 22   # x, the explicit region 1, the product, the atomic add


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


def bound(ops: float, nbytes: float) -> dict:
    """The least time of a kernel's work: the larger of its FP32 operations
    at the card's peak and its bytes (each input read once, each output
    written once) at its memory rate."""
    t_ops, t_bytes = 1e3 * ops / FP32_OPS_S, 1e3 * nbytes / HBM_BYTES_S
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                bound_ops=float(ops), bound_bytes=float(nbytes))


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


def near_w4_ops(grid, pos, ia, y0, d_near: float) -> float:
    """Operations of the w4 tiles of the (point, line) pairs within d_near,
    for every state (ia, y0: [n_states, n_lines] on the card)."""
    lo = np.searchsorted(grid, pos - d_near, side="left")
    hi = np.searchsorted(grid, pos + d_near, side="right")
    cnt = hi - lo
    line = np.repeat(np.arange(len(pos)), cnt)
    point = np.arange(cnt.sum()) - np.repeat(np.cumsum(cnt) - cnt, cnt) + np.repeat(lo, cnt)
    keep = np.abs(grid[point] - pos[line]) <= d_near
    line, dnu = line[keep], (grid[point] - pos[line])[keep]
    if line.size == 0:
        return 0.0
    dev = ia.device
    li = torch.as_tensor(line, device=dev)
    x = torch.as_tensor(dnu, dtype=torch.float32, device=dev)[None, :] * ia[:, li]
    return w4_ops(x, y0[:, li].expand_as(x)) + 2.0 * x.numel()


def column(Pe):
    """Dry adiabat with a 160 K floor on the edge pressures Pe."""
    from clearsky_tpu_torch.constants import R_GAS

    return np.maximum(288.0 * (Pe / PS) ** (R_GAS / (MU * CP)), 160.0)


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
    for k in sigma_lines.launches_by_mode:
        sigma_lines.launches_by_mode[k] = 0


def counts_read() -> dict:
    """Launches per kernel of ``KERNELS`` (K1 by mode) since the last reset."""
    from clearsky_tpu_torch.ops.linesum_cuda import sigma_lines, stencil_correction
    from clearsky_tpu_torch.rt.march_cuda import olr_march, monoflux_march
    from clearsky_tpu_torch.rt.fused_table_cuda import fused_olr, fused_monoflux

    out = {k: sigma_lines.launches_by_mode[m] for m, k in MODE_KERNEL.items()}
    out.update(stencil_correction=stencil_correction.launches, olr_march=olr_march.launches,
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


def main_states(dev):
    """outgoing's 57 Lobatto-node states of the main column, float32 on the card."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.atmosphere.profile import formprofile
    from clearsky_tpu_torch.rt.discretized import lobatto_pressures

    Pe = ct.pressuregrid(PT, PS, N_LEVELS)
    Pg = torch.tensor(Pe, dtype=torch.float32, device=dev)
    Pf = lobatto_pressures(Pg, 3).reshape(-1)
    Tf = formprofile(Pg, column(Pe))(Pf)
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


def _busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


# K1's template instances by mode number (csrc/linesum.cu ``Mode``), in the
# demangled (linesum_kernel<3>) or mangled (linesum_kernelILi3E) name
_K1_MODE = {0: "linesum", 3: "linesum_farall", 4: "linesum_fine", 5: "linesum_fine_stencil",
            6: "linesum_coarse"}
_K1_NAME = re.compile(r"linesum_kernel(?:<|ILi)(\d+)")
_OTHER_KERNELS = {k: re.compile(rf"\b{v}\b") for k, v in (
    ("stencil_correction", "stencil_correction_kernel"), ("olr_march", "olr_kernel"),
    ("monoflux_march", "monoflux_kernel"), ("fused_olr", "fused_olr_kernel"),
    ("fused_monoflux", "fused_monoflux_kernel"))}


def _kernel_of(name: str):
    m = _K1_NAME.search(name)
    if m:
        return _K1_MODE.get(int(m.group(1)), "linesum_other")
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

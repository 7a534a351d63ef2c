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
          PyTorch version in float64 on the same inputs (error and bar), and
          the median time of kernel and plain float32 version (CUDA events);
          the line sum also at the main path's shape, where the plain
          versions are timed over one call each
  main    the full-size main path (synthetic 5,599-line CO2 catalog, 2^19
          points, 20 levels, 5 streams): outgoing and radiate, their wall
          time per call and the band fluxes
  counts  the kernels' launch counts over the main path: main, and
          RCM.create with 3 x (update_absorber, step) at 16,384 points
  rcm     milliseconds of each of those steps (the first one cold), and
          the heating of the last state against the plain float64 version
  sanity  a near-transparent and a gray column through the OLR kernel
  table   the baked-table path at the main path's width: the bake of a Gas
          (12 T x 24 ln P domain, 288 line sums through K1: seconds and K1
          launches) and its split_precision(16); the fused kernels K6
          (outgoing's 57 Lobatto nodes) and K7 (radiate's 38) against their
          plain float64 versions on the same split operands, with kernel and
          plain float32 times; outgoing and radiate on the split Gas through
          the entry points (wall time, and the launch counts of that path:
          only K6 and K7); the table band OLR against the DirectGas one of
          ``main``; a split Gas beside a gray gas, which takes the unfused
          route (raw_sigma, K2)
  profile for each main-path and table-path call, its unprofiled wall time
          beside the device time that torch.profiler traces (CUDA
          activity), the kernels' share of it and the device's idle share,
          1 - device / wall; it runs after the launch counts are read

Then one JSON line ``{"kernels": [...]}`` and, last, the line
``{"ok": true, "device": {...}}``. Any failed check raises, and the script
exits non-zero; it exits non-zero without printing a result when no CUDA
device is present.
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
N_NU_KERNEL = 2**15
N_STATES_KERNEL = 16
N_NU_RCM = 16384
N_LEVELS = 20
G, MU, CP, PS, PT = 9.8, 0.044, 850.0, 1e5, 10.0
CONC = 0.95
RCM_DT = 3600.0  # s
KERNELS = {
    "linesum": ("clearsky_tpu_torch/csrc/linesum.cu",
                "clearsky_tpu/ops/linesum_pallas.py:223"),
    "olr_march": ("clearsky_tpu_torch/csrc/march.cu",
                  "clearsky_tpu/rt/march_pallas.py:158"),
    "monoflux_march": ("clearsky_tpu_torch/csrc/march.cu",
                       "clearsky_tpu/rt/march_pallas.py:94"),
    "fused_olr": ("clearsky_tpu_torch/csrc/fused_table.cu",
                  "clearsky_tpu/rt/fused_table.py:74"),
    "fused_monoflux": ("clearsky_tpu_torch/csrc/fused_table.cu",
                       "clearsky_tpu/rt/fused_table.py:94"),
}
LIBRARIES = ("linesum", "march", "fused_table")
TABLE_DOMAIN = ((150.0, 350.0), 12, (0.9 * PT, 1.01 * PS), 24)
TABLE_SPLIT = 16


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


def column(Pe):
    """Dry adiabat with a 160 K floor on the edge pressures Pe."""
    from clearsky_tpu_torch.constants import R_GAS

    return np.maximum(288.0 * (Pe / PS) ** (R_GAS / (MU * CP)), 160.0)


def grid_for(lines, n):
    nu64 = lines.positions64()
    return np.linspace(max(nu64.min() - 25.0, 1.0), nu64.max() + 25.0, n)


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


def check_sigma(out, ref, edge=None, ref32=None):
    """max abs and max rel error of a float32 line sum against float64, and
    whether it holds the bar (rtol 2e-3 where |sigma| > 1e-35, atol 1e-32).

    At the grid points ``edge`` (see :func:`cut_edges`) the reference is the
    plain float32 version ``ref32``, which decides the cut as the kernel does.
    """
    if edge is not None:
        e = torch.as_tensor(edge, device=ref.device)
        ref = torch.where(e, ref32.double(), ref)
    m = ref.abs() > 1e-35
    err = (out.double() - ref).abs()
    max_rel = float((err[m] / ref[m].abs()).max())
    ok = bool((err[m] <= 1e-32 + 2e-3 * ref[m].abs()).all()) and bool((err[~m] < 1e-30).all())
    return float(err.max()), max_rel, ok


def kernel_linesum(par, seed, dev, report):
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
        if shape == "voigt":
            report["linesum"] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                                     shape=f"{N_STATES_KERNEL} states x {N_NU_KERNEL} points")


def kernel_linesum_main_shape(par, dev, report):
    """K1 at the main path's shape (outgoing's 57 Lobatto-node states, 2^19
    points: 8 state tiles, the last with one real state) against the plain
    line sum on the same inputs: float64, and float32 at the cut edges."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.atmosphere.profile import formprofile
    from clearsky_tpu_torch.ops.linesum import sigma_from_lines
    from clearsky_tpu_torch.ops.linesum_cuda import _prepare
    from clearsky_tpu_torch.rt.discretized import lobatto_pressures

    l64 = ct.SpectralLines.from_par_dict(par, dtype=torch.float64, device=dev)
    lines = l64.to(torch.float32)
    gas = ct.DirectGas.from_lines(lines, CONC, grid_for(lines, N_NU_MAIN))
    Pe = ct.pressuregrid(PT, PS, N_LEVELS)
    Pg = torch.tensor(Pe, dtype=torch.float32, device=dev)
    Pf = lobatto_pressures(Pg, 3).reshape(-1)
    Tf = formprofile(Pg, column(Pe))(Pf)
    launch = _prepare(gas.plan, lines, Tf, Pf, CONC * Pf, "voigt")
    out = launch()
    torch.cuda.synchronize()
    args64 = [x.double() for x in (Tf, Pf, CONC * Pf)]

    def one_call(fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        r = fn()
        b.record()
        b.synchronize()
        return r, a.elapsed_time(b)

    ref, plain_f64_ms = one_call(
        lambda: sigma_from_lines(gas.plan, l64, *args64, shape="voigt"))
    ref32, plain_ms = one_call(
        lambda: sigma_from_lines(gas.plan, lines, Tf, Pf, CONC * Pf, shape="voigt"))
    edge = cut_edges(gas.plan, lines.positions64())
    max_abs, max_rel, ok = check_sigma(out, ref, edge, ref32)
    del ref, ref32
    ms = cuda_ms(launch)
    emit("kernel", kernel="linesum", mode="voigt_split", points=N_NU_MAIN,
         states=int(Pf.shape[0]), lines=lines.n_lines, max_abs_err=max_abs,
         max_rel_err=max_rel, bar="rtol 2e-3 where |sigma| > 1e-35 (atol 1e-32)",
         cut_edge_points=int(edge.sum()), ms=ms, plain_ms_one_call=plain_ms,
         plain_f64_ms_one_call=plain_f64_ms, plain_shape="same")
    check(ok, f"line-sum kernel at the main-path shape disagrees with the plain version: "
              f"max rel {max_rel:.3e}")
    report["linesum"].update(ms_main_shape=ms, plain_ms_main_shape_one_call=plain_ms,
                             max_abs_err_main_shape=max_abs,
                             main_shape=f"{int(Pf.shape[0])} states x {N_NU_MAIN} points")


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
    common = dict(layers=L, points=N, streams=5, bar=f"{bar} of peak", plain_shape="same")
    emit("kernel", kernel="olr_march", err_of_peak=e_olr, max_abs_err=abs_olr,
         ms=ms_olr, plain_ms=plain_olr, **common)
    emit("kernel", kernel="monoflux_march", err_up_of_peak=e_up, err_down_of_peak=e_dn,
         max_abs_err=max(abs_up, abs_dn), ms=ms_mono, plain_ms=plain_mono, **common)
    check(e_olr < bar, f"OLR march kernel error {e_olr:.3e} of peak exceeds {bar}")
    check(max(e_up, e_dn) < bar,
          f"flux march kernel error {max(e_up, e_dn):.3e} of peak exceeds {bar}")
    shape = f"{L} layers x {N} points, 5 streams"
    report["olr_march"] = dict(max_abs_err=abs_olr, ms=ms_olr, plain_ms=plain_olr,
                               shape=shape)
    report["monoflux_march"] = dict(max_abs_err=max(abs_up, abs_dn), ms=ms_mono,
                                    plain_ms=plain_mono, shape=shape)


def phase_main(par, dev):
    """outgoing and radiate at the full size through the entry points."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.constants import SIGMA_SB

    lines = ct.SpectralLines.from_par_dict(par, dtype=torch.float32, device=dev)
    nu = grid_for(lines, N_NU_MAIN)
    gas = ct.DirectGas.from_lines(lines, CONC, nu)
    Pe = ct.pressuregrid(PT, PS, N_LEVELS)
    Te = column(Pe)
    olr = ct.outgoing(Pe, G, Te, MU, gas)
    torch.cuda.synchronize()
    check(olr.shape == (N_NU_MAIN,), f"OLR spectrum has shape {tuple(olr.shape)}")
    check(bool(torch.isfinite(olr).all()), "OLR spectrum is not finite")
    band = float(ct.trapz(gas.nu, olr))
    bb = SIGMA_SB * Te[-1] ** 4
    check(0.0 < band < bb, f"band OLR {band} is not in (0, sigma Ts^4 = {bb})")
    ms_out = wall_ms(lambda: ct.outgoing(Pe, G, Te, MU, gas))

    span = float(nu[-1] - nu[0])
    S0 = 340.0 / math.cos(0.841)
    fS = lambda v: torch.full_like(v, S0 / span)
    F = ct.radiate(Pe, G, Te, MU, fS, 0.1, gas)
    torch.cuda.synchronize()
    for k in ("F_up", "F_down", "F_net"):
        check(bool(torch.isfinite(getattr(F, k)).all()), f"radiate {k} is not finite")
    check(tuple(F.M_up.shape) == (N_LEVELS, N_NU_MAIN), "radiate M_up has the wrong shape")
    ms_rad = wall_ms(lambda: ct.radiate(Pe, G, Te, MU, fS, 0.1, gas))
    emit("main", lines=lines.n_lines, points=N_NU_MAIN, levels=N_LEVELS, streams=5,
         nu_range=[float(nu[0]), float(nu[-1])], band_olr_W_m2=band,
         sigma_Ts4_W_m2=float(bb), outgoing_ms_per_call=ms_out,
         F_net_toa_W_m2=float(F.F_net[0]), F_up_toa_W_m2=float(F.F_up[0]),
         F_down_surface_W_m2=float(F.F_down[-1]), radiate_ms_per_call=ms_rad)
    return {"outgoing": lambda: ct.outgoing(Pe, G, Te, MU, gas),
            "radiate": lambda: ct.radiate(Pe, G, Te, MU, fS, 0.1, gas)}, olr


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
    from clearsky_tpu_torch.ops.linesum_cuda import sigma_lines

    lines = ct.SpectralLines.from_par_dict(par, dtype=torch.float32, device=dev)
    nu = grid_for(lines, N_NU_MAIN)
    dom = ct.AtmosphericDomain.create(*TABLE_DOMAIN)
    k1 = sigma_lines.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gas = ct.Gas.from_lines(lines, CONC, nu, dom)
    torch.cuda.synchronize()
    bake_s = time.perf_counter() - t0
    k1 = sigma_lines.launches - k1
    gs = gas.split_precision(TABLE_SPLIT)
    check(bool(torch.isfinite(gas.coeffs).all()), "the baked coefficients are not finite")
    check(tuple(gs.coeffs.shape) == (TABLE_SPLIT, N_NU_MAIN)
          and tuple(gs.coeffs_tail.shape) == (dom.nT * dom.nP - TABLE_SPLIT, N_NU_MAIN),
          "split_precision gave the wrong shapes")
    emit("table", step="bake", points=N_NU_MAIN, nT=dom.nT, nP=dom.nP, states=dom.nT * dom.nP,
         bake_seconds=bake_s, linesum_launches=k1, split_lead_rows=TABLE_SPLIT,
         coeff_bytes_full=gas.coeffs.numel() * 4,
         coeff_bytes_split=gs.coeffs.numel() * 4 + gs.coeffs_tail.numel() * 2)
    check(k1 == -(-dom.nT * dom.nP // 16), f"the bake launched K1 {k1} times")
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
    common = dict(layers=N_LEVELS - 1, points=N_NU_MAIN, streams=5, lead_rows=lead.shape[0],
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
    emit("kernel", kernel="fused_olr", nodes=int(bl.shape[0]), err_of_peak=e_olr,
         max_abs_err=abs_olr, ms=ms, plain_ms=plain, **common)
    check(bool(torch.isfinite(out).all()) and e_olr < bar,
          f"fused OLR kernel error {e_olr:.3e} of peak exceeds {bar}")
    report["fused_olr"] = dict(max_abs_err=abs_olr, ms=ms, plain_ms=plain,
                               shape=f"{int(bl.shape[0])} nodes x {N_NU_MAIN} points")

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
    emit("kernel", kernel="fused_monoflux", nodes=int(bl.shape[0]), err_up_of_peak=e_up,
         err_down_of_peak=e_dn, tau_max_rel_err=tau_rel, max_abs_err=max(abs_up, abs_dn),
         ms=ms, plain_ms=plain, **common)
    check(max(e_up, e_dn) < bar and tau_ok,
          f"fused flux kernel error {max(e_up, e_dn):.3e} of peak, tau {tau_rel:.3e}")
    report["fused_monoflux"] = dict(max_abs_err=max(abs_up, abs_dn), ms=ms, plain_ms=plain,
                                    shape=f"{int(bl.shape[0])} nodes x {N_NU_MAIN} points")


def phase_table(gs, dev, direct_olr, wrappers):
    """outgoing and radiate on the split Gas through the entry points, with
    the launch counts of that path; then a split Gas beside a gray gas."""
    import clearsky_tpu_torch as ct

    Pe = ct.pressuregrid(PT, PS, N_LEVELS)
    Te = column(Pe)
    span = float(gs.nu[-1] - gs.nu[0])
    fS = lambda v: torch.full_like(v, 340.0 / math.cos(0.841) / span)
    for w in wrappers.values():
        w.launches = 0
    olr = ct.outgoing(Pe, G, Te, MU, gs)
    F = ct.radiate(Pe, G, Te, MU, fS, 0.1, gs)
    torch.cuda.synchronize()
    counts = {k: w.launches for k, w in wrappers.items()}
    emit("counts", path="table", **counts)
    check(counts["fused_olr"] > 0 and counts["fused_monoflux"] > 0,
          "the table path did not launch the fused kernels")
    check(counts["linesum"] == counts["olr_march"] == counts["monoflux_march"] == 0,
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
    for w in wrappers.values():
        w.launches = 0
    olr_mix = ct.outgoing(Pe, G, Te, MU, gs, gray)
    torch.cuda.synchronize()
    mix = {k: w.launches for k, w in wrappers.items()}
    band_mix = float(ct.trapz(nu64, olr_mix.double()))
    emit("table", step="entry_points", band_olr_W_m2=band, direct_band_olr_W_m2=direct_band,
         band_rel_diff=rel, bar=1e-3, spectral_max_diff_of_peak=spectral,
         outgoing_ms_per_call=ms_out, radiate_ms_per_call=ms_rad,
         F_net_toa_W_m2=float(F.F_net[0]), F_down_surface_W_m2=float(F.F_down[-1]),
         mixed_stack_band_olr_W_m2=band_mix, mixed_stack_counts=mix)
    check(rel < 1e-3, f"table band OLR {band} off the direct one {direct_band} by {rel:.3e}")
    check(mix["olr_march"] > 0 and mix["fused_olr"] == 0,
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


def phase_profile(calls, n: int = 3):
    """Where the device time of each main-path call goes (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    kernel_names = {"linesum": "linesum_kernel", "olr_march": "olr_kernel",
                    "monoflux_march": "monoflux_kernel", "fused_olr": "fused_olr_kernel",
                    "fused_monoflux": "fused_monoflux_kernel"}
    # whole words: olr_kernel must not match inside fused_olr_kernel
    pattern = {k: re.compile(rf"\b{v}\b") for k, v in kernel_names.items()}
    for name, fn in calls.items():
        wall = wall_ms(fn, n=n)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        check(len(evs) > 0, f"the profiler traced no device activity in {name}")
        device = _busy_us([(e.time_range.start, e.time_range.end) for e in evs]) / n / 1e3
        per_kernel = {k: sum(e.time_range.elapsed_us() for e in evs if p.search(e.name))
                      / n / 1e3 for k, p in pattern.items()}
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
    from clearsky_tpu_torch.ops.linesum_cuda import sigma_lines
    from clearsky_tpu_torch.rt.march_cuda import olr_march, monoflux_march
    from clearsky_tpu_torch.rt.fused_table_cuda import fused_olr, fused_monoflux

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = phase_env(dev)
    phase_build()
    par = synthetic_co2_par(N_LINES, seed=args.seed)
    report = {}
    kernel_linesum(par, args.seed, dev, report)
    kernel_linesum_main_shape(par, dev, report)
    kernel_march(args.seed, dev, report)

    # the counts cover the main path alone: outgoing, radiate and the RCM
    # steps, not the checks that follow them
    wrappers = {"linesum": sigma_lines, "olr_march": olr_march,
                "monoflux_march": monoflux_march, "fused_olr": fused_olr,
                "fused_monoflux": fused_monoflux}
    for w in wrappers.values():
        w.launches = 0
    calls, direct_olr = phase_main(par, dev)
    rcm_run = phase_rcm(par, dev)
    counts = {k: w.launches for k, w in wrappers.items()}
    emit("counts", **counts)
    for k in ("linesum", "olr_march", "monoflux_march"):
        check(counts[k] > 0, f"kernel {k} was not launched on the main path")
    check_rcm(*rcm_run)
    phase_sanity(dev)
    rcm = rcm_run[0]
    calls["rcm_step"] = lambda: ct.step(ct.update_absorber(rcm), RCM_DT)
    calls["rcm_heating"] = lambda: ct.heating(rcm)

    # the baked-table path, counted on its own
    gs = phase_table_bake(par, dev)
    kernel_fused(gs, dev, report)
    table_calls, table_counts = phase_table(gs, dev, direct_olr, wrappers)
    for k in ("fused_olr", "fused_monoflux"):
        counts[k] = table_counts[k]
    calls.update(table_calls)
    phase_profile(calls)

    kernels = []
    for k, (source, replaces) in KERNELS.items():
        kernels.append({"name": k, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": counts[k], **report[k]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

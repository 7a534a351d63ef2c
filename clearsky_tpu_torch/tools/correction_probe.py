"""The near-core correction's probe: the correction kernel timed alone, in
both instances (voigt and chi), at chip_smoke.py's shapes, whole and cut, so
that two versions of the port compare inside one run on the card.

    python3 clearsky_tpu_torch/tools/correction_probe.py [--root TREE] [--seed N]
    python3 clearsky_tpu_torch/tools/correction_probe.py --calls [--root TREE] [--seed N]
    python3 clearsky_tpu_torch/tools/correction_probe.py --count [--seed N]

The shapes are chip_smoke.py's, on its seed's synthetic catalog (5,599 CO2
lines): the auto voigt route's weighted correction (57 states x 2^19, the
coarse split's stencil fine pass, K = 56), the auto phco2 route's weighted
chi instance (57 x 2^19 over the catalog +- 500 cm^-1, K = 40), the RCM's
unweighted correction (the stencil route, 20 states x 16,384 points) and
the RCE's weighted chi instance (20 x 16,384, phco2). ``csrc/linesum.cu``
of the port in use is compiled once for each cut applied to its text
(:data:`CUTS`), each with ``-Xptxas -v`` (registers and spills; the
wrapper's ``correction_info`` reports the build's registers, shared and
local bytes and resident blocks); the wrapper then launches it in place of
the port's library, on a preallocated output that each call adds into, timed with CUDA events
around one wrapper call (median of 10: host time included, as
chip_smoke.py's ``ms``) and by the profiler (the kernel's own device time,
mean of 10). Each result is one ``probe`` line, with the launch's blocks
(work items), the rows of the K-point row grid that some line's in-cut
window reaches and their share, and the bytes of those rows' sigma read and
written once.

The cuts of the row gather (one block a (row, state tile), the row's lines
staged in shared memory, its candidate terms evaluated as one list, a sum
in schedule order, one read and one write of sigma): ``stage`` (the
staging and sigma's read and write alone: no runs, no candidates), ``mask`` (the runs, the candidates' tests, the
ordered sums, a cheap term in place of w4 - region 1), ``no_rmw``
(everything but sigma's read) and ``no_sum`` (everything but the ordered
sums). ``--root TREE`` imports ``clearsky_tpu_torch`` from TREE
(another checkout, e.g. the parent commit unpacked under ``build/``) and
cuts TREE's source; the shapes and helpers are this checkout's
chip_smoke.py. Needs one CUDA card.

``--calls`` profiles, in place of the kernel alone, the entry-point calls
that run the correction as chip_smoke.py builds them: the auto voigt and
phco2 ``outgoing`` at 2^19 points, an RCM's refresh and step at 16,384
points, and 6 steps of the RCE run (one refresh); one chip_smoke.py
``profile`` line each (wall and device ms, device operations, kernel ms).

``--count`` needs none: on the host it counts, for the two main shapes, the
w4 work that three evaluation orders of the gather issue (the op counts of
chip_smoke.py's ``W4_COMMON``, ``W4_REGION`` and ``W4_SMALL_Y`` per region
a warp of 32 lanes runs): each thread's terms where it meets them, the
passing terms packed in order, and packed by region; each over the work
packed 32 to a warp without divergence. One ``count`` line a shape.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

# this checkout's root, where chip_smoke.py lies
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

cs = None  # chip_smoke, loaded by main()

# the cuts of csrc/linesum.cu ``correction_gather_kernel``; the results of a
# cut copy are not kept
_RUNS = "      if (s0 + u < n_states) run_of("
_WRITE = ("    if (hits >> i & 1u) out[", "    if (valid >> i & 1u) out[")
_EVAL = ("        if (pair_xy(k, x, y, w)) corr = sm.sia[q] * (wofz_re(x, y) - region1_xy(x, y)) * w;\n")
_READ = "      cp_async4(&sm.sig[i][t], out + (size_t)s * n_nu + p);  // sigma's one read\n"
_SUM = "      if (live) {\n        for (int e = ea; e < eb; ++e) {\n"
CUTS = {
    "none": [],
    "stage": [(_RUNS, "      if (n_states < 0) run_of("), _WRITE],
    "mask": [(_EVAL, "        if (pair_xy(k, x, y, w)) corr = sm.sia[q] * x * y * w;\n")],
    "no_rmw": [(_READ, "      sm.sig[i][t] = 0.0f;\n")],
    "no_sum": [(_SUM, "      if (live && n_states < 0) {\n        for (int e = ea; e < eb; ++e) {\n"),
               _WRITE],
}
def cut_source(src: str, cut: str) -> str:
    """``src`` with the edits of ``cut``; raises where an edit's text is
    missing, so that a changed source cannot give a silent uncut copy."""
    for old, new in CUTS[cut]:
        if src.count(old) != 1:
            raise ValueError(f"cut {cut!r}: the source holds {src.count(old)} copies of "
                             f"{old.strip()[:60]!r}")
        src = src.replace(old, new)
    return src


def _short(fn: str) -> str:
    """A mangled instance's template arguments (``ILb1ELi8E``), or its name."""
    m = re.search(r"kernelI(\w+?E)E", fn)
    return m.group(1) if m else fn


def _ptxas(stderr: str) -> dict:
    """Registers and spill bytes of each correction instance from ptxas -v."""
    out, fn = {}, None
    for line in stderr.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line) or \
            re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        if fn and "correction_gather_kernel" in fn:
            r = re.search(r"Used (\d+) registers", line)
            s = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if r:
                out.setdefault(_short(fn), {})["registers"] = int(r.group(1))
            if s:
                out.setdefault(_short(fn), {})["spill_store_bytes"] = int(s.group(1))
    return out


def build_cuts(root: str, out_dir: str):
    """Compile every cut of TREE's linesum.cu in parallel: {cut: (lib, ptxas)}."""
    from clearsky_tpu_torch.utils import cuda_build

    csrc = os.path.join(root, "clearsky_tpu_torch", "csrc")
    out_dir = os.path.abspath(out_dir)
    with open(os.path.join(csrc, "linesum.cu")) as f:
        src = f.read()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for cut in CUTS:
        cu = os.path.join(out_dir, f"linesum_{cut}.cu")
        with open(cu, "w") as f:
            f.write(cut_source(src, cut))
        so = os.path.join(out_dir, f"liblinesum_{cut}.so")
        procs[cut] = (so, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", csrc, "-o", so,
             cu], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for cut, (so, p) in procs.items():
        _, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on cut {cut}:\n{err}")
        libs[cut] = (ctypes.CDLL(so), _ptxas(err))
    return libs




def touched_rows(geom, cut: float, n_nu: int) -> int:
    """Rows of the K-point row grid that some line's in-cut window reaches
    (a grid point within the cut and inside the grid), counted on the host
    from the geometry alone."""
    K = geom.K
    k = np.arange(2 * K)[:, None]
    reach = (np.abs(geom.dnu_hi) <= cut) & (geom.q[None, :] * K + k < n_nu)   # [2K, L]
    rows = [geom.q[reach[:K].any(axis=0)], geom.q[reach[K:].any(axis=0)] + 1]
    return int(np.unique(np.concatenate(rows)).size)


def shapes(seed: int, dev):
    """(name, geometry, coefficients, cut, weight, T, n_nu) of each shape."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops import linesum_strategies as ls
    from clearsky_tpu_torch.spectra.synthetic import synthetic_co2_par

    par = synthetic_co2_par(cs.N_LINES, seed=seed)
    lines = ct.SpectralLines.from_par_dict(par, dtype=torch.float32, device=dev)
    Pe = ct.pressuregrid(cs.PT, cs.PS, cs.N_LEVELS)
    out = []
    for name, n_nu, shape in (("voigt", cs.N_NU_MAIN, "voigt"), ("chi", cs.N_NU_MAIN, "phco2"),
                              ("voigt_rcm", cs.N_NU_RCM, "voigt"),
                              ("chi_rce", cs.N_NU_RCM, "phco2")):
        ph = shape == "phco2"
        nu = (cs.phco2_grid if ph else cs.grid_for)(lines, n_nu)
        plan = ct.DirectGas.from_lines(lines, cs.CONC, nu, shape=shape).plan
        if n_nu == cs.N_NU_MAIN:
            states = cs.main_states(dev, cs.TS_RCE if ph else 288.0)
        else:
            states = [torch.tensor(x, dtype=torch.float32, device=dev)
                      for x in (cs.column(Pe, cs.TS_RCE if ph else 288.0), Pe, cs.CONC * Pe)]
        n = int(states[0].shape[0])
        route, params = ls._resolve(plan, lines, shape, "auto", n)
        if route == "coarse":
            geom = ls.coarse_geometry(plan, lines, params)
            stencil, z = geom.stencil, geom.zones
            cut, weight = z["cut"], (z["D1"], z["D2"])
        else:
            stencil, cut, weight = ls.stencil_geometry(plan, lines), plan.cut, None
        if stencil is None:
            raise RuntimeError(f"{name}: the {route} route runs no correction")
        co = (cs._phco2_operands(lines, states) if ph else cs._mode_operands(lines, states))[1]
        out.append((name, stencil, co, cut, weight, states[0] if ph else None, n_nu))
    return out


def _region(x, y):
    """wofz_re's region (0-3) of float64 (x, y)."""
    ax = np.abs(x)
    s = ax + y
    return np.where(s >= 15.0, 0, np.where(s >= 5.5, 1,
                                           np.where(y >= 0.195 * ax - 0.176, 2, 3)))


def _warp_ops(active, region, small_y) -> float:
    """FP32 operations of w4 that warps of 32 lanes issue ([..., 32]
    arrays): each region any active lane takes, the small-y repair where
    one needs it."""
    ops = cs.W4_COMMON * active.any(-1) + cs.W4_SMALL_Y * (active & small_y).any(-1)
    for r, c in enumerate(cs.W4_REGION):
        ops = ops + c * (active & (region == r)).any(-1)
    return float(ops.sum())


def _warps(*xs):
    """Each 1-d array padded with zeros to whole warps, as [n, 32]."""
    pad = (-xs[0].size) % 32
    return [np.concatenate([x, np.zeros(pad, x.dtype)]).reshape(-1, 32) for x in xs]


def count(seed: int):
    """The w4 work of each evaluation order at the two main shapes."""
    from clearsky_tpu_torch.ops import linesum_cuda as lc
    from clearsky_tpu_torch.ops import linesum_strategies as ls

    for name, geom, co, cut, _, _, n_nu in shapes(seed, torch.device("cpu"))[:2]:
        ia, y0 = (c.double().numpy() for c in co[1:3])
        n, K = ia.shape[0], geom.K
        hi, lo = geom.dnu_hi.astype(np.float64), geom.dnu_lo.astype(np.float64)
        inside = (geom.q[None, :] * K + np.arange(2 * K)[:, None] < n_nu) & (np.abs(hi) <= cut)
        packed = 0.0
        for s in range(n):
            x = ia[s][None, :] * (hi + lo)
            y = np.broadcast_to(y0[s][None, :], x.shape)
            act = inside & (x * x <= 225.0)
            packed += float((cs.W4_COMMON + np.asarray(cs.W4_REGION)[_region(x, y)[act]]
                             + cs.W4_SMALL_Y * (y < 0.01)[act]).sum()) / 32.0
        sch = ls.correction_rows(geom, cut, n_nu)
        G, nse, n_tiles = lc.correction_tiles(K, n)
        t = np.arange(K * G)
        j, g = t % K, t // K
        where = inorder = byregion = 0.0
        for row, e0, e1 in sch["rows"]:
            live = row * K + j < n_nu
            for tile in range(n_tiles):
                regs, smalls = [], []
                for e in range(e0, e1):
                    l = sch["line"][e]
                    d = sch["dnu_hi"][e, j].astype(np.float64) + sch["dnu_lo"][e, j]
                    for i in range(nse):
                        s = tile * G * nse + g + G * i
                        sc = np.minimum(s, n - 1)
                        x, y = ia[sc, l] * d, y0[sc, l]
                        act = live & (s < n) & (np.abs(sch["dnu_hi"][e, j]) <= cut) & \
                            (x * x <= 225.0)
                        where += _warp_ops(*_warps(act, _region(x, y), y < 0.01))
                        regs.append(_region(x, y)[act])
                        smalls.append((y < 0.01)[act])
                reg, small = np.concatenate(regs), np.concatenate(smalls)
                one = np.ones(reg.size, bool)
                inorder += _warp_ops(*_warps(one, reg, small))
                o = np.argsort(reg, kind="stable")
                byregion += _warp_ops(*_warps(one, reg[o], small[o]))
        cs.emit("count", instance=name, packed_ops=packed,
                ratio_gather_where_they_fall=where / packed,
                ratio_packed_in_order=inorder / packed, ratio_packed_by_region=byregion / packed)


def entry_calls(seed: int, dev) -> dict:
    """The entry-point calls that run the correction, on chip_smoke.py's
    catalog, columns and grids."""
    import math

    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.spectra.synthetic import synthetic_co2_par

    par = synthetic_co2_par(cs.N_LINES, seed=seed)
    lines = ct.SpectralLines.from_par_dict(par)
    Pe = ct.pressuregrid(cs.PT, cs.PS, cs.N_LEVELS)
    voigt = ct.DirectGas.from_lines(lines, cs.CONC, cs.grid_for(lines, cs.N_NU_MAIN))
    phco2 = ct.DirectGas.from_lines(lines, cs.CONC, cs.phco2_grid(lines, cs.N_NU_MAIN),
                                    shape="phco2")
    fmu, fcp = (lambda T, P: cs.MU), (lambda T, P: cs.CP)

    def rcm(gas, Te):
        span = float(gas.nu[-1] - gas.nu[0])
        fS = lambda v: torch.full_like(v, 340.0 / math.cos(0.841) / span)
        return ct.RCM.create(Pe, Te, cs.G, fmu, fS, 0.1, fcp, 1e7, gas, radmul=2)

    step = rcm(ct.DirectGas.from_lines(lines, cs.CONC, cs.grid_for(lines, cs.N_NU_RCM)),
               cs.column(Pe))
    adiabat = ct.DryAdiabat.create(cs.TS_RCE, cs.PS, cs.CP, cs.MU, Tstrat=160.0)
    rce = rcm(ct.DirectGas.from_lines(lines, cs.CONC, cs.phco2_grid(lines, cs.N_NU_RCM),
                                      shape="phco2"), adiabat(Pe).numpy())
    kw = dict(update_every=cs.RCE_UPDATE, adjust_every=1, cp=cs.CP, mu=cs.MU,
              record_every=cs.RCE_RECORD)
    return {"outgoing": lambda: ct.outgoing(Pe, cs.G, cs.column(Pe), cs.MU, voigt),
            "phco2_outgoing": lambda: ct.outgoing(Pe, cs.G, cs.column(Pe, cs.TS_RCE), cs.MU,
                                                  phco2),
            "rcm_step": lambda: ct.step(ct.update_absorber(step), cs.RCM_DT),
            "rce_run_6_steps": lambda: ct.run(rce, cs.RCM_DT, cs.RCE_UPDATE, **kw)}


def correction_probe(seed: int, dev, out_dir: str):
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops import linesum_cuda as lc

    root = os.path.dirname(os.path.dirname(os.path.abspath(ct.__file__)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    cs.emit("probe", part="env", package_root=root, card=torch.cuda.get_device_name(dev),
            nvidia_smi=smi.stdout.strip().splitlines()[dev.index or 0])
    libs = build_cuts(root, out_dir)
    cases = shapes(seed, dev)
    real = lc.load_library
    try:
        for cut, (lib, ptx) in libs.items():
            lc.load_library = lambda name, lib=lib: lib
            for name, geom, co, cut_cm, weight, T, n_nu in cases:
                n = int(co[0].shape[0])
                buf = torch.zeros((n, n_nu), device=dev)
                fn = (lambda buf=buf, geom=geom, co=co, c=cut_cm, w=weight, T=T:
                      lc.stencil_correction(buf, geom, co, c, w, T=T))
                fn()
                torch.cuda.synchronize()
                info = lc.correction_info(geom.K, n, chi=T is not None)
                items = lc._correction_arrays(geom, cut_cm, n_nu, dev)["n_rows"] * \
                    info["state_tiles"]
                rows = touched_rows(geom, cut_cm, n_nu)
                points = min(rows * geom.K, n_nu)
                kernel = "stencil_correction" if T is None else "stencil_correction_phco2"
                cs.emit("probe", kernel="stencil_correction", instance=name, cut=cut,
                        ms=cs.cuda_ms(fn), device_ms=cs.kernel_device_ms(fn, kernel),
                        states=n, points=n_nu, K=geom.K, lines=int(geom.q.shape[0]), weighted=weight is not None,
                        work_items=items, rows=geom.R, rows_touched=rows,
                        rows_touched_share=rows / geom.R, sigma_rmw_bytes=8 * n * points,
                        **info, ptxas=ptx)
                del buf
    finally:
        lc.load_library = real


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--root", default=None, help="import clearsky_tpu_torch from this tree")
    ap.add_argument("--out", default="build/correction_probe", help="where the cut builds go")
    ap.add_argument("--calls", action="store_true",
                    help="profile the entry-point calls that run the correction")
    ap.add_argument("--count", action="store_true",
                    help="count each evaluation order's w4 work on the host (no card)")
    args = ap.parse_args(argv)
    global cs
    if args.count:
        sys.path.insert(0, ROOT)
        import chip_smoke as cs

        count(args.seed)
        return 0
    if not torch.cuda.is_available():
        print("correction_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs                  # this checkout's, before TREE's

    sys.path.insert(0, os.path.abspath(args.root) if args.root else ROOT)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    if args.calls:
        import clearsky_tpu_torch as ct

        cs.emit("probe", part="env", package_root=os.path.dirname(os.path.dirname(
            os.path.abspath(ct.__file__))), card=torch.cuda.get_device_name(dev))
        calls = entry_calls(args.seed, dev)
        for fn in calls.values():           # set-up, library loads, caches
            fn()
        torch.cuda.synchronize()
        cs.phase_profile(calls)
        return 0
    tag = "root" if args.root else "self"
    correction_probe(args.seed, dev, os.path.join(args.out, tag))
    return 0


if __name__ == "__main__":
    sys.exit(main())

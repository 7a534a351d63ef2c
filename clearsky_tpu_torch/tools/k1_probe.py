"""K1's probe: every instance of the line-sum kernel K1 timed alone at
chip_smoke.py's shapes, and the profile of three ``outgoing`` calls (the
mix, config 2 on its auto and on its grouped route), so that two versions
of the port compare inside one run on the card.

    python3 clearsky_tpu_torch/tools/k1_probe.py [--step0] [--root TREE]

Each instance is timed with CUDA events (median of 5) and by the profiler
(its device ms) and printed as one ``probe`` line with a digest of its
output's bytes (two trees whose digests agree gave the same bits) and its
window statistics (lines per grid block: max, mean, 99th percentile, the
share in the densest 1% of blocks); each call's
``profile`` line is chip_smoke.py's: wall and device ms a call, device ops,
each kernel's share and the idle share. ``--root TREE`` imports
``clearsky_tpu_torch`` from TREE (another checkout, e.g. the parent commit
unpacked under ``build/``) and builds its kernels there; the shapes and
helpers are this checkout's chip_smoke.py. ``--step0`` adds each windowed
launch cut to its densest 1% of blocks and to the rest, and writes the
ptxas report and the SASS of TREE's ``csrc/linesum.cu`` under ``--out``.

    python3 clearsky_tpu_torch/tools/k1_probe.py --window [--cuts [NAMES]] [--plans] [--root TREE]
    python3 clearsky_tpu_torch/tools/k1_probe.py --errors [NAMES] [--root TREE]
    python3 clearsky_tpu_torch/tools/k1_probe.py --calls [--root TREE]

``--window`` times the region-1 window modes where the main path runs them:
FARALL at the mix's ``radiate`` (38 states x 2^19, 55,000 lines) and at the
RCM's refresh (20 x 16,384), FINE_STENCIL at the auto ``outgoing`` (57 x
2^19) and PH_FINE_STENCIL at the phco2 auto ``outgoing`` (57 x 2^19, cut
500) and at the RCE's refresh (57 x 16,384). Each launch is captured from
that entry point (``launch_mode``'s arguments) and replayed alone: CUDA
events around one launch (``ms``) and the profiler's device time
(``device_ms``), the build (registers, spills, resident warps), the work
items (blocks, items, rows on the scratch path). ``--cuts`` also builds
TREE's ``linesum.cu`` cut by text edits (:data:`WINDOW_CUTS`; all, or
those of a comma list NAMES): ``arith`` (the pack's quads made in
registers, not staged), ``stage`` (the staging and its pipeline, no line
summed), ``newton`` (the window kernel's reciprocal with a Newton step) and
``no_core`` (no correction algebra near the cores), and times
FINE_STENCIL's ``items`` (one work item a row: the mid window alone, no
scratch); and the SASS of
each mode's loop bodies (instructions, reciprocals, exponentials) through
``cuobjdump -sass`` (the window kernel's whole SASS in ``--out``).
``--plans`` also times the window kernel under other launch plans (groups,
piece length, points a thread: :data:`PLAN_VARIANTS`). ``--routes`` lists
each state's error of the stencil and coarse routes at the main shape
against float64, beside the plain float32 routes' and chip_smoke.py's bar,
for the kernel whole and built without its core algebra (``no_core``).
``--errors [NAMES]`` holds FARALL at the mix's ``radiate`` against float64
on chip_smoke.py's sampled blocks: built whole (and cut), with the pack's
reciprocal flag and with the IEEE division, and the plain float32 version.
``--calls`` profiles the entry points that run these modes (chip_smoke.py's
``profile`` lines): the mix's ``radiate``, the auto ``outgoing``, the phco2
auto ``outgoing``, an RCM refresh and step, the RCE run.

    python3 clearsky_tpu_torch/tools/k1_probe.py --fine [--cuts [NAMES]] [--root TREE]

``--fine`` times K1's FINE mode (the coarse split's fine pass where the
stencil rejects the grid) where the main path runs it: the auto ``outgoing``
at 2^20 (voigt, phco2) and the sharded auto ``outgoing`` of 4 shards at 2^19
(voigt, phco2), each launch captured from its entry point and replayed
alone, with its build and work items and what it computes on this data
(mid, near and annulus pairs, d_near, the near triples by Humlicek region,
those a per-(line, state) reach keeps, and the w4 work as warps of
consecutive points run it against the same work packed 32 to a warp);
``--cuts`` builds TREE's FINE cut (:data:`FINE_CUTS`, by its design: the
general sweep or the window kernel's FINE path): ``arith``, ``stage``, ``no_near``
(the near pairs take region 1), and times ``items`` (one work item a row);
then the profile of those four calls and the auto ``outgoing`` at 2^19.

    python3 clearsky_tpu_torch/tools/k1_probe.py --full [--cuts [NAMES]] [--plans] [--no-pairs] [--root TREE]

``--full`` times K4 and K5 (the window kernel's FULL modes) at
chip_smoke.py's shapes (the mix's CO2 catalog at 57 states x 2^19, cut 25;
config 2 at 16 x 2^15, cut 500, phco2), each launch captured from the
route's wrapper (``sigma_lane``, ``sigma_gathered``) and replayed, with its
build, the densest 1% of blocks alone, the work counted on the data
(triples by w4 region, with y < 0.01, in warps wholly region 1, and the
warps' region multiplicity; ``--no-pairs`` skips it), the peak memory of
each call and the profile of ``outgoing`` on "lane" and "gathered";
``--cuts`` builds TREE's K4/K5 cut or changed (:data:`FULL_CUTS`:
``arith``, ``stage``, ``no_near``, ``chunk64``), with each loop body's
SASS; ``--plans`` other launch plans of the FULL path.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# this checkout's root, where chip_smoke.py lies
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


cs = None  # chip_smoke, loaded by main()


def _probe_grid(blocks64, windows, dev):
    """A K1 grid dict (two-float block grid, int32 window table) on ``dev``."""
    from clearsky_tpu_torch.ops.linesum import two_float

    hi, lo = two_float(blocks64)
    return {"nu_hi": torch.as_tensor(hi.reshape(-1), device=dev),
            "nu_lo": torch.as_tensor(lo.reshape(-1), device=dev),
            "win": torch.as_tensor(windows, dtype=torch.int32, device=dev)}


def _window_stats(windows, n_win: int = 1) -> dict:
    """Lines per block summed over its windows: max, mean, 99th percentile."""
    c = np.asarray(windows, np.int64)[:, 1::2][:, :n_win].sum(axis=1)
    return dict(blocks=int(c.size), max_window_lines=int(c.max(initial=0)),
                mean_window_lines=float(c.mean()) if c.size else 0.0,
                p99_window_lines=float(np.percentile(c, 99)) if c.size else 0.0,
                lines_in_densest_1pct=float(np.sort(c)[::-1][:max(1, c.size // 100)].sum()
                                            / max(1, c.sum())))


def k1_probe_cases(seed, dev, step0=False):
    """(name, launch, windows stats) of every K1 instance chip_smoke times,
    at its shapes, built through the interfaces every version of the port
    has (``_prepare``, ``pack_coefficients``, ``launch_mode``,
    ``device_launches``); with ``step0`` also each windowed launch cut to
    its densest 1% of blocks and to the rest."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops import linesum_cuda as lc
    from clearsky_tpu_torch.ops import linesum_strategies as ls
    from clearsky_tpu_torch.ops.linesum import _line_params, effective_alpha
    from clearsky_tpu_torch.spectra.synthetic import synthetic_co2_par

    par = synthetic_co2_par(cs.N_LINES, seed=seed)
    lines = ct.SpectralLines.from_par_dict(par, dtype=torch.float32, device=dev)
    cases = []

    def windowed(name, mode, blocks64, windows, n_out, states, z, d_near=None, bcoef=None,
                 shape="voigt"):
        S, a, g = _line_params(lines, *states)
        a = effective_alpha(shape, a)
        coef = lc.pack_coefficients(mode, S, a, g)
        n = int(states[0].shape[0])
        nw = windows.shape[1] // 2
        zones = lc._zones(**z)
        kw = _fast_kw(lc, mode, S, a, g, z["cut"], bcoef)

        def sub(rows):
            grid = _probe_grid(blocks64[rows], windows[rows], dev)
            return lambda: lc.launch_mode(mode, grid, lines, coef, n, len(rows) * blocks64.shape[1],
                                          zones, d_near, bcoef=bcoef, **kw)

        grid = _probe_grid(blocks64, windows, dev)
        cases.append((name, lambda: lc.launch_mode(mode, grid, lines, coef, n, n_out, zones,
                                                   d_near, bcoef=bcoef, **kw),
                      _window_stats(windows, nw)))
        if step0:
            c = windows[:, 1::2].sum(axis=1)
            order = np.argsort(-c, kind="stable")
            k = max(1, len(order) // 100)
            cases.append((name + "@densest_1pct", sub(np.sort(order[:k])), {}))
            cases.append((name + "@other_99pct", sub(np.sort(order[k:])), {}))

    # config 2 at 2^19 and 57 states: split, no-split, and the coarse route
    plan = ct.DirectGas.from_lines(lines, cs.CONC, cs.grid_for(lines, cs.N_NU_MAIN)).plan
    states = cs.main_states(dev)
    n = int(states[0].shape[0])
    cases.append(("linesum", lc._prepare(plan, lines, *states, "voigt"),
                  _window_stats(plan.windows())))
    cases.append(("linesum_nosplit", lc._prepare(plan, lines, *states, "voigt", nosplit=True),
                  _window_stats(plan.windows())))
    geom = ls.coarse_geometry(plan, lines, ls.coarse_params(plan, ls.AUTO_COARSE_FRAC))
    windowed("linesum_coarse", 6, geom.coarse_blocks, geom.coarse_windows, geom.params[2],
             states, geom.zones)
    windowed("linesum_fine_stencil", 5, geom.fine_blocks, geom.fine_windows, plan.n_nu, states,
             geom.zones)
    plan20 = ct.DirectGas.from_lines(lines, cs.CONC, cs.grid_for(lines, cs.N_NU_FINE)).plan
    g20 = ls.coarse_geometry(plan20, lines, ls.coarse_params(plan20, ls.AUTO_COARSE_FRAC))
    a = _line_params(lines, *states)[1]
    windowed("linesum_fine", 4, g20.fine_blocks, g20.fine_windows, plan20.n_nu, states,
             g20.zones, lc.near_distance(a, g20.zones["cut_f"]))
    # FARALL at the RCM's shape
    prcm = ct.DirectGas.from_lines(lines, cs.CONC, cs.grid_for(lines, cs.N_NU_RCM)).plan
    Pe = ct.pressuregrid(cs.PT, cs.PS, cs.N_LEVELS)
    srcm = [torch.tensor(x, dtype=torch.float32, device=dev)
            for x in (cs.column(Pe), Pe, cs.CONC * Pe)]
    windowed("linesum_farall", 3, prcm.nu_blocks, prcm.windows(), prcm.n_nu, srcm,
             {"cut": prcm.cut})
    # K1-dev: 4 shards of the main grid
    sg = ct.shard_line_gas(ct.DirectGas.from_lines(lines, cs.CONC, plan.nu, strategy="grouped"),
                           cs.N_SHARDS)
    sa = ct.shard_line_gas(ct.DirectGas.from_lines(lines, cs.CONC, plan.nu), cs.N_SHARDS)
    (_, dev_split), = lc.device_launches(sg.plans, sg.lines, *states, None, "voigt", "grouped")[0]
    cases.append(("linesum_dev", dev_split, _window_stats(
        sg.plans.windows().reshape(-1, 2))))
    (_, dev_fine), (_, dev_coarse) = lc.device_launches(sa.plans, sa.lines, *states, None,
                                                       "voigt", "coarse")[0]
    cases.append(("linesum_dev_fine", dev_fine, _window_stats(
        sa.plans.fine_windows.reshape(-1, 6).cpu().numpy(), 3)))
    cases.append(("linesum_dev_coarse", dev_coarse, _window_stats(
        sa.plans.coarse_windows.reshape(-1, 2).cpu().numpy())))

    # phco2 at cut 500: 57 states x 2^19 (split, COARSE, FINE_STENCIL), 2^20 (FINE)
    pp = ct.DirectGas.from_lines(lines, cs.CONC, cs.phco2_grid(lines, cs.N_NU_MAIN),
                                 shape="phco2").plan
    ps = cs.main_states(dev, cs.TS_RCE)
    bc = lc.chi_rates(ps[0])
    cases.append(("linesum_phco2", lc._prepare(pp, lines, *ps, "phco2"),
                  _window_stats(pp.windows())))
    pg = ls.coarse_geometry(pp, lines, ls._resolve(pp, lines, "phco2", "auto", n)[1])
    windowed("linesum_phco2_coarse", 11, pg.coarse_blocks, pg.coarse_windows, pg.params[2], ps,
             pg.zones, bcoef=bc, shape="phco2")
    windowed("linesum_phco2_fine_stencil", 10, pg.fine_blocks, pg.fine_windows, pp.n_nu, ps,
             pg.zones, bcoef=bc, shape="phco2")
    pp20 = ct.DirectGas.from_lines(lines, cs.CONC, cs.phco2_grid(lines, cs.N_NU_FINE),
                                   shape="phco2").plan
    pg20 = ls.coarse_geometry(pp20, lines, ls._resolve(pp20, lines, "phco2", "auto", n)[1])
    windowed("linesum_phco2_fine", 9, pg20.fine_blocks, pg20.fine_windows, pp20.n_nu, ps,
             pg20.zones, lc.near_distance(_line_params(lines, *ps)[1], pg20.zones["cut_f"]),
             bcoef=bc, shape="phco2")
    # phco2 at 16 states x 2^15: FARALL, no-split, K1-seg (3 segments), K1-dev split
    pk = ct.DirectGas.from_lines(lines, cs.CONC, cs.phco2_grid(lines, cs.N_NU_KERNEL),
                                 shape="phco2").plan
    rng = np.random.default_rng(seed + 5)
    Tn = rng.uniform(160.0, 285.0, cs.N_STATES_KERNEL)
    Pn = np.geomspace(cs.PT, cs.PS, cs.N_STATES_KERNEL)
    sk = [torch.tensor(x, dtype=torch.float32, device=dev) for x in (Tn, Pn, cs.CONC * Pn)]
    bk = lc.chi_rates(sk[0])
    windowed("linesum_phco2_farall", 8, pk.nu_blocks, pk.windows(), pk.n_nu, sk,
             {"cut": pk.cut}, bcoef=bk, shape="phco2")
    cases.append(("linesum_phco2_nosplit", lc._prepare(pk, lines, *sk, "phco2", nosplit=True),
                  _window_stats(pk.windows())))
    L_seg = ls._resolve(pk, lines, "phco2", "grouped", cs.N_STATES_KERNEL,
                        cs.segment_budget(pk, lines, cs.N_STATES_KERNEL))[1]
    cases.append(("linesum_phco2_segmented", _seg_launch(pk, lines, sk, L_seg, 7, bk, dev),
                  _window_stats(pk.windows())))
    sp = ct.shard_line_gas(ct.DirectGas.from_lines(lines, cs.CONC, pk.nu, shape="phco2",
                                                   strategy="grouped"), cs.N_SHARDS)
    (_, dev_ph), = lc.device_launches(sp.plans, sp.lines, *sk, None, "phco2", "grouped")[0]
    cases.append(("linesum_dev_phco2", dev_ph, _window_stats(sp.plans.windows().reshape(-1, 2))))
    return cases


# the profiler's names (chip_smoke._kernel_of) of the cases whose own differ:
# K1-dev traces as K1's unsharded mode
_TRACED = {"linesum_dev": "linesum", "linesum_dev_fine": "linesum_fine",
           "linesum_dev_coarse": "linesum_coarse", "linesum_dev_phco2": "linesum_phco2"}


def _fast_kw(lc, mode, S, alpha, gamma, cut, bcoef=None) -> dict:
    """``launch_mode``'s ``fast`` for the pack of (S, alpha, gamma), computed
    before a timed launch; empty for a version of the port whose K1 has no
    reciprocal flag (the comparison tree)."""
    if not hasattr(lc, "far_reciprocal_ok"):
        return {}
    from clearsky_tpu_torch.ops.linesum import voigt_coefficients

    return {"fast": lc.far_reciprocal_ok(mode, voigt_coefficients(S, alpha, gamma), 1, cut,
                                         bcoef)}


def _seg_launch(plan, lines, states, L_seg, mode, bcoef, dev, conc=None, count_as=None):
    """K1-seg's launches alone, into one sigma, each segment's pack built
    beforehand (chip_smoke's ``_seg_launch``, for either version)."""
    from clearsky_tpu_torch.ops import linesum_cuda as lc
    from clearsky_tpu_torch.ops import linesum_strategies as ls
    from clearsky_tpu_torch.ops.linesum import _line_params

    n = int(states[0].shape[0])
    prepared = []
    for seg, grid in lc._segment_windows(plan, lines.n_lines, L_seg, dev):
        sub = ls._slice_lines(lines, seg.a, seg.b)
        c = None if conc is None else conc[:, seg.a:seg.b]
        S, a, g = _line_params(sub, *states, c)
        prepared.append((seg, grid, sub, lc.pack_coefficients(mode, S, a, g),
                         lc.near_distance(a, plan.cut),
                         _fast_kw(lc, mode, S, a, g, plan.cut, bcoef)))
    acc = torch.zeros((n, plan.n_nu), device=dev)

    def launch():
        acc.zero_()
        for seg, grid, sub, coef, d_near, kw in prepared:
            lc.launch_mode(mode, grid, sub, coef, n, seg.n_out, lc._zones(plan.cut), d_near,
                           out=acc[:, seg.blo * plan.block:], bcoef=bcoef, count_as=count_as,
                           **kw)
        return acc

    return launch


def k1_probe(seed, dev, step0, out_dir):
    """Time every K1 instance alone (median of 5, CUDA events) and profile
    the mix's and config 2's ``outgoing`` (auto and grouped), with each
    instance's window statistics, one ``probe`` line each. With ``step0``
    also the densest 1% of blocks apart from the rest, the library's ptxas
    report and its SASS (written to ``out_dir``)."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops import linesum_cuda as lc
    from clearsky_tpu_torch.ops import linesum_strategies as ls
    from clearsky_tpu_torch.ops.linesum import _line_params
    from clearsky_tpu_torch.spectra.synthetic import synthetic_co2_par
    from clearsky_tpu_torch.utils import cuda_build

    root = os.path.dirname(os.path.dirname(os.path.abspath(ct.__file__)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    cs.emit("probe", part="env", package_root=root, card=torch.cuda.get_device_name(dev),
            nvidia_smi=smi.stdout.strip().splitlines()[dev.index or 0])
    if step0:
        src = str(cuda_build.CSRC / "linesum.cu")
        os.makedirs(out_dir, exist_ok=True)
        so = os.path.join(out_dir, "probe_linesum.so")
        v = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                            so, src], capture_output=True, text=True)
        with open(os.path.join(out_dir, "ptxas.txt"), "w") as f:
            f.write(v.stderr)
        sass = subprocess.run([os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump"),
                               "-sass", so], capture_output=True, text=True)
        with open(os.path.join(out_dir, "sass.txt"), "w") as f:
            f.write(sass.stdout)
        cs.emit("probe", part="ptxas", rc=v.returncode, sass_rc=sass.returncode,
                sass_bytes=len(sass.stdout))
    t0 = time.perf_counter()
    cases = k1_probe_cases(seed, dev, step0)
    # the mix: K1-seg at 57 states, and outgoing
    build = os.path.join(root, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        paths = cs.write_mix_files(seed, tmp)
        lo, hi = cs.MIX_NU[0] - 25.0, cs.MIX_NU[1] + 25.0
        co2 = ct.SpectralLines.from_par(paths["co2"], numin=lo, numax=hi)
        h2o = ct.SpectralLines.from_par(paths["h2o"], numin=lo, numax=hi)
        cia = ct.CIATables.from_file(paths["cia"], singles=True)
    nu = np.linspace(*cs.MIX_NU, cs.N_NU_MAIN)
    mg = ct.MultiGas.from_lines([(co2, cs.MIX_CO2), (h2o, cs.fc_h2o)], nu)
    (T, P), _ = cs.mix_states(dev)
    n = int(T.shape[0])
    route, L_seg = ls._resolve(mg.plan, mg.lines, "voigt", "auto", n)
    c32 = mg._conc(T, P)
    cases.append(("linesum_segmented", _seg_launch(mg.plan, mg.lines, (T, P, P), L_seg, 0, None,
                                                   dev, c32),
                  dict(_window_stats(mg.plan.windows()), route=route, segment_lines=L_seg,
                       segments=[_window_stats(s.windows) for s in
                                 ls.segments(mg.plan, mg.lines.n_lines, L_seg)])))
    if step0:
        for i, (seg, grid) in enumerate(lc._segment_windows(mg.plan, mg.lines.n_lines, L_seg,
                                                            dev)):
            c = seg.windows[:, 1]
            order = np.argsort(-c, kind="stable")
            k = max(1, len(order) // 100)
            sub = ls._slice_lines(mg.lines, seg.a, seg.b)
            S, a, g = _line_params(sub, T, P, P, c32[:, seg.a:seg.b])
            coef = lc.pack_coefficients(0, S, a, g)
            dn = lc.near_distance(a, mg.plan.cut)
            kw = _fast_kw(lc, 0, S, a, g, mg.plan.cut)
            B = mg.plan.block
            blocks = mg.plan.nu_blocks[seg.blo:seg.bhi]
            for tag, rows in (("densest_1pct", np.sort(order[:k])), ("other_99pct",
                                                                     np.sort(order[k:]))):
                gr = _probe_grid(blocks[rows], seg.windows[rows], dev)
                cases.append((f"linesum_segmented[{i}]@{tag}",
                              (lambda gr=gr, rows=rows, sub=sub, coef=coef, dn=dn, kw=kw:
                               lc.launch_mode(0, gr, sub, coef, n, len(rows) * B,
                                              lc._zones(mg.plan.cut), dn, **kw)), {}))
    cs.emit("probe", part="setup", seconds=time.perf_counter() - t0, cases=len(cases))
    for name, launch, stats in cases:
        out = launch()
        torch.cuda.synchronize()
        digest = hashlib.sha1(out.cpu().numpy().tobytes()).hexdigest()[:16]
        del out
        traced = None if "@" in name else cs.kernel_device_ms(launch, _TRACED.get(name, name))
        cs.emit("probe", kernel=name, ms=cs.cuda_ms(launch, n=5), device_ms=traced,
                digest=digest, **stats)
        del launch
    Pe = ct.pressuregrid(cs.PT, cs.PS, cs.N_LEVELS)
    Te = cs.column(Pe)
    lines = ct.SpectralLines.from_par_dict(synthetic_co2_par(cs.N_LINES, seed=seed))
    gas = ct.DirectGas.from_lines(lines, cs.CONC, cs.grid_for(lines, cs.N_NU_MAIN))
    grouped = ct.DirectGas.from_lines(lines, cs.CONC, cs.grid_for(lines, cs.N_NU_MAIN),
                                      strategy="grouped")
    cs.phase_profile({"mix_outgoing": lambda: ct.outgoing(Pe, cs.G, Te, cs.MU, mg, cia),
                      "outgoing_auto": lambda: ct.outgoing(Pe, cs.G, Te, cs.MU, gas),
                      "outgoing_grouped": lambda: ct.outgoing(Pe, cs.G, Te, cs.MU, grouped)})


# --- the region-1 window modes (FARALL, FINE_STENCIL) --------------------------

# case: (K1 mode, chip_smoke's kernel name)
WINDOW_CASES = {"farall_mix": (3, "linesum_farall"), "farall_rcm": (3, "linesum_farall"),
                "fine_stencil": (5, "linesum_fine_stencil"),
                "phco2_fine_stencil": (10, "linesum_phco2_fine_stencil"),
                "phco2_fine_stencil_16384": (10, "linesum_phco2_fine_stencil")}

# register quads of the ``arith`` cut: a line's (A, c1, c2, k2) or phco2's
# (Sia, ia, y0, A) at alpha 0.01 cm^-1 and y 0.01, varied with the line
_QUAD = r"""
template <bool PH>
__device__ __forceinline__ float4 probe_quad(int j, int s) {
  const float f = 1.0f + 0.001f * (float)(j + s);
  return PH ? make_float4(1e-20f * f, 100.0f, 0.01f * f, 1e4f * f)
            : make_float4(1e4f * f, 0.5001f, 4.0f * f, 1e-20f * f);
}
"""
# the cuts of the shared sweep (every mode's before the window kernel): the
# quad staging and the quad read, and the line loop
_SWEEP_QUAD = ("// Accumulate the lines [start, start + cnt) of one window of the item into\n",
              _QUAD + "// Accumulate the lines [start, start + cnt) of one window of the item into\n")
_SWEEP_STAGE_QUADS = ("      cp_async16(&sm.c[buf][i], base + (size_t)(l0 + j) * ls + (i - j * W));\n",
                    "      (void)j;\n")
_SWEEP_READ_QUADS = ("      const float4* c = &sm.c[buf][j * W];\n",
                   "      float4 c[W];\n#pragma unroll\n"
                   "      for (int s = 0; s < W; ++s) c[s] = probe_quad<PH>(j, s);\n")
_SWEEP_LOOP = ("    for (int j = 0; j < n; ++j) {\n      // two-float dnu: the hi",
             "    for (int j = 0; j < n && n < 0; ++j) {\n      // two-float dnu: the hi")
# the same cuts of window_kernel: its quads (A, h, g, k2) or phco2's
# (c, y0, A, 0) at the same alpha and y
_WINDOW_QUAD = r"""
template <bool PH>
__device__ __forceinline__ float4 probe_quad(int j, int s) {
  const float f = 1.0f + 0.001f * (float)(j + s);
  return PH ? make_float4(1e-20f * f, 0.01f * f, 1e4f * f, 0.0f)
            : make_float4(1e4f * f, 0.4999f, 2e-4f * f, 1e-20f * f);
}
"""
_WINDOW_LINE = ("// One (line, state)'s region-1 term at one point, added into acc: D =\n",
              _WINDOW_QUAD + "// One (line, state)'s region-1 term at one point, added into acc: D =\n")
_WINDOW_STAGE_QUADS = ("      cp_async16(&sm.c[buf][i],\n                 it.coef + (size_t)it.line(c0 + j) "
                     "* it.n_states + it.s0 + (i - j * NS));\n", "      (void)j;\n")
_WINDOW_READ_QUADS = ("      const float4* c = &sm.c[buf][j * NS];\n",
                    "      float4 c[NS];\n#pragma unroll\n"
                    "      for (int s = 0; s < NS; ++s) c[s] = probe_quad<PH>(j, s);\n")
_WINDOW_LOOP = ("    for (int j = g * per; j < j1; ++j) {\n      // two-float dnu at each point",
              "    for (int j = g * per; j < j1 && j1 < 0; ++j) {\n      // two-float dnu at each point")
WINDOW_CUTS = {"sweep": {"none": [], "arith": [_SWEEP_QUAD, _SWEEP_STAGE_QUADS, _SWEEP_READ_QUADS],
                       "stage": [_SWEEP_LOOP]},
               "window": {"none": [], "arith": [_WINDOW_LINE, _WINDOW_STAGE_QUADS, _WINDOW_READ_QUADS],
                        "stage": [_WINDOW_LOOP],
                        "newton": [("  if constexpr (FAST) acc = fmaf(num, rcp_approx(den), acc);\n",
                                    "  if constexpr (FAST) acc = fmaf(num, rcp_newton(den), acc);\n")],
                        "no_core": [("        cor[p] = D[p] * am <= 4.0f;\n",
                                     "        cor[p] = false;\n")]}}


def window_design(src: str) -> str:
    """The design of TREE's window modes: "sweep" (every mode through the
    shared ``sweep``) or "window" (``window_kernel``)."""
    if "void window_sweep(int o, int cnt, int g, int G," in src:
        return "window"
    if "void sweep(int start, int cnt, const Item& it" in src:
        return "sweep"
    raise ValueError("csrc/linesum.cu is of no design the probe knows")


def cut_source(src: str, cut: str, edits) -> str:
    """``src`` with the ``edits`` of ``cut``; raises where an edit's text is
    not there exactly once (a changed source gives no silent uncut copy)."""
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"cut {cut!r}: the source holds {src.count(old)} copies of "
                             f"{old.strip()[:60]!r}")
        src = src.replace(old, new)
    return src


def window_cut_source(src: str, cut: str) -> str:
    """``src`` with the window modes' cut ``cut`` (:data:`WINDOW_CUTS`)."""
    return cut_source(src, cut, WINDOW_CUTS[window_design(src)][cut])


_INSTANCE = re.compile(r"(?:linesum|window)_kernelILi(\d+)E(?:Lb0E|ELb0E|Li\d+EE|E)")


def _instance_mode(fn: str):
    """K1's mode of a writing instance's mangled name, else None."""
    if "ELb1E" in fn:
        return None
    m = _INSTANCE.search(fn)
    return int(m.group(1)) if m else None


def _ptxas_by_mode(stderr: str, key=None) -> dict:
    """{mode: {registers, spill_store_bytes}} from ptxas -v (``key``: the
    instance's key in a mangled name, by default K1's mode)."""
    key = key or _instance_mode
    out, fn = {}, None
    for line in stderr.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line) or \
            re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        mode = key(fn) if fn else None
        if mode is not None:
            r = re.search(r"Used (\d+) registers", line)
            sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if r:
                out.setdefault(mode, {})["registers"] = int(r.group(1))
            if sp:
                out.setdefault(mode, {})["spill_store_bytes"] = int(sp.group(1))
    return out


def sass_loops(sass: str, key=None) -> dict:
    """{mode: [(instructions, MUFU.RCP, MUFU.EX2, FCHK, LDS) of each loop
    body that holds a MUFU]} of the writing K1 instances (``key``: another
    instance key of a mangled name) in ``cuobjdump -sass`` text: a loop is
    a branch to an earlier address, its body the instructions from that
    address to the branch."""
    key = key or _instance_mode
    funcs, mode = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            mode = key(m.group(1))
            if mode is not None:
                funcs.setdefault(mode, [])
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
        if mode is not None and m:
            funcs[mode].append((int(m.group(1), 16), m.group(2)))
    out = {}
    for mode, ins in funcs.items():
        for at, text in ins:
            b = re.search(r"BRA\w*(?:\.\w+)*\s+(?:`\()?(?:\.L_x_\d+\)?\s*)?0x([0-9a-f]+)", text)
            if not b or int(b.group(1), 16) >= at:
                continue
            body = [t for a, t in ins if int(b.group(1), 16) <= a <= at]
            cnt = lambda k: sum(k in t for t in body)
            if cnt("MUFU"):
                out.setdefault(mode, []).append((len(body), cnt("MUFU.RCP"), cnt("MUFU.EX2"),
                                                 cnt("FCHK"), cnt("LDS")))
    return out


def build_cuts(root: str, out_dir: str, cuts: dict, names=None, keep=None, key=None):
    """Compile the cuts ``cuts`` ({name: edits}) of TREE's linesum.cu (those
    of ``names`` and ``none``, where given) in parallel: {cut: (lib, ptxas by
    mode, SASS loops by mode, SASS text of the functions whose mangled name
    ``keep`` accepts; by default K1's FINE instances)}, by the instance
    ``key`` of a mangled name (by default K1's mode). An edit whose text is
    not in the source exactly once raises (no silent uncut copy)."""
    keep = keep or (lambda fn: _instance_mode(fn) in (4, 9))
    import ctypes

    from clearsky_tpu_torch.utils import cuda_build

    csrc = os.path.join(root, "clearsky_tpu_torch", "csrc")
    out_dir = os.path.abspath(out_dir)
    with open(os.path.join(csrc, "linesum.cu")) as f:
        src = f.read()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for cut, edits in cuts.items():
        if names is not None and cut not in names and cut != "none":
            continue
        cu = os.path.join(out_dir, f"linesum_{cut}.cu")
        with open(cu, "w") as f:
            f.write(cut_source(src, cut, edits))
        so = os.path.join(out_dir, f"liblinesum_{cut}.so")
        procs[cut] = (so, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", csrc, "-o", so,
             cu], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    dump = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    libs = {}
    for cut, (so, p) in procs.items():
        _, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on cut {cut}:\n{err[-3000:]}")
        loops, kept = {}, []
        if os.path.isfile(dump):
            d = subprocess.run([dump, "-sass", so], capture_output=True, text=True, timeout=600)
            if d.returncode == 0:
                loops = sass_loops(d.stdout, key)
                on = False
                for line in d.stdout.splitlines():
                    m = re.search(r"Function : (\S+)", line)
                    if m:
                        on = keep(m.group(1))
                    if on:
                        kept.append(line)
        libs[cut] = (ctypes.CDLL(so), _ptxas_by_mode(err, key), loops, "\n".join(kept))
    return libs


def build_window_cuts(root: str, out_dir: str, names=None):
    """Compile every cut of TREE's window modes (those of ``names`` and
    ``none``, where given) in parallel: {cut: (lib, ptxas by mode, SASS
    loops by mode)}; the window kernel's SASS in ``out_dir``."""
    with open(os.path.join(root, "clearsky_tpu_torch", "csrc", "linesum.cu")) as f:
        design = window_design(f.read())
    libs = build_cuts(root, out_dir, WINDOW_CUTS[design], names,
                      lambda fn: "window_kernel" in fn)
    if "none" in libs:
        with open(os.path.join(os.path.abspath(out_dir), "sass_window.txt"), "w") as f:
            f.write(libs["none"][3])
    return {cut: v[:3] for cut, v in libs.items()}


def window_launches(seed, dev) -> dict:
    """{case: (launch_mode's args, kwargs)} of each window case, captured
    from the entry point that launches it: the mix's ``radiate`` (FARALL, 38
    states), an RCM refresh at 16,384 points (FARALL, 20), the auto
    ``outgoing`` (FINE_STENCIL), the phco2 auto ``outgoing`` (PH_FINE_STENCIL)
    and the dense-CO2 RCE's refresh at 16,384 points."""
    import math

    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops import linesum_cuda as lc
    from clearsky_tpu_torch.spectra.synthetic import synthetic_co2_par

    par = synthetic_co2_par(cs.N_LINES, seed=seed)
    lines = ct.SpectralLines.from_par_dict(par)
    Pe = ct.pressuregrid(cs.PT, cs.PS, cs.N_LEVELS)
    Te = cs.column(Pe)
    fmu, fcp = (lambda T, P: cs.MU), (lambda T, P: cs.CP)

    def fS_of(nu):
        span = float(nu[-1] - nu[0])
        return lambda v: torch.full_like(v, 340.0 / math.cos(0.841) / span)

    build = os.path.join(ROOT, "build", "k1_probe_mix")
    os.makedirs(build, exist_ok=True)
    mix = cs.phase_mix_build(seed, dev, build)
    rcm_gas = ct.DirectGas.from_lines(lines, cs.CONC, cs.grid_for(lines, cs.N_NU_RCM))
    rcm = ct.RCM.create(Pe, Te, cs.G, fmu, fS_of(rcm_gas.nu), 0.1, fcp, 1e7, rcm_gas, radmul=2)
    voigt = ct.DirectGas.from_lines(lines, cs.CONC, cs.grid_for(lines, cs.N_NU_MAIN))
    phco2 = ct.DirectGas.from_lines(lines, cs.CONC, cs.phco2_grid(lines, cs.N_NU_MAIN),
                                    shape="phco2")
    adiabat = ct.DryAdiabat.create(cs.TS_RCE, cs.PS, cs.CP, cs.MU, Tstrat=160.0)
    rce_gas = ct.DirectGas.from_lines(lines, cs.CONC, cs.phco2_grid(lines, cs.N_NU_RCM),
                                      shape="phco2")
    rce = ct.RCM.create(Pe, adiabat(Pe).numpy(), cs.G, fmu, fS_of(rce_gas.nu), 0.1, fcp, 1e7,
                        rce_gas, radmul=2)
    calls = {"farall_mix": lambda: ct.radiate(Pe, cs.G, Te, cs.MU, fS_of(mix["nu"]), 0.1,
                                              mix["mg"], mix["cia"]),
             "farall_rcm": lambda: ct.update_absorber(rcm),
             "fine_stencil": lambda: ct.outgoing(Pe, cs.G, Te, cs.MU, voigt),
             "phco2_fine_stencil": lambda: ct.outgoing(Pe, cs.G, cs.column(Pe, cs.TS_RCE),
                                                       cs.MU, phco2),
             "phco2_fine_stencil_16384": lambda: ct.update_absorber(rce)}
    real, got = lc.launch_mode, {}
    for case, call in calls.items():
        seen = []

        def record(*a, **k):
            seen.append((a, k))
            return real(*a, **k)

        lc.launch_mode = record
        try:
            call()
            torch.cuda.synchronize()
        finally:
            lc.launch_mode = real
        mode = WINDOW_CASES[case][0]
        hits = [x for x in seen if x[0][0] == mode]
        cs.check(len(hits) >= 1, f"{case}: the entry point launched no mode {mode}")
        got[case] = hits[-1]
    return got


def _items(lc, mode: int, grid: dict, n_states: int, over=None) -> dict:
    """The launch's work items: pieces, blocks, and rows on the scratch path
    (the window plan's, ``over`` its override)."""
    if hasattr(lc, "window_plan") and mode in lc._WINDOW_KERNEL_MODES:
        return {k: v for k, v in lc.window_plan(mode, grid, n_states, over).items()
                if k != "table"}
    table, n_slots = lc.piece_schedule(grid["win"].cpu().numpy(), lc._N_WIN[mode],
                                       lc.PIECE_LINES)
    parts = np.bincount(table[:, 0], minlength=grid["win"].shape[0])
    return dict(pieces=int(table.shape[0]), blocks=int(table.shape[0]) * lc.state_tiles(n_states),
                threads=grid["nu_hi"].shape[0] // grid["win"].shape[0],
                rows=int(parts.size), scratch_row_share=float((parts > 1).mean()))


# launch plans tried by --plans: (groups, piece lines, points a thread),
# None for the plan's own choice
PLAN_VARIANTS = {"few": [(g, p, t) for g in (2, 4) for p in (128, None) for t in (1, 2)],
                 "many": [(1, p, t) for p in (256, None) for t in (1, 2)]}


def window_probe(seed, dev, cuts, out_dir: str, plans: bool = False):
    """Each window case alone, whole (and with ``cuts`` cut: True for every
    cut, else a list of names; with ``plans``
    under the launch plans of :data:`PLAN_VARIANTS`, where the tree has a
    plan), one ``probe`` line each."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops import linesum_cuda as lc
    from clearsky_tpu_torch.utils import cuda_build

    root = os.path.dirname(os.path.dirname(os.path.abspath(ct.__file__)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    cs.emit("probe", part="env", package_root=root, card=torch.cuda.get_device_name(dev),
            nvidia_smi=smi.stdout.strip().splitlines()[dev.index or 0])
    t0 = time.perf_counter()
    libs = build_window_cuts(root, out_dir, None if cuts is True else cuts) if cuts else {}
    cs.emit("probe", part="cuts", seconds=time.perf_counter() - t0, cuts=list(libs))
    launches = window_launches(seed, dev)
    real_launch = lc.launch_mode
    if plans and hasattr(lc, "window_plan"):
        for case, (a, k) in launches.items():
            mode, name = WINDOW_CASES[case]
            grid, n_states = a[1], a[4]
            few = lc.window_plan(mode, grid, n_states)["groups"] > 1
            for g, p, t in PLAN_VARIANTS["few" if few else "many"]:
                over = {"groups": g, "piece_lines": p, "points_per_thread": t}
                over = {key: v for key, v in over.items() if v is not None}
                fn = lambda a=a, k=k, over=over: real_launch(*a, **k, window=over)
                fn()
                torch.cuda.synchronize()
                cs.emit("probe", kernel=name, case=case, cut="plan",
                        device_ms=cs.kernel_device_ms(fn, name),
                        **_items(lc, mode, grid, n_states, over))
    default = cuda_build.load_library("linesum")
    for cut in ["none"] + [c for c in libs if c != "none"]:
        lib, ptx, loops = libs.get(cut, (default, {}, {}))
        cuda_build._LIBS["linesum"] = lib
        try:
            for case, (a, k) in launches.items():
                mode, name = WINDOW_CASES[case]
                fn = lambda a=a, k=k: real_launch(*a, **k)
                fn()
                torch.cuda.synchronize()
                grid, n_states = a[1], a[4]
                items = _items(lc, mode, grid, n_states)
                pts = items.get("points_per_thread")
                info = (lc.kernel_info(mode, items["threads"], pts) if pts
                        else lc.kernel_info(mode, items["threads"]))
                w = grid["win"].cpu().numpy()[:, 1::2].sum(axis=1)
                cs.emit("probe", kernel=name, case=case, cut=cut, states=n_states,
                        points=a[5], lines=a[2].n_lines, ms=cs.cuda_ms(fn),
                        device_ms=cs.kernel_device_ms(fn, name), **info, **items,
                        max_window_lines=int(w.max(initial=0)), mean_window_lines=float(w.mean()),
                        ptxas=ptx.get(mode, {}), sass_loops=loops.get(mode, []))
                if cut == "none" and mode in (5, 10) and not hasattr(lc, "window_plan"):
                    # one work item a row: the mid window alone, no scratch
                    win = grid["win"].clone()
                    win[:, 2:] = 0
                    one = {"nu_hi": grid["nu_hi"], "nu_lo": grid["nu_lo"], "win": win}
                    keep, lc.PIECE_LINES = lc.PIECE_LINES, 1 << 30
                    try:
                        f1 = lambda a=a, k=k: real_launch(a[0], one, *a[2:], **k)
                        f1()
                        torch.cuda.synchronize()
                        cs.emit("probe", kernel=name, case=case, cut="items",
                                states=n_states, points=a[5], ms=cs.cuda_ms(f1),
                                device_ms=cs.kernel_device_ms(f1, name),
                                **_items(lc, mode, one, n_states))
                    finally:
                        lc.PIECE_LINES = keep
        finally:
            cuda_build._LIBS["linesum"] = default


def route_errors(seed, dev, out_dir: str, cuts=("none", "no_core")):
    """Each state's error of the stencil and coarse routes at the main shape
    (57 states x 2^19) against the float64 line sum, as chip_smoke.py's
    ``routes`` phase bars them (of each state's peak; the float32 plain
    version at the cut edges), for the window kernel built whole and cut
    (``no_core``: no correction algebra near the cores), beside the plain
    float32 routes' and the bar max(2 x grouped's, 1e-6, 2 x plain
    float32's): one ``probe`` line a state."""
    from clearsky_tpu_torch.ops import linesum_cuda as lc
    from clearsky_tpu_torch.ops import linesum_strategies as ls
    from clearsky_tpu_torch.spectra.synthetic import synthetic_co2_par
    from clearsky_tpu_torch.utils import cuda_build

    root = os.path.dirname(os.path.dirname(os.path.abspath(lc.__file__)))
    keep = WINDOW_CUTS["window"]
    WINDOW_CUTS["window"] = {c: keep[c] for c in cuts}
    try:
        libs = build_window_cuts(os.path.dirname(root), out_dir)
    finally:
        WINDOW_CUTS["window"] = keep
    d = cs.kernel_linesum_main_shape(synthetic_co2_par(cs.N_LINES, seed=seed), dev, {})
    lines, plan, states = d["lines"], d["plan"], d["states"]
    ref = cs.at_edges(d["ref"], d["ref32"], d["edge"])
    pk = ref.abs().amax(dim=1, keepdim=True)
    err = lambda out: ((out.double() - ref).abs() / pk).amax(dim=1).cpu().numpy()
    params = ls._resolve(plan, lines, "voigt", "coarse")[1]
    got = {"stencil_plain32": err(ls.sigma_stencil_plain(plan, lines, *states)),
           "coarse_plain32": err(ls.sigma_coarse_plain(plan, lines, *states, params)),
           "grouped": err(lc.sigma_lines(plan, lines, *states))}
    default = cuda_build.load_library("linesum")
    try:
        for cut, (lib, _, _) in libs.items():
            cuda_build._LIBS["linesum"] = lib
            got["stencil_" + cut] = err(lc.sigma_stencil(plan, lines, *states))
            got["coarse_" + cut] = err(lc.sigma_coarse(plan, lines, *states, params))
    finally:
        cuda_build._LIBS["linesum"] = default
    g = float(got["grouped"].max())
    for i, P in enumerate(states[1].double().cpu().tolist()):
        bar = max(2.0 * g, 1e-6, 2.0 * float(got["stencil_plain32"][i]))
        cs.emit("probe", part="routes", state=i, P=P, bar=bar,
                **{k: float(v[i]) for k, v in got.items() if k != "grouped"})


def farall_errors(seed, dev, out_dir: str, cuts=()):
    """FARALL where the mix's ``radiate`` runs it (38 states x 2^19, 55,000
    lines) against its float64 plain version on chip_smoke.py's sampled
    blocks, as its ``kernel`` line bars it (1e-5 of each state's peak): the
    kernel as built with the pack's reciprocal flag (``fast``) and with the
    IEEE division (the flag off), each cut of ``cuts`` (e.g. ``newton``)
    likewise, and the plain float32 version (the IEEE division, another
    order of sums): one ``probe`` line each, the largest error of a state's
    peak, the largest absolute error and the state where the first lies."""
    from clearsky_tpu_torch.ops import linesum_cuda as lc
    from clearsky_tpu_torch.ops import linesum_strategies as ls
    from clearsky_tpu_torch.utils import cuda_build

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(lc.__file__))))
    libs = build_window_cuts(root, out_dir, list(cuts)) if cuts else {}
    build = os.path.join(ROOT, "build", "k1_probe_mix")
    os.makedirs(build, exist_ok=True)
    plan, lines, T, P, Pp, conc, shape = cs.farall_mix_case(cs.phase_mix_build(seed, dev, build))
    n = int(T.shape[0])
    _, _, _, co, coef, _, fast = lc._route_operands(lines, T, P, Pp, plan.windows(), conc,
                                                     shape, plan.cut)
    grid = plan.device_arrays(dev)
    idx = cs.sample_blocks(plan.nu_blocks)
    ref = cs.farall_sample_ref(plan, lines, T, P, Pp, conc, idx)
    _, valid = cs.sampled(torch.zeros((n, plan.n_nu), device=dev), idx, plan.block, plan.n_nu)
    plain = ls.sigma_mode_plain("farall", plan.nu_blocks[idx], plan.windows()[idx], lines, co,
                                {"cut": plan.cut})
    cs.emit("probe", part="farall_errors", package_root=root, kernel="plain_float32",
            **dict(zip(("err_of_peak", "max_abs_err", "state"),
                       cs.sample_error(plain, ref, valid))))
    default = cuda_build.load_library("linesum")
    try:
        for cut in ["none"] + [c for c in libs if c != "none"]:
            cuda_build._LIBS["linesum"] = libs[cut][0] if cut in libs else default
            for flag in ("pack", "off"):
                f = fast if flag == "pack" else torch.zeros_like(fast)
                out = lc.launch_mode(3, grid, lines, coef, n, plan.n_nu, lc._zones(plan.cut),
                                     fast=f)
                got, _ = cs.sampled(out, idx, plan.block, plan.n_nu)
                del out
                e = cs.sample_error(got, ref, valid)
                cs.emit("probe", part="farall_errors", package_root=root, kernel="farall",
                        cut=cut, fast=flag, pack_fast=bool(fast.item()),
                        **dict(zip(("err_of_peak", "max_abs_err", "state"), e)))
    finally:
        cuda_build._LIBS["linesum"] = default


def window_calls(seed, dev) -> dict:
    """The entry-point calls that run FARALL or FINE_STENCIL: march_probe's
    (auto ``outgoing``, RCM refresh and step, RCE run and step, the mix's
    ``radiate``) and the phco2 auto ``outgoing``."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.spectra.synthetic import synthetic_co2_par
    from clearsky_tpu_torch.tools import march_probe

    march_probe.cs = cs
    calls = march_probe.entry_calls(seed, dev)
    lines = ct.SpectralLines.from_par_dict(synthetic_co2_par(cs.N_LINES, seed=seed))
    Pe = ct.pressuregrid(cs.PT, cs.PS, cs.N_LEVELS)
    phco2 = ct.DirectGas.from_lines(lines, cs.CONC, cs.phco2_grid(lines, cs.N_NU_MAIN),
                                    shape="phco2")
    Te = cs.column(Pe, cs.TS_RCE)
    calls["phco2_outgoing"] = lambda: ct.outgoing(Pe, cs.G, Te, cs.MU, phco2)
    return calls


# --- K1's FINE mode (the coarse split's in-kernel fine pass) --------------------

# case: (K1 mode, the profiler's name of the instance); K1-dev traces as K1's
FINE_CASES = {"fine": (4, "linesum_fine"), "phco2_fine": (9, "linesum_phco2_fine"),
              "dev_fine": (4, "linesum_fine"), "dev_phco2_fine": (9, "linesum_phco2_fine")}
# the cuts of FINE by its design: the general sweep (linesum_kernel's mid zone) or the
# window kernel's FINE path (fine_sweep: its mid pass and near phase)
_FINE_NO_NEAR = ("  return r >= 0.0f && d0 <= r + NEAR_EPS && d1 >= -r - NEAR_EPS;\n",
                 "  return false && r >= 0.0f && d0 <= r + NEAR_EPS && d1 >= -r - NEAR_EPS;\n")
FINE_CUTS = {
    "sweep": {"none": [], "arith": [_SWEEP_QUAD, _SWEEP_STAGE_QUADS, _SWEEP_READ_QUADS],
              "stage": [_SWEEP_LOOP],
              "no_near": [("        if (adnu > it.d_near) {\n", "        if (true) {\n")]},
    "window": {"none": [],
               "arith": [_WINDOW_LINE,
                         ("      cp_async16(&sm.c[buf][i], it.coef + (size_t)it.line(c0 + j) * ls"
                          " + it.s0 + (i - j * NS));\n", "      (void)j;\n"),
                         ("      const float4* c = sm.c[buf] + j * NS;\n",
                          "      float4 c[NS];\n#pragma unroll\n"
                          "      for (int s = 0; s < NS; ++s) c[s] = probe_quad<PH>(j, s);\n")],
               "stage": [("    for (int j = g * per; j < j1; ++j) {\n      const float2 ps",
                          "    for (int j = g * per; j < j1 && j1 < 0; ++j) {\n      const float2 ps"),
                         _FINE_NO_NEAR],
               "no_near": [_FINE_NO_NEAR]},
}


def fine_design(src: str) -> str:
    """The design of TREE's FINE mode: "sweep" (linesum_kernel) or "window"
    (window_kernel's FINE path)."""
    return "window" if "void fine_sweep(" in src else "sweep"


def fine_cut_source(src: str, cut: str) -> str:
    """``src`` with FINE's cut ``cut`` (:data:`FINE_CUTS`)."""
    return cut_source(src, cut, FINE_CUTS[fine_design(src)][cut])


def fine_calls(seed, dev) -> dict:
    """The entry-point calls that run FINE (auto ``outgoing`` at 2^20, voigt
    and phco2; the sharded auto ``outgoing`` of 4 shards at 2^19, voigt and
    phco2) and the auto ``outgoing`` at 2^19 (FINE_STENCIL, for contrast)."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.spectra.synthetic import synthetic_co2_par

    lines = ct.SpectralLines.from_par_dict(synthetic_co2_par(cs.N_LINES, seed=seed))
    Pe = ct.pressuregrid(cs.PT, cs.PS, cs.N_LEVELS)
    Te, Tph = cs.column(Pe), cs.column(Pe, cs.TS_RCE)
    gas = lambda nu, **k: ct.DirectGas.from_lines(lines, cs.CONC, nu, **k)
    g20 = gas(cs.grid_for(lines, cs.N_NU_FINE))
    p20 = gas(cs.phco2_grid(lines, cs.N_NU_FINE), shape="phco2")
    sv = ct.shard_line_gas(gas(cs.grid_for(lines, cs.N_NU_MAIN)), cs.N_SHARDS)
    sp = ct.shard_line_gas(gas(cs.phco2_grid(lines, cs.N_NU_MAIN), shape="phco2"), cs.N_SHARDS)
    g19 = gas(cs.grid_for(lines, cs.N_NU_MAIN))
    return {"fine": lambda: ct.outgoing(Pe, cs.G, Te, cs.MU, g20),
            "phco2_fine": lambda: ct.outgoing(Pe, cs.G, Tph, cs.MU, p20),
            "dev_fine": lambda: ct.outgoing(Pe, cs.G, Te, cs.MU, sv),
            "dev_phco2_fine": lambda: ct.outgoing(Pe, cs.G, Tph, cs.MU, sp),
            "outgoing_2e19": lambda: ct.outgoing(Pe, cs.G, Te, cs.MU, g19)}


def fine_launches(calls) -> dict:
    """{case: launch_mode's bound arguments} of the FINE launch each call of
    :data:`FINE_CASES` makes, captured from the entry point."""
    import inspect

    from clearsky_tpu_torch.ops import linesum_cuda as lc

    real, got = lc.launch_mode, {}
    sig = inspect.signature(real)
    for case, (mode, _) in FINE_CASES.items():
        seen = []

        def record(*a, **k):
            seen.append(sig.bind(*a, **k).arguments)
            return real(*a, **k)

        lc.launch_mode = record
        try:
            calls[case]()
            torch.cuda.synchronize()
        finally:
            lc.launch_mode = real
        hits = [x for x in seen if x["mode"] == mode]
        cs.check(len(hits) == 1, f"{case}: the entry point made {len(hits)} launches of mode {mode}")
        got[case] = hits[0]
    return got


def fine_pairs(lc, b: dict, max_pairs: int = 2**24) -> dict:
    """What one FINE launch ``b`` (launch_mode's arguments) computes, counted
    on its data: (point, line) pairs of the mid zone (|dnu| <= cut_f in the
    mid window), within d_near (the near zone, the w4 pairs), and of the
    annuli; the near triples (with each state) by w4 region (1-4 as
    chip_smoke.w4_ops splits them) and those a per-(line, state) reach keeps
    (|x| <= 15.01; |x| + y < 15.01: where w4 is not region 1); and the w4
    work as a warp of 32 consecutive points of a row runs it (the sum over
    (warp, line, state) of every region some lane needs) against the same
    triples packed 32 to a warp."""
    grid, lines, coef = b["grid"], b["lines"], b["coef"]
    n, k = b["n_states"], b.get("n_shards", 1)
    z = list(b["zones"])                       # cut, cut_f, d_lo, D1, inv_D, R1, inv_R
    cut, cut_f, R1 = z[0], z[1], z[5]
    win = grid["win"].long()
    rows = win.shape[0]
    B = grid["nu_hi"].shape[0] // rows
    nb = rows // k
    d_near = b["d_near"].float()
    dev = coef.device
    ph = b["mode"] in lc._PHCO2_MODES
    # the (Sia, ia, y0, .) quads: FINE's second quad [L, 2, n, 4], or the
    # first of the general sweep's [L, n, 8] (voigt) and [L, n, 4] (phco2) packs
    w4q = coef[:, 1] if coef.dim() == 4 else coef[..., :4]
    out = dict(rows=rows, block=B, shards=k, states=n, d_near=d_near.tolist())
    counts = {key: 0 for key in ("mid_pairs", "near_pairs", "annulus_pairs")}
    reg = torch.zeros(5, dtype=torch.float64, device=dev)   # near triples by region (1-4)
    keep_x = keep_xy = 0
    warp_ops = packed_ops = 0.0
    ops = torch.tensor([0.0, *cs.W4_REGION], dtype=torch.float64, device=dev)
    for w in range(3):
        starts, cnts = win[:, 2 * w], win[:, 2 * w + 1]
        row = torch.repeat_interleave(torch.arange(rows, device=dev), cnts)
        first = torch.cumsum(cnts, 0) - cnts
        line = (torch.arange(row.numel(), device=dev) - torch.repeat_interleave(first, cnts)
                + torch.repeat_interleave(starts, cnts))
        step = max(1, max_pairs // B)
        for a in range(0, row.numel(), step):
            r, l = row[a:a + step], line[a:a + step]
            pts = r[:, None] * B + torch.arange(B, device=dev)[None, :]
            dnu = ((grid["nu_hi"][pts] - lines.nu[l][:, None])
                   + (grid["nu_lo"][pts] - lines.nu_lo[l][:, None]))
            adnu = dnu.abs()
            if w:
                counts["annulus_pairs"] += int(((adnu <= cut) & (dnu * dnu > R1)).sum())
                continue
            counts["mid_pairs"] += int((adnu <= cut_f).sum())
            near = adnu <= d_near[r // nb][:, None]
            counts["near_pairs"] += int(near.sum())
            ri, pi = near.nonzero(as_tuple=True)
            if ri.numel() == 0:
                continue
            ln = l[ri]
            x = dnu[ri, pi][None, :] * w4q[ln, :, 1].T           # [n, pairs]
            y = w4q[ln, :, 2].T.expand_as(x)                     # chi = 1 within 3 cm^-1
            ax, s = x.abs(), x.abs() + y
            r1 = s >= 15.0
            r2 = ~r1 & (s >= 5.5)
            r3 = ~r1 & ~r2 & (y >= 0.195 * ax - 0.176)
            region = torch.where(r1, 1, torch.where(r2, 2, torch.where(r3, 3, 4)))
            reg += torch.bincount(region.reshape(-1), minlength=5).double()
            keep_x += int((ax <= 15.01).sum())
            keep_xy += int((s < 15.01).sum())
            # the warp's w4 work: every region a lane of (warp, line, state) needs
            wid = (r[ri] * B + pi) // 32
            key = (wid * lines.nu.shape[0] + ln)[None, :] * n + torch.arange(n, device=dev)[:, None]
            uk, inv = torch.unique(key.reshape(-1), return_inverse=True)
            bits = torch.zeros(uk.numel(), 5, dtype=torch.bool, device=dev)
            for q in range(1, 5):
                m = torch.zeros(uk.numel(), dtype=torch.long, device=dev)
                m.scatter_reduce_(0, inv, (region.reshape(-1) == q).long(), reduce="amax")
                bits[:, q] = m > 0
            warp_ops += float((bits.double() * ops).sum()) * 32.0
            packed_ops += float(ops[region.reshape(-1)].sum())
    out.update(counts, near_triples_by_region=reg[1:].tolist(), near_triples_x_le_15=keep_x,
               near_triples_w4_not_region1=keep_xy,
               w4_divergence=warp_ops / packed_ops if packed_ops else None)
    if ph:
        out["chi_one_in_near_zone"] = bool(float(d_near.max()) < 3.0)
    return out


def fine_probe(seed, dev, cuts, out_dir: str):
    """Each FINE case alone (:data:`FINE_CASES`, captured from its entry
    point), whole and cut (``cuts``: True for every cut of TREE's design,
    else a list of names; ``items``: one work item a row), with its build,
    work items and counted pairs; then the profile of the entry-point calls
    (:func:`fine_calls`). One ``probe`` line a case and cut, one ``profile``
    line a call."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops import linesum_cuda as lc
    from clearsky_tpu_torch.utils import cuda_build

    root = os.path.dirname(os.path.dirname(os.path.abspath(ct.__file__)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    cs.emit("probe", part="env", package_root=root, card=torch.cuda.get_device_name(dev),
            nvidia_smi=smi.stdout.strip().splitlines()[dev.index or 0])
    with open(os.path.join(root, "clearsky_tpu_torch", "csrc", "linesum.cu")) as f:
        design = fine_design(f.read())
    t0 = time.perf_counter()
    libs = {}
    if cuts:
        libs = build_cuts(root, out_dir, FINE_CUTS[design], None if cuts is True else cuts)
        for cut, (_, _, _, sass) in libs.items():
            if sass:
                with open(os.path.join(out_dir, f"sass_fine_{cut}.txt"), "w") as f:
                    f.write(sass)
    cs.emit("probe", part="cuts", design=design, seconds=time.perf_counter() - t0,
            cuts=list(libs))
    calls = fine_calls(seed, dev)
    launches = fine_launches(calls)
    real = lc.launch_mode
    windowed = 4 in getattr(lc, "_WINDOW_KERNEL_MODES", ())
    for case, b in launches.items():
        mode, name = FINE_CASES[case]
        grid, n = b["grid"], b["n_states"]
        if windowed:
            plan = {k: v for k, v in lc.window_plan(mode, grid, n, n_shards=b.get("n_shards", 1))
                    .items() if k != "table"}
            info = lc.kernel_info(mode, plan["threads"], plan["points_per_thread"])
        else:
            threads = grid["nu_hi"].shape[0] // grid["win"].shape[0]
            info = lc.kernel_info(mode, threads)
            plan = _items(lc, mode, grid, n)
        cs.emit("probe", kernel=name, case=case, part="pairs", lines=b["lines"].n_lines,
                points=b["n_out"] * b.get("n_shards", 1), **{**plan, **info, **fine_pairs(lc, b)})
    default = cuda_build.load_library("linesum")
    for cut in ["none"] + [c for c in libs if c != "none"] + ["items"]:
        lib = libs[cut][0] if cut in libs else default
        cuda_build._LIBS["linesum"] = lib
        try:
            for case, b in launches.items():
                mode, name = FINE_CASES[case]
                args = dict(b)
                if cut == "items":
                    # one work item a row: the mid window alone, no scratch
                    if windowed:
                        args["window"] = {"piece_lines": 1 << 20}
                    else:
                        win = b["grid"]["win"].clone()
                        win[:, 2:] = 0
                        args["grid"] = {"nu_hi": b["grid"]["nu_hi"],
                                        "nu_lo": b["grid"]["nu_lo"], "win": win}
                keep = lc.PIECE_LINES
                if cut == "items" and not windowed:
                    lc.PIECE_LINES = 1 << 30
                try:
                    fn = lambda args=args: real(**args)
                    out = fn()
                    torch.cuda.synchronize()
                    digest = hashlib.sha1(out.cpu().numpy().tobytes()).hexdigest()[:16]
                    del out
                    cs.emit("probe", kernel=name, case=case, cut=cut, ms=cs.cuda_ms(fn, n=5),
                            device_ms=cs.kernel_device_ms(fn, name), digest=digest,
                            ptxas=libs[cut][1].get(mode, {}) if cut in libs else {},
                            sass_loops=libs[cut][2].get(mode, []) if cut in libs else [])
                finally:
                    lc.PIECE_LINES = keep
        finally:
            cuda_build._LIBS["linesum"] = default
    for fn in calls.values():               # set-up, caches
        fn()
    torch.cuda.synchronize()
    cs.phase_profile(calls)


# --- the full-profile kernels K4 and K5 ----------------------------------------

# case: (shape, route, chip_smoke's kernel name)
FULL_CASES = {"lane": ("voigt", "lane", "linesum_lane"),
              "gathered": ("voigt", "gathered", "linesum_gathered"),
              "phco2_lane": ("phco2", "lane", "linesum_phco2_lane"),
              "phco2_gathered": ("phco2", "gathered", "linesum_phco2_gathered")}

# the window kernel's FULL path cut or changed: ``arith`` its window quads
# made in registers (FARALL's probe quads), not staged; ``stage`` the
# staging alone; ``no_near`` no near line (every pair its far term);
# ``chunk64`` every FULL mode in chunks of 64 lines (voigt's are 32: less
# shared memory a block; the plan's pieces are cut in 32-line chunks, which
# a 64-line stage takes whole or in part)
FULL_CUTS = {
    "none": [],
    "arith": [_WINDOW_LINE,
              ("      cp_async16(&sm.c[buf][i], it.coef + (size_t)(it.ws[0] + c0 + j) * ls + "
               "it.s0 + (i - j * NS));\n", "      (void)j;\n"),
              ("      const float4* c = sm.c[buf] + NS * j;\n",
               "      float4 c[NS];\n#pragma unroll\n"
               "      for (int s = 0; s < NS; ++s) c[s] = probe_quad<PH>(j, s);\n")],
    "stage": [("    for (int j = g * per; j < j1; ++j) {\n      // line j of the chunk:",
               "    for (int j = g * per; j < j1 && j1 < 0; ++j) {\n      // line j of the chunk:")],
    "no_near": [("        if (ax.x >= 0.0f && d0 <= ax.x + NEAR_EPS && d1 >= -ax.x - NEAR_EPS) {\n",
                 "        if (false && ax.x >= 0.0f && d0 <= ax.x + NEAR_EPS) {\n")],
    "chunk64": [("using ModeStage = WindowStage<window_chunk(MODE), ",
                 "using ModeStage = WindowStage<(is_full(MODE) ? 64 : window_chunk(MODE)), "),
                ("  constexpr int WCH = window_chunk(MODE);\n",
                 "  constexpr int WCH = is_full(MODE) ? 64 : window_chunk(MODE);\n")]}


# window_kernel's FULL modes (csrc/linesum.cu ``Mode``)
FULL_MODE_KEYS = (14, 15, 16, 17)


def _full_key(fn: str):
    """A K4/K5 instance's key in a mangled name: the window kernel's mode,
    else None."""
    mode = _instance_mode(fn)
    return mode if mode in FULL_MODE_KEYS else None

# other launch plans of the window kernel's FULL path (``--full --plans``)
FULL_PLAN_VARIANTS = {"voigt": [{"points_per_thread": 1}, {"piece_lines": 512},
                                {"piece_lines": 4096}],
                      "phco2": [{"groups": 1}, {"groups": 2}, {"piece_lines": 512}]}


def full_inputs(seed, dev) -> dict:
    """{shape: (plan, lines, states)}: the mix's CO2 catalog (40,000 lines)
    at the main column's 57 states on 2^19 points, cut 25 (voigt), and
    config 2 at chip_smoke's 16 phco2 kernel states on 2^15 points, cut 500
    (phco2), as chip_smoke.py's ``kernel`` lines take them."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.spectra.synthetic import synthetic_co2_par

    root = os.path.dirname(os.path.dirname(os.path.abspath(ct.__file__)))
    build = os.path.join(root, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        paths = cs.write_mix_files(seed, tmp)
        co2 = ct.SpectralLines.from_par(paths["co2"], numin=cs.MIX_NU[0] - 25.0,
                                        numax=cs.MIX_NU[1] + 25.0)
    nu = np.linspace(*cs.MIX_NU, cs.N_NU_MAIN)
    cplan = ct.DirectGas.from_lines(co2, cs.MIX_CO2, nu, strategy="lane").plan
    (T, P), _ = cs.mix_states(dev)
    lines = ct.SpectralLines.from_par_dict(synthetic_co2_par(cs.N_LINES, seed=seed),
                                             dtype=torch.float32, device=dev)
    pplan = ct.DirectGas.from_lines(lines, cs.CONC, cs.phco2_grid(lines, cs.N_NU_KERNEL),
                                    shape="phco2", strategy="stencil").plan
    rng = np.random.default_rng(seed + 5)
    Tn = rng.uniform(160.0, 285.0, cs.N_STATES_KERNEL)
    Pn = np.geomspace(cs.PT, cs.PS, cs.N_STATES_KERNEL)
    sk = [torch.tensor(x, dtype=torch.float32, device=dev) for x in (Tn, Pn, cs.CONC * Pn)]
    return {"voigt": (cplan, co2, (T, P, cs.MIX_CO2 * P)), "phco2": (pplan, lines, sk)}


def full_capture(inputs, case: str):
    """(launches, output) of one K4/K5 case: each ``launch_fullprofile``
    call the route's wrapper makes, as bound arguments (its operands kept),
    and the wrapper's output."""
    import inspect

    from clearsky_tpu_torch.ops import linesum_cuda as lc

    shape, route, _ = FULL_CASES[case]
    plan, lines, states = inputs[shape]
    real, seen = lc.launch_fullprofile, []
    sig = inspect.signature(real)

    def record(*a, **k):
        seen.append(dict(sig.bind(*a, **k).arguments))
        return real(*a, **k)

    lc.launch_fullprofile = record
    try:
        kern = lc.sigma_lane if route == "lane" else lc.sigma_gathered
        out = kern(plan, lines, *states, shape=shape)
        torch.cuda.synchronize()
    finally:
        lc.launch_fullprofile = real
    return seen, out


def full_replay(launches):
    """A function of no arguments that makes the captured launch (one a
    call) again and returns sigma."""
    from clearsky_tpu_torch.ops import linesum_cuda as lc

    (a,) = launches
    return lambda: lc.launch_fullprofile(**a)


def _only_rows(launches, keep_rows):
    """The captured launches with every grid block but ``keep_rows`` left
    without lines in the window table."""
    out = []
    for a in launches:
        g = a["grid"]
        win = g["win"].clone()
        mask = torch.ones(win.shape[0], dtype=torch.bool, device=win.device)
        mask[keep_rows] = False
        win[mask, 1::2] = 0
        out.append(dict(a, grid={"nu_hi": g["nu_hi"], "nu_lo": g["nu_lo"], "win": win,
                                 "win_host": win.cpu().numpy().astype(np.int64)}))
    return out


def _launch_device_ms(fn, n: int = 5):
    """(device ms a call of every traced kernel, launches a call by kernel
    name) of ``fn``, through chip_smoke's profiler helper."""
    fn()
    torch.cuda.synchronize()
    _, per, _, _ = cs.traced(fn, n)
    return (sum(us for _, us in per.values()) / n / 1e3,
            {k: c / n for k, (c, _) in per.items()})


def full_pairs(plan, lines, states, shape: str, stride: int = 16,
               max_elems: int = 2**26) -> dict:
    """What K4/K5 compute on one case's data, counted on every ``stride``-th
    grid block (row): in-cut (point, line) pairs and (point, line, state)
    triples, the triples by w4 region (1-4, as chip_smoke.w4_ops splits
    them) and with y < 0.01 (the small-y repair), the triples whose warp (32
    consecutive points of a row) has every in-cut lane in region 1, and the
    w4 work as warps run it (every region a lane of (warp, line, state)
    needs) against the same triples packed 32 to a warp."""
    from clearsky_tpu_torch.ops.linesum import _line_params, effective_alpha, voigt_coefficients
    from clearsky_tpu_torch.ops.lineshape import chi_phco2

    dev = states[0].device
    S, alpha, gamma = _line_params(lines, *states)
    alpha = effective_alpha(shape, alpha)
    _, ia, y0 = voigt_coefficients(S, alpha, gamma)[:3]
    n = ia.shape[0]
    win = np.asarray(plan.windows(), np.int64)
    grid = torch.as_tensor(np.asarray(plan.nu_blocks), device=dev)          # [nb, B] float64
    pos = torch.as_tensor(lines.positions64(), device=dev)
    B = grid.shape[1]
    rows = np.arange(0, win.shape[0], stride)
    ops = torch.tensor([0.0, *cs.W4_REGION], dtype=torch.float64, device=dev)
    reg = torch.zeros(5, dtype=torch.float64, device=dev)
    pairs = small = whole_r1 = 0
    warp_ops = packed_ops = 0.0
    Tn = states[0][:, None, None]
    for r in rows:
        a, c = int(win[r, 0]), int(win[r, 1])
        if c == 0:
            continue
        step = max(1, max_elems // (n * B))
        for l0 in range(a, a + c, step):
            l1 = min(a + c, l0 + step)
            dnu = grid[r][:, None] - pos[None, l0:l1]                          # [B, nl]
            inc = dnu.abs() <= plan.cut
            pairs += int(inc.sum())
            d32 = dnu.float()
            x = d32[None] * ia[:, None, l0:l1]                                  # [n, B, nl]
            y = y0[:, None, l0:l1].expand_as(x)
            if shape in ("phco2", "phco2_ref"):
                y = y * chi_phco2(d32.abs()[None], Tn)
            ax, s = x.abs(), x.abs() + y
            r1 = s >= 15.0
            r2 = ~r1 & (s >= 5.5)
            r3 = ~r1 & ~r2 & (y >= 0.195 * ax - 0.176)
            region = torch.where(r1, 1, torch.where(r2, 2, torch.where(r3, 3, 4)))
            region = torch.where(inc[None], region, 0)
            reg += torch.bincount(region.reshape(-1), minlength=5).double()
            small += int(((y < 0.01) & inc[None]).sum())
            # warps: [n, B / 32, 32, nl]
            rw = region.view(n, B // 32, 32, -1)
            need = torch.stack([(rw == q).any(dim=2) for q in range(1, 5)], dim=-1)  # [n, w, nl, 4]
            cnt = (rw > 0).sum(dim=2)                                          # in-cut lanes
            only1 = need[..., 0] & ~need[..., 1:].any(dim=-1)
            whole_r1 += int(cnt[only1].sum())
            warp_ops += float((need.double() * ops[1:]).sum()) * 32.0
            packed_ops += float(ops[region.reshape(-1)].sum())
    scale = win.shape[0] / max(1, len(rows))
    triples = float(reg[1:].sum())
    return dict(sampled_rows=int(len(rows)), row_scale=scale, in_cut_pairs=pairs * scale,
                in_cut_triples=triples * scale,
                triples_by_region=[float(v) * scale for v in reg[1:].tolist()],
                triples_small_y=small * scale,
                share_in_whole_region1_warps=whole_r1 / triples if triples else None,
                w4_warp_multiplicity=warp_ops / packed_ops if packed_ops else None)


def full_build_info(lc, launches, shape: str) -> dict:
    """Registers, shared and local bytes and resident warps of the FULL
    instance the launches run, with its launch plan."""
    a = launches[0]
    plan = lc.full_plan(shape, a["grid"], a["n_states"], a.get("window"))
    info = lc.kernel_info(lc.full_mode(shape), plan["threads"], plan["points_per_thread"])
    return dict(info, launches_per_call=len(launches),
                **{k: v for k, v in plan.items() if k != "table"})


def full_probe(seed, dev, cuts, out_dir: str, pairs: bool = True, plans: bool = False):
    """K4 and K5 alone at chip_smoke.py's shapes (:data:`FULL_CASES`), each
    launch captured from its route's wrapper and replayed: CUDA events (one
    call: every launch a call makes) and the profiler's device ms, a digest
    of sigma, the build, the densest 1% of blocks alone, the counted work
    (:func:`full_pairs`); ``cuts`` (True, or a list of names:
    :data:`FULL_CUTS`) rebuilds TREE's kernel cut; ``plans`` times the other
    launch plans (:data:`FULL_PLAN_VARIANTS`); then the peak memory of the
    gathered call and the profile of ``outgoing`` on "lane" and "gathered"
    on the mix's CO2 catalog."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops import linesum_cuda as lc
    from clearsky_tpu_torch.utils import cuda_build

    root = os.path.dirname(os.path.dirname(os.path.abspath(ct.__file__)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    cs.emit("probe", part="env", package_root=root, card=torch.cuda.get_device_name(dev),
            nvidia_smi=smi.stdout.strip().splitlines()[dev.index or 0])
    t0 = time.perf_counter()
    libs = {}
    if cuts:
        libs = build_cuts(root, out_dir, FULL_CUTS, None if cuts is True else cuts,
                          lambda fn: _full_key(fn) is not None, key=_full_key)
        for cut, (_, _, _, sass) in libs.items():
            with open(os.path.join(out_dir, f"sass_full_{cut}.txt"), "w") as f:
                f.write(sass)
    cs.emit("probe", part="cuts", seconds=time.perf_counter() - t0, cuts=list(libs))
    inputs = full_inputs(seed, dev)
    default = cuda_build.load_library("linesum")
    for case, (shape, route, name) in FULL_CASES.items():
        launches, out = full_capture(inputs, case)
        digest = hashlib.sha1(out.cpu().numpy().tobytes()).hexdigest()[:16]
        del out
        plan = inputs[shape][0]
        info = full_build_info(lc, launches, shape)
        stats = _window_stats(plan.windows())
        cs.emit("probe", kernel=name, case=case, part="build", launches=len(launches),
                **{**stats, **info})
        if route == "lane":
            T = inputs[shape][2][0] if shape == "phco2" else None
            a = launches[0]
            cs.emit("probe", kernel=name, case=case, part="bound",
                    **cs.full_bound(plan, a["lines"], a["coef"], a["n_states"], T))
        if pairs and route == "lane":
            cs.emit("probe", kernel=name, case=case, part="pairs",
                    **full_pairs(*inputs[shape], shape))
        for cut in ["none"] + [c for c in libs if c != "none"]:
            cuda_build._LIBS["linesum"] = libs[cut][0] if cut in libs else default
            try:
                fn = full_replay(launches)
                got = fn()
                torch.cuda.synchronize()
                d = hashlib.sha1(got.cpu().numpy().tobytes()).hexdigest()[:16]
                del got
                dms, per = _launch_device_ms(fn, n=3)
                cs.emit("probe", kernel=name, case=case, cut=cut, ms=cs.cuda_ms(fn, n=3, warmup=1),
                        device_ms=dms, traced_launches=per, digest=d,
                        digest_matches_wrapper=d == digest,
                        ptxas={str(k): v for k, v in libs[cut][1].items()} if cut in libs else {},
                        sass_loops={str(k): v for k, v in libs[cut][2].items()}
                        if cut in libs else {})
            finally:
                cuda_build._LIBS["linesum"] = default
        if plans:
            for over in FULL_PLAN_VARIANTS.get(shape, []):
                fn = full_replay([dict(a, window=over) for a in launches])
                cs.emit("probe", kernel=name, case=case, cut="plan", window=over,
                        device_ms=_launch_device_ms(fn, n=3)[0])
        c = np.asarray(plan.windows(), np.int64)[:, 1]
        order = np.argsort(-c, kind="stable")
        k = max(1, len(order) // 100)
        dense = torch.as_tensor(np.sort(order[:k]), device=dev)
        rest = torch.as_tensor(np.sort(order[k:]), device=dev)
        for tag, rows in (("densest_1pct", dense), ("other_99pct", rest)):
            fn = full_replay(_only_rows(launches, rows))
            cs.emit("probe", kernel=name, case=case, cut=tag,
                    device_ms=_launch_device_ms(fn, n=3)[0])
        del launches
        torch.cuda.empty_cache()
    # the gathered call's peak memory, and the entry points
    plan, co2, states = inputs["voigt"]
    peaks = {}
    for route in ("lane", "gathered"):
        kern = lc.sigma_lane if route == "lane" else lc.sigma_gathered
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        out = kern(plan, co2, *states)
        torch.cuda.synchronize()
        peaks[route] = dict(peak_bytes=torch.cuda.max_memory_allocated(dev) - before,
                            out_bytes=out.numel() * out.element_size())
        del out
    cs.emit("probe", part="memory", states=int(states[0].shape[0]), **peaks)
    Pe = ct.pressuregrid(cs.PT, cs.PS, cs.N_LEVELS)
    Te = cs.column(Pe)
    nu = np.linspace(*cs.MIX_NU, cs.N_NU_MAIN)
    calls = {f"outgoing_{r}": (lambda g=ct.DirectGas.from_lines(co2, cs.MIX_CO2, nu, strategy=r):
                               ct.outgoing(Pe, cs.G, Te, cs.MU, g)) for r in ("lane", "gathered")}
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    cs.phase_profile(calls)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--step0", action="store_true",
                    help="also the densest blocks, the ptxas report and the SASS")
    ap.add_argument("--root", default=None, help="import clearsky_tpu_torch from this tree")
    ap.add_argument("--out", default="build/k1_probe",
                    help="with --step0 or --cuts: where the ptxas report, SASS and cuts go")
    ap.add_argument("--window", action="store_true",
                    help="the region-1 window modes where the main path runs them")
    ap.add_argument("--cuts", nargs="?", const="all", default=None,
                    help="with --window: also the cut builds (all, or a comma list of names)")
    ap.add_argument("--plans", action="store_true",
                    help="with --window or --full: also other launch plans of the window kernel")
    ap.add_argument("--calls", action="store_true",
                    help="profile the entry-point calls that run the window modes")
    ap.add_argument("--errors", nargs="?", const="", default=None,
                    help="FARALL's error on the mix's sample, built whole (and the cuts of a "
                         "comma list)")
    ap.add_argument("--routes", action="store_true",
                    help="each state's error of the stencil and coarse routes, whole and no_core")
    ap.add_argument("--fine", action="store_true",
                    help="K1's FINE mode where the main path runs it (with --cuts: cut builds)")
    ap.add_argument("--full", action="store_true",
                    help="K4 and K5 where the lane and gathered routes run them (with --cuts: "
                         "cut builds)")
    ap.add_argument("--no-pairs", action="store_true",
                    help="with --full: skip counting the work on the data")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    global cs
    import chip_smoke as cs                  # this checkout's, before TREE's

    sys.path.insert(0, os.path.abspath(args.root) if args.root else ROOT)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    if args.errors is not None:
        farall_errors(args.seed, dev, os.path.join(args.out, "errors"),
                      [c for c in args.errors.split(",") if c])
    elif args.routes:
        route_errors(args.seed, dev, os.path.join(args.out, "routes"))
    elif args.full:
        cuts = args.cuts == "all" or (args.cuts.split(",") if args.cuts else False)
        full_probe(args.seed, dev, cuts,
                   os.path.join(args.out, "full_root" if args.root else "full_self"),
                   not args.no_pairs, args.plans)
    elif args.fine:
        cuts = args.cuts == "all" or (args.cuts.split(",") if args.cuts else False)
        fine_probe(args.seed, dev, cuts,
                   os.path.join(args.out, "fine_root" if args.root else "fine_self"))
    elif args.calls:
        calls = window_calls(args.seed, dev)
        for fn in calls.values():           # set-up, library loads, caches
            fn()
        torch.cuda.synchronize()
        cs.phase_profile(calls)
    elif args.window:
        cuts = args.cuts == "all" or (args.cuts.split(",") if args.cuts else False)
        window_probe(args.seed, dev, cuts,
                     os.path.join(args.out, "root" if args.root else "self"), args.plans)
    else:
        k1_probe(args.seed, dev, args.step0, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

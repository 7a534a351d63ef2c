"""K1's probe: every instance of the line-sum kernel K1 timed alone at
chip_smoke.py's shapes, and the profile of three ``outgoing`` calls (the
mix, config 2 on its auto and on its grouped route), so that two versions
of the port compare inside one run on the card.

    python3 clearsky_tpu_torch/tools/k1_probe.py [--step0] [--root TREE]

Each instance is timed with CUDA events (median of 5) and printed as one
``probe`` line with its window statistics (lines per grid block: max, mean,
99th percentile, the share in the densest 1% of blocks); each call's
``profile`` line is chip_smoke.py's: wall and device ms a call, device ops,
each kernel's share and the idle share. ``--root TREE`` imports
``clearsky_tpu_torch`` from TREE (another checkout, e.g. the parent commit
unpacked under ``build/``) and builds its kernels there; the shapes and
helpers are this checkout's chip_smoke.py. ``--step0`` adds each windowed
launch cut to its densest 1% of blocks and to the rest, and writes the
ptxas report and the SASS of TREE's ``csrc/linesum.cu`` under ``--out``.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import os
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
        launch()
        torch.cuda.synchronize()
        cs.emit("probe", kernel=name, ms=cs.cuda_ms(launch, n=5), **stats)
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--step0", action="store_true",
                    help="also the densest blocks, the ptxas report and the SASS")
    ap.add_argument("--root", default=None, help="import clearsky_tpu_torch from this tree")
    ap.add_argument("--out", default="build/k1_probe",
                    help="with --step0: where the ptxas report and SASS go")
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
    k1_probe(args.seed, dev, args.step0, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""sweep: a batch of columns of one radiative-convective model at seeded
insolation factors and start temperatures, advanced a refresh period at a
time by ``run_sweep``, synchronising at each period's end.

The configuration gives the model (``atmosphere`` with ``T_surf``, ``rcm``:
``cs``, ``radmul``, ``dt_s``, ``period``; ``insolation``: ``orbit`` and
``scale``); the traffic file gives ``columns``, ``T0_scale`` and
``T0_jitter_K`` (the template's cell temperatures scaled across the batch,
a seeded jitter, a seeded order), ``trace_seconds`` and ``check``:
``columns`` (one at a seeded place in each equal stratum of the batch) and
the ``limits`` of ``dT_start_rel`` and ``dT_last_rel``.
"""

import time

import numpy as np
import torch

from csbench import catalog, inputs, system
from csbench.reference import rcm as ref_rcm
from csbench.workload import (Profiler, Run, device_info, free, linesum_work, period_error,
                              stellar, sync, tables, window)


def _inputs(params, seed):
    """The cell's inputs: catalogs, grid, levels and the template's edge
    temperatures, the stellar flux, the columns' insolation factors and
    start temperatures [columns, cells], and the checked columns."""
    atm, chk = params["atmosphere"], params["check"]
    pars, tab = tables(params)
    grid = inputs.line_grid(catalog.line_table(*pars[0])["nu"], params["points"], params["cut"])
    Pe = inputs.pressure_levels(atm["P_top"], atm["P_surf"], atm["levels"])
    Te = inputs.dry_adiabat(Pe, atm["T_surf"], atm["P_surf"], atm["mu"], atm["cp"],
                            atm["T_floor"])
    nb = params["columns"]
    ins = params["insolation"]
    _, Tc = ref_rcm.cells(Pe, Te)
    g = inputs.rng(seed, 4)
    lo, hi = params["T0_scale"]
    T0 = Tc[None, :] * np.linspace(lo, hi, nb)[:, None] \
        + g.uniform(-1.0, 1.0, (nb, len(Tc))) * params["T0_jitter_K"]
    g.shuffle(T0)
    edges = np.linspace(0, nb, chk["columns"] + 1).astype(np.int64)
    cols = np.unique(edges[:-1] + (inputs.rng(seed, 5).uniform(0, 1, chk["columns"])
                                   * np.maximum(np.diff(edges), 1)).astype(np.int64))
    return dict(pars=pars, tab=tab, grid=grid, Pe=Pe, Te=Te, S0=stellar(params, grid),
                factors=ins["scale"] * inputs.annual_flux_factors(*ins["orbit"], nb), T0=T0,
                cols=cols)


def _reference(cell, x, T0, T_prev, dev, dtype):
    """The reference's temperatures of the checked columns after the first
    period from T0 on the template's cache, and after the last from the
    program's T_prev on a cache at T_prev's edge temperatures."""
    params = cell["params"]
    atm, r = params["atmosphere"], params["rcm"]
    m = ref_rcm.Model(cell["plugins"]["absorber"].reference(x["tab"], params), x["grid"], x["Pe"],
                      g=atm["g"], mu=atm["mu"], cp=atm["cp"], cs=r["cs"],
                      S_nu=np.full(len(x["grid"]), x["S0"]), albedo=atm["albedo"],
                      theta_s=params["star"]["zenith"], radmul=r["radmul"],
                      nstream=params.get("nstream", 5), nlobatto=2, dtype=dtype, device=dev)
    factors = x["factors"][x["cols"]]
    C = T0.shape[0]
    ls0 = ref_rcm.edge_ln_sigma(m, np.asarray(x["Te"])[None]).expand(C, -1, -1)
    first = ref_rcm.run_steps(m, T0, ls0, factors, r["dt_s"], r["period"], 1)
    ls1 = ref_rcm.edge_ln_sigma(m, ref_rcm.edge_temperatures(m, T_prev))
    last = ref_rcm.run_steps(m, T_prev, ls1, factors, r["dt_s"], r["period"], 1)
    return first.double(), last.double()


def run(cell, seed, seconds, trace, dev, t_start):
    params, plugins = cell["params"], cell["plugins"]
    atm, r = params["atmosphere"], params["rcm"]
    x = _inputs(params, seed)
    grid, Pe, T0, cols, nb = x["grid"], x["Pe"], x["T0"], x["cols"], params["columns"]

    absorber = plugins["absorber"].program(x["pars"], grid, dev, params)
    model = system.rcm(Pe, x["Te"], atm["g"], atm["mu"], lambda v: torch.full_like(v, x["S0"]),
                       atm["albedo"], atm["cp"], r["cs"], absorber, r["radmul"])
    f_dev = torch.as_tensor(x["factors"], dtype=torch.float32, device=dev)
    T = torch.as_tensor(T0, dtype=torch.float32, device=dev)
    period = lambda T, A: system.sweep_period(model, f_dev, r["dt_s"], r["period"], T, A,
                                              atm["cp"], atm["mu"])
    # set-up: the first period from the start temperatures (the check's
    # start), then one more from the refreshed cache (the window's path)
    T1, A = period(T, None)
    T_start = T1[cols].double().cpu()
    T, A = period(T1, A)
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start

    state = {"T": T, "A": A, "prev": T}

    def step(i):
        state["prev"] = state["T"]
        state["T"], state["A"] = period(state["T"], state["A"])
        sync(dev)

    prof = Profiler(trace, params.get("trace_seconds", seconds))
    walls, length = window(seconds, step, prof)
    steps = r["period"]
    if prof.record is not None:
        prof.record.units *= steps
    T_fin = state["T"]
    result = Run(params=params, kind="sweep", setup_s=setup_s, window_s=length, unit_s=walls,
                 units=len(walls) * steps, attempted=len(walls),
                 failed=int((~torch.isfinite(T_fin).all(dim=1)).sum()), device=device_info(dev),
                 trace=prof.record)
    # the refresh evaluates the line sum at every column's edges once a period
    ls = linesum_work(x["tab"], grid, params["cut"], nb * atm["levels"] / steps)
    result.work = {"columns": nb, "linesum_triples_per_step": ls["triples"],
                   "linesum_bytes_per_step": ls["bytes"]}
    T_prev = state["prev"][cols].double().cpu()
    T_last = T_fin[cols].double().cpu()
    del state, model, absorber, A, T, T1, period, step
    free(dev)

    t_check = time.perf_counter()
    ref_start, ref_last = _reference(cell, x, T0[cols], T_prev, dev, torch.float64)
    result.checks = {"dT_start_rel": period_error(T_start, ref_start, T0[cols]),
                     "dT_last_rel": period_error(T_last, ref_last, T_prev)}
    result.check_s = time.perf_counter() - t_check
    return result


def control(cell, seed, dev, dtype):
    """The check's numbers with the reference computed in ``dtype`` in the
    program's place: the checked columns through their first period (for
    both numbers, from the start temperatures), against the reference in
    float64."""
    x = _inputs(cell["params"], seed)
    T0c = torch.as_tensor(x["T0"][x["cols"]])
    ref = _reference(cell, x, T0c, T0c, dev, torch.float64)
    low = _reference(cell, x, T0c, T0c, dev, dtype)
    return {"dT_start_rel": period_error(low[0], ref[0], T0c),
            "dT_last_rel": period_error(low[1], ref[1], T0c)}

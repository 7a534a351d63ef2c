"""column_calls: a closed loop of one client. Each call is a new column (a
dry adiabat from a surface temperature of its own) through ``radiate`` on
the cell's core (``cores/<core>.py``) and absorber (``absorbers/<name>.py``);
the call ends when its band fluxes reach the host.

The traffic file gives ``points`` (the grid over the first gas's lines +-
the cut), ``core``, ``surface_T`` ([lo, hi] K), ``trace_seconds`` and
``check``: ``calls`` (how many window calls are judged, drawn from the seed
among the window's first ``CHECK_FROM_FIRST``), ``points`` (sampled
wavenumbers) and the ``limits`` of ``M_of_peak`` and ``F_vs_own_spectra``.
"""

import time

import numpy as np
import torch

from csbench import catalog, inputs, system
from csbench.workload import (Profiler, Run, device_info, free, linesum_work, m_of_peak,
                              stellar, sync, tables, window)

# set-up runs the first columns of the run's sequence: the calls that build
# every kernel and plan, then as many packs kept alive as the window keeps
# (the checked calls' and the last), so that the allocator allocates
# nothing in the window; the window's columns start after them
WARM_CALLS = 2
WINDOW_FROM = 16
CHECK_FROM_FIRST = 48


def validate(params):
    if params["check"]["calls"] + WARM_CALLS + 1 > WINDOW_FROM:
        raise ValueError(f"set-up's columns would reach the window's ({WINDOW_FROM})")
    if params["check"]["calls"] > CHECK_FROM_FIRST:
        raise ValueError(f"at most {CHECK_FROM_FIRST} checked calls")


def _inputs(params, seed):
    """The cell's inputs: catalogs, grid, levels, the k-th column of the
    run's sequence, the stellar flux, the window calls the check reads and
    the grid points it compares."""
    atm, chk = params["atmosphere"], params["check"]
    pars, tab = tables(params)
    grid = inputs.line_grid(catalog.line_table(*pars[0])["nu"], params["points"], params["cut"])
    Pe = inputs.pressure_levels(atm["P_top"], atm["P_surf"], atm["levels"])

    def column(k):
        Ts = inputs.surface_temperature(seed, k, *params["surface_T"])
        return inputs.dry_adiabat(Pe, Ts, atm["P_surf"], atm["mu"], atm["cp"], atm["T_floor"])

    checked = sorted(inputs.rng(seed, 3).permutation(CHECK_FROM_FIRST)[:chk["calls"]].tolist())
    return dict(pars=pars, tab=tab, grid=grid, Pe=Pe, column=column, S0=stellar(params, grid),
                checked=checked, idx=inputs.sample_points(seed, grid, chk["points"]))


def _band(M_up, M_dn, integrate):
    """F_up, F_down, F_net [3, levels] from the spectra by ``integrate``."""
    F = torch.stack([integrate(M_up), integrate(M_dn)])
    return torch.cat([F, (F[0] - F[1])[None]])


def _reference(cell, x, cols, dev, dtype, count_work=False):
    params, plugins = cell["params"], cell["plugins"]
    sigma = plugins["absorber"].reference(x["tab"], params)
    Te = np.stack([x["column"](k) for k in cols])
    return plugins["core"].reference(params, sigma, x["Pe"], Te, x["grid"], x["idx"], x["S0"],
                                     dev, dtype, count_work)


def run(cell, seed, seconds, trace, dev, t_start):
    params, plugins = cell["params"], cell["plugins"]
    atm = params["atmosphere"]
    x = _inputs(params, seed)
    grid, Pe, S0, column = x["grid"], x["Pe"], x["S0"], x["column"]
    checked = set(x["checked"])

    absorber = plugins["absorber"].program(x["pars"], grid, dev, params)
    flux_core = system.core(params["core"])
    fS = lambda v: torch.full_like(v, S0)

    def call(k):
        F = system.radiate(Pe, atm["g"], column(k), atm["mu"], fS, atm["albedo"], absorber,
                           flux_core)
        return F, torch.stack([F.F_up, F.F_down, F.F_net]).cpu()

    alive = [call(k)[0] for k in range(WARM_CALLS + len(checked) + 1)]
    sync(dev)
    del alive
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start

    kept, last, failed = {}, {}, [0]

    def step(i):
        F, host = call(WINDOW_FROM + i)
        if not bool(torch.isfinite(host).all()):
            failed[0] += 1
        if i in checked:
            kept[i] = (F.M_up, F.M_down, host)
        last.clear()
        last[i] = (F.M_up, F.M_down, host)

    prof = Profiler(trace, params.get("trace_seconds", seconds))
    walls, length = window(seconds, step, prof)
    result = Run(params=params, kind="column_calls", setup_s=setup_s, window_s=length,
                 unit_s=walls, units=len(walls), attempted=len(walls), failed=failed[0],
                 device=device_info(dev), trace=prof.record)
    if not kept:   # a window shorter than the checked calls: its last call stands in
        kept.update(last)
    last.clear()
    # the judge's inputs: the spectra at the sampled points, and each call's
    # band fluxes against the float64 integral of its own spectra
    nu64 = torch.as_tensor(grid, dtype=torch.float64, device=dev)
    ids = sorted(kept)
    got_up, got_dn, own = [], [], 0.0
    for i in ids:
        M_up, M_dn, host = kept[i]
        F_t = _band(M_up, M_dn, lambda M: torch.trapezoid(M.double(), nu64, dim=-1)).cpu()
        own = max(own, float((host.double() - F_t).abs().max() / F_t.abs().max()))
        sel = torch.as_tensor(x["idx"], device=M_up.device)
        got_up.append(M_up[:, sel].double().cpu())
        got_dn.append(M_dn[:, sel].double().cpu())
    del kept, absorber, call, step
    free(dev)

    t_check = time.perf_counter()
    ref_up, ref_dn, work = _reference(cell, x, [WINDOW_FROM + i for i in ids], dev,
                                      torch.float64, count_work=trace)
    result.checks = {"M_of_peak": m_of_peak([(torch.stack(got_up), ref_up),
                                             (torch.stack(got_dn), ref_dn)]),
                     "F_vs_own_spectra": own}
    result.check_s = time.perf_counter() - t_check
    states = plugins["core"].linesum_states(params)
    ls = linesum_work(x["tab"], grid, params["cut"], states)
    result.work = dict(work, linesum_triples_per_call=ls["triples"],
                       linesum_bytes_per_call=ls["bytes"], linesum_states=states)
    return result


def control(cell, seed, dev, dtype):
    """The check's numbers with the reference computed in ``dtype`` in the
    program's place, on the columns and points a run of ``seed`` checks,
    against the reference in float64; and the band fluxes of the program's
    own spectra of those columns integrated in ``dtype`` (on the grid's
    uniform spacing) against their float64 integral."""
    params, plugins = cell["params"], cell["plugins"]
    atm = params["atmosphere"]
    x = _inputs(params, seed)
    cols = [WINDOW_FROM + i for i in x["checked"]]
    ref = _reference(cell, x, cols, dev, torch.float64)
    low = _reference(cell, x, cols, dev, dtype)
    spectra = m_of_peak([(low[0], ref[0]), (low[1], ref[1])])
    absorber = plugins["absorber"].program(x["pars"], x["grid"], dev, params)
    flux_core = system.core(params["core"])
    nu64 = torch.as_tensor(x["grid"], dtype=torch.float64, device=dev)
    dx = float(x["grid"][1] - x["grid"][0])
    band = 0.0
    for k in cols:
        F = system.radiate(x["Pe"], atm["g"], x["column"](k), atm["mu"],
                           lambda v: torch.full_like(v, x["S0"]), atm["albedo"], absorber,
                           flux_core)
        want = _band(F.M_up, F.M_down, lambda M: torch.trapezoid(M.double(), nu64, dim=-1))
        got = _band(F.M_up, F.M_down,
                    lambda M: torch.trapezoid(M.to(dtype), dx=dx, dim=-1).double())
        band = max(band, float((got - want).abs().max() / want.abs().max()))
    return {"M_of_peak": spectra, "F_vs_own_spectra": band}

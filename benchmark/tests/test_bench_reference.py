"""The plain reference against the program's CPU path at a tiny size, in
float64: the line sum, the grid-refined and adaptive cores' fluxes, and a
sweep's refresh period. The only file that runs both."""

import math

import numpy as np
import pytest
import torch

import clearsky_tpu_torch as ct
from csbench import catalog, inputs
from csbench.reference import flux, linesum, rcm

F64 = dict(dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module")
def co2():
    par = catalog.make_par(2, 300, 5)
    return par, ct.SpectralLines.from_par_dict(par, **F64), catalog.line_table(par, 0.95)


def _column(n_levels=7, Ts=290.0):
    Pe = inputs.pressure_levels(10.0, 1e5, n_levels)
    return Pe, inputs.dry_adiabat(Pe, Ts, 1e5, 0.044, 850.0, 160.0)


def test_line_sum(co2):
    par, lines, tab = co2
    nu = np.linspace(550.0, 800.0, 2000)
    gas = ct.DirectGas.from_lines(lines, 0.95, nu)
    T = torch.tensor([180.0, 250.0, 310.0], dtype=torch.float64)
    P = torch.tensor([10.0, 2e3, 1e5], dtype=torch.float64)
    want = gas(T, P)
    got = linesum.sigma_at(tab, nu, T, P)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-13


@pytest.mark.parametrize("refine", [1, 3])
def test_refined_core(co2, refine):
    par, lines, tab = co2
    nu = np.linspace(600.0, 720.0, 600)
    gas = ct.DirectGas.from_lines(lines, 0.95, nu)
    Pe, Te = _column()
    F = ct.radiate(Pe, 9.8, Te, 0.044, lambda v: torch.full_like(v, 4.0), 0.1, gas,
                   core=ct.RadauEq(refine=refine))
    idx = np.arange(0, 600, 7)
    up, dn = flux.refined_fluxes(linesum.line_sum(tab), Pe, Te[None], nu[idx], g=9.8, mu=0.044,
                                 S_nu=torch.full((len(idx),), 4.0, **F64), albedo=0.1,
                                 theta_s=0.841, nstream=5, nlobatto=3, refine=refine)
    for got, want in ((up[0], F.M_up[:, idx]), (dn[0], F.M_down[:, idx])):
        assert float((got - want).abs().max() / want.abs().max()) < 1e-12


def test_adaptive_core(co2):
    par, lines, tab = co2
    nu = np.linspace(640.0, 700.0, 96)
    gas = ct.DirectGas.from_lines(lines, 0.95, nu)
    Pe, Te = _column(5)
    F = ct.radiate(Pe, 9.8, Te, 0.044, lambda v: torch.full_like(v, 4.0), 0.1, gas,
                   core=ct.Radau(tol=1e-6, nlevels=24))
    idx = np.arange(0, 96, 5)
    cache = flux.radau_cache(linesum.line_sum(tab), Pe, Te[None], nu[idx], mu=0.044, nlevels=24)
    up, dn, lanes = flux.radau_fluxes(cache, Pe, g=9.8, S_nu=torch.full((len(idx),), 4.0, **F64),
                                      albedo=0.1, theta_s=0.841, nstream=5, n_sub=16)
    # the program integrates to 1e-6; the reference on fixed sub-steps far finer
    for got, want in ((up[0], F.M_up[:, idx]), (dn[0], F.M_down[:, idx])):
        assert float((got - want).abs().max() / want.abs().max()) < 5e-6
    steps = flux.radau_steps(cache, Pe, lanes, g=9.8, nstream=5, tol=1e-5,
                             B_peak=torch.tensor([0.2], **F64))
    assert steps["emission"] > 2 * 5 * len(idx) * (len(Pe) - 1) and steps["depth"] > 0


def test_sweep_period():
    pars = (catalog.make_par(2, 200, 5), catalog.make_par(1, 100, 12))
    co2, h2o = (ct.SpectralLines.from_par_dict(p, **F64) for p in pars)
    nu = inputs.line_grid(co2.positions64(), 256, 25.0)
    mg = ct.MultiGas.from_lines([(co2, 0.9), (h2o, 0.005)], nu)
    Pe = inputs.pressure_levels(10.0, 1e5, 7)
    Te = inputs.dry_adiabat(Pe, 255.0, 1e5, 0.044, 850.0, 150.0)
    S0 = 340.0 / math.cos(0.841) / (nu[-1] - nu[0])
    model = ct.RCM.create(Pe, Te, 9.8, lambda T, P: 0.044, lambda v: torch.full_like(v, S0), 0.1,
                          lambda T, P: 850.0, 1e6, mg)
    f = np.array([0.7, 1.0, 1.4])
    T0 = model.T[None] * torch.tensor([0.99, 1.0, 1.01], **F64)[:, None]
    T1, A1 = ct.run_sweep(model, f, 900.0, 4, T0_b=T0, update_every=4, adjust_every=1,
                          cp=850.0, mu=0.044)
    T2, _ = ct.run_sweep(model, f, 900.0, 4, T0_b=T1, A0_b=A1, update_every=4, adjust_every=1,
                         cp=850.0, mu=0.044)
    tab = catalog.merge_tables([catalog.line_table(pars[0], 0.9),
                                catalog.line_table(pars[1], 0.005)])
    m = rcm.Model(linesum.line_sum(tab), nu, Pe, g=9.8, mu=0.044, cp=850.0, cs=1e6, S_nu=np.full(len(nu), S0),
                  albedo=0.1, theta_s=0.841, radmul=2, nstream=5, nlobatto=2)
    first = rcm.run_steps(m, T0, rcm.edge_ln_sigma(m, np.repeat(Te[None], 3, 0)), f, 900.0, 4, 1)
    last = rcm.run_steps(m, T1, rcm.edge_ln_sigma(m, rcm.edge_temperatures(m, T1)), f, 900.0,
                         4, 1)
    assert float((first - T1).abs().max()) < 1e-9 and float((last - T2).abs().max()) < 1e-9

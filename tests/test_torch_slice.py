"""The port's main path as a whole against the JAX package.

One clear-sky column: a synthetic 400-line CO2 catalog, 4096 points, 9
levels. The same numpy inputs go through ``clearsky_tpu`` (CPU, float64)
and ``clearsky_tpu_torch`` (CPU, float64, the plain versions of the
kernels): ``outgoing`` (OLR spectrum and band OLR), ``radiate`` (F_up,
F_down, F_net) and, on 1024 of the points, ``RCM.create`` followed by two
rounds of (``update_absorber``, ``step``). The arithmetic is the same, so
the bar is 1e-9. The gray analytic OLR (conftest.gray_analytic_olr) holds
within 1%.
"""

import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from clearsky_tpu.spectra.lines import SpectralLines as JLines
from clearsky_tpu.absorption.gas import DirectGas as JDirectGas
from clearsky_tpu.rt import fluxes as jf
from clearsky_tpu.models import rcm as jr
from clearsky_tpu.utils.grids import pressuregrid, logrange, trapz as jtrapz
import clearsky_tpu_torch as ct
from clearsky_tpu_torch import convert
from clearsky_tpu_torch.constants import R_GAS, SIGMA_SB
from clearsky_tpu_torch.rt.fluxes import Radau, RadauEq
from clearsky_tpu_torch.ops.linesum_cuda import sigma_lines
from clearsky_tpu_torch.rt.march_cuda import olr_march, monoflux_march

# the suite runs in several worker processes: a torch thread pool of every
# core in each of them oversubscribes the machine
torch.set_num_threads(2)

G, MU, CP, PS, PT = 9.8, 0.044, 850.0, 1e5, 10.0
S0 = 340.0 / math.cos(0.841)


def _column(n_nu):
    par = ct.synthetic_co2_par(400, seed=5)
    jl = JLines.from_par_dict(par)
    nu = np.linspace(560.0, 790.0, n_nu)
    jg = JDirectGas.from_lines(jl, 0.95, nu)
    tg = convert.direct_gas(jg, 0.95, dtype=torch.float64, device="cpu")
    Pe = pressuregrid(PT, PS, 9)
    Te = np.maximum(288.0 * (Pe / PS) ** (R_GAS / (MU * CP)), 160.0)
    span = float(nu[-1] - nu[0])
    return dict(nu=nu, jg=jg, tg=tg, Pe=Pe, Te=Te,
                fS_j=lambda v: jnp.full(jnp.shape(v), S0 / span),
                fS_t=lambda v: torch.full_like(v, S0 / span))


@pytest.fixture(scope="module")
def col():
    return _column(4096)


def test_outgoing_matches(col):
    before = (sigma_lines.launches, olr_march.launches, monoflux_march.launches)
    out = ct.outgoing(col["Pe"], G, col["Te"], MU, col["tg"])
    # on CPU tensors the kernel wrappers take their plain versions
    assert (sigma_lines.launches, olr_march.launches, monoflux_march.launches) == before
    ref = np.asarray(jf.outgoing(col["Pe"], G, col["Te"], MU, col["jg"]))
    assert out.shape == ref.shape == (4096,)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-9)
    band = float(ct.trapz(col["tg"].nu, out))
    assert band == pytest.approx(float(jtrapz(col["nu"], ref)), rel=1e-9)
    assert 0.0 < band < SIGMA_SB * col["Te"][-1] ** 4


def test_radiate_matches(col):
    F = ct.radiate(col["Pe"], G, col["Te"], MU, col["fS_t"], 0.1, col["tg"])
    R = jf.radiate(col["Pe"], G, col["Te"], MU, col["fS_j"], 0.1, col["jg"])
    for k in ("F_up", "F_down", "F_net", "M_up", "M_down", "tau"):
        a, b = getattr(F, k).numpy(), np.asarray(getattr(R, k))
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9 * np.abs(b).max(), err_msg=k)
    # fluxes and net_fluxes are radiate's F_up, F_down and F_net (a gray
    # column keeps the two extra calls cheap)
    gray = ct.GrayGas.create(1e-27, col["nu"], dtype=torch.float64, device="cpu")
    Fg = ct.radiate(col["Pe"], G, col["Te"], MU, col["fS_t"], 0.1, gray)
    up, dn = ct.fluxes(col["Pe"], G, col["Te"], MU, col["fS_t"], 0.1, gray)
    np.testing.assert_array_equal(up.numpy(), Fg.F_up.numpy())
    np.testing.assert_array_equal(dn.numpy(), Fg.F_down.numpy())
    np.testing.assert_array_equal(
        ct.net_fluxes(col["Pe"], G, col["Te"], MU, col["fS_t"], 0.1, gray).numpy(),
        Fg.F_net.numpy())


def test_rcm_steps_match():
    col = _column(1024)
    fmu = lambda T, P: MU
    fcp = lambda T, P: CP
    rj = jr.RCM.create(col["Pe"], col["Te"], G, fmu, col["fS_j"], 0.1, fcp, 1e7,
                       col["jg"], radmul=2)
    rt = ct.RCM.create(col["Pe"], col["Te"], G, fmu, col["fS_t"], 0.1, fcp, 1e7,
                       col["tg"], radmul=2)
    for f in ("Pe", "P", "T", "Pr"):
        np.testing.assert_array_equal(getattr(rt, f).numpy(), np.asarray(getattr(rj, f)))
    T0 = np.asarray(rj.T)
    for _ in range(2):
        rj = jr.step(jr.update_absorber(rj), 3600.0)
        rt = ct.step(ct.update_absorber(rt), 3600.0)
    Tj = np.asarray(rj.T)
    assert np.abs(Tj - T0).max() > 1e-3
    np.testing.assert_allclose(rt.T.numpy(), Tj, rtol=1e-9)
    np.testing.assert_allclose(rt.A.ln_sigma.numpy(), np.asarray(rj.A.ln_sigma), rtol=1e-9)
    # the converted JAX state radiates as the JAX model does
    rc = convert.rcm(rj, col["tg"])
    Hj = np.asarray(jr.heating(rj))
    np.testing.assert_allclose(ct.heating(rc).numpy(), Hj, rtol=1e-9,
                               atol=1e-9 * np.abs(Hj).max())


@pytest.mark.parametrize("sigma", [1e-29, 1e-26, 1e-24])
def test_gray_olr_vs_analytic(sigma):
    from conftest import gray_analytic_olr

    g, mu, cp, ps, ts = 10.0, 0.01, 1e3, 1e5, 300.0
    nu = np.concatenate([logrange(1e-6, 1e5, 10000, 4), [1e6]])
    gas = ct.GrayGas.create(sigma, nu, dtype=torch.float64, device="cpu")
    fT = lambda P: ts * (P / ps) ** (R_GAS / (mu * cp))
    olr_nu = ct.outgoing(ps, g, fT, lambda T, P: mu, gas, Ptop=1e-6, nlobatto=3,
                         nlevels=256, vertical=True)
    olr = float(ct.trapz(gas.nu, olr_nu))
    ref = gray_analytic_olr(sigma, g, mu, cp, ps, ts)
    assert abs(olr - ref) / ref < 0.01


def test_transparent_olr_is_sigma_t4():
    nu = np.concatenate([logrange(1e-6, 1e5, 10000, 4), [1e6]])
    gas = ct.GrayGas.create(1e-35, nu, dtype=torch.float64, device="cpu")
    olr = float(ct.trapz(gas.nu, ct.outgoing(np.array([1.0, 1e3, 1e5]), G, 290.0, MU, gas)))
    assert olr == pytest.approx(SIGMA_SB * 290.0**4, rel=1e-4)


@pytest.mark.parametrize("core", [Radau(), RadauEq()])
def test_unported_cores_raise(col, core):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ct.outgoing(col["Pe"], G, col["Te"], MU, col["tg"], core=core)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ct.radiate(col["Pe"], G, col["Te"], MU, 0.0, 0.1, col["tg"], core=core)


def test_input_guards(col):
    with pytest.raises(ValueError):
        ct.radiate(col["Pe"][::-1], G, col["Te"], MU, 0.0, 0.1, col["tg"])
    with pytest.raises(ValueError):
        ct.DirectGas.from_lines(col["tg"].lines, 0.95, col["nu"][::-1])
    with pytest.raises(ValueError):
        ct.DirectGas.from_lines(col["tg"].lines, 1.5, col["nu"])
    with pytest.raises(NotImplementedError):
        ct.AbsorberStack.create(col["tg"], type("CIATables", (), {"__call__": None})())


def test_gray_radiate_top_flux_is_the_beam():
    nu = np.linspace(1.0, 3000.0, 256)
    gas = ct.GrayGas.create(1e-27, nu, dtype=torch.float64, device="cpu")
    P = np.geomspace(10.0, PS, 24)
    fT = lambda P_: 300.0 * (P_ / PS) ** (R_GAS / (0.01 * 1e3))
    fS = lambda v: torch.full_like(v, 340.0 / 3000.0)
    F = ct.radiate(P, G, fT, 0.01, fS, 0.3, gas)
    assert float(F.F_down[0]) == pytest.approx(340.0 * (2999.0 / 3000.0) * math.cos(0.841),
                                               rel=1e-6)
    up0 = ct.radiate(P, G, fT, 0.01, fS, 0.0, gas).F_up[0]
    assert float(F.F_up[0]) > float(up0)

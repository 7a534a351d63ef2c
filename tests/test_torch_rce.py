"""The port's column model run to radiative-convective equilibrium, and the
modules under it, against the JAX package.

``heating`` at given temperatures and absorbers, ``step_n``, ``run`` with
its cadences of absorber refresh and convective adjustment and its records,
``convective_adjustment``, ``radiate_state``; the adiabats (``lapse``,
``DryAdiabat``, ``MoistAdiabat``, ``tropopause``,
``pressure_of_temperature``), hydrostatics, saturation curves, the host
root finders and ODE integrator, and the grid helpers. The same numpy
inputs go to both packages, float64 on the CPU. The arithmetic is the same,
so the bar is 1e-12 (host code, scalar loops) and 1e-9 where a column
radiates (the JAX package's summation orders in its line sum and march).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from clearsky_tpu.absorption.gas import DirectGas as JDirectGas, GrayGas as JGrayGas
from clearsky_tpu.atmosphere import adiabats as ja
from clearsky_tpu.atmosphere import hydrostatics as jh
from clearsky_tpu.atmosphere import saturation as jsat
from clearsky_tpu.models import rcm as jr
from clearsky_tpu.spectra.lines import SpectralLines as JLines
from clearsky_tpu.utils import grids as jgrids
from clearsky_tpu.utils import ode as jode
from clearsky_tpu.utils import rootfind as jroot
import clearsky_tpu_torch as ct
from clearsky_tpu_torch import convert
from clearsky_tpu_torch.constants import R_GAS
from clearsky_tpu_torch.utils import grids as tgrids
from clearsky_tpu_torch.utils import ode as tode
from clearsky_tpu_torch.utils import rootfind as troot

torch.set_num_threads(2)

G, MU, CP, PS, PT = 9.8, 0.044, 850.0, 1e5, 10.0
CPU64 = dict(dtype=torch.float64, device="cpu")


def _t(x):
    return torch.tensor(np.asarray(x, np.float64))


# --- host utilities and grids ----------------------------------------------------

def test_root_finders_match_jax():
    f = lambda x, p: x**3 - 2.0 * x - p
    for p in (1.0, 5.0):
        assert troot.regula_falsi(f, 0.0, 3.0, p) == jroot.regula_falsi(f, 0.0, 3.0, p)
        assert troot.secant(f, 1.0, 3.0, p) == jroot.secant(f, 1.0, 3.0, p)
    with pytest.raises(ValueError):
        troot.regula_falsi(f, 0.0, 0.5, 5.0)          # not bracketing
    with pytest.raises(ValueError):
        troot.secant(f, 1.0, 1.0, 1.0)


def test_rk4_matches_jax_and_the_closed_form():
    f = lambda x, y, p: -p * y
    x = np.linspace(0.0, 2.0, 21)
    got = tode.rk4_dense(f, 1.0, x, 0.7)
    np.testing.assert_array_equal(got, jode.rk4_dense(f, 1.0, x, 0.7))
    np.testing.assert_allclose(got, np.exp(-0.7 * x), rtol=1e-10)
    assert tode.rk4_to(f, 1.0, 0.0, 2.0, 0.7) == jode.rk4_to(f, 1.0, 0.0, 2.0, 0.7)


def test_grid_helpers_match_jax():
    x = np.geomspace(1.0, 50.0, 17)
    y = np.sin(x) * x
    np.testing.assert_allclose(tgrids.deriv(_t(x), _t(y)).numpy(),
                               np.asarray(jgrids.deriv(x, y)), rtol=1e-12)
    X, Y = tgrids.meshgrid(_t(x[:5]), _t(y[:3]))
    JX, JY = jgrids.meshgrid(x[:5], y[:3])
    assert X.shape == (3, 5)
    np.testing.assert_array_equal(X.numpy(), np.asarray(JX))
    np.testing.assert_array_equal(Y.numpy(), np.asarray(JY))
    P = _t(np.geomspace(1.0, 1e5, 9))
    for name in ("p2omega", "domega_fac", "p2iota", "diota_fac"):
        np.testing.assert_allclose(getattr(tgrids, name)(P).numpy(),
                                   np.asarray(getattr(jgrids, name)(P.numpy())), rtol=1e-15)
    np.testing.assert_allclose(tgrids.omega2p(tgrids.p2omega(P)).numpy(), P.numpy(), rtol=1e-14)
    np.testing.assert_allclose(tgrids.iota2p(tgrids.p2iota(P)).numpy(), P.numpy(), rtol=1e-14)


# --- adiabats, hydrostatics, saturation -------------------------------------------

ADIABATS = {
    "plain": dict(),
    "tstrat": dict(Tstrat=160.0),
    "ptropo": dict(Ptropo=1e4),
    "tstrat_no_smooth": dict(Tstrat=170.0, smooth=0.0),
}


@pytest.mark.parametrize("kind", list(ADIABATS))
def test_dry_adiabat_matches_jax(kind):
    kw = ADIABATS[kind]
    ja_ = ja.DryAdiabat.create(285.0, PS, CP, MU, **kw)
    ta = ct.DryAdiabat.create(285.0, PS, CP, MU, **kw)
    for f in ("Tstrat", "Ptropo", "T2", "h2"):
        assert getattr(ta, f) == getattr(ja_, f)
    P = np.geomspace(1.0, PS, 300)
    np.testing.assert_allclose(ta(P).numpy(), np.asarray(ja_(P)), rtol=1e-13)
    # a float32 tensor stays float32
    assert ta(torch.tensor(P, dtype=torch.float32)).dtype == torch.float32
    if kind != "plain":
        assert ct.tropopause(ta) == ja.tropopause(ja_)
    else:
        with pytest.raises(ValueError):
            ct.tropopause(ta)
    assert ct.pressure_of_temperature(ta, 200.0) == pytest.approx(
        ja.pressure_of_temperature(ja_, 200.0), rel=1e-12)


def test_adiabat_guards():
    with pytest.raises(ValueError):
        ct.DryAdiabat.create(285.0, 10.0, CP, MU, Pt=100.0)
    with pytest.raises(ValueError):
        ct.DryAdiabat.create(285.0, PS, CP, MU, Tstrat=300.0)
    with pytest.raises(ValueError):
        ct.DryAdiabat.create(285.0, PS, CP, MU, Tstrat=160.0, Ptropo=1e4)


@pytest.mark.parametrize("kw", [dict(), dict(Tstrat=190.0)])
def test_moist_adiabat_matches_jax(kw):
    """The water adiabat (Murphy and Koop saturation), RK4 on 100 omega
    nodes."""
    args = (300.0, PS, 1005.0, 1850.0, 0.029, 0.018, 2.5e6, jsat.psat_h2o)
    targs = args[:-1] + (ct.psat_h2o,)
    jm = ja.MoistAdiabat.create(*args, N=100, **kw)
    tm = ct.MoistAdiabat.create(*targs, N=100, **kw)
    np.testing.assert_allclose(tm.T.numpy(), np.asarray(jm.T), rtol=1e-12)
    assert tm.Ptropo == pytest.approx(jm.Ptropo, rel=1e-12)
    P = np.geomspace(10.0, PS, 200)
    np.testing.assert_allclose(tm(P).numpy(), np.asarray(jm(P)), rtol=1e-12)
    # latent heat: warmer aloft than the dry adiabat from the same surface
    dry = ct.DryAdiabat.create(300.0, PS, 1005.0, 0.029)
    Pw = np.geomspace(1e3, 0.9 * PS, 20)
    assert bool((tm.temperature_raw(Pw) > dry(Pw)).all())


def test_lapse_rates_match_jax():
    T, P = _t([180.0, 250.0, 300.0]), _t([1e3, 3e4, 1e5])
    np.testing.assert_allclose(ct.lapse_rate_dry(T, P, CP, MU).numpy(),
                               np.asarray(ja.lapse_rate_dry(T.numpy(), P.numpy(), CP, MU)),
                               rtol=1e-15)
    np.testing.assert_allclose(
        ct.lapse_rate_moist(T, P, 1005.0, 1850.0, 0.029, 0.018, 2.5e6, ct.psat_h2o).numpy(),
        np.asarray(ja.lapse_rate_moist(T.numpy(), P.numpy(), 1005.0, 1850.0, 0.029, 0.018,
                                       2.5e6, jsat.psat_h2o)), rtol=1e-13)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_lapse_matches_jax(dtype):
    """The adjustment sweep on a superadiabatic column, unsorted pressures,
    in either dtype (the JAX package's scan in the same dtype)."""
    rng = np.random.default_rng(2)
    P = rng.permutation(np.geomspace(10.0, PS, 20))
    T = 180.0 + 120.0 * (P / PS) ** 0.3 + rng.normal(0.0, 8.0, 20)
    npt = np.float64 if dtype == torch.float64 else np.float32
    want = np.asarray(ja.lapse(jnp.asarray(T.astype(npt)), jnp.asarray(P.astype(npt)), CP, MU))
    got = ct.lapse(torch.tensor(T, dtype=dtype), torch.tensor(P, dtype=dtype), CP, MU)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, T.astype(npt))      # the sweep did adjust
    order = np.argsort(-P)
    Ts, Ps = got.double().numpy()[order], P[order]
    gam = (Ts[:-1] / Ps[:-1]) * (R_GAS / (MU * CP))
    assert np.all((Ts[1:] - Ts[:-1]) / (Ps[1:] - Ps[:-1]) <= gam * (1 + 1e-5))


def test_hydrostatics_match_jax():
    """Both packages integrate on the host, calling the profile on floats:
    a plain function, and once the port's DryAdiabat."""
    fT = lambda P: max(280.0 * (P / PS) ** (R_GAS / (MU * CP)), 180.0)
    fmu = lambda T, P: MU
    assert ct.scale_height(G, MU, 250.0) == jh.scale_height(G, MU, 250.0)
    z = 1.2e4
    assert ct.hydrostatic(z, PS, G, fT, fmu) == jh.hydrostatic(z, PS, G, fT, fmu)
    adiabat = ct.DryAdiabat.create(280.0, PS, CP, MU, Tstrat=180.0, smooth=0.0)
    assert ct.hydrostatic(z, PS, G, adiabat, fmu, n=64) == pytest.approx(
        jh.hydrostatic(z, PS, G, fT, fmu, n=64), rel=1e-12)
    assert ct.altitude(3e4, PS, G, fT, fmu) == jh.altitude(3e4, PS, G, fT, fmu)
    th = ct.Hydrostatic.create(PS, 100.0, G, fT, fmu, N=60)
    jhh = jh.Hydrostatic.create(PS, 100.0, G, fT, fmu, N=60)
    np.testing.assert_allclose(th.lnP.numpy(), np.asarray(jhh.lnP), rtol=1e-13)
    zz = np.linspace(-100.0, th.zt + 500.0, 50)
    np.testing.assert_allclose(th(zz).numpy(), np.asarray(jhh(zz)), rtol=1e-12)
    assert th.altitude(5e3) == pytest.approx(jhh.altitude(5e3), rel=1e-12)
    with pytest.raises(ValueError):
        ct.hydrostatic(-1.0, PS, G, fT, fmu)


def test_saturation_matches_jax():
    T = np.linspace(150.0, 360.0, 50)
    P = np.geomspace(50.0, 4e5, 50)
    np.testing.assert_allclose(ct.psat_h2o(T).numpy(), np.asarray(jsat.psat_h2o(T)), rtol=1e-13)
    np.testing.assert_allclose(ct.tsat_co2(P).numpy(), np.asarray(jsat.tsat_co2(P)), rtol=1e-14)
    np.testing.assert_allclose(ct.ozonelayer(P).numpy(), np.asarray(jsat.ozonelayer(P)),
                               rtol=1e-13, atol=1e-20)
    Tc = 150.0 + 0.0 * P
    np.testing.assert_allclose(ct.haircut(Tc, P, ct.tsat_co2).numpy(),
                               np.asarray(jsat.haircut(Tc, P, jsat.tsat_co2)), rtol=1e-14)
    assert bool((ct.haircut(Tc, P, ct.tsat_co2) >= ct.tsat_co2(P)).all())
    nu = np.linspace(100.0, 30000.0, 40)
    np.testing.assert_allclose(ct.rayleigh_co2(nu, 6e2, 3.7, 0.6).numpy(),
                               np.asarray(jsat.rayleigh_co2(nu, 6e2, 3.7, 0.6)), rtol=1e-13)
    jad = ja.DryAdiabat.create(300.0, PS, 1005.0, 0.029, Tstrat=190.0)
    tad = ct.DryAdiabat.create(300.0, PS, 1005.0, 0.029, Tstrat=190.0)
    jf = jsat.condensible_profile(jad, jsat.psat_h2o)
    tf = ct.condensible_profile(tad, ct.psat_h2o)
    Ts = np.asarray(jad(P))
    np.testing.assert_allclose(tf(_t(Ts), _t(P)).numpy(), np.asarray(jf(Ts, P)), rtol=1e-13)


# --- the column model --------------------------------------------------------------

def _gray_pair(nnu=150, Ts=280.0):
    """The JAX package's test column (tests/test_rcm.py::make_rcm), gray."""
    nu = np.concatenate([jgrids.logrange(1e-6, 1e4, nnu - 1, 3), [1e5]])
    Pe = jgrids.pressuregrid(PT, PS, 24)
    Te = np.maximum(Ts * (Pe / PS) ** (R_GAS / (0.029 * 1e3)), 150.0)
    S0 = 240.0 / math.cos(0.841) / (1e5 - 1e-6)
    jm = jr.RCM.create(Pe, Te, G, lambda T, P: 0.029, lambda v: jnp.full(jnp.shape(v), S0), 0.1,
                       lambda T, P: 1e3, 1e7, JGrayGas.create(5e-27, nu))
    tm = ct.RCM.create(Pe, Te, G, lambda T, P: 0.029, lambda v: torch.full_like(v, S0), 0.1,
                       lambda T, P: 1e3, 1e7, ct.GrayGas.create(5e-27, nu, **CPU64))
    return jm, tm


def _lbl_pair(shape="phco2", n_nu=256, n_levels=8):
    """A small line-by-line column of a dense-CO2 atmosphere: 120 synthetic
    CO2 lines, ``shape`` at its default cut, the dry adiabat of chip_smoke's
    rce phase."""
    jl = JLines.from_par_dict(ct.synthetic_co2_par(120, seed=11))
    pos = np.asarray(jl.nu)
    nu = np.linspace(max(pos.min() - 500.0, 1.0), pos.max() + 500.0, n_nu)
    jg = JDirectGas.from_lines(jl, 0.95, nu, shape=shape)
    tg = convert.direct_gas(jg, 0.95, **CPU64)
    Pe = jgrids.pressuregrid(PT, PS, n_levels)
    Te = np.asarray(ja.DryAdiabat.create(285.0, PS, CP, MU, Tstrat=160.0)(Pe))
    span = float(nu[-1] - nu[0])
    fS = 340.0 / math.cos(0.841) / span
    jm = jr.RCM.create(Pe, Te, G, lambda T, P: MU, lambda v: jnp.full(jnp.shape(v), fS), 0.1,
                       lambda T, P: CP, 1e7, jg, radmul=2)
    tm = ct.RCM.create(Pe, Te, G, lambda T, P: MU, lambda v: torch.full_like(v, fS), 0.1,
                       lambda T, P: CP, 1e7, tg, radmul=2)
    return jm, tm


@pytest.fixture(scope="module")
def gray():
    return _gray_pair()


@pytest.fixture(scope="module")
def lbl():
    return _lbl_pair()


def _close(a, b, rtol=1e-9):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=rtol, atol=rtol * np.abs(b).max())


def test_heating_at_given_temperatures_and_absorber(lbl):
    """heating(rcm, T, A): other cell temperatures and a refreshed absorber
    than the model's own, and the spectral_sum hook."""
    jm, tm = lbl
    T = np.asarray(jm.T) + np.linspace(-5.0, 5.0, jm.T.shape[0])
    Te = np.asarray(jm.A.T) + 3.0
    jA, tA = jm.A.update(jnp.asarray(Te)), tm.A.update(_t(Te))
    _close(tA.ln_sigma.numpy(), jA.ln_sigma)
    _close(ct.heating(tm, _t(T), tA).numpy(), jr.heating(jm, jnp.asarray(T), jA))
    _close(ct.heating(tm).numpy(), jr.heating(jm))
    s = ct.heating(tm, spectral_sum=lambda y: y.sum(-1)).numpy()
    _close(s, jr.heating(jm, spectral_sum=lambda y: y.sum(-1)))
    # update_absorber with explicit edge temperatures
    _close(ct.update_absorber(tm, _t(Te)).A.ln_sigma.numpy(),
           jr.update_absorber(jm, jnp.asarray(Te)).A.ln_sigma)


def test_radiate_state_matches_jax(lbl):
    jm, tm = lbl
    F, R = ct.radiate_state(tm), jr.radiate_state(jm)
    for k in ("tau", "M_up", "M_down", "F_up", "F_down", "F_net"):
        _close(getattr(F, k).numpy(), getattr(R, k))


def test_step_n_equals_steps(gray, lbl):
    """step_n is n steps of step on the cached absorber, bit for bit, and
    matches the JAX package's scan."""
    for jm, tm in (gray, lbl):
        a = ct.step_n(tm, 900.0, 3)
        b = tm
        for _ in range(3):
            b = ct.step(b, 900.0)
        assert torch.equal(a.T, b.T)
        assert a.A is tm.A
        _close(a.T.numpy(), jr.step_n(jm, 900.0, 3).T)


@pytest.mark.parametrize("cadence", [
    dict(nsteps=6, update_every=2, adjust_every=3, record_every=2),
    dict(nsteps=7, update_every=3, adjust_every=1, record_every=3),
    dict(nsteps=4, update_every=0, adjust_every=0, record_every=0),
    dict(nsteps=5, update_every=5, adjust_every=2, record_every=1),
])
def test_run_matches_jax_with_cadences_and_records(lbl, cadence):
    """run on the phco2 column: the refreshes, adjustments and records at
    the JAX package's cadences (its tests/test_rcm.py run-loop pattern)."""
    jm, tm = lbl
    kw = dict(cadence, cp=CP, mu=MU)
    tout, trec = ct.run(tm, 3600.0, **kw)
    jout, jrec = jr.run(jm, 3600.0, **kw)
    n_rec = cadence["nsteps"] // cadence["record_every"] if cadence["record_every"] else 0
    assert trec.shape == tuple(np.asarray(jrec).shape) == (n_rec, tm.T.shape[0])
    if n_rec:
        _close(trec.numpy(), jrec)
    _close(tout.T.numpy(), jout.T)
    _close(tout.A.ln_sigma.numpy(), jout.A.ln_sigma)
    if cadence["record_every"] and cadence["nsteps"] % cadence["record_every"] == 0:
        assert torch.equal(trec[-1], tout.T)
    if not cadence["update_every"]:
        assert tout.A is tm.A


def test_run_is_the_composed_loop(gray):
    """run against step, update_absorber and convective_adjustment composed
    by hand (the loop it replaces), and its guard."""
    _, tm = gray
    out, rec = ct.run(tm, 600.0, 4, update_every=2, adjust_every=1, cp=1e3, mu=0.029,
                      record_every=2)
    m, recs = tm, []
    for i in range(4):
        m = ct.convective_adjustment(ct.step(m, 600.0), 1e3, 0.029)
        if (i + 1) % 2 == 0:
            m = ct.update_absorber(m)
            recs.append(m.T)
    assert torch.equal(out.T, m.T) and torch.equal(rec, torch.stack(recs))
    with pytest.raises(ValueError):
        ct.run(tm, 600.0, 2, adjust_every=1)


def test_convective_adjustment_matches_jax(gray):
    jm, tm = gray
    T = np.asarray(jm.T).copy()
    T[-3] = T[-1] + 50.0
    jm2 = jr.convective_adjustment(dataclasses.replace(jm, T=jnp.asarray(T)), 1e3, 0.029)
    tm2 = ct.convective_adjustment(dataclasses.replace(tm, T=_t(T)), 1e3, 0.029)
    np.testing.assert_array_equal(tm2.T.numpy(), np.asarray(jm2.T))
    assert not np.array_equal(tm2.T.numpy(), T)


def test_rce_drives_toward_equilibrium(gray):
    """A long gray run with insolation: the column's net imbalance at the
    top shrinks (the JAX package's test_rce_approaches_radiative_equilibrium,
    shortened)."""
    _, tm = gray
    F0 = ct.radiate_state(tm)
    out, _ = ct.run(tm, 3e4, 300, adjust_every=1, cp=1e3, mu=0.029)
    F1 = ct.radiate_state(out)
    assert bool(torch.isfinite(out.T).all())
    assert abs(float(F1.F_net[0])) < abs(float(F0.F_net[0]))


def test_jacobian_is_not_ported_yet(gray):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ct.jacobian(gray[1])

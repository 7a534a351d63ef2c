"""The rest of the single-column public API against the JAX package.

The Planck family, the cross-section helpers, ``bilinear``, ``bisect_jax``
and the layer quadrature helpers (``layer_planck``, ``layer_tau``,
``layer_tau_flat(floor=)``, ``path_tau``) on seeded numpy inputs, float64
on the CPU, where the arithmetic is the same: rtol 1e-12. ``optical_depth``
and ``transmittance`` in both call forms, and ``outgoing``,
``monochromatic_fluxes`` and ``radiate`` with the grid-refined core
``RadauEq`` (scalar and vector P, refine 2 and 3; a DirectGas, a GrayGas
and a split table Gas that takes the fused route's plain versions here), on
a synthetic 200-line CO2 catalog at 2^10 points: rtol 1e-10. The RCM with
``RadauEq``, ``SemiGrayGas``, ``reconcentrate``, ``AbsorberStack.update``,
``march_kernel_mode`` and the root's public names.
"""

import dataclasses
import inspect
import math
import types

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import clearsky_tpu as jpkg
from clearsky_tpu.absorption.domain import AtmosphericDomain as JDomain
from clearsky_tpu.absorption.gas import (DirectGas as JDirectGas, Gas as JGas,
                                         GrayGas as JGrayGas, SemiGrayGas as JSemiGray)
from clearsky_tpu.models import rcm as jr
from clearsky_tpu.ops import planck as jplanck, lineshape as jls
from clearsky_tpu.rt import discretized as jd, fluxes as jf
from clearsky_tpu.spectra.lines import SpectralLines as JLines
from clearsky_tpu.utils import interp as jinterp, rootfind as jroot
import clearsky_tpu_torch as ct
from clearsky_tpu_torch import convert
from clearsky_tpu_torch.constants import R_GAS
from clearsky_tpu_torch.ops import planck as tplanck, lineshape as tls
from clearsky_tpu_torch.rt import discretized as td, fluxes as tf
from clearsky_tpu_torch.utils import interp as tinterp, profiling, rootfind as troot

# the suite runs in several worker processes: a torch thread pool of every
# core in each of them oversubscribes the machine
torch.set_num_threads(2)

G, MU, CP, PS, PT = 9.8, 0.044, 850.0, 1e5, 10.0
CONC = 0.95
S0 = 340.0 / math.cos(0.841)
CPU64 = dict(dtype=torch.float64, device="cpu")
DOMAIN = ((150.0, 350.0), 12, (0.9 * PT, 1.01 * PS), 24)
# names of the JAX root with no counterpart at the port's root; the list may
# only shrink
MISSING = {
    "march_gspmd": "XLA partitioning of a pallas_call; no counterpart by design",
}


def _t(x):
    return torch.tensor(np.asarray(x, np.float64))


def _close(b, a, rtol, err_msg=""):
    a = np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert b.shape == a.shape, err_msg
    np.testing.assert_allclose(b, a, rtol=rtol, atol=rtol * max(np.abs(a).max(), 1e-300),
                               err_msg=err_msg)


def _counts():
    return (profiling.counters["launch.linesum"], profiling.counters["launch.march.olr"],
            profiling.counters["launch.march.monoflux"],
            profiling.counters["launch.fused.olr"], profiling.counters["launch.fused.monoflux"])


# --- pure math ---------------------------------------------------------------------

def _planck_args(rng):
    nu = rng.uniform(10.0, 3000.0, 64)
    T = rng.uniform(150.0, 320.0, 64)
    sig = rng.uniform(1e-28, 1e-24, 64)
    I = rng.uniform(0.0, 0.5, 64)
    P = rng.uniform(10.0, 1e5, 64)
    mu = rng.uniform(0.02, 0.05, 64)
    return {
        "nu2f": (nu,), "f2nu": (nu * 3e10,), "nu2lam": (nu,), "lam2nu": (1e-2 / nu,),
        "lam2f": (1e-2 / nu,), "f2lam": (nu * 3e10,), "planck": (nu, T),
        "normplanck": (nu, T), "dplanck": (nu, T), "stefanboltzmann": (T,),
        "equilibrium_temperature": (rng.uniform(100.0, 2000.0, 64), rng.uniform(0, 0.9, 64)),
        "equilibrium_temperature_luminosity": (rng.uniform(1e25, 1e27, 64),
                                               rng.uniform(0, 0.9, 64),
                                               rng.uniform(1e10, 1e12, 64)),
        "dtau_dP": (sig, 9.8, mu), "transmittance": (rng.uniform(0.0, 20.0, 64),),
        "schwarzschild_dIdz": (I, nu, sig, T, P),
        "schwarzschild_dIdP": (I, nu, sig, 9.8, mu, T),
        "absorption_dIdP": (I, sig, 9.8, mu), "emission_dIdP": (nu, sig, 9.8, mu, T),
    }


@pytest.mark.parametrize("name", tplanck.__all__)
def test_planck_family_matches(name):
    args = _planck_args(np.random.default_rng(11))[name]
    b = getattr(tplanck, name)(*(_t(a) if isinstance(a, np.ndarray) else a for a in args))
    a = getattr(jplanck, name)(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                 for a in args))
    _close(b, a, 1e-12, name)


@pytest.mark.parametrize("name", ["planck", "dplanck"])
def test_planck_float32_at_50_K(name):
    nu = torch.linspace(1.0, 1e4, 4001, dtype=torch.float32)
    fn = getattr(tplanck, name)
    ref = fn(nu.double(), _t(50.0))
    got = fn(nu, torch.tensor(50.0))
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    err = (got.double() - ref).abs()
    peak = float(ref.abs().max())
    assert float(err.max()) <= 1e-5 * peak
    # relative within six decades of the peak (beyond them float32's
    # rounding of x = c2 nu / T ~ 85 alone is 1e-5 of e^-x)
    big = ref.abs() > 1e-6 * peak
    assert float((err[big] / ref[big].abs()).max()) < 1e-5


@pytest.mark.parametrize("name", ["doppler_xsec", "lorentz_xsec", "voigt_xsec"])
def test_xsec_helpers_match(name):
    rng = np.random.default_rng(12)
    dnu = rng.uniform(-30.0, 30.0, 200)
    S = rng.uniform(1e-22, 1e-19, 200)
    alpha = rng.uniform(1e-4, 2e-3, 200)
    gamma = rng.uniform(1e-4, 1e-1, 200)
    widths = {"doppler_xsec": (alpha,), "lorentz_xsec": (gamma,),
              "voigt_xsec": (alpha, gamma)}[name]
    b = getattr(tls, name)(_t(dnu), _t(S), *map(_t, widths))
    a = getattr(jls, name)(jnp.asarray(dnu), jnp.asarray(S), *map(jnp.asarray, widths))
    _close(b, a, 1e-12, name)


@pytest.mark.parametrize("extrapolate", [True, False])
def test_bilinear_matches(extrapolate):
    rng = np.random.default_rng(13)
    xp, yp = np.sort(rng.uniform(0, 10, 9)), np.sort(rng.uniform(-5, 5, 7))
    fp = rng.normal(size=(3, 9, 7))
    x, y = rng.uniform(-1, 11, 50), rng.uniform(-6, 6, 50)
    b = tinterp.bilinear(_t(x), _t(y), _t(xp), _t(yp), _t(fp), extrapolate=extrapolate)
    a = jinterp.bilinear(jnp.asarray(x), jnp.asarray(y), xp, yp, fp, extrapolate=extrapolate)
    _close(b, a, 1e-12)


def test_bisect_jax_matches():
    c = np.linspace(0.5, 5.0, 17)
    lo, hi = np.zeros(17), np.full(17, 3.0)
    b = troot.bisect_jax(lambda x: x**3 - _t(c), _t(lo), _t(hi))
    a = jroot.bisect_jax(lambda x: x**3 - jnp.asarray(c), lo, hi)
    # numbers as brackets: float64, broadcast against the residuals
    assert torch.equal(troot.bisect_jax(lambda x: x**3 - _t(c), 0.0, 3.0), b)
    _close(b, a, 1e-12)
    np.testing.assert_allclose(b.numpy(), np.cbrt(c), rtol=1e-14)


def _layers(rng, k=3, L=7, n=40):
    P = np.sort(rng.uniform(10.0, 1e5, L + 1))
    Tn = rng.uniform(180.0, 300.0, (L, k))
    mun = rng.uniform(0.02, 0.05, (L, k))
    sig = rng.uniform(0.0, 1e-25, (L, k, n))
    sig[0] = 0.0  # a transparent layer: the floor decides it
    return P, Tn, mun, sig


@pytest.mark.parametrize("floor", [False, True])
def test_layer_tau_matches(floor):
    P, Tn, mun, sig = _layers(np.random.default_rng(14))
    b = td.layer_tau(_t(P), _t(Tn), _t(mun), _t(sig), G, 3, floor=floor)
    a = jd.layer_tau(P, jnp.asarray(Tn), jnp.asarray(mun), jnp.asarray(sig), G, 3, floor=floor)
    _close(b, a, 1e-12)
    assert (float(b.min()) == td.TAU_MIN) == floor


@pytest.mark.parametrize("floor", [False, True])
def test_layer_tau_flat_matches(floor):
    P, _, mun, sig = _layers(np.random.default_rng(15))
    L, k, n = sig.shape
    b = td.layer_tau_flat(_t(P), _t(mun.reshape(-1)), _t(sig.reshape(L * k, n)), G, k,
                          floor=floor)
    a = jd.layer_tau_flat(jnp.asarray(P), jnp.asarray(mun.reshape(-1)),
                          jnp.asarray(sig.reshape(L * k, n)), G, k, floor=floor)
    _close(b, a, 1e-12)


def test_layer_tau_flat_is_row_major_for_any_sigma_layout():
    """A sigma stored point-major (as a cached absorber may give it) still
    gives a row-major tau, the only layout the march kernels take."""
    P, _, mun, sig = _layers(np.random.default_rng(15))
    L, k, n = sig.shape
    flat = _t(np.ascontiguousarray(sig.reshape(L * k, n).T)).t()
    b = td.layer_tau_flat(_t(P), _t(mun.reshape(-1)), flat, G, k)
    assert not flat.is_contiguous() and b.is_contiguous()
    a = td.layer_tau_flat(_t(P), _t(mun.reshape(-1)), flat.contiguous(), G, k)
    assert torch.equal(a, b)


def test_path_tau_and_layer_planck_match():
    rng = np.random.default_rng(16)
    P, Tn, mun, sig = _layers(rng)
    b = td.path_tau(_t(P), _t(Tn), _t(mun), _t(sig), G, 1.3, 3)
    a = jd.path_tau(P, jnp.asarray(Tn), jnp.asarray(mun), jnp.asarray(sig), G, 1.3, 3)
    _close(b, a, 1e-12)
    B1, B2 = rng.uniform(0, 1, 300), rng.uniform(0, 1, 300)
    tau = np.concatenate([[0.0, 1e-9], 10.0 ** rng.uniform(-6, 2, 298)])
    t = np.exp(-tau)
    for omt in (None, -np.expm1(-tau)):
        b = td.layer_planck(_t(B1), _t(B2), _t(tau), _t(t), None if omt is None else _t(omt))
        a = jd.layer_planck(jnp.asarray(B1), jnp.asarray(B2), jnp.asarray(tau),
                            jnp.asarray(t), None if omt is None else jnp.asarray(omt))
        _close(b, a, 1e-12)


# --- the column API ----------------------------------------------------------------

@pytest.fixture(scope="module")
def col():
    par = ct.synthetic_co2_par(200, seed=7)
    jl = JLines.from_par_dict(par)
    tl = ct.SpectralLines.from_par_dict(par, **CPU64)
    p64 = tl.positions64()
    nu = np.linspace(max(p64.min() - 25.0, 1.0), p64.max() + 25.0, 2**10)
    jg = JDirectGas.from_lines(jl, CONC, nu)
    tg = ct.DirectGas.from_lines(tl, CONC, nu)
    jgray, tgray = JGrayGas.create(2e-27, nu), ct.GrayGas.create(2e-27, nu, **CPU64)
    js = JGas.from_lines(jl, CONC, nu, JDomain.create(*DOMAIN)).split_precision(16)
    ts = convert.gas(js, CONC, **CPU64)
    Pe = ct.pressuregrid(PT, PS, 9)
    Te = np.maximum(288.0 * (Pe / PS) ** (R_GAS / (MU * CP)), 160.0)
    span = float(nu[-1] - nu[0])
    return dict(nu=nu, Pe=Pe, Te=Te, gases={"direct": (jg, tg), "gray": (jgray, tgray),
                                            "table": (js, ts)},
                fS_j=lambda v: jnp.full(jnp.shape(v), S0 / span),
                fS_t=lambda v: torch.full_like(v, S0 / span))


def _profiles(pkg):
    """Dry adiabat with a 160 K floor, as callables of each package."""
    if pkg == "jax":
        return (lambda P: jnp.maximum(288.0 * (P / PS) ** (R_GAS / (MU * CP)), 160.0),
                lambda T, P: MU)
    return (lambda P: torch.clamp(288.0 * (P / PS) ** (R_GAS / (MU * CP)), min=160.0),
            lambda T, P: MU)


@pytest.mark.parametrize("form", ["vector", "pair", "scalar"])
@pytest.mark.parametrize("fn", ["optical_depth", "transmittance"])
def test_optical_depth_matches(col, form, fn):
    jg, tg = col["gases"]["direct"]
    P = {"vector": col["Pe"], "pair": (PS, 50.0), "scalar": PS}[form]
    kw = dict(nlevels=24, Ptop=PT)
    before = _counts()
    b = getattr(ct, fn)(P, G, *_profiles("torch"), 0.4, tg, **kw)
    assert _counts() == before
    a = getattr(jf, fn)(P, G, *_profiles("jax"), 0.4, jg, **kw)
    assert b.shape == (2**10,)
    _close(b, a, 1e-10, f"{fn} {form}")
    assert float(b.max()) > 0.0


def test_optical_depth_core_selectors(col):
    jg, tg = col["gases"]["direct"]
    # Radau integrates the depth adaptively, as JAX's does (within its tol)
    got = ct.optical_depth((PS, 50.0), G, col["Te"][-1], MU, 0.3, tg, core=ct.Radau(tol=1e-6))
    ref = np.asarray(jf.optical_depth((PS, 50.0), G, col["Te"][-1], MU, 0.3, jg,
                                      core=jf.Radau(tol=1e-6)))
    assert np.abs(got.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()
    with pytest.raises(ValueError, match="core"):
        ct.optical_depth(col["Pe"], G, col["Te"], MU, 0.3, tg, core=ct.Discretized())
    with pytest.raises(ValueError, match="zenith"):
        ct.optical_depth(col["Pe"], G, col["Te"], MU, 2.0, tg)


def _radau_entry(col, pkg, name, gas, P, refine):
    core = (jf if pkg == "jax" else tf).RadauEq(refine=refine)
    mod = jf if pkg == "jax" else ct
    T = col["Te"] if np.ndim(P) else _profiles(pkg)[0]
    if name == "outgoing":
        return [mod.outgoing(P, G, T, MU, gas, core=core, nlevels=12, Ptop=PT)]
    fS = col["fS_j"] if pkg == "jax" else col["fS_t"]
    out = getattr(mod, name)(P, G, T, MU, fS, 0.1, gas, core=core)
    return list(out)


@pytest.mark.parametrize("refine", [2, 3])
@pytest.mark.parametrize("P", ["vector", "scalar"])
@pytest.mark.parametrize("gas", ["direct", "gray", "table"])
def test_radaueq_outgoing_matches(col, gas, P, refine):
    jg, tg = col["gases"][gas]
    Pv = col["Pe"] if P == "vector" else PS
    b = _radau_entry(col, "torch", "outgoing", tg, Pv, refine)
    a = _radau_entry(col, "jax", "outgoing", jg, Pv, refine)
    _close(b[0], np.asarray(a[0]), 1e-10, f"{gas} {P} {refine}")


@pytest.mark.parametrize("refine", [2, 3])
@pytest.mark.parametrize("name", ["monochromatic_fluxes", "radiate"])
@pytest.mark.parametrize("gas", ["direct", "gray", "table"])
def test_radaueq_fluxes_match(col, gas, name, refine):
    jg, tg = col["gases"][gas]
    before = _counts()
    b = _radau_entry(col, "torch", name, tg, col["Pe"], refine)
    assert _counts() == before
    a = _radau_entry(col, "jax", name, jg, col["Pe"], refine)
    assert len(b) == len(a) == (3 if name == "monochromatic_fluxes" else 6)
    for k, (x, y) in enumerate(zip(b, a)):
        _close(x, np.asarray(y), 1e-10, f"{gas} {name} {refine} [{k}]")
    # the fluxes at the caller's levels, tau summed back onto its layers
    tau = b[-1] if name == "monochromatic_fluxes" else b[0]
    assert tau.shape == (len(col["Pe"]) - 1, 2**10)


@pytest.fixture
def fused_calls(monkeypatch):
    """Counts the calls that take the fused table route (its plain versions
    run on CPU tensors, so the kernels' counts stay)."""
    calls = []
    for name in ("table_olr_fused", "table_monoflux_fused"):
        fn = getattr(tf, name)
        monkeypatch.setattr(tf, name, lambda *a, _fn=fn, **k: calls.append(1) or _fn(*a, **k))
    return calls


def test_radaueq_table_gate_reads_the_refined_layers(col, fused_calls):
    """The fused table route is gated on the refined layer count: 8 layers x
    refine 8 = 64 <= MAX_LAYERS takes it, x 32 = 256 does not; RadauEq's
    radiate never does."""
    ts = col["gases"]["table"][1]
    for refine, fused in ((8, 1), (32, 0)):
        del fused_calls[:]
        ct.outgoing(col["Pe"], G, col["Te"], MU, ts, core=ct.RadauEq(refine=refine))
        assert len(fused_calls) == fused
    del fused_calls[:]
    ct.radiate(col["Pe"], G, col["Te"], MU, col["fS_t"], 0.1, ts, core=ct.RadauEq(refine=2))
    assert not fused_calls


def test_radaueq_is_the_refined_discretized_call(col):
    """RadauEq's outgoing and radiate are the Discretized call on _refined
    levels with T and mu interpolated against the caller's levels."""
    tg = col["gases"]["direct"][1]
    Pr, idx = tf._refined(col["Pe"], 4)
    prof = ct.AtmosphericProfile.create(_t(col["Pe"]), _t(col["Te"]))
    olr = ct.outgoing(col["Pe"], G, col["Te"], MU, tg, core=ct.RadauEq(refine=4))
    ref = ct.outgoing(Pr, G, prof, MU, tg, core=ct.Discretized(nlobatto=3))
    assert torch.equal(olr, ref)
    F = ct.radiate(col["Pe"], G, col["Te"], MU, col["fS_t"], 0.1, tg,
                   core=ct.RadauEq(refine=4))
    Fr = ct.radiate(Pr, G, prof, MU, col["fS_t"], 0.1, tg, core=ct.Discretized(nlobatto=3))
    assert torch.equal(F.M_up, Fr.M_up[idx]) and torch.equal(F.M_down, Fr.M_down[idx])
    np.testing.assert_allclose(F.F_net.numpy(), Fr.F_net[idx].numpy(), rtol=1e-15)
    np.testing.assert_allclose(F.tau.numpy(), Fr.tau.reshape(8, 4, -1).sum(1).numpy(),
                               rtol=1e-15)


@pytest.mark.parametrize("name", ["top_fluxes", "top_imbalance", "bottom_fluxes"])
def test_top_and_bottom_fluxes_match(col, name):
    jg, tg = col["gases"]["direct"]
    b = getattr(ct, name)(col["Pe"], G, col["Te"], MU, col["fS_t"], 0.1, tg)
    a = getattr(jf, name)(col["Pe"], G, col["Te"], MU, col["fS_j"], 0.1, jg)
    b, a = (b, a) if name == "top_imbalance" else (torch.stack(b), jnp.stack(a))
    _close(b, np.asarray(a), 1e-10, name)
    F = ct.radiate(col["Pe"], G, col["Te"], MU, col["fS_t"], 0.1, tg)
    rows = {"top_fluxes": torch.stack([F.F_up[0], F.F_down[0]]),
            "top_imbalance": F.F_up[0] - F.F_down[0],
            "bottom_fluxes": torch.stack([F.F_up[-1], F.F_down[-1]])}[name]
    assert torch.equal(b, rows)


def test_rcm_with_radaueq_matches(col):
    jg, tg = col["gases"]["direct"]
    fmu, fcp = (lambda T, P: MU), (lambda T, P: CP)
    rj = jr.RCM.create(col["Pe"], col["Te"], G, fmu, col["fS_j"], 0.1, fcp, 1e7, jg,
                       core=jf.RadauEq(refine=3), radmul=2)
    rt = ct.RCM.create(col["Pe"], col["Te"], G, fmu, col["fS_t"], 0.1, fcp, 1e7, tg,
                       core=ct.RadauEq(refine=3), radmul=2)
    assert rt.n_cells == rj.n_cells == len(col["Pe"])
    assert rt.Pr.shape == (8 * 2 * 3 + 1,)
    np.testing.assert_array_equal(rt.Pr.numpy(), np.asarray(rj.Pr))
    Hj = np.asarray(jr.heating(rj))
    _close(ct.heating(rt), Hj, 1e-10)
    rj2, rt2 = jr.step(jr.update_absorber(rj), 3600.0), ct.step(ct.update_absorber(rt), 3600.0)
    _close(rt2.T, np.asarray(rj2.T), 1e-10)
    # the JAX state carried over keeps its core
    rc = convert.rcm(rj, tg)
    assert rc.core == ct.RadauEq(refine=3)
    _close(ct.heating(rc), Hj, 1e-10)


def test_semigray_gas_matches(col):
    nu = col["nu"]
    jsg = JSemiGray.create(3e-27, nu, nucut=700.0)
    tsg = ct.SemiGrayGas.create(3e-27, nu, 700.0, **CPU64)
    T, P = np.array([200.0, 250.0, 290.0]), np.array([1e2, 1e4, 9e4])
    _close(tsg.raw_sigma(_t(T), _t(P)), np.asarray(jsg.raw_sigma(jnp.asarray(T),
                                                                 jnp.asarray(P))), 1e-15)
    assert float(tsg.raw_sigma(_t(T), _t(P))[:, nu > 700.0].abs().max()) == 0.0
    jg, tg = col["gases"]["direct"]
    b = ct.outgoing(col["Pe"], G, col["Te"], MU, tsg, tg)
    a = jf.outgoing(col["Pe"], G, col["Te"], MU, jsg, jg)
    _close(b, np.asarray(a), 1e-10)
    assert ct.SemiGrayGas.create(1e-27, nu, 700.0, **CPU64).spectral_slab(3, 9).nu.shape == (6,)


def test_reconcentrate_and_update(col):
    jg, tg = col["gases"]["direct"]
    T, P = np.array([220.0, 280.0]), np.array([5e3, 8e4])
    for c in (0.5, lambda T_, P_: 0.2 + 0 * T_):
        b = tg.reconcentrate(c)(_t(T), _t(P))
        a = jg.reconcentrate(c)(jnp.asarray(T), jnp.asarray(P))
        _close(b, np.asarray(a), 1e-10)
    # the self-broadening follows the concentration
    assert not torch.equal(tg.reconcentrate(0.5).raw_sigma(_t(T), _t(P)),
                           tg.raw_sigma(_t(T), _t(P)))
    with pytest.raises(ValueError):
        tg.reconcentrate(1.5)
    stack = ct.unify_absorbers((tg,))
    assert stack.update(_t(T)) is stack


def test_march_kernel_mode(col, fused_calls):
    tg = col["gases"]["table"][1]
    args = (col["Pe"], G, col["Te"], MU)
    auto = ct.outgoing(*args, tg), ct.radiate(*args, col["fS_t"], 0.1, tg).M_up
    assert len(fused_calls) == 2
    with ct.march_kernel_mode("off"):
        off = ct.outgoing(*args, tg), ct.radiate(*args, col["fS_t"], 0.1, tg).M_up
        with ct.march_kernel_mode("auto"):
            assert tf._fused_table_ok(tg, 8, 5, 3)
        assert not tf._fused_table_ok(tg, 8, 5, 3)
    assert len(fused_calls) == 2 and tf._fused_table_ok(tg, 8, 5, 3)
    for a, b in zip(auto, off):
        _close(b, a.numpy(), 1e-12)
    with pytest.raises(ValueError, match="interpret"):
        with ct.march_kernel_mode("interpret"):
            pass
    with pytest.raises(ValueError):
        with ct.march_kernel_mode("fast"):
            pass


def test_public_names():
    """The names each root defines (submodules aside: which of them appear
    in ``dir`` depends on what the process imported before), and the
    submodules the JAX root imports itself."""
    public = lambda mod: {n for n in dir(mod) if not n.startswith("_")
                          and not isinstance(getattr(mod, n), types.ModuleType)}
    assert public(jpkg) - public(ct) == set(MISSING)
    assert set(ct.__all__) <= public(ct)
    for sub in ("constants", "orbital", "parallel"):
        assert isinstance(getattr(ct, sub), types.ModuleType)
    col = ct.pressuregrid(PT, PS, 5)
    gas = ct.GrayGas.create(1e-27, np.linspace(10.0, 2000.0, 16), **CPU64)
    # every core selector runs: Radau, the last to be ported, against JAX's
    got = ct.outgoing(col, G, 250.0, MU, gas, core=ct.Radau())
    ref = jpkg.outgoing(col, G, 250.0, MU, JGrayGas.create(1e-27, np.linspace(10.0, 2000.0, 16)),
                        core=jpkg.Radau())
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= 1e-5 * np.abs(np.asarray(ref)).max()


def _same_default(a, b) -> bool:
    """Equal defaults: dataclass instances by type name and fields (each
    package has its own classes), NaN equal to NaN, else ``==``."""
    if dataclasses.is_dataclass(a) and dataclasses.is_dataclass(b):
        return type(a).__name__ == type(b).__name__ and dataclasses.asdict(a) == dataclasses.asdict(b)
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    try:
        return bool(a == b)
    except (TypeError, ValueError, RuntimeError):
        return False


def _signature_gaps(jfn, tfn) -> list:
    """Where a call written for ``jfn`` could fail on ``tfn``: a positional
    parameter of another name or missing, a keyword or variadic parameter
    missing, a default missing or different, or a parameter the port adds
    without a default."""
    E = inspect.Parameter.empty
    positional = (inspect.Parameter.POSITIONAL_ONLY, inspect.Parameter.POSITIONAL_OR_KEYWORD)
    js, ts = inspect.signature(jfn), inspect.signature(tfn)
    tp = list(ts.parameters.values())
    kinds = {q.kind for q in tp}
    gaps = []
    for i, p in enumerate(js.parameters.values()):
        if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
            if p.kind not in kinds:
                gaps.append(f"no {p}")
            continue
        if p.kind in positional:
            q = tp[i] if i < len(tp) and tp[i].kind in positional else None
            if q is None or q.name != p.name:
                gaps.append(f"positional {i} is {p.name!r}, not {q and q.name!r}")
                continue
        else:
            q = ts.parameters.get(p.name)
            if q is None:
                if inspect.Parameter.VAR_KEYWORD not in kinds:
                    gaps.append(f"no keyword {p.name!r}")
                continue
        if p.default is not E and (q.default is E or not _same_default(p.default, q.default)):
            gaps.append(f"{p.name}={q.default!r}, JAX {p.default!r}")
    names = set(js.parameters)
    gaps += [f"{q.name!r} added without a default" for q in tp
             if q.name not in names and q.default is E
             and q.kind not in (q.VAR_POSITIONAL, q.VAR_KEYWORD)]
    return gaps


def test_public_signatures_take_jax_calls():
    """Every function and class both roots export takes the JAX package's
    calls: its parameter names (positional ones in JAX's order) and its
    defaults, where the port's may only be more permissive (more optional
    parameters, a default where JAX has none)."""
    checked = 0
    for name in sorted(set(dir(jpkg)) & set(dir(ct))):
        a, b = getattr(jpkg, name), getattr(ct, name)
        if name.startswith("_") or isinstance(a, types.ModuleType) or not callable(a):
            continue
        assert _signature_gaps(a, b) == [], name
        checked += 1
    assert checked > 100


def test_fused_table_refuses_interpret():
    """JAX's ``interpret=True`` has no counterpart: it raises before any work."""
    for fn, args in ((ct.table_olr_fused, (None, None, G, None, None)),
                     (ct.table_monoflux_fused, (None, None, G, None, None, None, None, 0.5))):
        with pytest.raises(ValueError, match="interpret"):
            fn(*args, interpret=True)


def test_sigma_from_lines_refuses_conc_in_batch_blocks_place(col):
    """``batch_blocks`` stands where ``conc`` stood: concentrations passed
    positionally raise instead of being dropped; an int changes nothing."""
    from clearsky_tpu_torch.ops.linesum import sigma_from_lines

    gas = col["gases"]["direct"][1]
    T, P = _t(np.array([200.0, 280.0])), _t(np.array([1e3, 1e5]))
    conc = torch.full((T.shape[0], gas.lines.n_lines), CONC, **CPU64)
    with pytest.raises(TypeError, match="batch_blocks"):
        sigma_from_lines(gas.plan, gas.lines, T, P, P, "voigt", conc)
    want = sigma_from_lines(gas.plan, gas.lines, T, P, P, "voigt", conc=conc)
    assert torch.equal(sigma_from_lines(gas.plan, gas.lines, T, P, P, "voigt", 16, conc), want)


def test_absorber_stack_positional_matches_jax():
    """JAX's field order: (gases, cias, nu, funs=())."""
    nu = np.linspace(10.0, 2000.0, 64)
    jstack = jpkg.AbsorberStack((JGrayGas.create(2e-27, nu),), (), jnp.asarray(nu))
    tstack = ct.AbsorberStack((ct.GrayGas.create(2e-27, nu, **CPU64),), (), _t(nu))
    assert tstack.funs == () and tstack.n_nu == 64 and tstack.cias == ()
    T, P = np.array([200.0, 250.0, 300.0]), np.array([1e2, 1e4, 1e5])
    _close(tstack.sigma(_t(T), _t(P)), jstack.sigma(jnp.asarray(T), jnp.asarray(P)), 1e-14)
    assert [f.name for f in dataclasses.fields(ct.AbsorberStack)] == \
        [f.name for f in dataclasses.fields(jpkg.AbsorberStack)]

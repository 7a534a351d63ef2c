"""The port's baked-table path against the JAX package.

A synthetic 300-line CO2 catalog (seed 5) on 1,500 points, baked on a
12 T x 24 ln P domain ((150, 350) K x (0.9 Pt, 1.01 Ps)) by both packages
on the CPU; a 12-level column. The same numpy inputs go through
``clearsky_tpu`` and ``clearsky_tpu_torch``:

- Chebyshev helpers, the domain, the bake, the ln sigma fit, ``raw_sigma``
  and ``split_precision`` in float64, where the arithmetic is the same
  (1e-12 for the helpers, 1e-9 for the rest);
- the plain versions of the fused kernels K6/K7 in float32 against the JAX
  Pallas kernels in interpret mode, at the JAX tests' own bars
  (tests/test_fused_table.py: OLR rtol 2e-5 and 2e-5 of peak; tau rtol
  3e-5, fluxes 5e-5 of peak);
- the entry points on a split gas, which take the fused route here (its
  plain versions on CPU tensors): against the JAX defaults (float64,
  unfused) at 1e-9, and against the JAX fused route in interpret mode at
  1e-4 of peak (that route computes in float32);
- the pressure-domain guard, the route gate and ``convert.gas``.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from clearsky_tpu.spectra.lines import SpectralLines as JLines
from clearsky_tpu.absorption import gas as jgas_mod
from clearsky_tpu.absorption.gas import Gas as JGas, GrayGas as JGray
from clearsky_tpu.absorption.domain import AtmosphericDomain as JDomain
from clearsky_tpu.absorption.absorbers import unify_absorbers as junify
from clearsky_tpu.rt import fluxes as jf, fused_table as jft
from clearsky_tpu.rt.discretized import march_kernel_mode
from clearsky_tpu.utils import interp as jinterp
import clearsky_tpu_torch as ct
from clearsky_tpu_torch import convert
from clearsky_tpu_torch.absorption import gas as tgas_mod
from clearsky_tpu_torch.absorption.absorbers import (unify_absorbers, pressure_limits,
                                                      temperature_limits)
from clearsky_tpu_torch.atmosphere.profile import formprofile
from clearsky_tpu_torch.constants import R_GAS
from clearsky_tpu_torch.rt import fused_table as tft
from clearsky_tpu_torch.utils import interp as tinterp, profiling

# the suite runs in several worker processes: a torch thread pool of every
# core in each of them oversubscribes the machine
torch.set_num_threads(2)

G, MU, CP, PS, PT = 9.8, 0.044, 850.0, 1e5, 10.0
CONC = 0.95
S0 = 340.0 / math.cos(0.841)
DOMAIN = ((150.0, 350.0), 12, (0.9 * PT, 1.01 * PS), 24)
# all-zero table columns hold log(float64 tiny), so their sigma is ~2e-308:
# subnormal after rounding, which XLA's CPU backend flushes to 0 and torch
# keeps
SUBNORMAL = 1e-300


def _counts():
    return (profiling.counters["launch.linesum"], profiling.counters["launch.march.olr"],
            profiling.counters["launch.march.monoflux"],
            profiling.counters["launch.fused.olr"], profiling.counters["launch.fused.monoflux"])


@pytest.fixture(scope="module")
def tab():
    par = ct.synthetic_co2_par(300, seed=5)
    jl = JLines.from_par_dict(par)
    tl = ct.SpectralLines.from_par_dict(par, dtype=torch.float64, device="cpu")
    p64 = tl.positions64()
    nu = np.linspace(max(p64.min() - 25.0, 1.0), p64.max() + 25.0, 1500)
    jd, td = JDomain.create(*DOMAIN), ct.AtmosphericDomain.create(*DOMAIN)
    jg = JGas.from_lines(jl, CONC, nu, jd)
    tg = ct.Gas.from_lines(tl, CONC, nu, td)
    Pe = ct.pressuregrid(PT, PS, 12)
    Te = np.maximum(288.0 * (Pe / PS) ** (R_GAS / (MU * CP)), 160.0)
    span = float(nu[-1] - nu[0])
    return dict(jl=jl, tl=tl, nu=nu, jd=jd, td=td, jg=jg, tg=tg,
                js=jg.split_precision(16), ts=tg.split_precision(16), Pe=Pe, Te=Te,
                fS_j=lambda v: jnp.full(jnp.shape(v), S0 / span),
                fS_t=lambda v: torch.full_like(v, S0 / span))


def _states(n=64, seed=3):
    rng = np.random.default_rng(seed)
    return rng.uniform(150.0, 350.0, n), np.exp(rng.uniform(np.log(9.0), np.log(1.01e5), n))


@pytest.mark.parametrize("what", ["cheb_basis", "cheb_coeff_matrix", "cheb2d_coeffs",
                                  "cheb2d_eval", "domain"])
def test_chebyshev_helpers_and_domain_match(what):
    rng = np.random.default_rng(11)
    t = torch.from_numpy
    if what == "cheb_basis":
        x = rng.uniform(150.0, 350.0, 50)
        a, b = np.asarray(jinterp.cheb_basis(x, 150.0, 350.0, 12)), \
            tinterp.cheb_basis(t(x), 150.0, 350.0, 12).numpy()
    elif what == "cheb_coeff_matrix":
        a, b = jinterp.cheb_coeff_matrix(24), tinterp.cheb_coeff_matrix(24)
    elif what == "cheb2d_coeffs":
        v = rng.normal(-60.0, 5.0, (7, 12, 24))
        a, b = np.asarray(jinterp.cheb2d_coeffs(v)), tinterp.cheb2d_coeffs(t(v)).numpy()
    elif what == "cheb2d_eval":
        c = rng.normal(0.0, 1.0, (5, 12, 24))
        x, y = rng.uniform(150.0, 350.0, 40), rng.uniform(2.0, 11.0, 40)
        a = np.asarray(jinterp.cheb2d_eval(c, x, 150.0, 350.0, y, 2.0, 11.0))
        b = tinterp.cheb2d_eval(t(c), t(x), 150.0, 350.0, t(y), 2.0, 11.0).numpy()
    else:
        jd, td = JDomain.create(*DOMAIN), ct.AtmosphericDomain.create(*DOMAIN)
        for f in ("Tmin", "Tmax", "nT", "Pmin", "Pmax", "nP"):
            assert getattr(jd, f) == getattr(td, f)
        a, b = np.concatenate([jd.T, jd.P]), np.concatenate([td.T, td.P])
        with pytest.raises(ValueError):
            ct.AtmosphericDomain.create((10.0, 350.0))   # below the TIPS range
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-12 * np.abs(a).max())


@pytest.fixture(scope="module")
def grids(tab):
    """Both packages' sigma grids on every fifth point of the table grid."""
    nu = tab["nu"][::5]
    sj = np.asarray(jgas_mod.bake_sigma_grid(tab["jl"], CONC, nu, tab["jd"], backend="oracle"))
    st = tgas_mod.bake_sigma_grid(tab["tl"], CONC, nu, tab["td"])
    return sj, st


def test_bake_sigma_grid_matches_oracle(tab, grids):
    sj, st = grids
    assert st.shape == sj.shape == (12, 24, 300)
    assert (sj > 0).mean() > 0.25   # the gaps between the bands are zero
    np.testing.assert_allclose(st, sj, rtol=1e-9, atol=0.0)
    with pytest.raises(ValueError, match=r"\[0,1\]"):
        tgas_mod.bake_sigma_grid(tab["tl"], lambda T, P: 2.0 * torch.ones_like(T),
                                 tab["nu"][:50], tab["td"])


@pytest.mark.parametrize("twin", ["host", "device"])
def test_ln_sigma_coeffs_match(tab, grids, twin):
    sigma = grids[0].copy()
    sigma[..., 0] = 0.0           # all-zero column: the constant log(tiny)
    sigma[..., 1] *= 1e-300       # a column under the float32 floor
    sigma[0, 0, 2] = 0.0          # one zero node under a 1e-20-of-peak clip
    if twin == "host":
        a = jgas_mod._ln_sigma_coeffs(sigma, tab["jd"])
        b = tgas_mod._ln_sigma_coeffs(sigma, tab["td"])
    else:
        a = np.asarray(jgas_mod._ln_sigma_coeffs_device(sigma, tab["jd"]))
        b = tgas_mod._ln_sigma_coeffs_device(torch.from_numpy(sigma), tab["td"]).numpy()
    assert b.shape == a.shape == (288, 300)
    peak = np.abs(a).max(axis=0)
    assert np.all(np.abs(b - a) <= 1e-9 * peak)


@pytest.mark.parametrize("mode", ["full", "split"])
def test_raw_sigma_matches(tab, mode):
    jgas, tgas = (tab["jg"], tab["tg"]) if mode == "full" else (tab["js"], tab["ts"])
    T, P = _states()
    a = np.asarray(jgas.raw_sigma(T, P))
    b = tgas.raw_sigma(torch.from_numpy(T), torch.from_numpy(P)).numpy()
    assert b.shape == a.shape == (64, 1500)
    np.testing.assert_allclose(b, a, rtol=1e-9, atol=SUBNORMAL)
    # batch shapes broadcast as in the JAX package
    b2 = tgas.raw_sigma(torch.from_numpy(T[:8]).reshape(2, 4), torch.tensor(P[0]))
    np.testing.assert_allclose(b2.numpy(), np.asarray(jgas.raw_sigma(T[:8].reshape(2, 4),
                                                                     P[0])),
                               rtol=1e-9, atol=SUBNORMAL)


def test_split_precision_matches(tab):
    # the port's own bake picks the JAX lead rows
    assert tab["ts"].lead_idx == tab["js"].lead_idx
    assert tab["ts"].tail_idx == tab["js"].tail_idx
    # on identical full coefficients the bfloat16 tail is bitwise the JAX one
    ts = convert.gas(tab["jg"], CONC, dtype=torch.float64, device="cpu").split_precision(16)
    assert ts.lead_idx == tab["js"].lead_idx
    assert ts.coeffs_tail.dtype == torch.bfloat16
    np.testing.assert_array_equal(ts.coeffs_tail.float().numpy(),
                                  np.asarray(tab["js"].coeffs_tail).astype(np.float32))
    np.testing.assert_array_equal(ts.coeffs.numpy(), np.asarray(tab["js"].coeffs))
    with pytest.raises(ValueError):
        ts.split_precision(16)
    with pytest.raises(ValueError):
        tab["tg"].split_precision(288)


@pytest.mark.parametrize("kind", ["select", "reconcentrate", "opacity_error"])
def test_gas_methods_match(tab, kind):
    T, P = _states(16)
    if kind == "select":
        idx = np.arange(3, 1500, 7)
        a = np.asarray(tab["js"].select(idx).raw_sigma(T, P))
        b = tab["ts"].select(idx).raw_sigma(torch.from_numpy(T), torch.from_numpy(P)).numpy()
        assert b.shape == (16, len(idx))
    elif kind == "reconcentrate":
        a = np.asarray(tab["jg"].reconcentrate(0.4)(T, P))
        b = tab["tg"].reconcentrate(0.4)(torch.from_numpy(T), torch.from_numpy(P)).numpy()
        with pytest.raises(ValueError):
            tab["tg"].reconcentrate(lambda T_, P_: 1.5 * torch.ones_like(T_))
    else:
        i = int(np.argmax(np.asarray(tab["jg"].coeffs)[0]))
        ja = jgas_mod.opacity_error(tab["jg"], tab["jl"], i, N=20)
        tb = tgas_mod.opacity_error(tab["tg"], tab["tl"], i, N=20)
        for x, y in zip(ja[:2], tb[:2]):
            np.testing.assert_allclose(y, x, rtol=1e-12)
        assert np.nanmax(np.abs(tb[3])) < 0.2    # the table's own fit error class
        # the error is table minus line sum, two values ~1e-8 apart here: hold
        # it to 1e-12 of the line sum's peak, not of its own
        exact = np.nanmax(np.abs(np.asarray(ja[2]) / np.asarray(ja[3])))
        np.testing.assert_allclose(tb[2], np.asarray(ja[2]), rtol=0, atol=1e-12 * exact)
        return
    np.testing.assert_allclose(b, a, rtol=1e-9, atol=max(1e-9 * np.abs(a).max(), SUBNORMAL))


@pytest.fixture(scope="module")
def f32(tab):
    """The split gas in float32 on both sides and the JAX test's profiles."""
    jg32 = dataclasses.replace(tab["jg"], nu=tab["jg"].nu.astype(jnp.float32),
                               coeffs=tab["jg"].coeffs.astype(jnp.float32))
    js = jg32.split_precision(16)
    ts = convert.gas(js, CONC, dtype=torch.float32, device="cpu")
    Pe32 = tab["Pe"].astype(np.float32)
    Te32 = tab["Te"].astype(np.float32)
    lnPe = jnp.log(jnp.asarray(Pe32))
    fT_j = lambda P: jinterp.interp_linear(jnp.log(P), lnPe, jnp.asarray(Te32)).astype(jnp.float32)
    Pt = torch.from_numpy(Pe32)
    fT_t = formprofile(Pt, torch.from_numpy(Te32))
    return dict(js=js, ts=ts, Pj=jnp.asarray(Pe32), Pt=Pt, fT_j=fT_j, fT_t=fT_t)


@pytest.mark.parametrize("kernel", ["K6", "K7"])
def test_fused_twins_match_pallas_interpret(f32, kernel):
    fmu = lambda T, P: MU
    before = _counts()
    if kernel == "K6":
        a = np.asarray(jft.table_olr_fused(f32["js"], f32["Pj"], G, f32["fT_j"], fmu,
                                           interpret=True))
        b = tft.table_olr_fused(f32["ts"], f32["Pt"], G, f32["fT_t"], fmu).numpy()
        assert b.dtype == np.float32 and b.shape == a.shape
        np.testing.assert_allclose(b, a, rtol=2e-5, atol=2e-5 * np.abs(a).max())
    else:
        n = f32["ts"].nu.shape[0]
        S, al = np.linspace(0.1, 0.4, n, dtype=np.float32), np.full(n, 0.3, np.float32)
        ja = jft.table_monoflux_fused(f32["js"], f32["Pj"], G, f32["fT_j"], fmu,
                                      jnp.asarray(S), jnp.asarray(al), 0.841, interpret=True)
        tb = tft.table_monoflux_fused(f32["ts"], f32["Pt"], G, f32["fT_t"], fmu,
                                      torch.from_numpy(S), torch.from_numpy(al), 0.841)
        (up_a, dn_a, tau_a), (up_b, dn_b, tau_b) = [np.asarray(x) for x in ja], \
            [x.numpy() for x in tb]
        np.testing.assert_allclose(tau_b, tau_a, rtol=3e-5, atol=1e-10)
        pk = np.abs(up_a).max()
        np.testing.assert_allclose(up_b, up_a, rtol=5e-5, atol=5e-5 * pk)
        np.testing.assert_allclose(dn_b, dn_a, rtol=5e-5, atol=5e-5 * pk)
    assert _counts() == before     # CPU tensors: the plain versions, no launch


@pytest.mark.parametrize("nlobatto,nstream", [(3, 5), (2, 8)])
def test_unfused_reference_matches(tab, nlobatto, nstream):
    """table_olr_fused_ref (raw_sigma -> layer_tau_flat -> march) against
    the JAX one in float64, and the fused route's plain version against it."""
    fmu = lambda T, P: MU
    Pt = torch.from_numpy(tab["Pe"])
    fT_t = formprofile(Pt, torch.from_numpy(tab["Te"]))
    lnPe = jnp.log(jnp.asarray(tab["Pe"]))
    fT_j = lambda P: jinterp.interp_linear(jnp.log(P), lnPe, jnp.asarray(tab["Te"]))
    a = np.asarray(jft.table_olr_fused_ref(tab["js"], jnp.asarray(tab["Pe"]), G, fT_j, fmu,
                                           nlobatto, nstream))
    b = tft.table_olr_fused_ref(tab["ts"], Pt, G, fT_t, fmu, nlobatto, nstream).numpy()
    c = tft.table_olr_fused(tab["ts"], Pt, G, fT_t, fmu, nlobatto, nstream).numpy()
    pk = np.abs(a).max()
    np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-9 * pk)
    np.testing.assert_allclose(c, b, rtol=1e-12, atol=1e-12 * pk)


def _entry(tab, pkg, name, gas):
    if pkg == "jax":
        args = (tab["Pe"], G, tab["Te"], MU)
        if name == "outgoing":
            return [np.asarray(jf.outgoing(*args, gas))]
        if name == "monochromatic_fluxes":
            return [np.asarray(x) for x in jf.monochromatic_fluxes(*args, tab["fS_j"], 0.1, gas)]
        return [np.asarray(x) for x in jf.radiate(*args, tab["fS_j"], 0.1, gas)]
    args = (tab["Pe"], G, tab["Te"], MU)
    if name == "outgoing":
        return [ct.outgoing(*args, gas).numpy()]
    if name == "monochromatic_fluxes":
        return [x.numpy() for x in ct.monochromatic_fluxes(*args, tab["fS_t"], 0.1, gas)]
    return [x.numpy() for x in ct.radiate(*args, tab["fS_t"], 0.1, gas)]


@pytest.mark.parametrize("name", ["outgoing", "monochromatic_fluxes", "radiate"])
def test_entry_points_on_a_split_gas(tab, name):
    before = _counts()
    got = _entry(tab, "torch", name, tab["ts"])
    assert _counts() == before
    ref = _entry(tab, "jax", name, tab["js"])
    with march_kernel_mode("interpret"):
        fused = _entry(tab, "jax", name, tab["js"])
    for b, a, f in zip(got, ref, fused):
        assert b.shape == a.shape
        pk = np.abs(a).max()
        np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-9 * pk)
        np.testing.assert_allclose(b, f, rtol=1e-4, atol=1e-4 * pk)


def test_mixed_stack_and_table_accuracy(tab):
    """A split gas beside a gray gas takes the unfused route (raw_sigma),
    as in the JAX package; the table's band OLR is within 1e-4 of the
    direct line sum on the same column."""
    jgray = JGray.create(1e-35, tab["nu"])
    tgray = ct.GrayGas.create(1e-35, tab["nu"], dtype=torch.float64, device="cpu")
    assert not tft.fused_table_applicable(unify_absorbers((tab["ts"], tgray)))
    a = np.asarray(jf.outgoing(tab["Pe"], G, tab["Te"], MU, tab["js"], jgray))
    b = ct.outgoing(tab["Pe"], G, tab["Te"], MU, tab["ts"], tgray).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-9 * np.abs(a).max())
    direct = ct.DirectGas.from_lines(tab["tl"], CONC, tab["nu"])
    d = ct.outgoing(tab["Pe"], G, tab["Te"], MU, direct).numpy()
    band_t, band_d = np.trapezoid(b, tab["nu"]), np.trapezoid(d, tab["nu"])
    assert abs(band_t - band_d) < 1e-4 * band_d


def test_fused_route_gate_matches(tab):
    """fused_table_applicable holds the JAX package's cases."""
    jgray = JGray.create(1e-28, tab["nu"])
    tgray = ct.GrayGas.create(1e-28, tab["nu"], dtype=torch.float64, device="cpu")
    cases = [((tab["js"],), (tab["ts"],)), ((tab["jg"],), (tab["tg"],)),
             ((tab["js"], jgray), (tab["ts"], tgray)), ((jgray,), (tgray,))]
    for jabs, tabs in cases:
        want = jft.fused_table_applicable(junify(jabs))
        assert tft.fused_table_applicable(unify_absorbers(tabs)) == want
        if len(tabs) == 1:
            assert tft.fused_table_applicable(tabs[0]) == jft.fused_table_applicable(jabs[0])
    assert [jft.fused_table_applicable(junify(j)) for j, _ in cases] == [True, False, False, False]


@pytest.mark.parametrize("column", ["top_below_domain", "surface_above_domain", "inside"])
def test_check_pressures_guards_the_table_domain(tab, column):
    Pe = {"top_below_domain": ct.pressuregrid(1.0, PS, 12),
          "surface_above_domain": ct.pressuregrid(PT, 2.0 * PS, 12),
          "inside": tab["Pe"]}[column]
    Te = np.maximum(288.0 * (Pe / Pe[-1]) ** (R_GAS / (MU * CP)), 160.0)
    gray = ct.GrayGas.create(1e-30, tab["nu"], dtype=torch.float64, device="cpu")
    stack = unify_absorbers((tab["ts"], gray))
    assert pressure_limits(stack) == (0.9 * PT, 1.01 * PS)
    assert temperature_limits(stack) == (150.0, 350.0)
    if column == "inside":
        ct.outgoing(Pe, G, Te, MU, tab["ts"])
        jf.outgoing(Pe, G, Te, MU, tab["js"])
        return
    for fn, gas in ((jf.outgoing, tab["js"]), (ct.outgoing, tab["ts"])):
        with pytest.raises(ValueError, match="gas table domain"):
            fn(Pe, G, Te, MU, gas)
    with pytest.raises(ValueError, match="gas table domain"):
        ct.radiate(Pe, G, Te, MU, 0.0, 0.1, tab["tg"])
    # a stack without a table has no pressure domain
    ct.outgoing(Pe, G, Te, MU,
                ct.GrayGas.create(1e-30, tab["nu"], dtype=torch.float64, device="cpu"))


@pytest.mark.parametrize("mode", ["full", "split"])
def test_convert_gas_round_trip(tab, mode):
    jgas = tab["jg"] if mode == "full" else tab["js"]
    g = convert.gas(jgas, CONC, dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(g.coeffs.numpy(), np.asarray(jgas.coeffs))
    np.testing.assert_array_equal(g.nu.numpy(), np.asarray(jgas.nu))
    assert (g.lead_idx, g.tail_idx) == (jgas.lead_idx, jgas.tail_idx)
    assert (g.coeffs_tail is None) == (mode == "full")
    for f in ("T", "P"):
        np.testing.assert_array_equal(getattr(g.domain, f), getattr(jgas.domain, f))
    assert (g.name, g.formula, g.mu) == (jgas.name, jgas.formula, jgas.mu)
    T, P = _states(8)
    np.testing.assert_allclose(g(torch.from_numpy(T), torch.from_numpy(P)).numpy(),
                               np.asarray(jgas(T, P)), rtol=1e-12, atol=SUBNORMAL)

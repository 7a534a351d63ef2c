"""Gas mixtures from HITRAN files in the port against the JAX package.

Synthetic CO2 and H2O line lists and a CO2-CO2 continuum, made from a seed,
are written in HITRAN's fixed-width formats and read back by both packages'
readers; the same numpy inputs then go through ``clearsky_tpu`` and
``clearsky_tpu_torch``. Bars and their reasons:

* the readers, ``from_par`` and the merge: bitwise (the same parse and the
  same sort of the same numbers);
* ``_line_params`` with concentrations, CIA tables and cross-sections:
  1e-12 (the same formulas in float64, other operation order);
* line sums, gases, stacks and the entry points in float64: 1e-9, the
  bar of the earlier slices' parity tests; baked gases at the table tests' bars
  (``raw_sigma`` rtol 1e-9);
* the routing: the decision JAX's ``sigma_from_lines_pallas`` takes,
  observed in JAX's own code, at its 6 MiB budget and at most 16 states;
* the plain versions of K1-seg, K4 and K5 in float32 against the JAX
  Pallas kernels in interpret mode: 1e-5 of each state's peak (float32
  summation order, and region 1 against w4 in K1's far wing), and in float64
  against the exact line sum: rtol 2e-3 where |sigma| > 1e-35;
* CIA in float32: within 1e-5 of float64, as
  tests/test_cia_flux.py::test_cia_survives_float32 asks of JAX.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from clearsky_tpu.absorption import cia as jcia
from clearsky_tpu.absorption.absorbers import unify_absorbers as junify
from clearsky_tpu.absorption.domain import AtmosphericDomain as JDomain
from clearsky_tpu.absorption.gas import (
    DirectGas as JDirectGas,
    Gas as JGas,
    GrayGas as JGray,
    MultiGas as JMultiGas,
    VariableGas as JVariableGas,
    WellMixedGas as JWellMixedGas,
)
from clearsky_tpu.ops import linesum_pallas as jp
from clearsky_tpu.ops.linesum import (
    _line_params as jline_params,
    build_line_window_plan as jplan,
    sigma_from_lines as jsigma,
)
from clearsky_tpu.rt import fluxes as jf
from clearsky_tpu.spectra import merge as jmerge
from clearsky_tpu.spectra.lines import SpectralLines as JLines
from clearsky_tpu.spectra.par import read_par as jread_par
import clearsky_tpu_torch as ct
from clearsky_tpu_torch import convert
from clearsky_tpu_torch.absorption import cia as tcia
from clearsky_tpu_torch.absorption.absorbers import unify_absorbers
from clearsky_tpu_torch.constants import R_GAS
from clearsky_tpu_torch.ops import linesum_strategies as ls
from clearsky_tpu_torch.ops.linesum import (
    _line_params,
    build_line_window_plan,
    sigma_from_lines,
    sigma_from_lines_auto,
)
from clearsky_tpu_torch.spectra import merge as tmerge
from clearsky_tpu_torch.spectra.lines import PER_LINE_FIELDS
from clearsky_tpu_torch.spectra.synthetic import (
    synthetic_co2_cia,
    synthetic_co2_par,
    synthetic_h2o_par,
    write_cia,
    write_par,
)

# the suite runs in several worker processes: a torch thread pool of every
# core in each of them oversubscribes the machine
torch.set_num_threads(2)

CPU64 = dict(dtype=torch.float64, device="cpu")
G, MU, CP, PS, PT = 9.8, 0.029, 1e3, 1e5, 10.0
T3, P3 = np.array([200.0, 250.0, 300.0]), np.array([10.0, 1e3, 1e5])


def f_h2o(T, P):
    """A water concentration fC(T, P), plain arithmetic so that it runs on
    JAX arrays and on tensors alike."""
    return 1e-3 * (T / 250.0) ** 2 * (P / 1e5) + 1e-6


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("hitran")
    out = {"co2": str(d / "co2.par"), "h2o": str(d / "h2o.par"), "cia": str(d / "CO2-CO2.cia")}
    write_par(out["co2"], synthetic_co2_par(600, seed=31))
    write_par(out["h2o"], synthetic_h2o_par(500, seed=32))
    write_cia(out["cia"], synthetic_co2_cia(seed=33))
    return out


@pytest.fixture(scope="module")
def cats(files):
    """Both packages' CO2 and H2O catalogs from the files (600-800 cm^-1
    for the water, where it overlaps the CO2 band)."""
    kw = {"co2": {}, "h2o": dict(numin=550.0, numax=800.0)}
    return {k: (JLines.from_par(files[k], **kw[k]),
                ct.SpectralLines.from_par(files[k], **CPU64, **kw[k])) for k in ("co2", "h2o")}


def _t(*xs, dtype=torch.float64):
    return [torch.tensor(np.asarray(x), dtype=dtype) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _of_peak(out, ref):
    pk = np.abs(ref).max(axis=-1, keepdims=True)
    return float((np.abs(out - ref) / pk).max())


# --- readers and catalogs -----------------------------------------------------

@pytest.mark.parametrize("strings", [True, False])
def test_read_par_matches_jax(files, strings):
    """Every column, bitwise; JAX's strings=False path is its C++ parser
    where built, the port's is numpy."""
    for k in ("co2", "h2o"):
        a, b = jread_par(files[k], strings=strings), ct.read_par(files[k], strings=strings)
        assert sorted(a) == sorted(b)
        for col in a:
            assert b[col].dtype == a[col].dtype or col == "M", col
            np.testing.assert_array_equal(b[col], a[col])


FILTERS = {
    "range": dict(numin=300.0, numax=500.0),
    "Scut": dict(Scut=1e-22),
    "I_chars": dict(I=("2", "3")),
    "I_index": dict(I=(1, 3)),
    "maxlines": dict(maxlines=57),
    "all": dict(numin=600.0, Scut=1e-25, I=("1", 2), maxlines=40),
}


@pytest.mark.parametrize("name", list(FILTERS))
def test_read_par_filters_match_jax(files, name):
    kw = FILTERS[name]
    a, b = jread_par(files["h2o"], **kw), ct.read_par(files["h2o"], **kw)
    for col in a:
        np.testing.assert_array_equal(b[col], a[col])
    assert np.all(np.diff(b["nu"]) >= 0)
    full = ct.read_par(files["h2o"])
    if "maxlines" in kw and name == "maxlines":
        assert len(b["nu"]) == 57
        assert b["S"].min() >= np.sort(full["S"])[-57]
    if "I" in kw and name != "all":
        assert 0 < len(b["nu"]) < len(full["nu"])


def test_read_par_refuses_empty_results_and_other_files(files, tmp_path):
    for read in (jread_par, ct.read_par):
        with pytest.raises(ValueError, match="filtered to nothing"):
            read(files["co2"], numin=5000.0)
    with pytest.raises(ValueError, match=".par"):
        ct.read_par(str(tmp_path / "lines.txt"))


def test_from_par_matches_jax(cats):
    for jl, tl in cats.values():
        for f in PER_LINE_FIELDS + ("tips_coeffs",):
            np.testing.assert_array_equal(getattr(tl, f).numpy(), np.asarray(getattr(jl, f)),
                                          err_msg=f)
        assert (tl.name, tl.formula, tl.M) == (jl.name, jl.formula, jl.M)


def test_merge_matches_jax(cats):
    (jc, tc), (jh, th) = cats["co2"], cats["h2o"]
    jm, jptr = jmerge.merge_catalogs([jc, jh])
    tm, tptr = tmerge.merge_catalogs([tc, th])
    for f in PER_LINE_FIELDS + ("tips_coeffs",):
        np.testing.assert_array_equal(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(tptr.numpy(), np.asarray(jptr))
    assert (tm.name, tm.formula) == (jm.name, jm.formula)
    _, jconc = jmerge.merge_lines([(jc, 4e-4), (jh, 0.01)])
    _, tconc = tmerge.merge_lines([(tc, 4e-4), (th, 0.01)])
    np.testing.assert_array_equal(tconc.numpy(), np.asarray(jconc))
    with pytest.raises(ValueError, match=r"\[0,1\]"):
        tmerge.merge_lines([(tc, 1.5)])


def test_merge_keeps_two_float_positions(cats):
    """A float32 merge carries each catalog's float32 residuals: hi + lo
    is the float64 position to ~1e-11 relative."""
    (_, tc), (_, th) = cats["co2"], cats["h2o"]
    m32, _ = tmerge.merge_catalogs([tc.to(torch.float32), th.to(torch.float32)])
    m64, _ = tmerge.merge_catalogs([tc, th])
    assert m32.nu.dtype == torch.float32
    np.testing.assert_allclose(m32.positions64(), m64.positions64(), rtol=1e-11, atol=0.0)


@pytest.mark.parametrize("kind", ["per_line", "per_state"])
def test_line_params_with_concentrations(cats, kind):
    (jc, tc), (jh, th) = cats["co2"], cats["h2o"]
    jm, jptr = jmerge.merge_catalogs([jc, jh])
    tm, _ = tmerge.merge_catalogs([tc, th])
    rng = np.random.default_rng(5)
    shape = (jm.n_lines,) if kind == "per_line" else (3, jm.n_lines)
    conc = rng.uniform(1e-6, 0.9, shape)
    a = jline_params(jm, *_j(T3, P3, P3), conc=jnp.asarray(conc))
    b = _line_params(tm, *_t(T3, P3, P3), conc=torch.tensor(conc))
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-12, atol=0.0)


# --- gases --------------------------------------------------------------------

def _multigas_pair(cats, fixed):
    (jc, tc), (jh, th) = cats["co2"], cats["h2o"]
    nu = np.linspace(550.0, 800.0, 900)
    fc = 0.01 if fixed else f_h2o
    return (JMultiGas.from_lines([(jc, 4e-4), (jh, fc)], nu),
            ct.MultiGas.from_lines([(tc, 4e-4), (th, fc)], nu), nu)


@pytest.mark.parametrize("fixed", [True, False])
def test_multigas_raw_sigma_matches_jax(cats, fixed):
    jm, tm, _ = _multigas_pair(cats, fixed)
    assert (tm.conc is None) == (not fixed) and (tm.mol_ptr is None) == fixed
    a = np.asarray(jm.raw_sigma(*_j(T3, P3)))
    b = tm.raw_sigma(*_t(T3, P3)).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-9, atol=0.0)
    # batch shapes broadcast, and the concentration is 1 (folded per line)
    T2 = T3[:2].reshape(2, 1)
    np.testing.assert_allclose(tm.raw_sigma(*_t(T2, P3)).numpy(),
                               np.asarray(jm.raw_sigma(*_j(T2, P3))), rtol=1e-9, atol=0.0)
    assert torch.equal(tm.concentration(*_t(T3, P3)), torch.ones(3, dtype=torch.float64))
    assert [c.formula for c in tm.components()] == ["CO2", "H2O"]


def test_multigas_takes_strategy_and_ignores_it(cats):
    """As in the JAX package, ``strategy`` is accepted and not stored."""
    jc, tc = cats["co2"]
    nu = np.linspace(550.0, 800.0, 300)
    mg = ct.MultiGas.from_lines([(tc, 0.5)], nu, strategy="lane")
    assert mg.strategy == "auto" == JMultiGas.from_lines([(jc, 0.5)], nu, strategy="lane").strategy
    with pytest.raises(ValueError, match="unknown"):
        ct.MultiGas.from_lines([(tc, 0.5)], nu, strategy="fast")


DOMAIN = ((150.0, 350.0), 4, (0.9 * PT, 1.01 * PS), 6)


@pytest.mark.parametrize("kind", ["from_par", "well_mixed", "variable"])
def test_table_gases_from_par_match_jax(files, kind):
    nu = np.linspace(550.0, 800.0, 400)
    jd, td = JDomain.create(*DOMAIN), ct.AtmosphericDomain.create(*DOMAIN)
    kw = dict(maxlines=300)
    if kind == "from_par":
        jg = JGas.from_par(files["co2"], 0.9, nu, jd, **kw)
        tg = ct.Gas.from_par(files["co2"], 0.9, nu, td, **CPU64, **kw)
    elif kind == "well_mixed":
        jg = JWellMixedGas(files["co2"], 4e-4, nu, jd, **kw)
        tg = ct.WellMixedGas(files["co2"], 4e-4, nu, td, **CPU64, **kw)
        with pytest.raises(ValueError):
            ct.WellMixedGas(files["co2"], 1.2, nu, td, **CPU64)
    else:
        jg = JVariableGas(files["h2o"], f_h2o, nu, jd, **kw)
        tg = ct.VariableGas(files["h2o"], f_h2o, nu, td, **CPU64, **kw)
        with pytest.raises(TypeError):
            ct.VariableGas(files["h2o"], 0.1, nu, td, **CPU64)
    rng = np.random.default_rng(7)
    T, P = rng.uniform(150.0, 350.0, 16), np.exp(rng.uniform(np.log(9.0), np.log(1.01e5), 16))
    np.testing.assert_allclose(tg.raw_sigma(*_t(T, P)).numpy(), np.asarray(jg.raw_sigma(T, P)),
                               rtol=1e-9, atol=1e-300)
    np.testing.assert_allclose(tg(*_t(T, P)).numpy(), np.asarray(jg(*_j(T, P))), rtol=1e-9,
                               atol=1e-300)


# --- CIA ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def cia(files):
    data_j, data_t = jcia.read_cia(files["cia"]), ct.read_cia(files["cia"])
    return data_j, data_t


def test_read_cia_and_tables_match_jax(cia):
    data_j, data_t = cia
    assert len(data_t) == len(data_j) == 7
    for a, b in zip(data_j, data_t):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                np.testing.assert_array_equal(b[k], a[k])
            elif isinstance(a[k], float) and math.isnan(a[k]):
                assert math.isnan(b[k])
            else:
                assert b[k] == a[k], k
    for singles in (False, True):
        for extrapolate in (False, True):
            jt = jcia.CIATables.from_data(data_j, extrapolate=extrapolate, singles=singles)
            tt = tcia.CIATables.from_data(data_t, extrapolate=extrapolate, singles=singles)
            assert (tt.name, tt.formulae) == (jt.name, jt.formulae) == ("CO2-CO2", ("CO2", "CO2"))
            for gj, gt in zip(jt.grids + jt.singles_data, tt.grids + tt.singles_data):
                for x, y in zip(gj, gt):
                    np.testing.assert_array_equal(np.asarray(y), np.asarray(x))
            for nu, T in ((100.0, 250.0), (700.0, 399.0), (1300.0, 296.0), (60.0, 180.0),
                          (2000.0, 300.0), (1.0, 200.0)):
                a, b = jt(nu, T), tt(nu, T)
                assert b == pytest.approx(a, rel=1e-12, abs=0.0)
    with pytest.raises(ValueError, match="mixed symbols"):
        tcia.CIATables.from_data([data_t[0], dict(data_t[-1], symbol="N2-N2")])


@pytest.mark.parametrize("singles,extrapolate", [(False, False), (True, False), (True, True)])
def test_bound_cia_matches_jax(cia, singles, extrapolate):
    data_j, data_t = cia
    nu = np.linspace(20.0, 1500.0, 700)
    jb = jcia.CIATables.from_data(data_j, extrapolate, singles).bind(nu)
    tb = tcia.CIATables.from_data(data_t, extrapolate, singles).bind(nu, **CPU64)
    for x, y in zip(jb.logk + jb.T + jb.s_logk, tb.logk + tb.T + tb.s_logk):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-12, atol=0.0)
    T = np.array([150.0, 200.0, 263.3, 400.0, 450.0]).reshape(5, 1)   # in and out of range
    for scale in (0.0, float(np.log(ct.constants.LOSCHMIDT))):
        a, b = np.asarray(jb.k(jnp.asarray(T), scale=scale)), tb.k(*_t(T), scale=scale).numpy()
        assert b.shape == a.shape == (5, 1, 700)
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=0.0)
    k = tb.k(*_t(T))
    Pa, P1 = 5e4, 3e4
    np.testing.assert_allclose(
        tcia.cia_xsec(k, *_t(T), Pa, P1, P1).numpy(),
        np.asarray(jcia.cia_xsec(jb.k(jnp.asarray(T)), jnp.asarray(T), Pa, P1, P1)),
        rtol=1e-12, atol=0.0)
    kLo = tb.k(*_t(T), scale=float(np.log(ct.constants.LOSCHMIDT)))
    np.testing.assert_allclose(tcia.cia_xsec_scaled(kLo, *_t(T), Pa, P1, P1).numpy(),
                               tcia.cia_xsec(k, *_t(T), Pa, P1, P1).numpy(), rtol=1e-12, atol=0.0)


def test_cia_pair_matches_jax_and_refuses_bad_pairs(cia):
    data_j, data_t = cia
    nu = np.linspace(20.0, 1500.0, 300)
    jb = jcia.CIATables.from_data(data_j).bind(nu)
    tb = tcia.CIATables.from_data(data_t).bind(nu, **CPU64)
    jg = dataclasses.replace(JGray.create(1e-30, nu), formula="CO2")
    tg = dataclasses.replace(ct.GrayGas.create(1e-30, nu, **CPU64), formula="CO2")
    jpair, tpair = jcia.CIA.pair(jb, (jg,)), tcia.CIA.pair(tb, (tg,))
    assert tpair.g1.formula == tpair.g2.formula == "CO2" and tpair.name == "CO2-CO2"
    T, P = np.array([180.0, 250.0, 330.0]), np.array([1e3, 3e4, 1e5])
    np.testing.assert_allclose(tpair.sigma(*_t(T, P)).numpy(),
                               np.asarray(jpair.sigma(*_j(T, P))), rtol=1e-12, atol=0.0)
    with pytest.raises(ValueError, match="missing"):
        tcia.CIA.pair(tb, (dataclasses.replace(tg, formula="N2"),))
    with pytest.raises(ValueError, match="duplicate"):
        tcia.CIA.pair(tb, (tg, tg))


@pytest.fixture(scope="module")
def stacks(cats, files):
    jm, tm, nu = _multigas_pair(cats, fixed=False)
    jt = jcia.CIATables.from_file(files["cia"], singles=True)
    tt = ct.CIATables.from_file(files["cia"], singles=True)
    return jm, tm, jt, tt, nu


def test_stack_with_cia_matches_jax(stacks):
    jm, tm, jt, tt, nu = stacks
    ja, ta = junify((jm, jt)), unify_absorbers((tm, tt))
    assert len(ta.cias) == 1 and ta.cias[0].g1.formula == "CO2"
    assert ta.cias[0].g1.fC is tm.fCs[0]
    T, P = np.array([160.0, 250.0, 288.0]), np.array([1e2, 1e4, 1e5])
    a = np.asarray(ja.sigma(*_j(T, P)))
    b = ta.sigma(*_t(T, P)).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-9, atol=0.0)
    assert np.all(b >= unify_absorbers((tm,)).sigma(*_t(T, P)).numpy())
    # CIA needs its gases: H2O-only stacks cannot pair CO2-CO2
    with pytest.raises(ValueError, match="missing"):
        unify_absorbers((ct.MultiGas.from_lines([(ct.SpectralLines.from_par_dict(
            synthetic_h2o_par(50, seed=1), **CPU64), 0.01)], nu), tt))


@pytest.mark.parametrize("entry", ["outgoing", "radiate"])
def test_entry_points_on_a_mixture_with_cia_match_jax(stacks, entry):
    jm, tm, jt, tt, nu = stacks
    Pe = ct.pressuregrid(PT, PS, 12)
    Te = np.maximum(288.0 * (Pe / PS) ** (R_GAS / (MU * CP)), 160.0)
    span = float(nu[-1] - nu[0])
    if entry == "outgoing":
        a = np.asarray(jf.outgoing(Pe, G, Te, MU, jm, jt))
        b = ct.outgoing(Pe, G, Te, MU, tm, tt).numpy()
        c = ct.outgoing(Pe, G, Te, MU, tm).numpy()
        assert np.trapezoid(b, nu) < np.trapezoid(c, nu)     # CIA lowers the OLR
    else:
        a = np.asarray(jf.radiate(Pe, G, Te, MU, lambda v: jnp.full(jnp.shape(v), 300.0 / span),
                                  0.1, jm, jt).M_up)
        b = ct.radiate(Pe, G, Te, MU, lambda v: torch.full_like(v, 300.0 / span), 0.1, tm,
                       tt).M_up.numpy()
    np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-9 * np.abs(a).max())


def test_cia_survives_float32(stacks):
    """k ~ 1e-44 is below float32's normal range: through k Lo the float32
    cross-section stays within 1e-5 of float64 (on the CPU, where torch
    keeps subnormals, k itself would keep only a few bits: shown beside).
    The bound tables are float64 whatever the dtype asked for, so this
    covers the float32 conversion (k Lo, cia_xsec_scaled) and the final
    cast, not a float32 table."""
    _, _, _, tt, nu = stacks
    T, P = np.array([160.0, 250.0, 300.0, 390.0]), np.array([1e2, 1e4, 5e4, 1e5])
    out = {}
    for dt in (torch.float32, torch.float64):
        g = dataclasses.replace(ct.GrayGas.create(1e-30, nu, dtype=dt, device="cpu"),
                                formula="CO2")
        pair = tcia.CIA.pair(tt.bind(nu, dtype=dt, device="cpu"), (g,))
        Tt, Pt = _t(T, P, dtype=dt)
        out[dt] = (pair.sigma(Tt, Pt).double().numpy(),
                   tcia.cia_xsec(pair.tables.k(Tt), Tt[:, None], Pt[:, None], 0.9 * Pt[:, None],
                                 0.9 * Pt[:, None]).double().numpy())
    s32, s64 = out[torch.float32][0], out[torch.float64][0]
    assert out[torch.float32][0].dtype == np.float64 and np.all(np.isfinite(s32))
    m = s64 > 1e-30 * s64.max()
    assert s64.max() > 1e-30 and np.all(s32[m] > 0.0)
    assert np.max(np.abs(s32[m] - s64[m]) / s64[m]) < 1e-5
    naive32, naive64 = out[torch.float32][1], out[torch.float64][1]
    mn = naive64 > 1e-30 * naive64.max()
    assert np.max(np.abs(naive32[mn] - naive64[mn]) / naive64[mn]) > 1e-5


# --- routing and the plain versions of K1-seg, K4, K5 ---------------------------

class _Taken(Exception):
    pass


def _jax_decision(monkeypatch, jpl, jl, T, P, strategy, limit):
    """The route ``sigma_from_lines_pallas`` takes, observed in JAX's code:
    its segmented and coarse entry functions and its kernels are replaced by spies
    that stop the call and name themselves."""
    def stop(name):
        def spy(*a, **k):
            raise _Taken(name)
        return spy

    def grouped(kern, *a, **k):
        shape, split = kern.args[0], kern.args[4]
        if kern.args[7] == ("farall",):
            raise _Taken("stencil")
        raise _Taken("nosplit" if shape in jp._SPLIT_SHAPES and not split else "grouped")

    def pallas_call(kern, *a, **k):
        raise _Taken({"_kernel_resident": "lane", "_kernel": "gathered"}[kern.func.__name__])

    monkeypatch.setattr(jp, "_pallas_sigma_segmented", stop("segmented"))
    monkeypatch.setattr(jp, "_coarse_core", stop("coarse"))
    monkeypatch.setattr(jp, "_grouped_call", grouped)
    monkeypatch.setattr(jp.pl, "pallas_call", pallas_call)
    try:
        jp.sigma_from_lines_pallas(jpl, jl, *_j(T, P, 0.5 * P), interpret=True,
                                   strategy=strategy, resident_limit=limit)
    except _Taken as taken:
        return str(taken)
    finally:
        monkeypatch.undo()
    raise AssertionError("JAX took no route")


@pytest.fixture(scope="module")
def big():
    """3,000 CO2 lines (seed 8) on a 1,024-point band grid and a 4,096-point
    grid (where the coarse split's geometry accepts)."""
    par = synthetic_co2_par(3000, seed=8)
    jl = JLines.from_par_dict(par)
    tl = ct.SpectralLines.from_par_dict(par, **CPU64)
    out = {}
    for name, n in (("band", 1024), ("dense", 4096)):
        nu = np.linspace(560.0, 780.0, n)
        out[name] = (jplan(nu, np.asarray(jl.nu), 25.0),
                     build_line_window_plan(nu, tl.positions64(), 25.0))
    return jl, tl, out


MIB6 = ls.JAX_RESIDENT_LIMIT
# (grid, strategy, states, budget, the route)
ROUTE_CASES = {
    "resident": ("band", "grouped", 4, MIB6, "grouped"),
    "resident_stencil": ("band", "auto", 16, MIB6, "stencil"),
    "coarse": ("dense", "coarse", 8, MIB6, "coarse"),
    "coarse_too_big": ("dense", "coarse", 16, 500_000, "segmented"),
    "auto_too_big": ("dense", "auto", 16, 400_000, "segmented"),
    "segmented": ("band", "grouped", 16, 400_000, "segmented"),
    "stencil_to_segmented": ("band", "stencil", 16, 400_000, "segmented"),
    "lane": ("band", "lane", 16, MIB6, "lane"),
    "lane_to_gathered": ("band", "lane", 16, 200_000, "gathered"),
    "gathered": ("band", "gathered", 2, MIB6, "gathered"),
    "no_segment_gathered": ("band", "grouped", 16, 100_000, "gathered"),
    "nosplit": ("band", "nosplit", 4, MIB6, "nosplit"),
    "nosplit_card_budget": ("dense", "nosplit", 57, ls.H100_L2_BYTES, "nosplit"),
    "nosplit_segmented": ("band", "nosplit", 16, 2_000_000, "segmented"),
    "nosplit_gathered": ("band", "nosplit", 16, 100_000, "gathered"),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_route_matches_jax_decision(big, monkeypatch, case):
    grid, strategy, n, limit, want = ROUTE_CASES[case]
    jl, tl, plans = big
    jpl, tpl = plans[grid]
    T, P = np.linspace(180.0, 300.0, n), np.geomspace(10.0, 1e5, n)
    got = ls.route(tpl, tl, "voigt", strategy, n_states=n, resident_limit=limit)
    assert got == want
    assert _jax_decision(monkeypatch, jpl, jl, T, P, strategy, limit) == want
    if got == "segmented":
        # the segments' pack: the split mode's, or the no-split sweep's
        cost_as = "nosplit" if strategy == "nosplit" else "auto"
        lane_cost = jp._grouped_lane_cost("voigt", cost_as, n)
        assert ls._resolve(tpl, tl, "voigt", strategy, n, limit)[1] == jp._segment_cap(
            "voigt", cost_as, n, limit, jpl.slab)
        assert ls._resident_bytes_est(tl.n_lines, tpl.slab, lane_cost) == \
            jp._resident_bytes_est(jl.n_lines, jpl.slab, lane_cost)


def test_default_budget_is_the_l2_cache(big):
    """Without a card the budget is the H100's 50 MiB L2; chip_smoke's
    5,599-line shapes keep their routes under it."""
    _, tl, plans = big
    assert ls.resident_budget("cpu") == 50 * 2**20 == ls.resident_budget("cpu", 50 * 2**20)
    assert ls.route(plans["dense"][1], tl, "voigt", "coarse", n_states=57) == "coarse"
    assert ls.route(plans["band"][1], tl, "voigt", "grouped", n_states=57) == "grouped"


@pytest.fixture(scope="module")
def mix(cats):
    """The fixed-concentration mixture of the two files on 700 points, its
    catalog in float32, and three states."""
    jm, tm, _ = _multigas_pair(cats, fixed=True)
    return jm, tm


@pytest.mark.parametrize("strategy,limit,route", [("grouped", 40_000, "segmented"),
                                                  ("lane", None, "lane"),
                                                  ("gathered", None, "gathered")])
@pytest.mark.parametrize("conc", ["per_line", "per_state"])
def test_plain_routes_match_pallas_and_the_exact_sum(mix, strategy, limit, route, conc):
    """K1-seg, K4 and K5's plain versions in float32 against JAX's Pallas
    kernels in interpret mode (forced to segments by a small budget), and
    in float64 against the exact line sum, with per-line and per-state
    concentrations."""
    jm, tm = mix
    jl, tl, jpl, tpl = jm.lines, tm.lines, jm.plan, tm.plan
    c = np.asarray(jm.conc)
    if conc == "per_state":
        c = c[None, :] * np.array([1.0, 0.5, 2.0])[:, None]
    ker = np.asarray(jp.sigma_from_lines_pallas(jpl, jl, *_j(T3, P3, P3), interpret=True,
                                                conc=jnp.asarray(c), strategy=strategy,
                                                resident_limit=limit))
    name, param = ls._resolve(tpl, tl, "voigt", strategy, 3, limit)
    assert name == route
    plain = {"segmented": lambda *a, **k: ls.sigma_segmented_plain(*a, param, **k),
             "lane": ls.sigma_lane_plain, "gathered": ls.sigma_gathered_plain}[route]
    if route == "segmented":
        assert len(ls.segments(tpl, tl.n_lines, param)) >= 3
    t32 = tl.to(torch.float32)
    out32 = plain(tpl, t32, *_t(T3, P3, P3, dtype=torch.float32),
                  conc=torch.tensor(c, dtype=torch.float32)).double().numpy()
    assert _of_peak(out32, ker) < 1e-5
    out = plain(tpl, tl, *_t(T3, P3, P3), conc=torch.tensor(c)).numpy()
    ref = np.asarray(jsigma(jpl, jl, *_j(T3, P3, P3), conc=jnp.asarray(c)))
    m = np.abs(ref) > 1e-35
    np.testing.assert_allclose(out[m], ref[m], rtol=2e-3, atol=0.0)
    assert np.all(np.abs(out[~m]) < 1e-30)


def test_segments_cover_every_window_pair_once(big):
    """Each (block, line) pair of the plan's windows lies in exactly one
    segment's clipped window; segments that meet no block are skipped."""
    _, tl, plans = big
    plan = plans["band"][1]
    for L_seg in (128, 1000, 5000):
        hits = np.zeros((plan.n_blocks, tl.n_lines), dtype=np.int64)
        for s in ls.segments(plan, tl.n_lines, L_seg):
            for k, (a, c) in enumerate(s.windows):
                hits[s.blo + k, s.a + a: s.a + a + c] += 1
        want = np.zeros_like(hits)
        for b, (a, c) in enumerate(plan.windows()):
            want[b, a:a + c] = 1
        np.testing.assert_array_equal(hits, want)
    # a catalog whose first lines lie beyond the cut of every block
    nu = np.linspace(700.0, 760.0, 512)
    far = build_line_window_plan(nu, tl.positions64(), 25.0)
    segs = ls.segments(far, tl.n_lines, 256)
    assert segs[0].a > 0 and len(segs) < -(-tl.n_lines // 256)


def test_lane_and_gathered_layouts(big):
    """K4: rows padded at 1e30 cm^-1 with zero strength, starts aligned down
    to 128, empty blocks at count 0; K5: each block's slab from its start."""
    _, tl, plans = big
    plan = plans["band"][1]
    T, P = _t(T3, P3)
    S, a, g = _line_params(tl, T, P, P)
    lay = ls.lane_layout(plan, tl, S, a, g)
    n_pad = lay.nu.shape[0]
    assert n_pad % 128 == 0 and n_pad >= tl.n_lines + plan.slab + 128
    assert bool((lay.nu[tl.n_lines:] == 1e30).all()) and bool((lay.S[:, tl.n_lines:] == 0).all())
    start, cnt = lay.windows.T
    assert np.all(start % 128 == 0) and np.all(start <= plan.start)
    np.testing.assert_array_equal(cnt == 0, plan.count == 0)
    np.testing.assert_array_equal(np.where(cnt > 0, start + cnt, 0),
                                  np.where(plan.count > 0, plan.start + plan.count, 0))
    gs = ls.gathered_slabs(plan, tl, S, a, g)
    assert gs.slab_pad % 128 == 0 and gs.S.shape == (3, plan.n_blocks * gs.slab_pad)
    b = int(np.argmax(plan.count))
    s0 = int(plan.start[b])
    np.testing.assert_array_equal(gs.nu[b * gs.slab_pad: b * gs.slab_pad + plan.count[b]].numpy(),
                                  tl.nu[s0: s0 + plan.count[b]].numpy())


def test_auto_with_concentrations_on_the_cpu_is_the_exact_sum(mix):
    _, tm = mix
    T, P = _t(T3, P3)
    for strategy in ls.STRATEGIES:
        np.testing.assert_array_equal(
            sigma_from_lines_auto(tm.plan, tm.lines, T, P, None, conc=tm.conc,
                                  strategy=strategy).numpy(),
            sigma_from_lines(tm.plan, tm.lines, T, P, P, conc=tm.conc).numpy())


@pytest.mark.parametrize("strategy", ["lane", "gathered"])
def test_lane_and_gathered_strategies_are_taken(cats, strategy):
    """``check_strategy`` accepts both; a DirectGas stores them and is the
    exact sum on the CPU; the JAX gas's strategy converts."""
    jl, tl = cats["co2"]
    nu = np.linspace(550.0, 800.0, 500)
    gas = ct.DirectGas.from_lines(tl, 0.9, nu, strategy=strategy)
    assert gas.strategy == strategy
    T, P = _t(T3, P3)
    np.testing.assert_array_equal(gas.raw_sigma(T, P).numpy(),
                                  sigma_from_lines(gas.plan, tl, T, P, 0.9 * P).numpy())
    jg = JDirectGas.from_lines(jl, 0.9, nu, strategy=strategy)
    assert convert.direct_gas(jg, 0.9, **CPU64).strategy == strategy


# --- conversion ---------------------------------------------------------------

@pytest.mark.parametrize("fixed", [True, False])
def test_convert_multi_gas(cats, fixed):
    jm, _, _ = _multigas_pair(cats, fixed)
    tm = convert.multi_gas(jm, **CPU64)
    assert (tm.conc is None) == (not fixed)
    if not fixed:
        np.testing.assert_array_equal(tm.mol_ptr.numpy(), np.asarray(jm.mol_ptr))
    else:
        np.testing.assert_array_equal(tm.conc.numpy(), np.asarray(jm.conc))
        tm = convert.multi_gas(jm, fCs=(4e-4, 0.01), **CPU64)
    np.testing.assert_allclose(tm.raw_sigma(*_t(T3, P3)).numpy(),
                               np.asarray(jm.raw_sigma(*_j(T3, P3))), rtol=1e-9, atol=0.0)
    assert [c.formula for c in tm.components()] == list(jm.formulas)


def test_convert_cia(files):
    jt = jcia.CIATables.from_file(files["cia"], singles=True)
    tt = convert.cia(jt)
    assert isinstance(tt, tcia.CIATables) and tt.singles
    assert tt(700.0, 250.0) == jt(700.0, 250.0)
    nu = np.linspace(20.0, 1500.0, 200)
    tb = convert.cia(jt.bind(nu), **CPU64)
    T = np.array([210.0, 333.0])
    np.testing.assert_allclose(tb.k(*_t(T)).numpy(), np.asarray(jt.bind(nu).k(jnp.asarray(T))),
                               rtol=1e-12, atol=0.0)

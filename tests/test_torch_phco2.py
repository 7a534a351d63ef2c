"""The phco2, voigt_ref and phco2_ref line shapes of the port against the
JAX package.

The sub-Lorentzian CO2 far wing (chi of Perrin and Hartmann) and the
reference's HWHM-convention Voigt in every route of the line sum: the plain
line sum, the routing policy, and the plain version of each route (grouped,
stencil, coarse, segmented, lane, gathered), which is what the CUDA
kernels are held to on the card. Synthetic catalogs from a seed feed both
packages' ``from_par_dict``; the JAX Pallas kernels run in interpret mode.
Bars and their reasons:

* the same algorithm in float64 in both packages: 1e-12 (summation order);
* float64 routes against the exact float64 line sum: the bars of the JAX
  package's own oracle tests (tests/test_linesum_pallas.py): the exact
  layouts rtol 2e-3 where |sigma| > 1e-35; the coarse split rel 2e-3 where
  |sigma| > 1e-4 of peak, 5e-2 where > 1e-6 of peak and 1e-5 of peak
  overall; the stencil twice the split mode's own error of peak;
* float32 plain routes against the float32 Pallas routes: 1e-5 of peak
  (float32 summation order).

The kernels themselves run only on a card (tests/test_torch_kernels.py,
chip_smoke.py).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from clearsky_tpu.absorption.domain import AtmosphericDomain as JDomain
from clearsky_tpu.absorption.gas import DirectGas as JDirectGas, Gas as JGas
from clearsky_tpu.ops import lineshape as jshape
from clearsky_tpu.ops import linesum as jlinesum
from clearsky_tpu.ops import linesum_pallas as jp
from clearsky_tpu.ops.linesum import build_line_window_plan as jplan, sigma_from_lines as jsigma
from clearsky_tpu.rt.fluxes import outgoing as joutgoing
from clearsky_tpu.spectra.lines import SpectralLines as JLines
import clearsky_tpu_torch as ct
from clearsky_tpu_torch import convert
from clearsky_tpu_torch.ops import lineshape as tshape
from clearsky_tpu_torch.ops import linesum as tlinesum
from clearsky_tpu_torch.ops import linesum_strategies as ls
from clearsky_tpu_torch.ops.linesum import build_line_window_plan, sigma_from_lines
from clearsky_tpu_torch.spectra.synthetic import synthetic_co2_par

torch.set_num_threads(2)

CPU64 = dict(dtype=torch.float64, device="cpu")
SHAPES = ("voigt", "lorentz", "doppler", "phco2", "voigt_ref", "phco2_ref")
T2, P2 = np.array([200.0, 300.0]), np.array([10.0, 9e4])


@pytest.fixture(scope="module")
def cat():
    par = synthetic_co2_par(300, seed=7)
    jl = JLines.from_par_dict(par)
    return jl, convert.spectral_lines(jl, **CPU64)


def _plans(cat, nu, cut):
    jl, tl = cat
    return jplan(nu, np.asarray(jl.nu), cut), build_line_window_plan(nu, tl.positions64(), cut)


BAND = np.linspace(610.0, 780.0, 512)
DENSE = np.linspace(2300.0, 2350.0, 8192)


def _states(dtype, T=T2, P=P2):
    return [torch.tensor(x, dtype=dtype) for x in (T, P, 0.5 * P)]


def _jstates(T=T2, P=P2):
    return jnp.asarray(T), jnp.asarray(P), jnp.asarray(0.5 * P)


def _of_peak(out, ref):
    return float((np.abs(out - ref) / np.abs(ref).max(axis=1, keepdims=True)).max())


# --- the line shapes ------------------------------------------------------------

@pytest.mark.parametrize("T", [150.0, 250.0, 400.0])
def test_chi_phco2_matches_jax_and_is_continuous(T):
    dnu = np.concatenate([np.linspace(-600.0, 600.0, 4001), [3.0, 30.0, 120.0, -3.0]])
    T64 = torch.tensor(T, dtype=torch.float64)
    got = tshape.chi_phco2(torch.tensor(dnu), T64).numpy()
    want = np.asarray(jshape.chi_phco2(jnp.asarray(dnu), T))
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=0.0)
    assert float(tshape.chi_phco2(torch.tensor(0.5, dtype=torch.float64), T64)) == 1.0
    for brk in (3.0, 30.0, 120.0):
        lo, hi = (float(tshape.chi_phco2(torch.tensor(brk + e, dtype=torch.float64), T64))
                  for e in (-1e-9, 1e-9))
        assert abs(lo - hi) < 1e-8
    assert np.all(np.diff(got[2000:4001]) <= 0.0)      # decays away from the core


def test_fvoigt_ref_and_phco2_xsec_match_jax():
    rng = np.random.default_rng(4)
    dnu = rng.uniform(-40.0, 40.0, 500)
    alpha = rng.uniform(1e-4, 5e-3, 500)
    gamma = rng.uniform(1e-5, 1e-1, 500)
    t = lambda x: torch.tensor(x)
    got = tshape.fvoigt_ref(t(dnu), t(alpha), t(gamma)).numpy()
    np.testing.assert_allclose(got, np.asarray(jshape.fvoigt_ref(dnu, alpha, gamma)), rtol=1e-13)
    # the reference convention is the internal one at alpha / sqrt(ln 2)
    np.testing.assert_allclose(
        got, tshape.fvoigt(t(dnu), t(alpha) / np.sqrt(np.log(2.0)), t(gamma)).numpy(),
        rtol=1e-12)
    S = rng.uniform(1e-22, 1e-19, 500)
    got = tshape.phco2_xsec(t(dnu), torch.tensor(230.0, dtype=torch.float64), t(S), t(alpha),
                            t(gamma)).numpy()
    np.testing.assert_allclose(got, np.asarray(jshape.phco2_xsec(dnu, 230.0, S, alpha, gamma)),
                               rtol=1e-13)


def test_profiles_and_default_cuts_match_jax():
    assert tlinesum.DEFAULT_CUT == jlinesum.DEFAULT_CUT
    assert set(tlinesum.PROFILES) == set(jlinesum.PROFILES) == set(SHAPES)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_line_sum_matches_jax(cat, shape):
    """The plain line sum at the shape's default cut, float64 both sides,
    T and P of different batch shapes."""
    jl, tl = cat
    cut = tlinesum.DEFAULT_CUT[shape]
    jpl, tpl = _plans(cat, BAND, cut)
    T = np.array([[180.0], [290.0]])
    P = np.array([30.0, 3e3, 9e4])
    want = np.asarray(jsigma(jpl, jl, jnp.asarray(T), jnp.asarray(P), jnp.asarray(0.4 * P),
                             shape))
    got = sigma_from_lines(tpl, tl, torch.tensor(T), torch.tensor(P), torch.tensor(0.4 * P),
                           shape).numpy()
    # the port broadcasts (S, alpha, gamma) to one batch shape; JAX's Doppler
    # sum keeps T's, which the pressures do not change
    assert got.shape == (2, 3, BAND.shape[0])
    np.testing.assert_allclose(got, np.broadcast_to(want, got.shape), rtol=1e-12, atol=1e-300)


# --- the routing policy -----------------------------------------------------------

def _jax_route(jpl, jl, shape, strategy, n_states, limit):
    """The route of ``sigma_from_lines_pallas`` (its wrapper, its jitted
    body and ``_pallas_sigma_impl``), from the JAX package's own gates."""
    voigt = shape in ("voigt", "voigt_ref")
    split = shape in jp._SPLIT_SHAPES
    n_lines = int(jl.nu.shape[0])
    geom = jp._build_stencil_geom(jpl, jl) if split else None
    frac = 0.6
    if strategy == "coarse" and voigt and jp._coarse_far_params(jpl) is None:
        strategy = "auto"
    if strategy == "auto" and voigt:
        if (jp._coarse_far_params(jpl, frac_limit=0.2) is not None
                and jp._coarse_resident_ok(shape, n_states, n_lines, limit)):
            strategy, frac = "coarse", 0.2
        elif (jp._resident_bytes_est(n_lines, jpl.slab,
                                     jp._grouped_lane_cost(shape, "stencil", n_states)) <= limit
              and geom is not None):
            strategy = "stencil"
    if strategy == "auto" and shape.startswith("phco2"):
        strategy = "coarse"
    if strategy == "coarse":
        if (split and jp._coarse_far_params(jpl, frac_limit=frac) is not None
                and jp._coarse_resident_ok(shape, n_states, n_lines, limit)):
            return "coarse"
        strategy = "auto"
    if strategy == "stencil" and (not split or geom is None):
        strategy = "auto"
    if strategy in ("auto", "grouped", "nosplit", "stencil"):
        cost = jp._grouped_lane_cost(shape, strategy, n_states)
        if jp._resident_bytes_est(n_lines, jpl.slab, cost) <= limit:
            if strategy == "nosplit" and split:
                return "nosplit"
            return "stencil" if strategy == "stencil" else "grouped"
        if strategy == "stencil":
            strategy = "auto"
        L_seg = jp._segment_cap(shape, strategy, n_states, limit, jpl.slab)
        return "segmented" if jp.CHUNK <= L_seg < n_lines else "gathered"
    n_pad = -(-(n_lines + -(-jpl.slab // 128) * 128 + 128) // 128) * 128
    if strategy == "lane" and (3 * n_states + 2) * n_pad * 4 <= limit:
        return "lane"
    return "gathered"


# budgets: the JAX package's 6 MiB of VMEM, and two that cut this catalog's
# packs into segments or send them to the gathered kernel
LIMITS = (jp._RESIDENT_VMEM_LIMIT, 700_000, 300_000)


@pytest.mark.parametrize("limit", LIMITS)
@pytest.mark.parametrize("n_states", [2, 57, 400])
@pytest.mark.parametrize("strategy", ["auto", "grouped", "nosplit", "stencil", "coarse",
                                      "lane", "gathered"])
@pytest.mark.parametrize("shape", ["phco2", "phco2_ref", "voigt_ref"])
@pytest.mark.parametrize("grid", ["band", "dense"])
def test_route_matches_jax(cat, grid, shape, strategy, n_states, limit):
    """route() against the JAX package's decisions at the same budget:
    phco2's "auto" takes the coarse split where it accepts and never the
    stencil route; voigt_ref routes as voigt."""
    jl, tl = cat
    nu = BAND if grid == "band" else DENSE
    jpl, tpl = _plans(cat, nu, tlinesum.DEFAULT_CUT[shape])
    want = _jax_route(jpl, jl, shape, strategy, n_states, limit)
    got = ls.route(tpl, tl, shape, strategy, n_states, resident_limit=limit)
    assert got == want
    if shape == "voigt_ref":
        assert got == ls.route(tpl, tl, "voigt", strategy, n_states, resident_limit=limit)
    if shape.startswith("phco2") and strategy == "auto":
        assert got != "stencil"
        if limit == ls.JAX_RESIDENT_LIMIT:
            assert (got == "coarse") == (grid == "dense")


def test_phco2_budget_cases_are_all_reached(cat):
    """The cases above cover each of phco2's routes."""
    jl, tl = cat
    seen = set()
    for nu in (BAND, DENSE):
        _, tpl = _plans(cat, nu, 500.0)
        for strategy in ("auto", "stencil", "lane", "nosplit"):
            for n in (2, 57, 400):
                for limit in LIMITS:
                    seen.add(ls.route(tpl, tl, "phco2", strategy, n, resident_limit=limit))
    assert seen == {"coarse", "grouped", "nosplit", "stencil", "segmented", "lane", "gathered"}


# --- the routes' plain versions -----------------------------------------------------

@pytest.fixture(scope="module")
def oracle(cat):
    """Per (grid, shape): plans, the exact float64 line sum and JAX's
    interpret-mode split mode (float32)."""
    jl, _ = cat
    out = {}
    for grid, nu in (("band", BAND), ("dense", DENSE)):
        for shape in ("phco2", "voigt_ref"):
            jpl, tpl = _plans(cat, nu, tlinesum.DEFAULT_CUT[shape])
            ref = np.asarray(jsigma(jpl, jl, *_jstates(), shape))
            out[grid, shape] = (jpl, tpl, ref)
    return out


def _pallas(jpl, jl, shape, strategy, **kw):
    return np.asarray(jp.sigma_from_lines_pallas(jpl, jl, *_jstates(), shape, interpret=True,
                                                 strategy=strategy, **kw))


@pytest.mark.parametrize("shape", ["phco2", "voigt_ref"])
def test_stencil_route_matches_jax_and_oracle(cat, oracle, shape):
    jl, tl = cat
    jpl, tpl, ref = oracle["band", shape]
    assert ls.route(tpl, tl, shape, "stencil", 2) == "stencil"
    ker = _pallas(jpl, jl, shape, "stencil")
    split = _pallas(jpl, jl, shape, "grouped")
    out32 = ls.sigma_stencil_plain(tpl, tl.to(torch.float32), *_states(torch.float32),
                                   shape=shape).double().numpy()
    assert _of_peak(out32, ker) < 1e-5
    out = ls.sigma_stencil_plain(tpl, tl, *_states(torch.float64), shape=shape).numpy()
    assert _of_peak(out, ref) < max(2.0 * _of_peak(split, ref), 1e-6)
    pk = np.abs(ref).max(axis=1, keepdims=True)
    m = np.abs(ref) > 1e-2 * pk
    np.testing.assert_allclose(out[m], ref[m], rtol=2e-3, atol=0.0)
    assert np.all(np.abs(out[np.abs(ref) <= 1e-35]) < 1e-30)


@pytest.mark.parametrize("shape", ["phco2", "voigt_ref"])
def test_coarse_route_matches_jax_and_oracle(cat, oracle, shape):
    """The coarse split with its stencil fine pass (JAX's own route here)
    and with the in-kernel fine pass (the geometry's stencil suppressed)."""
    import dataclasses

    jl, tl = cat
    jpl, tpl, ref = oracle["dense", shape]
    assert ls.route(tpl, tl, shape, "auto", 2) == "coarse"
    ker = _pallas(jpl, jl, shape, "auto")
    if shape == "phco2":
        # phco2's auto is the explicit coarse split; voigt's takes its own
        # work fraction
        np.testing.assert_array_equal(ker, _pallas(jpl, jl, shape, "coarse"))
    params = ls._resolve(tpl, tl, shape, "auto", 2)[1]
    t32 = tl.to(torch.float32)
    out32 = ls.sigma_coarse_plain(tpl, t32, *_states(torch.float32), params,
                                  shape=shape).double().numpy()
    assert _of_peak(out32, ker) < 1e-5
    pk = np.abs(ref).max(axis=1, keepdims=True)
    # the oracle bars are those of JAX's test of the explicit split (a work
    # fraction of 0.6, phco2's auto)
    geom = ls.coarse_geometry(tpl, tl, ls.coarse_params(tpl, ls.EXPLICIT_COARSE_FRAC))
    assert geom.stencil is not None
    for g in (geom, dataclasses.replace(geom, stencil=None, _on_device={})):
        out = ls.coarse_route_plain(g, tl, *_states(torch.float64), shape=shape).numpy()
        rel = np.abs(out - ref) / np.maximum(np.abs(ref), 1e-300)
        assert rel[np.abs(ref) > 1e-4 * pk].max() < 2e-3
        assert rel[np.abs(ref) > 1e-6 * pk].max() < 5e-2
        assert _of_peak(out, ref) < 1e-5


@pytest.mark.parametrize("kind", ["resident", "segmented"])
@pytest.mark.parametrize("shape", ["phco2", "voigt_ref"])
def test_nosplit_matches_jax_and_oracle(cat, oracle, shape, kind):
    """K1's no-split sweep (strategy "nosplit"): its plain version (the full
    w4 at every in-cut pair on the kernel's coefficients) against the exact
    sum at 1e-12 in float64, and in float32 against JAX's interpret-mode
    no-split kernel at the line-sum bar (rtol 2e-3 where |sigma| > 1e-35,
    tests/test_linesum_pallas.py:42) and 1e-5 of peak; JAX's split mode
    within rtol 1e-4 of it (:62). Segmented: each segment sweeps without the
    split, at a budget that cuts the catalog (JAX's segment length)."""
    jl, tl = cat
    jpl, tpl, ref = oracle["band", shape]
    limit = 250_000 if kind == "segmented" else None
    name, L_seg = ls._resolve(tpl, tl, shape, "nosplit", 2, limit)
    if kind == "segmented":
        assert name == "segmented" and L_seg == jp._segment_cap(shape, "nosplit", 2, limit,
                                                                jpl.slab) < tl.n_lines
        plain = lambda l, x: ls.sigma_segmented_plain(tpl, l, *x, L_seg, shape=shape)
    else:
        assert name == "nosplit"
        plain = lambda l, x: ls.sigma_nosplit_plain(tpl, l, *x, shape=shape)
    ker = _pallas(jpl, jl, shape, "nosplit", resident_limit=limit)
    out = plain(tl, _states(torch.float64)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-300)
    out32 = plain(tl.to(torch.float32), _states(torch.float32)).double().numpy()
    m = np.abs(ref) > 1e-35
    for got in (out32, ker):
        np.testing.assert_allclose(got[m], ref[m], rtol=2e-3, atol=1e-32)
        assert np.all(np.abs(got[~m]) < 1e-30)
    assert _of_peak(out32, ker) < 1e-5
    split = _pallas(jpl, jl, shape, "grouped", resident_limit=limit)
    mk = np.abs(out32) > 1e-35
    np.testing.assert_allclose(split[mk], out32[mk], rtol=1e-4, atol=0.0)


@pytest.mark.parametrize("kind", ["grouped", "segmented", "lane", "gathered"])
@pytest.mark.parametrize("shape", ["phco2", "voigt_ref"])
def test_exact_layouts_match_jax_and_oracle(cat, oracle, shape, kind):
    """The split mode's, K1-seg's, K4's and K5's plain versions (the exact
    profile in each layout): float64 against the exact sum at 1e-12, float32
    against JAX's interpret-mode kernel of the same route at the line-sum
    bar. K1-seg at a budget that cuts the catalog into segments."""
    jl, tl = cat
    jpl, tpl, ref = oracle["band", shape]
    limit = None
    if kind == "segmented":
        limit = {"phco2": 300_000, "voigt_ref": 30_000}[shape]    # segments of 128 lines
        L_seg = ls._resolve(tpl, tl, shape, "grouped", 2, limit)[1]
        assert ls.route(tpl, tl, shape, "grouped", 2, resident_limit=limit) == "segmented"
        assert jp._segment_cap(shape, "grouped", 2, limit, jpl.slab) == L_seg < tl.n_lines
        plain = lambda l, x: ls.sigma_segmented_plain(tpl, l, *x, L_seg, shape=shape)
        ker = _pallas(jpl, jl, shape, "grouped", resident_limit=limit)
    elif kind == "grouped":
        plain = lambda l, x: sigma_from_lines(tpl, l, *x, shape=shape)
        ker = _pallas(jpl, jl, shape, "grouped")
    else:
        plain = lambda l, x: {"lane": ls.sigma_lane_plain, "gathered": ls.sigma_gathered_plain}[
            kind](tpl, l, *x, shape=shape)
        ker = _pallas(jpl, jl, shape, kind)
    out = plain(tl, _states(torch.float64)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-300)
    out32 = plain(tl.to(torch.float32), _states(torch.float32)).double().numpy()
    for got in (out32, ker):
        m = np.abs(ref) > 1e-35
        np.testing.assert_allclose(got[m], ref[m], rtol=2e-3, atol=1e-32)
        assert np.all(np.abs(got[~m]) < 1e-30)
    assert _of_peak(out32, ker) < 1e-5


def test_plain_routes_refuse_other_shapes(cat, oracle):
    jl, tl = cat
    _, tpl, _ = oracle["band", "phco2"]
    with pytest.raises(ValueError):
        ls.sigma_stencil_plain(tpl, tl, *_states(torch.float64), shape="lorentz")
    with pytest.raises(ValueError):
        ls.sigma_coarse_plain(tpl, tl, *_states(torch.float64), shape="doppler")


# --- absorbers and convert --------------------------------------------------------

def _column():
    Pe = ct.pressuregrid(10.0, 1e5, 8)
    return Pe, np.maximum(285.0 * (Pe / 1e5) ** (8.314 / (0.044 * 850.0)), 160.0)


@pytest.mark.parametrize("shape", ["phco2", "voigt_ref", "phco2_ref"])
def test_direct_gas_takes_the_shapes_and_outgoing_matches_jax(cat, shape):
    """DirectGas with the shape's default cut, and outgoing through it,
    against the JAX package (float64; the CPU takes the exact sum)."""
    jl, tl = cat
    nu = np.linspace(600.0, 800.0, 400)
    jg = JDirectGas.from_lines(jl, 0.95, nu, shape=shape)
    tg = convert.direct_gas(jg, 0.95, **CPU64)
    assert tg.shape == shape and tg.plan.cut == tlinesum.DEFAULT_CUT[shape] == jg.plan.cut
    direct = ct.DirectGas.from_lines(tl, 0.95, nu, shape=shape)
    assert direct.plan.cut == tg.plan.cut and direct.shape == shape
    Pe, Te = _column()
    want = np.asarray(joutgoing(Pe, 9.8, Te, 0.044, jg))
    got = ct.outgoing(Pe, 9.8, Te, 0.044, tg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-14)


def test_convert_carries_shape_and_cut(cat):
    jl, _ = cat
    nu = np.linspace(600.0, 800.0, 64)
    for shape, cut in (("phco2", None), ("phco2_ref", 120.0), ("voigt_ref", 10.0)):
        jg = JDirectGas.from_lines(jl, 0.9, nu, shape=shape, cut=cut)
        tg = convert.direct_gas(jg, 0.9, **CPU64)
        assert (tg.shape, tg.plan.cut) == (jg.shape, jg.plan.cut)
    from clearsky_tpu.absorption.gas import MultiGas as JMultiGas

    jm = JMultiGas.from_lines([(jl, 0.9)], nu, shape="phco2")
    tm = convert.multi_gas(jm, **CPU64)
    assert (tm.shape, tm.plan.cut) == ("phco2", 500.0)


def test_baked_phco2_gas_matches_jax(cat):
    """Gas.from_lines on a phco2 catalog (the bake on the CPU's exact sum):
    coefficients against the JAX package's, and outgoing on the table."""
    jl, tl = cat
    nu = np.linspace(600.0, 800.0, 200)
    jdom = JDomain.create((150.0, 350.0), 4, (5.0, 1.2e5), 5)
    tdom = convert.domain(jdom)
    jg = JGas.from_lines(jl, 0.95, nu, jdom, shape="phco2")
    tg = ct.Gas.from_lines(tl, 0.95, nu, tdom, shape="phco2")
    np.testing.assert_allclose(tg.coeffs.numpy(), np.asarray(jg.coeffs), rtol=1e-9, atol=1e-9)
    Pe, Te = _column()
    want = np.asarray(joutgoing(Pe, 9.8, Te, 0.044, jg))
    got = ct.outgoing(Pe, 9.8, Te, 0.044, tg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-12)

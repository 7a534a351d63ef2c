"""The spectrally sharded line-by-line gas of the port against the JAX package.

``shard_line_gas``/``ShardedLineGas`` (``absorption/sharded.py``), the device
plan and its plain line sum (``ops/linesum.py``), the sharded path's routing
(``ops/linesum_strategies.device_route``) and K1-dev's wrapper
(``ops/linesum_cuda.sigma_device``). Synthetic catalogs from a seed feed both
packages' ``SpectralLines.from_par_dict``. Bars and their reasons:

* the host set-up (slab bounds and padding, L_pad, plans, the coarse split's
  grids, meta and auto flag): equal to the JAX package's arrays, floats
  bitwise (the same float64 numpy), ``coarse_meta`` to 1e-12;
* cross-sections in float64: rtol 1e-12 against JAX's sharded gas and the
  unsharded gas (the same lines in every window, another banding; JAX's own
  bar, tests/test_parallel_lbl.py), jacfwd 1e-10 (JAX's);
* K1-dev's operands (stacked grids, window offsets, d_near a shard, output
  columns) through a plain stand-in of the launch that reads them as the
  kernel does: rtol 2e-3 where |sigma| > 1e-35 against the exact sum (the
  split mode's region 1 in the far wing, K1's bar), the coarse route rel
  2e-3 where |sigma| > 1e-4 of peak (its bar), and equal to the same
  stand-in's unsharded launch within 1e-12 of peak;
* the JAX package's device kernel in interpret mode (float32) against the
  stand-in on the same float32 operands: 1e-5 of each state's peak.

The CUDA kernel itself runs only on a card (tests/test_torch_kernels.py,
chip_smoke.py).
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from clearsky_tpu.absorption.gas import DirectGas as JDirectGas, MultiGas as JMultiGas
from clearsky_tpu.absorption.sharded import shard_line_gas as jshard
from clearsky_tpu.ops import linesum_pallas as jp
from clearsky_tpu.spectra.lines import SpectralLines as JLines
import clearsky_tpu_torch as ct
from clearsky_tpu_torch import convert
from clearsky_tpu_torch.absorption.sharded import shard_line_gas
from clearsky_tpu_torch.ops import linesum_cuda
from clearsky_tpu_torch.ops import linesum_strategies as ls
from clearsky_tpu_torch.ops.linesum import (
    DeviceWindowPlan,
    block_sum,
    shard_lines,
    sigma_from_lines_auto_device,
    sigma_from_lines_device,
    tile_exact,
    tile_region1,
    tile_w4,
    two_float,
)
from clearsky_tpu_torch.spectra.lines import PER_LINE_FIELDS
from clearsky_tpu_torch.spectra.synthetic import synthetic_co2_par, synthetic_h2o_par
from clearsky_tpu_torch.utils import profiling, twin

torch.set_num_threads(2)

CPU64 = dict(dtype=torch.float64, device="cpu")
T3, P3 = np.array([210.0, 260.0, 310.0]), np.array([1e2, 1e4, 9e4])


def f_h2o(T, P):
    """A water concentration fC(T, P) in plain arithmetic (JAX arrays and tensors)."""
    return 1e-3 * (T / 250.0) ** 2 * (P / 1e5) + 1e-6


def _t(*xs, dtype=torch.float64):
    return [torch.tensor(np.asarray(x, np.float64), dtype=dtype) for x in xs]


def _pair(par):
    jl = JLines.from_par_dict(par)
    return jl, ct.SpectralLines.from_par_dict(par, **CPU64)


@pytest.fixture(scope="module")
def cats():
    return {"co2": _pair(synthetic_co2_par(300, seed=5)),
            "h2o": _pair(synthetic_h2o_par(200, seed=6)),
            "dense": _pair(synthetic_co2_par(1500, seed=3)),
            "band": _pair(synthetic_co2_par(300, seed=7, bands=((2349.1, 70.0, 1.0),)))}


def _span(jl, n, margin=25.0):
    pos = np.asarray(jl.nu)
    return np.linspace(pos.min() - margin, pos.max() + margin, n)


def _lineless(jl, n):
    pos = np.asarray(jl.nu)
    span = pos.max() - pos.min()
    return np.linspace(max(pos.min() - 2 * span, 1.0), pos.max() + 2 * span, n)


# name -> (catalog, grid, shards, shape): the JAX tests' 512-point grids,
# lineless shards at both ends, a dense band where the coarse split
# engages, and phco2 with its 500 cm^-1 cut
CASES = {
    "wide": ("co2", lambda jl: _span(jl, 512), 8, "voigt"),
    "lineless": ("band", lambda jl: _lineless(jl, 512), 8, "voigt"),
    "dense": ("dense", lambda jl: np.linspace(2300.0, 2350.0, 16384), 4, "voigt"),
    "phco2": ("co2", lambda jl: _span(jl, 1024, 500.0), 4, "phco2"),
}


def _gases(cats, case):
    cat, grid, k, shape = CASES[case]
    jl, tl = cats[cat]
    nu = grid(jl)
    return (JDirectGas.from_lines(jl, 0.9, nu, shape=shape),
            ct.DirectGas.from_lines(tl, 0.9, nu, shape=shape), k)


def _multigas(cats, fixed):
    (jc, tc), (jh, th) = cats["co2"], cats["h2o"]
    nu = _span(jc, 512)
    fc = 0.01 if fixed else f_h2o
    return (JMultiGas.from_lines([(jc, 0.3), (jh, fc)], nu),
            ct.MultiGas.from_lines([(tc, 0.3), (th, fc)], nu))


def _assert_host_arrays(tg, jg):
    """The port's sharded gas holds the JAX package's host arrays."""
    for f in PER_LINE_FIELDS:
        np.testing.assert_array_equal(getattr(tg.lines, f).numpy(),
                                      np.asarray(getattr(jg.lines, f)), err_msg=f)
    tp, jpl = tg.plans, jg.plans
    for f in ("nu_blocks", "nu_blocks_lo", "start", "count", "fine_blocks", "fine_blocks_lo",
              "coarse_blocks", "coarse_blocks_lo"):
        a, b = getattr(tp, f), getattr(jpl, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    for f in ("cut", "block", "n_blocks", "slab", "n_nu", "coarse_auto"):
        assert getattr(tp, f) == getattr(jpl, f), f
    assert (tp.coarse_meta is None) == (jpl.coarse_meta is None)
    if tp.coarse_meta is not None:
        np.testing.assert_allclose(tp.coarse_meta, jpl.coarse_meta, rtol=1e-12)
        assert tp.coarse_meta[2:] == tuple(jpl.coarse_meta[2:])
    for f in ("conc", "mol_ptr"):
        a, b = getattr(tg, f), getattr(jg, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    assert (tg.n_shards, tg.k_local, tg.shape, tg.strategy) == (
        jg.n_shards, jg.k_local, jg.shape, jg.strategy)
    np.testing.assert_array_equal(tg.nu.numpy(), np.asarray(jg.nu))


@pytest.mark.parametrize("case", list(CASES))
def test_shard_host_arrays_equal_jax(cats, case):
    jgas, tgas, k = _gases(cats, case)
    jg, tg = jshard(jgas, k), shard_line_gas(tgas, k)
    _assert_host_arrays(tg, jg)
    assert tg.lines.nu.shape[-1] % 128 == 0
    if case == "dense":
        assert tg.plans.coarse_meta is not None     # the split engages here
    if case == "lineless":
        # the end shards hold no line within reach: every window is empty
        counts = tg.plans.count.numpy()
        assert counts[0].sum() == 0 and counts[-1].sum() == 0


@pytest.mark.parametrize("fixed", [True, False])
def test_shard_multigas_host_arrays_equal_jax(cats, fixed):
    jm, tm = _multigas(cats, fixed)
    _assert_host_arrays(shard_line_gas(tm, 8), jshard(jm, 8))


@pytest.mark.parametrize("case", list(CASES))
def test_raw_sigma_matches_jax_and_unsharded(cats, case):
    jgas, tgas, k = _gases(cats, case)
    tg = shard_line_gas(tgas, k)
    T, P = _t(T3, P3)
    got = tg.raw_sigma(T, P).numpy()
    ref = tgas.raw_sigma(T, P).numpy()
    jref = np.asarray(jshard(jgas, k).raw_sigma(jnp.asarray(T3), jnp.asarray(P3)))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=ref.max() * 1e-15)
    np.testing.assert_allclose(got, jref, rtol=1e-12, atol=ref.max() * 1e-15)
    # the concentration-scaled call, as the stack calls it
    np.testing.assert_allclose(tg(T, P).numpy(), tgas(T, P).numpy(), rtol=1e-12,
                               atol=ref.max() * 1e-15)


@pytest.mark.parametrize("fixed", [True, False])
def test_sharded_multigas_matches_jax(cats, fixed):
    jm, tm = _multigas(cats, fixed)
    tg = shard_line_gas(tm, 8)
    T, P = _t(T3[:2], P3[1:])
    got = tg.raw_sigma(T, P).numpy()
    ref = tm.raw_sigma(T, P).numpy()
    jref = np.asarray(jshard(jm, 8).raw_sigma(jnp.asarray(T3[:2]), jnp.asarray(P3[1:])))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=ref.max() * 1e-15)
    np.testing.assert_allclose(got, jref, rtol=1e-12, atol=ref.max() * 1e-15)
    np.testing.assert_array_equal(tg.concentration(T, P).numpy(), np.ones(2))
    with pytest.raises(ValueError, match="reconcentrate"):
        tg.reconcentrate(0.5)
    # CIA pairs with a sharded mixture through its molecules
    assert [c.formula for c in tg.components()] == ["CO2", "H2O"]


def test_sharded_plan_keeps_float64_grid(cats):
    """The shards' plans come from the gas plan's float64 grid, not from
    its (float32) ``nu``: a float32 grid moves line membership at the cut."""
    _, tgas, _ = _gases(cats, "wide")
    gas32 = dataclasses.replace(tgas, nu=tgas.nu.float())
    sg = shard_line_gas(gas32, 8)
    got = sg.plans.nu_blocks.numpy().reshape(-1)[:512]
    np.testing.assert_array_equal(got, tgas.plan.nu_blocks.reshape(-1)[:512])
    hi, lo = two_float(sg.plans.nu_blocks.numpy())
    np.testing.assert_array_equal(sg.plans.nu_blocks_lo.numpy(), lo)


def test_shard_line_gas_validation(cats):
    (_, tl) = cats["co2"]
    with pytest.raises(ValueError, match="divisible"):
        shard_line_gas(ct.DirectGas.from_lines(tl, 0.9, _span(cats["co2"][0], 510)), 8)
    gas = ct.DirectGas.from_lines(tl, 0.9, _span(cats["co2"][0], 512))
    sg = shard_line_gas(gas, 8)
    assert shard_line_gas(sg, 8) is sg
    with pytest.raises(ValueError, match="re-shard"):
        shard_line_gas(sg, 4)
    with pytest.raises(TypeError, match="DirectGas or MultiGas"):
        shard_line_gas(ct.GrayGas.create(1e-26, np.linspace(1.0, 10.0, 16), **CPU64), 2)
    # an unsharded line-by-line gas has no spectral slab
    with pytest.raises(ValueError, match="shard"):
        gas.spectral_slab(0, 64)
    with pytest.raises(ValueError, match="boundaries"):
        sg.spectral_slab(0, 60)
    # a slab of whole shards is those shards
    T, P = _t(T3, P3)
    part = sg.spectral_slab(128, 320)
    assert part.k_local == 3 and part.n_shards == 8
    np.testing.assert_allclose(part.raw_sigma(T, P).numpy(),
                               sg.raw_sigma(T, P)[:, 128:320].numpy(), rtol=1e-14, atol=0.0)


def test_reconcentrate(cats):
    _, tgas, _ = _gases(cats, "wide")
    sg = shard_line_gas(tgas, 8).reconcentrate(0.5)
    T, P = _t(T3, P3)
    ref = ct.DirectGas.from_lines(tgas.lines, 0.5, tgas.plan.nu).raw_sigma(T, P).numpy()
    np.testing.assert_allclose(sg.raw_sigma(T, P).numpy(), ref, rtol=1e-12,
                               atol=ref.max() * 1e-15)


def test_sharded_gas_jacfwd_matches_jax(cats):
    jgas, tgas, _ = _gases(cats, "wide")
    jg, tg = jshard(jgas, 4), shard_line_gas(tgas, 4)
    T, P = jnp.asarray([230.0, 300.0]), jnp.asarray([5e3, 6e4])
    Jj = np.asarray(jax.jacfwd(lambda t: jg.raw_sigma(t, P).sum(axis=-1).sum())(T))
    Pt = torch.tensor(np.asarray(P))
    Jt = torch.func.jacfwd(lambda t: tg.raw_sigma(t, Pt).sum(dim=-1).sum())(
        torch.tensor(np.asarray(T)))
    np.testing.assert_allclose(Jt.numpy(), Jj, rtol=1e-10)
    Ju = torch.func.jacfwd(lambda t: tgas.raw_sigma(t, Pt).sum(dim=-1).sum())(
        torch.tensor(np.asarray(T)))
    np.testing.assert_allclose(Jt.numpy(), Ju.numpy(), rtol=1e-10)


def test_convert_carries_the_jax_sharded_gas(cats):
    jgas, tgas, k = _gases(cats, "dense")
    jg = jshard(jgas, k)
    cg = convert.sharded_line_gas(jg, fC=0.9, **CPU64)
    own = shard_line_gas(tgas, k)
    _assert_host_arrays(cg, jg)
    for f in ("fine_windows", "coarse_windows"):
        np.testing.assert_array_equal(getattr(cg.plans, f).numpy(),
                                      getattr(own.plans, f).numpy())
    T, P = _t(T3[:2], P3[:2])
    np.testing.assert_allclose(cg.raw_sigma(T, P).numpy(), own.raw_sigma(T, P).numpy(),
                               rtol=1e-14, atol=0.0)
    jm, tm = _multigas(cats, False)
    cm = convert.sharded_line_gas(jshard(jm, 8), fCs=(0.3, f_h2o), **CPU64)
    np.testing.assert_allclose(cm.raw_sigma(T, P).numpy(), tm.raw_sigma(T, P).numpy(),
                               rtol=1e-12, atol=0.0)


def test_device_plan_from_plan_is_the_plain_sum(cats):
    """One shard's device plan over the whole catalog is the static plan."""
    _, tgas, _ = _gases(cats, "wide")
    T, P = _t(T3, P3)
    dplan = DeviceWindowPlan.from_plan(tgas.plan)
    assert dplan.n_shards == 1 and dplan.start.dim() == 1
    got = sigma_from_lines_device(dplan, tgas.lines, T, P, 0.9 * P)
    np.testing.assert_array_equal(got.numpy(), tgas.raw_sigma(T, P).numpy())
    # one unstacked shard through the dispatch
    got1 = sigma_from_lines_auto_device(dplan, tgas.lines, T, P, 0.9 * P)
    np.testing.assert_array_equal(got1.numpy(), got.numpy())
    # float32: the two-float grid of the plan
    l32 = tgas.lines.to(torch.float32)
    T32, P32 = T.float(), P.float()
    got32 = sigma_from_lines_device(dplan, l32, T32, P32, 0.9 * P32)
    ref = got.numpy()
    m = ref > 1e-35
    assert np.abs(got32.double().numpy()[m] / ref[m] - 1).max() < 2e-3


# --- routing -----------------------------------------------------------------

def test_device_route_policy(cats):
    jgas, tgas, k = _gases(cats, "dense")
    sg = shard_line_gas(tgas, k)
    p, L = sg.plans, sg.lines.nu.shape[-1]
    meta_auto = p.coarse_auto
    big = 2**30
    assert ls.device_route(p, L, "voigt", "coarse", 57, big) == "coarse"
    assert ls.device_route(p, L, "voigt", "auto", 57, big) == ("coarse" if meta_auto else "grouped")
    assert ls.device_route(dataclasses.replace(p, coarse_auto=True), L, "voigt", "auto", 57,
                           big) == "coarse"
    assert ls.device_route(p, L, "phco2", "auto", 57, big) == "coarse"
    assert ls.device_route(p, L, "lorentz", "auto", 57, big) == "grouped"
    assert ls.device_route(p, L, "lorentz", "coarse", 57, big) == "grouped"
    for strategy in ("grouped", "stencil"):
        assert ls.device_route(p, L, "voigt", strategy, 57, big) == "grouped"
    assert ls.device_route(p, L, "voigt", "nosplit", 57, big) == "nosplit"
    assert ls.device_route(p, L, "doppler", "nosplit", 57, big) == "grouped"
    assert ls.device_route(p, L, "voigt", "lane", 57, big) == "lane"
    assert ls.device_route(p, L, "voigt", "gathered", 57, big) == "gathered"
    no_split = dataclasses.replace(p, coarse_meta=None)
    assert ls.device_route(no_split, L, "phco2", "auto", 57, big) == "grouped"
    # past the budget: the split and the pack no longer fit, no segments here
    assert ls.device_route(p, L, "voigt", "coarse", 57, 4096) == "gathered"
    assert ls.device_route(p, L, "voigt", "lane", 57, 4096) == "gathered"
    with pytest.raises(ValueError, match="strategy"):
        ls.device_route(p, L, "voigt", "fast")
    # the JAX package's budget decides as JAX's gates do
    lim = ls.JAX_RESIDENT_LIMIT
    assert (ls.device_route(p, L, "voigt", "coarse", 57, lim) == "coarse") == \
        jp._coarse_resident_ok("voigt", 57, L, lim)


# --- K1-dev's operands through a plain stand-in of the launch ---------------

def _unpack(coef, mode):
    """The per-(state, line) values [n_states, n_lines] of a K1 pack
    [n_lines, n_states, n_coef] of ``mode`` (FINE's [n_lines, 2, n_states,
    4]), as the plain tiles take them: (Sia, ia, y0, A, c1, c2, k2) for the
    Voigt modes (None where the mode's pack leaves a value out), (S, alpha,
    gamma) for lorentz and doppler."""
    if mode == 4:                   # (A, 1/2 - y0^2, 2 y0^2, k2), then (Sia, ia, y0, r)
        w, c = coef[:, 0].transpose(0, 1), coef[:, 1].transpose(0, 1)
        y2 = c[..., 2] * c[..., 2]
        return (c[..., 0], c[..., 1], c[..., 2], w[..., 0], 0.5 + y2, 4.0 * y2 * w[..., 0],
                w[..., 3])
    v = coef.permute(1, 0, 2)
    cols = [v[..., i] for i in range(v.shape[-1])]
    if mode == 0:                   # (Sia, ia, y0, 0) and (A, c1, c2, k2)
        return tuple(cols[:3] + cols[4:])
    if mode in (3, 5, 6):           # the far wing's (A, c1, c2, k2) alone
        return (None, None, None, *cols)
    return tuple(cols[:3])          # (Sia, ia, y0, A): NOSPLIT; (S, alpha, gamma, 0)


def _stand_in_launch(mode, grid, lines, coef, n_states, n_out, zones, d_near=None, out=None,
                     count_as=None, bcoef=None, n_shards=1, fast=None):
    """K1's launch as the kernel reads its operands, in plain float64 torch
    (voigt family and single sweeps): shard s's block grid, window rows,
    d_near[s] and output columns; the windows index the flat catalog."""
    names = linesum_cuda._MODE_NAMES
    assert bcoef is None, "the stand-in covers the voigt family"
    z = dict(zip(("cut", "cut_f", "d_lo", "D1", "inv_D", "R1", "inv_R"), list(zones)))
    z["D2"], z["R2"] = z["D1"] + 1.0 / z["inv_D"], z["R1"] + 1.0 / z["inv_R"]
    co = _unpack(coef.double(), mode)
    win = grid["win"].long().numpy()
    n_blocks = win.shape[0] // n_shards
    hi = grid["nu_hi"].double() + grid["nu_lo"].double()
    block = hi.shape[0] // win.shape[0]
    cut = z["cut"]
    res = torch.zeros((n_states, n_shards * n_out), dtype=torch.float64)
    for s in range(n_shards):
        nb = hi[s * n_blocks * block:(s + 1) * n_blocks * block].view(n_blocks, block)
        w = win[s * n_blocks:(s + 1) * n_blocks]
        if mode in (1, 2):
            shape = names[mode]
            zl = [(0, tile_exact(shape, *co, None), lambda a, D: a <= cut, None)]
        elif mode == 0:
            dn = float(d_near[s])
            zl = [(0, tile_region1(co), lambda a, D: (a <= cut) & (a > dn), None),
                  (0, tile_w4(co), lambda a, D: a <= dn, None)]
        elif mode == 12:
            zl = [(0, tile_w4(co), lambda a, D: a <= cut, None)]
        else:
            name = {4: "fine", 6: "coarse"}[mode]
            dn = None if d_near is None else d_near[s].double()
            zl = ls.mode_zones(name, z, co, dn)
        nu64 = lines.nu.double()
        if lines.nu.dtype == torch.float32:
            nu64 = nu64 + lines.nu_lo.double()
        flat = dataclasses.replace(lines, nu=nu64)
        sig = block_sum(nb, None, flat, w, zl, (n_states,))
        res[:, s * n_out:(s + 1) * n_out] = sig[:, :n_out]
    linesum_cuda._count(count_as or names[mode])
    return res.to(coef.dtype)


@pytest.fixture
def stand_in(monkeypatch):
    """K1-dev's wrapper on CPU tensors with the launch replaced by the
    plain stand-in (the kernel's reading of its operands)."""
    monkeypatch.setattr(twin, "kernel_path", lambda x: True)
    monkeypatch.setattr(linesum_cuda, "launch_mode", _stand_in_launch)

    def checked(lines, T, P, Pp, conc=None):
        return T.shape[0], T.device

    monkeypatch.setattr(linesum_cuda, "_checked", checked)


def _sharded_call(sg, T, P, strategy):
    return sigma_from_lines_auto_device(sg.plans, sg.lines, T, P, 0.9 * P, sg.shape,
                                        strategy=strategy)


def _rel_ok(got, ref, floor, nu, pos, cut=25.0):
    """max rel error where |ref| > floor, away from the grid points within
    1e-9 cm^-1 of a line's cut: the launch's two-float grid (hi + lo, to
    ~1e-11 cm^-1) and the float64 grid may decide |dnu| <= cut apart there."""
    e = np.concatenate([pos - cut, pos + cut])
    edge = np.zeros(len(nu), dtype=bool)
    k = np.searchsorted(nu, e)
    for kk in (k - 1, k):
        ok = (kk >= 0) & (kk < len(nu))
        edge[kk[ok][np.abs(nu[kk[ok]] - e[ok]) <= 1e-9]] = True
    m = (ref.abs() > floor) & ~torch.as_tensor(edge)
    return float(((got - ref).abs()[m] / ref.abs()[m]).max())


@pytest.mark.parametrize("case,strategy,modes", [
    ("wide", "grouped", {"dev_voigt_split": 1}),
    ("lineless", "auto", {"dev_voigt_split": 1}),
    ("dense", "coarse", {"dev_fine": 1, "dev_coarse": 1}),
    ("dense", "nosplit", {"dev_nosplit": 1}),
])
def test_k1_dev_operands_through_a_stand_in(cats, stand_in, case, strategy, modes):
    _, tgas, k = _gases(cats, case)
    sg = shard_line_gas(tgas, k)
    T, P = _t(T3, P3)
    before = profiling.counts("launch.linesum.")
    got = _sharded_call(sg, T, P, strategy)
    counted = {m: v - before[m] for m, v in profiling.counts("launch.linesum.").items()
               if v != before[m]}
    assert counted == modes
    ref = tgas.raw_sigma(T, P)
    assert got.shape == ref.shape
    if strategy == "coarse":
        pk = ref.abs().amax(dim=1, keepdim=True)
        m = ref.abs() > 1e-4 * pk
        assert float(((got - ref).abs()[m] / ref.abs()[m]).max()) < 2e-3
    else:
        assert _rel_ok(got, ref, 1e-35, tgas.plan.nu, tgas.lines.positions64()) < 2e-3
        # the same stand-in over one stack of k shards and shard by shard
        n = sg.n_local
        one = torch.cat([_sharded_call(sg.spectral_slab(s * n, (s + 1) * n), T, P, strategy)
                         for s in range(k)], dim=-1)
        pk = ref.abs().max()
        assert float((got - one).abs().max() / pk) < 1e-12


def test_k1_dev_lane_and_gathered_run_per_shard(cats, stand_in, monkeypatch):
    """"lane" and "gathered" run the K4/K5 wrappers once a shard."""
    _, tgas, k = _gases(cats, "wide")
    sg = shard_line_gas(tgas, k)
    seen = []
    for name in ("sigma_lane", "sigma_gathered"):
        def run(plan, lines, T, P, Pp, shape, conc, _n=name):
            seen.append((_n, plan.n_nu, lines.n_lines))
            return torch.zeros((T.shape[0], plan.n_nu), dtype=T.dtype)
        monkeypatch.setattr(linesum_cuda, name, run)
    T, P = _t(T3, P3)
    for strategy in ("lane", "gathered"):
        out = _sharded_call(sg, T, P, strategy)
        assert out.shape == (3, 512)
    L = sg.lines.nu.shape[-1]
    assert seen == [("sigma_lane", 64, L)] * k + [("sigma_gathered", 64, L)] * k


def test_k1_dev_carries_the_plain_derivatives(cats, stand_in):
    _, tgas, k = _gases(cats, "wide")
    sg = shard_line_gas(tgas, k)
    T, P = _t(T3, P3)
    f = lambda t: _sharded_call(sg, t, P, "grouped").sum()
    J = torch.func.jacfwd(f)(T)
    J_ref = torch.func.jacfwd(lambda t: tgas.raw_sigma(t, P).sum())(T)
    np.testing.assert_allclose(J.numpy(), J_ref.numpy(), rtol=1e-10)
    g = torch.func.grad(f)(T)
    np.testing.assert_allclose(g.numpy(), J_ref.numpy(), rtol=1e-10)


def test_per_shard_coarse_plain_route(cats):
    """The plain version of the sharded coarse route, shard by shard, in
    float64 against the exact line sum at the route's bar."""
    _, tgas, k = _gases(cats, "dense")
    sg = shard_line_gas(tgas, k)
    T, P = _t(T3, P3)
    got = torch.cat([ls.sigma_coarse_device_plain(sg.plans.shard(s), shard_lines(
        sg.lines, s), T, P, 0.9 * P) for s in range(k)], dim=-1)
    ref = tgas.raw_sigma(T, P)
    pk = ref.abs().amax(dim=1, keepdim=True)
    m = ref.abs() > 1e-4 * pk
    assert float(((got - ref).abs()[m] / ref.abs()[m]).max()) < 2e-3
    # the static route at the same split: the shards' coarse lattices start
    # at their own first points, so the far fields interpolate from other
    # points (the JAX route's of-peak class is 2.6e-6)
    static = ls.sigma_coarse_plain(tgas.plan, tgas.lines, T, P, 0.9 * P,
                                   ls.coarse_params(tgas.plan, ls.AUTO_COARSE_FRAC))
    np.testing.assert_allclose(sg.plans.coarse_meta[:2],
                               ls.coarse_params(tgas.plan, ls.AUTO_COARSE_FRAC)[:2], rtol=1e-12)
    assert float(((got - static).abs() / pk).max()) < 1e-6


@pytest.mark.parametrize("case,strategy,shards", [("wide", "grouped", range(8)),
                                                  ("dense", "coarse", (0, 3))])
def test_jax_device_kernel_interpret_matches_stand_in(cats, stand_in, case, strategy, shards):
    """JAX's sigma_from_lines_pallas_device (interpret mode, float32) and
    K1-dev's operands read by the stand-in, shard by shard on the same
    float32 slabs: 1e-5 of each state's peak (float32 summation order, and
    region 1 against w4 in the far wing), for the coarse route also rel
    1e-3 where |sigma| > 1e-4 of peak (the far field's float32 rounding in
    sqrt space), the bars of tests/test_torch_strategies.py."""
    jgas, tgas, k = _gases(cats, case)
    jg = jshard(jgas, k)
    sg = shard_line_gas(tgas, k)
    l32 = dataclasses.replace(sg.lines, **{f: getattr(sg.lines, f).float()
                                           for f in ("nu", "S", "ga", "gs", "Epp", "na", "mu",
                                                     "A", "tips_coeffs")})
    s32 = dataclasses.replace(sg, lines=l32)
    T2, P2 = np.array([200.0, 300.0]), np.array([1e3, 1e5])
    T, P = _t(T2, P2, dtype=torch.float32)
    for s in shards:
        n = s32.n_local
        got = _sharded_call(s32.spectral_slab(s * n, (s + 1) * n), T, P, strategy).double()
        jl = dataclasses.replace(jg.lines, **{f: getattr(jg.lines, f)[s] for f in PER_LINE_FIELDS})
        opt = lambda x: None if x is None else x[s]
        jpl = dataclasses.replace(
            jg.plans, nu_blocks=jg.plans.nu_blocks[s], nu_blocks_lo=jg.plans.nu_blocks_lo[s],
            start=jg.plans.start[s], count=jg.plans.count[s],
            fine_blocks=opt(jg.plans.fine_blocks), fine_blocks_lo=opt(jg.plans.fine_blocks_lo),
            coarse_blocks=opt(jg.plans.coarse_blocks),
            coarse_blocks_lo=opt(jg.plans.coarse_blocks_lo))
        ref = torch.tensor(np.asarray(jp.sigma_from_lines_pallas_device(
            jpl, jl, jnp.asarray(T2), jnp.asarray(P2), 0.9 * jnp.asarray(P2), interpret=True,
            strategy=strategy)), dtype=torch.float64)
        pk = ref.abs().amax(dim=1, keepdim=True).clamp(min=1e-300)  # a shard may hold no line
        assert float(((got - ref).abs() / pk).max()) < 1e-5, s
        if strategy == "coarse":
            m = ref.abs() > 1e-4 * pk
            assert float(((got - ref).abs()[m] / ref.abs()[m]).max()) < 1e-3, s

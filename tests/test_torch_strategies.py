"""The voigt routes of the port's line sum against the JAX package.

The stencil-near and coarse-far routes (``ops/linesum_strategies.py``, the
kernel modes FARALL, FINE, FINE_STENCIL, COARSE and the near-core
correction of ``csrc/linesum.cu``) and their routing policy. Synthetic CO2
catalogs built from a seed feed both packages' ``from_par_dict``; the JAX
Pallas kernels run in interpret mode, as tests/test_linesum_pallas.py runs
them. Bars and their reasons:

* geometry: the JAX package's tuples (integers exactly, floats to 1e-12)
  and its stencil offsets bitwise, since routes and windows follow from
  them;
* plain float32 routes against the float32 Pallas routes: 1e-5 of peak
  (summation order; for the coarse route also the float32 rounding of the
  far field in sqrt space, hence rel 1e-3 where |sigma| > 1e-4 peak);
* plain float64 routes against the exact float64 line sum: the bars of the
  JAX package's own oracle tests of each route;
* kernel arithmetic in float64: 1e-12 (same formulas, other summation
  order); placement against ``_stencil_apply``: one float32 rounding, the
  dtype of its placement buffer.

The CUDA kernels themselves run only on a card (tests/test_torch_kernels.py,
chip_smoke.py).
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from clearsky_tpu.absorption.gas import DirectGas as JDirectGas
from clearsky_tpu.ops import linesum_pallas as jp
from clearsky_tpu.ops.linesum import (
    _line_params as jline_params,
    build_line_window_plan as jplan,
    sigma_from_lines as jsigma,
)
from clearsky_tpu.spectra.lines import SpectralLines as JLines
import clearsky_tpu_torch as ct
from clearsky_tpu_torch import convert
from clearsky_tpu_torch.ops import linesum_cuda
from clearsky_tpu_torch.ops import linesum_strategies as ls
from clearsky_tpu_torch.ops.faddeeva import wofz_re
from clearsky_tpu_torch.ops.linesum import (
    _line_params,
    build_line_window_plan,
    sigma_from_lines,
    sigma_from_lines_auto,
    voigt_coefficients,
)
from clearsky_tpu_torch.spectra.synthetic import synthetic_co2_par

# the suite runs in several worker processes: a torch thread pool of every
# core in each of them oversubscribes the machine
torch.set_num_threads(2)

CPU64 = dict(dtype=torch.float64, device="cpu")
T2, P2 = np.array([200.0, 300.0]), np.array([1e3, 1e5])


def _pair(n_lines, seed):
    par = synthetic_co2_par(n_lines, seed=seed)
    jl = JLines.from_par_dict(par)
    return jl, convert.spectral_lines(jl, **CPU64)


@pytest.fixture(scope="module")
def big():
    """chip_smoke.py's catalog (5,599 lines, seed 0)."""
    return _pair(5599, 0)


@pytest.fixture(scope="module")
def small():
    return _pair(1500, 3)


def _grid_for(tl, n):
    """chip_smoke.grid_for: the catalog's span, 25 cm^-1 beyond each end."""
    pos = tl.positions64()
    return np.linspace(max(pos.min() - 25.0, 1.0), pos.max() + 25.0, n)


def _random_walk(n=8192):
    rng = np.random.default_rng(3)
    nu = np.linspace(2300.0, 2350.0, n)
    nu = nu + np.cumsum(rng.uniform(-0.2, 0.2, nu.shape)) * (nu[1] - nu[0])
    nu.sort()
    return nu


# geometry name -> (catalog fixture, grid)
GRIDS = {
    "main_2e19": ("big", lambda tl: _grid_for(tl, 2**19)),
    "fine_2e20": ("big", lambda tl: _grid_for(tl, 2**20)),
    "rcm_16384": ("big", lambda tl: _grid_for(tl, 16384)),
    "dense_8192": ("small", lambda tl: np.linspace(2300.0, 2350.0, 8192)),
    "f32_quantized": ("small", lambda tl: np.linspace(2200.0, 2400.0, 4096)
                      .astype(np.float32).astype(np.float64)),
    "chirped": ("small", lambda tl: np.concatenate([
        np.linspace(2300.0, 2325.0, 8192, endpoint=False), np.linspace(2325.0, 2351.0, 8192)])),
    "random_walk": ("small", lambda tl: _random_walk()),
    "under_2048": ("small", lambda tl: np.linspace(2300.0, 2350.0, 2000)),
}


@pytest.fixture(scope="module")
def plans(big, small):
    """Each geometry's (JAX plan, port plan, JAX lines, port lines)."""
    cats = {"big": big, "small": small}
    out = {}
    for name, (cat, grid) in GRIDS.items():
        jl, tl = cats[cat]
        nu = grid(tl)
        out[name] = (jplan(nu, np.asarray(jl.nu), 25.0), build_line_window_plan(
            nu, tl.positions64(), 25.0), jl, tl)
    return out


@pytest.mark.parametrize("frac", [0.2, 0.6])
@pytest.mark.parametrize("name", list(GRIDS))
def test_coarse_params_match_jax(plans, name, frac):
    jpl, tpl, _, _ = plans[name]
    want = jp._coarse_far_params(jpl, frac_limit=frac)
    got = ls._coarse_far_params(tpl, frac_limit=frac)
    assert (got is None) == (want is None)
    if name == "under_2048":
        assert got is None
    if name in ("main_2e19", "fine_2e20", "dense_8192"):
        assert got is not None
    if got is not None:
        assert got[2:] == want[2:]
        np.testing.assert_allclose(got[:2], want[:2], rtol=1e-12)
        if name == "random_walk":
            assert got[3] == 0           # gathered interpolation
        if name in ("f32_quantized", "chirped"):
            assert (got[3] >= 2) == (name == "f32_quantized")


@pytest.mark.parametrize("name", ["main_2e19", "fine_2e20", "rcm_16384", "dense_8192",
                                  "random_walk"])
def test_stencil_geometry_matches_jax(plans, name):
    """K, R, the rows q and the two-float offsets, or the rejection (K > 64
    at 2^20)."""
    jpl, tpl, jl, tl = plans[name]
    want = jp._build_stencil_geom(jpl, jl)
    got = ls._build_stencil_geom(tpl, tl)
    assert ls._stencil_width(tpl, tl) == jp._stencil_width(jpl, jl)
    assert (got is None) == (want is None)
    assert (got is None) == (name == "fine_2e20")
    if got is None:
        assert ls._stencil_width(tpl, tl) > 64
        return
    K, R = want[0][:2]
    assert (got.K, got.R) == (K, R)
    np.testing.assert_array_equal(got.dnu_hi, want[1]["dnu_hi"])
    np.testing.assert_array_equal(got.dnu_lo, want[1]["dnu_lo"])
    idx0 = np.searchsorted(jpl.nu, np.asarray(jl.nu))
    np.testing.assert_array_equal(got.q, np.clip((idx0 - K // 2) // K, 0, R - 2))


def test_stencil_geometry_rejects_short_grids(small):
    """n_nu < 4K: the stencil would not fit; both packages refuse."""
    jl, tl = small
    nu = np.linspace(2340.0, 2350.0, 30)
    jpl, tpl = jplan(nu, np.asarray(jl.nu), 25.0), build_line_window_plan(
        nu, tl.positions64(), 25.0)
    assert ls._stencil_width(tpl, tl) * 4 > 30
    assert jp._build_stencil_geom(jpl, jl) is None and ls._build_stencil_geom(tpl, tl) is None


def _jax_route(jpl, jl, shape, strategy, n_states=57, limit=jp._RESIDENT_VMEM_LIMIT):
    """The route ``sigma_from_lines_pallas`` takes, from JAX's own gates
    (VMEM residency included, asserted to pass where it is read; the
    no-split sweep's pack, 3 values a state padded to 128, is the larger and
    its residency is decided at ``limit``)."""
    if shape not in jp._SPLIT_SHAPES:
        return "grouped"
    n_lines = int(jl.nu.shape[0])
    if strategy == "nosplit":
        lane_cost = jp._grouped_lane_cost(shape, strategy, n_states)
        if jp._resident_bytes_est(n_lines, jpl.slab, lane_cost) <= limit:
            return "nosplit"
        L_seg = jp._segment_cap(shape, strategy, n_states, limit, jpl.slab)
        return "segmented" if jp.CHUNK <= L_seg < n_lines else "gathered"
    if strategy == "coarse" and jp._coarse_far_params(jpl) is None:
        strategy = "auto"
    if strategy == "auto":
        if jp._coarse_far_params(jpl, frac_limit=0.2) is not None:
            assert jp._coarse_resident_ok(shape, 33, n_lines, jp._RESIDENT_VMEM_LIMIT)
            return "coarse"
        lane_cost = jp._grouped_lane_cost(shape, "stencil", n_states)
        assert jp._resident_bytes_est(n_lines, jpl.slab, lane_cost) <= jp._RESIDENT_VMEM_LIMIT
        return "stencil" if jp._build_stencil_geom(jpl, jl) is not None else "grouped"
    if strategy == "coarse":
        return "coarse"
    if strategy == "stencil" and jp._build_stencil_geom(jpl, jl) is not None:
        return "stencil"
    return "grouped"


@pytest.mark.parametrize("strategy", ["auto", "grouped", "nosplit", "stencil", "coarse"])
@pytest.mark.parametrize("name", list(GRIDS))
def test_route_matches_jax(plans, name, strategy):
    jpl, tpl, jl, tl = plans[name]
    want = _jax_route(jpl, jl, "voigt", strategy)
    if strategy == "nosplit":
        # at JAX's budget (57 states of 5,599 lines outgrow its VMEM) and
        # at the card's, where the pack is resident
        vmem = jp._RESIDENT_VMEM_LIMIT
        assert ls.route(tpl, tl, "voigt", strategy, 57, resident_limit=vmem) == want
        want = _jax_route(jpl, jl, "voigt", strategy, limit=ls.resident_budget("cpu"))
        assert want == "nosplit"
    assert ls.route(tpl, tl, "voigt", strategy) == want
    for shape in ("lorentz", "doppler"):
        assert ls.route(tpl, tl, shape, strategy) == "grouped"
    if strategy == "coarse" and ls.coarse_params(tpl, 0.6) is None:
        # an explicit "coarse" the geometry rejects takes auto's route
        assert want == ls.route(tpl, tl, "voigt", "auto")


def test_chip_smoke_shapes_route_as_jax_does(plans):
    """The routes chip_smoke.py's grids take: coarse with the stencil fine
    pass at 2^19, coarse with the in-kernel fine pass at 2^20, stencil at
    16,384 points."""
    main, fine, rcm = (plans[k] for k in ("main_2e19", "fine_2e20", "rcm_16384"))
    assert ls.route(main[1], main[3]) == "coarse"
    assert ls.coarse_params(main[1], 0.2)[2:] == (37464, 14)
    assert ls.stencil_geometry(main[1], main[3]).K == 56
    assert ls.route(fine[1], fine[3]) == "coarse" and ls.stencil_geometry(fine[1], fine[3]) is None
    assert ls.route(rcm[1], rcm[3]) == "stencil" and ls.stencil_geometry(rcm[1], rcm[3]).K == 8


@pytest.mark.parametrize("strategy,exc,match", [("fast", ValueError, "unknown")])
def test_unported_strategies_raise(plans, strategy, exc, match):
    """An unknown name is refused; "lane" and "gathered" (K4, K5) are
    taken."""
    _, tpl, _, tl = plans["rcm_16384"]
    with pytest.raises(exc, match=match):
        ls.route(tpl, tl, "voigt", strategy)
    T, P = (torch.tensor(x, dtype=torch.float64) for x in (T2, P2))
    with pytest.raises(exc, match=match):
        sigma_from_lines_auto(tpl, tl, T, P, P, strategy=strategy)
    with pytest.raises(exc, match=match):
        ct.DirectGas.from_lines(tl, 0.9, tpl.nu, strategy=strategy)
    for taken in ("lane", "gathered"):
        assert ls.route(tpl, tl, "voigt", taken) == taken


# --- the routes against JAX's interpret-mode kernels and the exact sum ------

def _states(T, P, dtype):
    return [torch.tensor(x, dtype=dtype) for x in (T, P, 0.5 * P)]


def _jax_states(T, P):
    return jnp.asarray(T), jnp.asarray(P), jnp.asarray(0.5 * P)


def _of_peak(out, ref):
    pk = np.abs(ref).max(axis=1, keepdims=True)
    return float((np.abs(out - ref) / pk).max())


@pytest.fixture(scope="module")
def stencil_cases(small):
    """(plan pair, T, P) of the JAX stencil oracle test's grid and states,
    and of a grid that starts on a line (the clamped window at the edge)."""
    jl, tl = small
    nu_l = np.asarray(jl.nu)
    out = {}
    for name, nu in (("band", np.linspace(610.0, 780.0, 1024)),
                     ("edge", np.linspace(nu_l[0], nu_l[0] + 80.0, 512))):
        out[name] = (jplan(nu, nu_l, 25.0), build_line_window_plan(nu, tl.positions64(), 25.0))
    return out


@pytest.mark.parametrize("case", ["band", "edge"])
def test_stencil_route_matches_jax_and_oracle(small, stencil_cases, case):
    jl, tl = small
    jpl, tpl = stencil_cases[case]
    T, P = np.array([200.0, 300.0]), np.array([10.0, 9e4])
    assert ls.route(tpl, tl) == "stencil"
    ker = np.asarray(jp.sigma_from_lines_pallas(jpl, jl, *_jax_states(T, P), "voigt",
                                                interpret=True, strategy="stencil"))
    dflt = np.asarray(jp.sigma_from_lines_pallas(jpl, jl, *_jax_states(T, P), "voigt",
                                                 interpret=True, strategy="grouped"))
    ref = np.asarray(jsigma(jpl, jl, *_jax_states(T, P), "voigt"))
    t32 = tl.to(torch.float32)
    out32 = ls.sigma_stencil_plain(tpl, t32, *_states(T, P, torch.float32)).double().numpy()
    assert _of_peak(out32, ker) < 1e-5
    out = ls.sigma_stencil_plain(tpl, tl, *_states(T, P, torch.float64)).numpy()
    pk = np.abs(ref).max(axis=1, keepdims=True)
    assert _of_peak(out, ref) < max(2.0 * _of_peak(dflt, ref), 1e-6)
    m = np.abs(ref) > 1e-2 * pk
    np.testing.assert_allclose(out[m], ref[m], rtol=2e-3, atol=0.0)
    m0 = np.abs(ref) > 1e-35
    assert np.all(np.abs(out[~m0]) < 1e-30)


def _jax_coarse_core_no_stencil(jpl, jl, T, P):
    """JAX's coarse route with its in-kernel fine pass (``_coarse_core`` with
    ``stencil_geom=None``), set up as ``_pallas_sigma_coarse`` sets it up."""
    d_far, h, n_cc, c_ratio = params = jp._coarse_far_params(jpl)
    nu_f = np.asarray(jpl.nu, np.float64)
    B = jpl.block
    Bf = jp._fine_block("voigt", jpl.n_nu, B)
    n_bf = -(-jpl.n_nu // Bf)
    fnb = np.concatenate([nu_f, np.full(n_bf * Bf - jpl.n_nu, nu_f[-1])]).reshape(n_bf, Bf)
    nu_c0 = nu_f[0] - 2.0 * h
    n_bc = -(-n_cc // B)
    cnb = np.concatenate([nu_c0 + np.arange(n_cc) * h,
                          np.full(n_bc * B - n_cc, nu_c0 + (n_cc - 1) * h)]).reshape(n_bc, B)

    def blocks(nb64):
        hi = nb64.astype(np.float32)
        lo = (nb64 - hi.astype(np.float64)).astype(np.float32)
        return jnp.asarray(hi)[:, None, :], jnp.asarray(lo)[:, None, :]

    interp = None
    if c_ratio < 2:
        u = (nu_f - nu_c0) / h
        j = np.clip(np.floor(u).astype(np.int64), 1, n_cc - 3)
        interp = (j, jp._cr_weights((u - j).astype(np.float64)))
    return np.asarray(jp._coarse_core(
        "voigt", True, 8, float(jpl.cut), jpl.n_nu, params, jl, *_jax_states(T, P)[:2],
        0.5 * jnp.asarray(P), None, *blocks(fnb), *blocks(cnb), interp, stencil_geom=None))


@pytest.mark.parametrize("name,fine", [("dense_8192", "fine_stencil"), ("dense_8192", "fine"),
                                       ("random_walk", "fine_stencil"),
                                       ("f32_quantized", "fine_stencil")])
def test_coarse_route_matches_jax_and_oracle(plans, name, fine):
    """Both fine passes (the stencil one where it applies, the in-kernel one
    with the stencil suppressed) and both interpolations (strided on the
    uniform and quantized grids, gathered on the random walk)."""
    jpl, tpl, jl, tl = plans[name]
    params = ls.coarse_params(tpl, 0.6)
    geom = ls.coarse_geometry(tpl, tl, params)
    assert geom.stencil is not None
    assert (geom.interp_j is None) == (name != "random_walk")
    if fine == "fine":
        geom = dataclasses.replace(geom, stencil=None, _on_device={})
        ker = _jax_coarse_core_no_stencil(jpl, jl, T2, P2)
    else:
        ker = np.asarray(jp.sigma_from_lines_pallas(jpl, jl, *_jax_states(T2, P2), "voigt",
                                                    interpret=True, strategy="coarse"))
    ref = np.asarray(jsigma(jpl, jl, *_jax_states(T2, P2), "voigt"))
    pk = np.abs(ref).max(axis=1, keepdims=True)
    t32 = tl.to(torch.float32)
    geom32 = ls.coarse_geometry(tpl, t32, params)
    if fine == "fine":
        geom32 = dataclasses.replace(geom32, stencil=None, _on_device={})
    out32 = ls.coarse_route_plain(geom32, t32, *_states(T2, P2, torch.float32)).double().numpy()
    assert _of_peak(out32, ker) < 1e-5
    m4 = np.abs(ker) > 1e-4 * pk
    assert (np.abs(out32 - ker)[m4] / np.abs(ker[m4])).max() < 1e-3
    # float64 against the exact sum, at test_coarse_far_strategy_matches_oracle's bars
    out = ls.coarse_route_plain(geom, tl, *_states(T2, P2, torch.float64)).numpy()
    rel = np.abs(out - ref) / np.maximum(np.abs(ref), 1e-300)
    assert rel[np.abs(ref) > 1e-4 * pk].max() < 2e-3
    assert _of_peak(out, ref) < 1e-5
    assert rel[np.abs(ref) > 1e-6 * pk].max() < 5e-2
    N_col = 1e4 / pk
    dtr = np.exp(-N_col * out) - np.exp(-N_col * ref)
    assert np.abs(dtr).max() < 5e-3
    assert np.abs(dtr.mean(axis=1)).max() < 1e-5


@pytest.mark.parametrize("weighted", [False, True])
def test_correction_placement_matches_jax(plans, weighted):
    """index_add_ on a padded buffer against the one-hot matrix products of
    ``_stencil_apply``, on float64 inputs. ``_stencil_apply`` places into a
    float32 buffer whatever its inputs, so each of its values carries one
    float32 rounding (2^-23 relative); the port's stays in float64."""
    jpl, tpl, jl, tl = plans["dense_8192"]
    meta, arrays = jp._build_stencil_geom(jpl, jl)
    geom = ls.stencil_geometry(tpl, tl)
    T = np.array([180.0, 240.0, 310.0])
    P = np.array([10.0, 3e3, 1e5])
    weight = None
    if weighted:
        d_far = ls.coarse_params(tpl, 0.6)[0]
        weight = (d_far * d_far, 4.0 * d_far * d_far)
    S, a, g = jline_params(jl, jnp.asarray(T), jnp.asarray(P), jnp.asarray(0.5 * P))
    want = np.asarray(jp._stencil_apply("voigt", meta, {k: jnp.asarray(v) for k, v in
                                                        arrays.items()},
                                        S, a, g, jnp.asarray(T), 25.0, jpl.n_nu,
                                        weight=weight))
    co = voigt_coefficients(*_line_params(tl, *_states(T, P, torch.float64)))
    got = ls.stencil_correction_plain(geom, co, 25.0, tpl.n_nu, weight).numpy()
    pk = np.abs(want).max()
    assert pk > 0 and want.dtype == np.float32
    assert np.all(np.abs(got - want) <= 2.0**-23 * np.abs(got) + 1e-12 * pk)


# --- the kernel's arithmetic on its pack ---------------------------------------

# w4's region-1 constant over the far wing's 1/sqrt(pi)
W4_R1 = 0.5641896 * np.sqrt(np.pi)


def _emulate_windowed(mode, blocks64, windows, lines, coef, z, d_near, n_states):
    """The windowed modes of csrc/linesum.cu in float64 on the kernel's pack
    [n_lines, n_states, n_coef] and window table: per block and window, its
    zone's mask and weight; COARSE's pack holds the far wing's (A, c1, c2,
    k2) alone, and FARALL's, FINE_STENCIL's and FINE's the window pack (A,
    h, g, k2), region 1 as k2 (1 - w) / (w^2 + g) at w = h - D A; FINE's
    [n_lines, 2, n_states, 4] adds (Sia, ia, y0, ry), w4 over its mid window
    where |dnu| <= min(d_near, ry), each (line, state)'s near reach, and
    beyond it within d_near (|x| + y >= 15, y >= 0.01) region 1 as w4 takes
    it, with its constant 0.5641896 (the voigt quad's 1/sqrt(pi) is 2.9e-8
    from it, below float32's rounding, which the kernel computes in)."""
    far = coef.shape[-1] - 4
    nb = torch.tensor(blocks64)
    out = torch.zeros(n_states, *nb.shape, dtype=torch.float64)
    sm = lambda D, A1, A2: ls._smoothstep_d2(D, A1, A2)
    zones = {"farall": ["farall"], "coarse": ["coarse"], "fine": ["mid", "ann", "ann"],
             "fine_stencil": ["mid_all", "ann", "ann"]}[mode]
    for b in range(nb.shape[0]):
        for w, zone in enumerate(zones):
            s0, cnt = int(windows[b, 2 * w]), int(windows[b, 2 * w + 1])
            if cnt == 0:
                continue
            dnu = nb[b][:, None] - lines.nu[s0:s0 + cnt][None, :]
            a, D = dnu.abs(), dnu * dnu
            for st in range(n_states):
                c = coef[s0:s0 + cnt, 0, st] if mode == "fine" else coef[s0:s0 + cnt, st]
                if mode in ("farall", "fine_stencil", "fine"):
                    A, h, gg, k2 = (c[:, i] for i in range(4))
                    w_ = h - D * A
                    r1 = k2 * (1.0 - w_) / (w_ * w_ + gg)
                else:
                    A, c1, c2, k2 = (c[:, far + i] for i in range(4))
                    m_ = D * A
                    r1 = k2 * (c1 + m_) / ((c1 - m_) ** 2 + c2 * D)
                if zone == "farall":
                    f, keep = r1, a <= z["cut"]
                elif zone == "coarse":
                    f = r1 * sm(D, z["D1"], z["D2"]) * (1.0 - sm(D, z["R1"], z["R2"]))
                    keep = (a <= z["cut"]) & (a > z["d_lo"])
                elif zone == "ann":
                    f, keep = r1 * sm(D, z["R1"], z["R2"]), (a <= z["cut"]) & (D > z["R1"])
                else:
                    wgt = 1.0 - sm(D, z["D1"], z["D2"])
                    f, keep = r1 * wgt, a <= z["cut_f"]
                    if zone == "mid":
                        nq = coef[s0:s0 + cnt, 1, st]
                        w4 = nq[:, 0] * wofz_re(dnu * nq[:, 1], nq[:, 2].expand_as(dnu))
                        r = torch.clamp(nq[:, 3], max=d_near)
                        f = torch.where(a > d_near, f, torch.where(a > r, f * W4_R1, w4 * wgt))
                out[st, b] += torch.where(keep, f, 0.0).sum(-1)
    return out.reshape(n_states, -1)


def _emulate_correction(geom, coef, n_states, cut, n_nu, weight):
    """The correction's terms in float64, one (window point k, line l) at a
    time: (Sia, ia, y0) (here from the FINE mode's pack [n_lines, 2,
    n_states, 4], its second quad) added at q[l] K + k."""
    out = torch.zeros(n_states, n_nu, dtype=torch.float64)
    hi = torch.tensor(geom.dnu_hi, dtype=torch.float64)
    lo = torch.tensor(geom.dnu_lo, dtype=torch.float64)
    p = torch.tensor(geom.q)[None, :] * geom.K + torch.arange(2 * geom.K)[:, None]  # [2K, L]
    w = 1.0
    if weight is not None:
        w = 1.0 - ls._smoothstep_d2((hi + lo) ** 2, *weight)
    for st in range(n_states):
        c = coef[:, 1, st]
        x = c[:, 1] * hi + c[:, 1] * lo
        y = c[:, 2].expand_as(x)
        t2r, t2i = y * y - x * x, -2.0 * x * y
        br = 0.5 + t2r
        wr1 = 0.5641896 * (y * br - x * t2i) / (br * br + t2i * t2i)
        corr = c[:, 0] * (wofz_re(x, y) - wr1) * w
        keep = (x * x <= 225.0) & (hi.abs() <= cut) & (p < n_nu)
        out[st].index_add_(0, p[keep], corr[keep])
    return out


@pytest.mark.parametrize("mode", ["farall", "fine", "fine_stencil", "coarse", "correction"])
def test_kernel_pack_reproduces_plain_modes(plans, mode):
    """Each new mode's formulas on the real pack and window table (11
    states: K1's tiles of 8, 2 and 1) against its plain version."""
    _, tpl, _, tl = plans["dense_8192"]
    Ts = torch.tensor(np.linspace(180.0, 320.0, 11))
    Ps = torch.tensor(np.geomspace(10.0, 1e5, 11))
    S, a, g = _line_params(tl, Ts, Ps, 0.4 * Ps)
    co = voigt_coefficients(S, a, g)
    kmode = linesum_cuda.WINDOW_MODES["fine" if mode == "correction" else mode]
    coef = linesum_cuda.pack_coefficients(kmode, S, a, g)
    assert coef.shape == ((tl.n_lines, 2, 11, 4) if kmode == 4
                          else (tl.n_lines, 11, linesum_cuda._N_COEF[kmode]))
    geom = ls.coarse_geometry(tpl, tl, ls.coarse_params(tpl, 0.6))
    z = geom.zones
    if mode == "correction":
        for weight in (None, (z["D1"], z["D2"])):
            got = _emulate_correction(geom.stencil, coef, 11, 25.0, tpl.n_nu, weight)
            ref = ls.stencil_correction_plain(geom.stencil, co, 25.0, tpl.n_nu, weight)
            assert float((got - ref).abs().max()) <= 1e-12 * float(ref.abs().max())
        return
    if mode == "farall":
        blocks, windows, zz = tpl.nu_blocks, tpl.windows(), {"cut": 25.0}
    elif mode == "coarse":
        blocks, windows, zz = geom.coarse_blocks, geom.coarse_windows, z
    else:
        blocks, windows, zz = geom.fine_blocks, geom.fine_windows, z
    d_near = torch.clamp(15.0 * a.max(), max=z["cut_f"]) if mode == "fine" else None
    got = _emulate_windowed(mode, blocks, windows, tl, coef, zz, d_near, 11)
    ref = ls.sigma_mode_plain(mode, blocks, windows, tl, co, zz, d_near)
    pk = ref.abs().amax(dim=1, keepdim=True)
    assert float(((got - ref).abs() / pk).max()) <= 1e-12


@pytest.mark.parametrize("case", ["rcm_16384", "rce_16384_phco2", "main_2e19"])
def test_window_plan_fills_the_card(plans, big, case):
    """window_kernel's launch plan at the main path's shapes (chip_smoke's
    catalog): FARALL at the RCM's 20 states x 16,384 points, phco2's
    FINE_STENCIL at the RCE's (20 x 16,384, cut 500) and FINE_STENCIL at 57
    x 2^19. Blocks of at most 512 threads (G groups of a row's points). At
    16,384 points (128 rows) four groups of a point a thread, pieces of
    about the mean lines a row, and at least a full wave of the H100's 132
    SMs x 32 resident warps; at 2^19 one group of two points a thread (the
    voigt modes), pieces of up to twice the mean (four chunks at least), so
    that a dense row is cut and no item holds far more than the others."""
    _, tpl, _, tl = plans["main_2e19" if case == "main_2e19" else "rcm_16384"]
    if case == "rce_16384_phco2":
        pos = tl.positions64()
        nu = np.linspace(max(pos.min() - 500.0, 1.0), pos.max() + 500.0, 16384)
        tpl = build_line_window_plan(nu, pos, 500.0)
    if case == "rcm_16384":
        blocks, win, mode, n = tpl.nu_blocks, tpl.windows(), 3, 20
    else:
        shape = "phco2" if case == "rce_16384_phco2" else "voigt"
        n = 20 if shape == "phco2" else 57
        name, params = ls._resolve(tpl, tl, shape, "auto", n)
        assert name == "coarse"
        geom = ls.coarse_geometry(tpl, tl, params)
        assert geom.stencil is not None
        blocks, win = geom.fine_blocks, geom.fine_windows
        mode = linesum_cuda.window_mode("fine_stencil", shape)
    B = blocks.shape[1]
    grid = {"nu_hi": torch.zeros(blocks.size), "nu_lo": torch.zeros(blocks.size),
            "win": torch.as_tensor(win, dtype=torch.int32), "win_host": win}
    plan = linesum_cuda.window_plan(mode, grid, n)
    pts = plan["points_per_thread"]
    assert plan["groups"] in (1, 2, 4) and pts == (2 if case == "main_2e19" else 1)
    assert plan["threads"] == plan["groups"] * B // pts <= 512
    assert plan["tiles"] == -(-n // 8) and plan["blocks"] == plan["pieces"] * plan["tiles"]
    warps = plan["blocks"] * plan["threads"] // 32
    mean = np.asarray(win, np.int64)[:, 1::2].sum(axis=1).mean()
    chunk = linesum_cuda.WINDOW_CHUNKS[mode]
    if case == "main_2e19":
        assert plan["groups"] == 1 and plan["blocks"] >= 132 * 16
        assert plan["piece_lines"] <= max(4 * chunk, 2 * mean + chunk)
    else:
        assert plan["groups"] == 4
        assert plan["piece_lines"] <= mean + chunk and warps >= 132 * 32
    # the plan is cached with the grid, keyed by what it depends on
    assert linesum_cuda.window_plan(mode, grid, n) is plan
    # a caller's override sets its choices and is cached apart
    over = {"groups": 2, "piece_lines": 64, "points_per_thread": 1}
    mine = linesum_cuda.window_plan(mode, grid, n, over)
    assert {k: mine[k] for k in over} == over and mine["threads"] == 2 * B
    assert linesum_cuda.window_plan(mode, grid, n, dict(over)) is mine
    assert linesum_cuda.window_plan(mode, grid, n) is plan
    with pytest.raises(ValueError, match="sets only"):
        linesum_cuda.window_plan(mode, grid, n, {"threads": 64})


# --- the gas, convert, and the device defaults -------------------------------

@pytest.mark.parametrize("strategy", ["auto", "grouped", "stencil", "coarse"])
def test_direct_gas_carries_strategy_and_is_exact_on_cpu(plans, strategy):
    _, tpl, jl, tl = plans["dense_8192"]
    gas = ct.DirectGas.from_lines(tl, 0.9, tpl.nu, strategy=strategy)
    assert gas.strategy == strategy
    T = torch.tensor(T2)
    P = torch.tensor(P2)
    exact = sigma_from_lines(gas.plan, tl, T, P, 0.9 * P)
    np.testing.assert_array_equal(gas.raw_sigma(T, P).numpy(), exact.numpy())
    jg = JDirectGas.from_lines(jl, 0.9, tpl.nu, strategy=strategy)
    assert convert.direct_gas(jg, 0.9, **CPU64).strategy == strategy


def test_default_strategy_is_auto(plans):
    _, tpl, _, tl = plans["rcm_16384"]
    assert ct.DirectGas.from_lines(tl, 0.9, tpl.nu).strategy == "auto"


def _table_like():
    """The fields ``convert.gas`` reads from a JAX Gas, without a bake."""
    from types import SimpleNamespace
    from clearsky_tpu.absorption.domain import AtmosphericDomain as JDomain

    dom = JDomain.create((150.0, 350.0), 4, (10.0, 1e5), 4)
    return SimpleNamespace(nu=np.linspace(500.0, 900.0, 64), coeffs=np.zeros((16, 64)),
                           name="", formula="", mu=0.044, domain=dom, coeffs_tail=None,
                           lead_idx=None, tail_idx=None)


_CONSTRUCTORS = {
    "SpectralLines.from_par_dict": lambda jl: ct.SpectralLines.from_par_dict(
        synthetic_co2_par(50, seed=1)).nu,
    "SpectralLines.from_arrays": lambda jl: ct.SpectralLines.from_arrays(
        {f: np.asarray(getattr(jl, f)) for f in ("nu", "S", "ga", "gs", "Epp", "na", "mu", "A",
                                                 "iso", "iso_ptr", "tips_coeffs")}).nu,
    "GrayGas.create": lambda jl: ct.GrayGas.create(1e-30, np.linspace(500.0, 900.0, 64)).nu,
    "convert.gas": lambda jl: convert.gas(_table_like(), 0.9).nu,
    "convert.spectral_lines": lambda jl: convert.spectral_lines(jl).nu,
    "convert.direct_gas": lambda jl: convert.direct_gas(
        JDirectGas.from_lines(jl, 0.9, np.linspace(2300.0, 2350.0, 64)), 0.9).nu,
}


@pytest.mark.parametrize("name", list(_CONSTRUCTORS))
def test_constructors_default_to_float32_on_the_card(small, name):
    """Without ``device``, a constructor asks for the CUDA card, in float32;
    on a machine without one, torch raises rather than falling back."""
    make = _CONSTRUCTORS[name]
    if torch.cuda.is_available():
        nu = make(small[0])
        assert nu.device.type == "cuda" and nu.dtype == torch.float32
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            make(small[0])

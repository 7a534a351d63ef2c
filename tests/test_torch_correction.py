"""The near-core correction's gather schedule (``ops/linesum_strategies.py::
correction_rows``) and its summation order, on the CPU.

The kernel (csrc/linesum.cu ``correction_gather_kernel``) runs one block per
(row of the stencil's K-point row grid that lines reach, tile of states) and
adds each point's terms in the schedule's order. These tests hold the
schedule to that contract: every half window that reaches a grid point
within the cut is one entry of its row, entries run in (row, q, catalog
index) order whatever the catalog's order, rows that no line reaches are not
listed, lines clipped to the first and last row pair and the last row's
points past the grid are handled, and a row may hold every line. A float64
stand-in that sums in the kernel's gather order is held to the plain
version (1e-12 of the correction's peak: the same terms in another order)
and to the JAX package's ``_stencil_apply`` (one float32 rounding a value,
the dtype of its placement buffer, as
tests/test_torch_strategies.py::test_correction_placement_matches_jax),
for voigt and phco2, weighted and unweighted.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from clearsky_tpu.ops import linesum_pallas as jp
from clearsky_tpu.ops.linesum import _line_params as jline_params
from clearsky_tpu.ops.linesum import build_line_window_plan as jplan
from clearsky_tpu.spectra.lines import SpectralLines as JLines
from clearsky_tpu_torch import convert
from clearsky_tpu_torch.ops import linesum_cuda
from clearsky_tpu_torch.ops import linesum_strategies as ls
from clearsky_tpu_torch.ops.faddeeva import wofz_re
from clearsky_tpu_torch.ops.lineshape import chi_phco2
from clearsky_tpu_torch.ops.linesum import build_line_window_plan, region1_xy
from clearsky_tpu_torch.spectra.lines import PER_LINE_FIELDS
from clearsky_tpu_torch.spectra.synthetic import synthetic_co2_par

torch.set_num_threads(2)

CPU64 = dict(dtype=torch.float64, device="cpu")
T = np.array([180.0, 240.0, 310.0])
P = np.array([10.0, 3e3, 1e5])


def _lines(n_lines, seed):
    """(JAX catalog, port catalog) of a synthetic CO2 par."""
    jl = JLines.from_par_dict(synthetic_co2_par(n_lines, seed=seed))
    return jl, convert.spectral_lines(jl, **CPU64)


def _permuted(tl, seed):
    """The port catalog ``tl`` with its lines in a random order (the readers
    sort; a merged mixture or a hand-built catalog need not)."""
    order = torch.as_tensor(np.random.default_rng(seed).permutation(tl.n_lines))
    return dataclasses.replace(tl, **{f: getattr(tl, f)[order] for f in PER_LINE_FIELDS})


@pytest.fixture(scope="module")
def voigt():
    jl, tl = _lines(1500, 3)
    nu = np.linspace(2300.0, 2350.0, 8191)
    return jl, tl, nu, 25.0


@pytest.fixture(scope="module")
def phco2():
    jl, tl = _lines(400, 5)
    pos = tl.positions64()
    return jl, tl, np.linspace(pos.min() - 500.0, pos.max() + 500.0, 8191), 500.0


def _geom(tl, nu, cut):
    """The stencil geometry of ``tl`` on ``nu`` (the plan, which bands the
    sorted positions, only lends its grid and cut)."""
    plan = build_line_window_plan(nu, np.sort(tl.positions64()), cut)
    geom = ls._build_stencil_geom(plan, tl)
    assert geom is not None
    return geom


def _reaching_halves(geom, cut, n_nu):
    """{(line, half)} whose half window holds a grid point within the cut."""
    K = geom.K
    out = set()
    for h in (0, 1):
        for l in range(geom.q.shape[0]):
            p = (geom.q[l] + h) * K + np.arange(K)
            if ((np.abs(geom.dnu_hi[h * K:(h + 1) * K, l]) <= cut) & (p < n_nu)).any():
                out.add((l, h))
    return out


def _check_schedule(geom, cut, n_nu):
    """The schedule's contract on ``geom``; returns it."""
    K = geom.K
    sch = ls.correction_rows(geom, cut, n_nu)
    rows, line = sch["rows"], sch["line"]
    E = line.shape[0]
    assert sch["dnu_hi"].shape == sch["dnu_lo"].shape == (E, K)
    assert sch["dnu_hi"].dtype == np.float32 and sch["dnu_lo"].dtype == np.float32
    # the rows' runs tile the entries, none empty, costliest first (stably)
    runs = sorted((int(e0), int(e1)) for _, e0, e1 in rows)
    assert runs[0][0] == 0 and runs[-1][1] == E and all(
        a[1] == b[0] for a, b in zip(runs, runs[1:]))
    counts = rows[:, 2] - rows[:, 1]
    assert (counts > 0).all() and (np.diff(counts) <= 0).all()
    for k in np.flatnonzero(np.diff(counts) == 0):
        assert rows[k, 0] < rows[k + 1, 0]
    assert len(set(rows[:, 0].tolist())) == rows.shape[0]
    assert sch["max_entries"] == int(counts.max(initial=0))
    # each reaching half once, in its row, with its offsets; (q, line) order
    seen = set()
    for r, e0, e1 in rows:
        prev = None
        for e in range(e0, e1):
            l = int(line[e])
            h = int(r - geom.q[l])
            assert h in (0, 1)
            assert (l, h) not in seen
            seen.add((l, h))
            np.testing.assert_array_equal(sch["dnu_hi"][e], geom.dnu_hi[h * K:(h + 1) * K, l])
            np.testing.assert_array_equal(sch["dnu_lo"][e], geom.dnu_lo[h * K:(h + 1) * K, l])
            key = (int(geom.q[l]), l)
            assert prev is None or key > prev
            prev = key
    assert seen == _reaching_halves(geom, cut, n_nu)
    return sch


def test_schedule_on_the_band_grid(voigt):
    """The dense band grid: lines beyond each end of the grid (within the
    cut) are clipped to q = 0 and q = R - 2 and crowd those rows."""
    _, tl, nu, cut = voigt
    geom = _geom(tl, nu, cut)
    sch = _check_schedule(geom, cut, nu.shape[0])
    pos = tl.positions64()
    assert (pos < nu[0]).any() and (pos > nu[-1]).any()
    assert geom.q.min() == 0 and geom.q.max() == geom.R - 2
    listed = set(sch["rows"][:, 0].tolist())
    assert {0, 1, geom.R - 2, geom.R - 1} <= listed


def test_schedule_of_an_unsorted_catalog(voigt):
    """A catalog in random order (a merged mixture, a user's .par): the
    entries still run in (row, q, catalog index) order, and each is the
    same half window of the same line as in the sorted catalog's schedule."""
    _, tl, nu, cut = voigt
    tp = _permuted(tl, 11)
    assert (np.diff(tp.positions64()) < 0).any()
    geom, geom_p = _geom(tl, nu, cut), _geom(tp, nu, cut)
    sch, sch_p = (_check_schedule(g, cut, nu.shape[0]) for g in (geom, geom_p))
    pos, pos_p = tl.positions64(), tp.positions64()

    def halves(s, g, p):
        return sorted((int(r), float(p[l]), int(r - g.q[l]))
                      for r, e0, e1 in s["rows"] for l in s["line"][e0:e1])
    assert halves(sch, geom, pos) == halves(sch_p, geom_p, pos_p)


def test_schedule_lists_no_unreached_row():
    """A grid with a gap in the catalog: rows that no half window reaches
    are not listed, and every listed row holds an entry."""
    _, tl = _lines(1500, 3)
    pos = tl.positions64()
    nu = np.linspace(pos.min() - 1.0, pos.max() + 1.0, 20000)
    geom = _geom(tl, nu, 25.0)
    sch = _check_schedule(geom, 25.0, nu.shape[0])
    reached = {int(geom.q[l]) + h for l, h in _reaching_halves(geom, 25.0, nu.shape[0])}
    assert set(sch["rows"][:, 0].tolist()) == reached
    assert len(reached) < geom.R


@pytest.mark.parametrize("extra", [0, 1, 5])
def test_schedule_leaves_points_past_the_grid(voigt, extra):
    """n_nu = (R - 1) K + extra points (extra > 0) or R K (extra = 0): the
    last row's points past the grid reach nothing, and a half window that
    holds only such points is no entry."""
    _, tl, nu, cut = voigt
    K = _geom(tl, nu, cut).K
    n = (nu.shape[0] // K) * K + extra
    grid = np.linspace(2300.0, 2350.0, n)
    geom = _geom(tl, grid, cut)
    assert geom.K == K and geom.R == -(-n // K)
    _check_schedule(geom, cut, n)
    # the same geometry on a grid cut shorter: the halves past it drop out
    short = ls.correction_rows(geom, cut, (geom.R - 1) * K)
    assert short["rows"][:, 0].max() <= geom.R - 2


def test_schedule_of_one_crowded_row(voigt):
    """Every line in one row: two rows of L entries each, q and q + 1."""
    _, tl, nu, cut = voigt
    g0 = _geom(tl, nu, cut)
    K, r = g0.K, g0.R // 2
    lo, hi = nu[r * K + K // 2], nu[r * K + K // 2 + K - 1]
    rng = np.random.default_rng(2)
    pos = np.sort(rng.uniform(lo, hi, tl.n_lines))
    crowd = dataclasses.replace(tl, nu=torch.tensor(pos), nu_lo=torch.zeros(tl.n_lines,
                                                                             **CPU64))
    geom = _geom(crowd, nu, cut)
    assert geom.K == K and (geom.q == r).all()
    sch = _check_schedule(geom, cut, nu.shape[0])
    assert sch["rows"][:, 0].tolist() == [r, r + 1]
    assert (sch["rows"][:, 2] - sch["rows"][:, 1]).tolist() == [tl.n_lines, tl.n_lines]


def gather_standin(geom, co, cut, n_nu, weight=None, T=None):
    """The correction kernel's sum in float64: each listed row's points add
    their terms entry by entry in the schedule's order, then add the sum
    into sigma once (here a zero buffer)."""
    sch = ls.correction_rows(geom, cut, n_nu)
    Sia, ia, y0 = (c.double() for c in co[:3])
    K = geom.K
    out = torch.zeros(ia.shape[0], n_nu, dtype=torch.float64)
    for r, e0, e1 in sch["rows"]:
        p = r * K + torch.arange(K)
        live = p < n_nu
        acc = torch.zeros(ia.shape[0], K, dtype=torch.float64)
        for e in range(e0, e1):
            l = int(sch["line"][e])
            dh = torch.as_tensor(sch["dnu_hi"][e]).double()
            dl = torch.as_tensor(sch["dnu_lo"][e]).double()
            x = ia[:, l, None] * dh + ia[:, l, None] * dl
            y = y0[:, l, None].expand_as(x)
            if T is not None:
                y = y * chi_phco2((dh + dl)[None], T[:, None])
            w = 1.0 if weight is None else 1.0 - ls._smoothstep_d2((dh + dl) ** 2, *weight)
            corr = Sia[:, l, None] * (wofz_re(x, y) - region1_xy(x, y)) * w
            keep = (x * x <= 225.0) & (dh.abs() <= cut)[None] & live[None]
            acc = acc + torch.where(keep, corr, 0.0)
        out[:, p[live]] += acc[:, live]
    return out


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("shape", ["voigt", "phco2"])
def test_gather_order_matches_plain_and_jax(voigt, phco2, shape, weighted):
    """The stand-in against the plain correction (1e-12 of its peak) and
    against JAX's ``_stencil_apply`` on float64 inputs (2^-23 of each value:
    JAX places into a float32 buffer, plus 1e-12 of the peak)."""
    jl, tl, nu, cut = voigt if shape == "voigt" else phco2
    n_nu = nu.shape[0]
    plan = build_line_window_plan(nu, tl.positions64(), cut)
    geom = ls.stencil_geometry(plan, tl)
    weight = None
    if weighted:
        d_far = ls.coarse_params(plan, 0.6)[0]
        weight = (d_far * d_far, 4.0 * d_far * d_far)
    Tt, Pt = torch.tensor(T), torch.tensor(P)
    _, co = ls.coefficients(tl, Tt, Pt, 0.5 * Pt, shape=shape)
    Tc = Tt if shape == "phco2" else None
    got = gather_standin(geom, co, cut, n_nu, weight, Tc)
    ref = ls.stencil_correction_plain(geom, co, cut, n_nu, weight, Tc)
    pk = float(ref.abs().max())
    assert pk > 0
    assert float((got - ref).abs().max()) <= 1e-12 * pk
    jpl = jplan(nu, np.asarray(jl.nu), cut)
    meta, arrays = jp._build_stencil_geom(jpl, jl)
    S, a, g = jline_params(jl, jnp.asarray(T), jnp.asarray(P), jnp.asarray(0.5 * P))
    want = np.asarray(jp._stencil_apply(shape, meta, {k: jnp.asarray(v) for k, v in
                                                      arrays.items()},
                                        S, a, g, jnp.asarray(T), cut, n_nu, weight=weight))
    assert want.dtype == np.float32
    got = got.numpy()
    assert np.all(np.abs(got - want) <= 2.0**-23 * np.abs(got) + 1e-12 * pk)


@pytest.mark.parametrize("K,n,want", [(56, 57, (4, 8, 2)), (40, 57, (6, 5, 2)),
                                      (64, 57, (4, 8, 2)), (8, 20, (20, 1, 1)),
                                      (8, 57, (32, 1, 2)), (16, 1, (1, 1, 1)),
                                      (48, 0, (1, 0, 1))])
def test_state_tiles_cover_the_states(K, n, want):
    """The correction's tiles: K G threads of at most 256 (G no more groups
    than states), G nse <= 48 states a tile (nse <= 8 a thread), every state
    in one tile."""
    G, nse, n_tiles = linesum_cuda.correction_tiles(K, n)
    assert (G, nse, n_tiles) == want
    assert K * G <= linesum_cuda.CORR_THREADS and G * nse <= linesum_cuda.CORR_TS
    assert nse <= 8 and G * nse * n_tiles >= n
    assert G * nse * (n_tiles - 1) < max(n, 1)


def test_wrapper_on_cpu_takes_the_plain_version(phco2):
    """CPU tensors add the plain correction in place; chi's rates come with
    the temperatures or not at all."""
    _, tl, nu, cut = phco2
    geom = _geom(tl, nu, cut)
    Tt, Pt = torch.tensor(T), torch.tensor(P)
    _, co = ls.coefficients(tl, Tt, Pt, 0.5 * Pt, shape="phco2")
    out = torch.ones(3, nu.shape[0], dtype=torch.float64)
    got = linesum_cuda.stencil_correction(out, geom, co, cut, T=Tt)
    assert got is out
    ref = 1.0 + ls.stencil_correction_plain(geom, co, cut, nu.shape[0], T=Tt)
    assert torch.equal(out, ref)
    with pytest.raises(ValueError):
        linesum_cuda.stencil_correction(out, geom, co, cut, bcoef=linesum_cuda.chi_rates(Tt))


@pytest.mark.parametrize("cut", ["none", "stage", "mask", "no_rmw", "no_sum"])
def test_probe_cuts_apply_to_the_kernel_source(cut):
    """tools/correction_probe.py cuts csrc/linesum.cu by text edits: each
    edit of each cut finds its text exactly once in today's source."""
    from clearsky_tpu_torch.tools import correction_probe
    from clearsky_tpu_torch.utils.cuda_build import CSRC

    src = (CSRC / "linesum.cu").read_text()
    out = correction_probe.cut_source(src, cut)
    assert (out == src) == (cut == "none")

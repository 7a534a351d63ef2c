"""K1's work items and coefficient pack on the host (``ops/linesum_cuda.py``).

The kernel (csrc/linesum.cu) runs one block per work item: a piece of at
most ``piece_lines`` lines of a grid block's windows and a tile of states.
A block cut into several pieces leaves their partial sums in scratch, and
the last piece to finish adds them in piece order. These tests hold the
schedule to that contract on the plans every mode sweeps (the split mode's,
K1-seg's segments, the coarse split's fine and coarse grids, K1-dev's
stacked shards), emulate the piece-wise sum in float64 against the plain
line sum (1e-12: the same terms in another order) and the JAX package's
(1e-9, the bar of tests/test_torch_linesum.py), hold the line-major pack
to the tiled one it replaced through the plain stand-in launch of
tests/test_torch_sharded.py, and check the bound behind the far wing's
reciprocal.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from clearsky_tpu.spectra.lines import SpectralLines as JLines
from clearsky_tpu.ops.linesum import build_line_window_plan as jplan, sigma_from_lines as jsigma
from clearsky_tpu_torch import convert
from clearsky_tpu_torch.absorption.sharded import shard_line_gas
from clearsky_tpu_torch.absorption.gas import DirectGas
from clearsky_tpu_torch.ops import linesum_cuda
from clearsky_tpu_torch.ops import linesum_strategies as ls
from clearsky_tpu_torch.ops.linesum import (
    _line_params,
    block_sum,
    build_line_window_plan,
    grid_blocks,
    sigma_from_lines,
    tile_exact,
    tile_T,
    voigt_coefficients,
)
from clearsky_tpu_torch.spectra.synthetic import synthetic_co2_par

torch.set_num_threads(2)

T = np.array([190.0, 250.0, 310.0])
P = np.array([20.0, 4e3, 9e4])


@pytest.fixture(scope="module")
def cat():
    par = synthetic_co2_par(1500, seed=3)
    jl = JLines.from_par_dict(par)
    tl = convert.spectral_lines(jl, dtype=torch.float64, device="cpu")
    nu = np.linspace(2300.0, 2350.0, 4096)
    return dict(jl=jl, tl=tl, nu=nu, jp=jplan(nu, np.asarray(jl.nu), 25.0),
                tp=build_line_window_plan(nu, tl.positions64(), 25.0))


def _states():
    return [torch.tensor(x, dtype=torch.float64) for x in (T, P, 0.4 * P)]


def _tables(cat):
    """(name, window table, windows per row) of every kind of grid K1 sweeps."""
    plan, lines = cat["tp"], cat["tl"]
    out = [("split", plan.windows(), 1)]
    L = -(-lines.n_lines // 3)
    segs = ls.segments(plan, lines.n_lines, L)
    out += [(f"segment{i}", s.windows, 1) for i, s in enumerate(segs)]
    geom = ls.coarse_geometry(plan, lines, ls.coarse_params(plan, 0.6))
    out += [("fine", geom.fine_windows, 3), ("coarse", geom.coarse_windows, 1)]
    sg = shard_line_gas(DirectGas.from_lines(lines, 0.9, cat["nu"], strategy="coarse"), 4)
    grid = linesum_cuda._dev_grid(sg.plans, "plan", sg.lines.nu.shape[-1], torch.device("cpu"))
    out.append(("dev", grid["win_host"], 1))
    return out


@pytest.mark.parametrize("P_lines", [1, 7, 32, 256])
def test_pieces_cover_each_window_once(cat, P_lines):
    """Every (row, window) line lies in exactly one piece; no piece holds more
    than P lines; pieces are listed by line count, largest first; a row's
    pieces are numbered 0..n-1 in line order and own disjoint scratch slots;
    a row without lines has one empty piece."""
    for name, win, n_win in _tables(cat):
        w = np.asarray(win, np.int64).reshape(-1, 2 * n_win)
        table, n_slots = linesum_cuda.piece_schedule(w, n_win, P_lines)
        row, k, start, count, part, n_parts, slot, zero = table.T.astype(np.int64)
        assert table.dtype == np.int32 and not zero.any(), name
        assert count.max() <= P_lines and count.min() >= 0, name
        assert np.all(np.diff(count) <= 0), name
        cover = {}
        for r, kk, s, c in zip(row, k, start, count):
            for line in range(s, s + c):
                key = (r, kk, line)
                assert key not in cover, name
                cover[key] = True
        want = {(r, kk, line) for r in range(w.shape[0]) for kk in range(n_win)
                for line in range(w[r, 2 * kk], w[r, 2 * kk] + w[r, 2 * kk + 1])}
        assert set(cover) == want, name
        per_row = np.bincount(row, minlength=w.shape[0])
        assert per_row.min() >= 1, name
        assert np.all(n_parts == per_row[row]), name
        for r in np.flatnonzero(per_row > 1):
            m = row == r
            order = np.lexsort((start[m], k[m]))
            np.testing.assert_array_equal(part[m][order], np.arange(per_row[r]))
        owned = per_row[row] > 1
        slots = slot[owned] + part[owned]
        assert len(set(slots.tolist())) == owned.sum() and (n_slots == 0 or slots.max() < n_slots)
        empty = w[:, 1::2].sum(axis=1) == 0
        assert np.all(count[np.isin(row, np.flatnonzero(empty))] == 0), name


def _piece_sum(plan, lines, windows, zones, batch, P_lines):
    """The kernel's combination in float64: each piece's partial sum over
    its lines, then each block's partials added in piece order."""
    table, _ = linesum_cuda.piece_schedule(windows, 1, P_lines)
    table = table[np.lexsort((table[:, 4], table[:, 0]))].astype(np.int64)
    nb, nb_lo = grid_blocks(plan.nu_blocks, torch.float64, "cpu")
    n_rows = windows.shape[0]
    out = torch.zeros(batch + (n_rows, plan.block), dtype=torch.float64)
    for q in range(int(table[:, 5].max())):
        sel = table[table[:, 4] == q]
        w = np.zeros((n_rows, 2), np.int64)
        w[sel[:, 0], 0], w[sel[:, 0], 1] = sel[:, 2], sel[:, 3]
        part = block_sum(nb, nb_lo, lines, w, zones, batch).reshape(out.shape)
        out += part
    return out.reshape(batch + (-1,))[..., : plan.n_nu]


@pytest.mark.parametrize("shape", ["voigt", "lorentz", "phco2"])
@pytest.mark.parametrize("P_lines", [5, 64])
def test_piece_sums_match_plain_and_jax(cat, shape, P_lines):
    plan, lines = cat["tp"], cat["tl"]
    states = _states()
    S, a, g = _line_params(lines, *states)
    batch = (len(T),)
    zones = [(0, tile_exact(shape, S, a, g, tile_T(states[0], batch)),
              lambda adnu, D: adnu <= plan.cut, None)]
    got = _piece_sum(plan, lines, plan.windows(), zones, batch, P_lines)
    ref = sigma_from_lines(plan, lines, *states, shape=shape)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-12, atol=1e-300)
    jref = np.asarray(jsigma(cat["jp"], cat["jl"], jnp.asarray(T), jnp.asarray(P),
                             jnp.asarray(0.4 * P), shape))
    m = np.abs(jref) > 1e-35
    np.testing.assert_allclose(got.numpy()[m], jref[m], rtol=1e-9)


def test_state_tiles_cover_the_states():
    """K1's tiles: n // 8 of 8, then one of 4, 2, 1 per bit of the rest."""
    for n in range(0, 70):
        sizes = [8] * (n // 8) + [w for w in (4, 2, 1) if n % 8 & w]
        assert linesum_cuda.state_tiles(n) == len(sizes) and sum(sizes) == n
    assert linesum_cuda.state_tiles(57) == 8 and linesum_cuda.state_tiles(38) == 6


# --- the pack: the tiled layout against the line-major one ---------------------

def _old_pack(mode, S, alpha, gamma, st=8):
    """The tiled pack K1 read before its line-major one, [n_tiles, n_lines,
    ST nc]: (Sia, ia, y0, A, c1, c2, k2)
    for the voigt modes, (Sia, ia, y0) for NOSPLIT, (S, alpha, gamma) for
    lorentz and doppler, states padded to whole tiles."""
    n_states, n_lines = S.shape
    if mode in (1, 2):
        rows = list(zip((S, alpha, gamma), (0.0, 1.0, 1.0)))
    elif mode == 12:
        rows = list(zip(voigt_coefficients(S, alpha, gamma)[:3], (0.0, 1.0, 1.0)))
    else:
        rows = list(zip(voigt_coefficients(S, alpha, gamma), (0.0, 1.0, 1.0, 1.0, 1.5, 4.0, 0.0)))
    n_tiles = -(-n_states // st)
    pad = n_tiles * st - n_states
    cols = [torch.cat([v, v.new_full((pad, n_lines), f)]) if pad else v for v, f in rows]
    pack = torch.stack(cols, dim=-1).view(n_tiles, st, n_lines, len(rows)).permute(0, 2, 1, 3)
    return pack.reshape(n_tiles, n_lines, st * len(rows)).contiguous()


def _old_unpack(coef, n_states, nc, st=8):
    n_tiles, n_lines, _ = coef.shape
    v = coef.view(n_tiles, n_lines, st, nc).permute(0, 2, 1, 3).reshape(n_tiles * st, n_lines, nc)
    return tuple(v[:n_states, :, i] for i in range(nc))


@pytest.mark.parametrize("mode", [0, 1, 2, 4, 6, 12])
def test_line_major_pack_reads_as_the_tiled_one(cat, mode):
    """The stand-in launch of tests/test_torch_sharded.py (the kernel's
    reading of its operands, float64) gives the same sigma on the
    line-major pack as on the tiled one."""
    from test_torch_sharded import _stand_in_launch, _unpack

    plan, lines = cat["tp"], cat["tl"]
    states = _states()
    S, a, g = _line_params(lines, *states)
    n = len(T)
    new = linesum_cuda.pack_coefficients(mode, S, a, g)
    assert new.shape == (lines.n_lines, n, linesum_cuda._N_COEF[mode])
    nc_old = 3 if mode in (1, 2, 12) else 7
    old = _old_unpack(_old_pack(mode, S, a, g), n, nc_old)
    got = _unpack(new, mode)
    for x, y in zip(got, old):
        if x is not None:
            np.testing.assert_array_equal(x.numpy(), y.numpy())
    if mode in (4, 6):
        geom = ls.coarse_geometry(plan, lines, ls.coarse_params(plan, 0.6))
        blocks, windows = ((geom.fine_blocks, geom.fine_windows) if mode == 4
                           else (geom.coarse_blocks, geom.coarse_windows))
        z = geom.zones
        zones = linesum_cuda._zones(**z)
        n_out = plan.n_nu if mode == 4 else geom.params[2]
        d_near = torch.clamp(15.0 * a.max(), max=z["cut_f"]).reshape(1) if mode == 4 else None
    else:
        blocks, windows, n_out = plan.nu_blocks, plan.windows(), plan.n_nu
        zones = linesum_cuda._zones(plan.cut)
        d_near = torch.clamp(15.0 * a.max(), max=plan.cut).reshape(1) if mode == 0 else None
    hi, lo = (torch.as_tensor(x.reshape(-1)) for x in linesum_cuda.two_float(blocks))
    grid = {"nu_hi": hi, "nu_lo": lo, "win": torch.as_tensor(windows, dtype=torch.int32)}
    sig_new = _stand_in_launch(mode, grid, lines, new, n, n_out, zones, d_near)
    old_as_new = torch.stack([c if c is not None else torch.zeros_like(S)
                              for c in _old_layout_as_new(mode, old)], -1).transpose(0, 1)
    sig_old = _stand_in_launch(mode, grid, lines, old_as_new.contiguous(), n, n_out, zones,
                               d_near)
    np.testing.assert_array_equal(sig_new.numpy(), sig_old.numpy())


def _old_layout_as_new(mode, old):
    """The tiled pack's values placed where the line-major pack keeps them."""
    if mode in (0, 4):
        Sia, ia, y0, A, c1, c2, k2 = old
        return (Sia, ia, y0, None, A, c1, c2, k2)
    if mode == 6:
        return old[3:]
    if mode == 12:
        return (*old, None)
    return (*old, None)


# --- the reciprocal's bound ---------------------------------------------------

@pytest.mark.parametrize("shape", ["voigt", "phco2"])
def test_far_reciprocal_bound_holds_the_denominators(cat, shape):
    """Every region-1 denominator over |dnu| <= cut lies between the bounds
    :func:`far_reciprocal_ok` takes (2 y^2 and the cut's), so the flag it
    gives is one the data obeys; pressures that make y0 vanish clear it."""
    lines, plan = cat["tl"], cat["tp"]
    states = [x.float() for x in _states()]
    S, a, g = _line_params(lines.to(torch.float32), *states)
    cut = 500.0 if shape == "phco2" else plan.cut
    mode = 11 if shape == "phco2" else 6
    bcoef = linesum_cuda.chi_rates(states[0]) if shape == "phco2" else None
    co32 = voigt_coefficients(S, a, g)
    assert linesum_cuda.far_reciprocal_ok(mode, co32, 1, cut, bcoef).tolist() == [1]
    co = [c.double() for c in co32]
    d = torch.cat([torch.logspace(-5, np.log10(cut), 300, dtype=torch.float64),
                   torch.linspace(0.0, cut, 101, dtype=torch.float64)])
    dnu = torch.cat([-d, d])
    x2 = dnu[None, None, :] ** 2 * co[3][..., None]
    y = co[2][..., None].expand_as(x2)
    if shape == "phco2":
        from clearsky_tpu_torch.ops.lineshape import chi_phco2

        y = y * chi_phco2(dnu.abs()[None, None, :], states[0].double()[:, None, None])
    den = (0.5 + y * y - x2) ** 2 + 4.0 * x2 * y * y
    lo, hi = linesum_cuda._chi_range(bcoef, len(T), cut) if bcoef is not None else (1.0, 1.0)
    lo = torch.as_tensor(lo, dtype=torch.float64).reshape(-1, 1, 1)
    hi = torch.as_tensor(hi, dtype=torch.float64).reshape(-1, 1, 1)
    y2 = co[2][..., None] ** 2
    assert bool((den >= 2.0 * (y2 * lo * lo).amin() * (1 - 1e-9)).all())
    A = co[3].max()
    y2hi = float((y2 * hi * hi).max())
    assert float(den.max()) <= (0.5 + y2hi + cut * cut * A) ** 2 + 4 * cut * cut * A * y2hi
    # one line of y0 ~ 1e-25 (its denominators reach 2e-50) clears the flag;
    # a line of zero strength is left out of the bound
    tiny = [c.clone() for c in co32]                       # Sia, ia, y0, A, c1, c2, k2
    if shape == "phco2":
        tiny[2][1, 7] = 1e-25
    else:
        tiny[5][1, 7] = 4e-50 * float(tiny[3][1, 7])        # c2 = 4 y0^2 A
    assert linesum_cuda.far_reciprocal_ok(mode, tiny, 1, cut, bcoef).tolist() == [0]
    live = 0 if shape == "phco2" else 6                      # Sia or k2
    tiny[live][1, 7] = 0.0
    assert linesum_cuda.far_reciprocal_ok(mode, tiny, 1, cut, bcoef).tolist() == [1]
    # the bound per shard: two shards, the tiny line in the first
    tiny[live][1, 7] = 1.0
    two = [torch.cat([t, c], dim=1) for t, c in zip(tiny, co32)]
    assert linesum_cuda.far_reciprocal_ok(mode, two, 2, cut, bcoef).tolist() == [0, 1]
    # a mode with no far wing gives no flag
    assert linesum_cuda.far_reciprocal_ok(12, co32, 1, cut).tolist() == [0]

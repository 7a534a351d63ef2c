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

import clearsky_tpu_torch as ct
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


@pytest.mark.parametrize("kind", ["k1", "window"])
def test_state_tiles_cover_the_states(kind):
    """K1's tiles: n // 8 of 8, then one of 4, 2, 1 per bit of the rest; the
    window modes' balanced tiles: ceil(n / 8) of n // T or n // T + 1 states
    in tile order, so that no tile repeats the pair work for a state or two
    (57 = 8 + 7 x 7, 38 = 3 x 8 + 2 x 7)."""
    if kind == "k1":
        for n in range(0, 70):
            sizes = [8] * (n // 8) + [w for w in (4, 2, 1) if n % 8 & w]
            assert linesum_cuda.state_tiles(n) == len(sizes) and sum(sizes) == n
        assert linesum_cuda.state_tiles(57) == 8 and linesum_cuda.state_tiles(38) == 6
        return
    for n in range(0, 70):
        sizes = linesum_cuda.window_tile_sizes(n)
        assert len(sizes) == linesum_cuda.window_tiles(n) == -(-n // 8) and sum(sizes) == n
        if n:
            assert max(sizes) <= 8 and max(sizes) - min(sizes) <= 1
            assert sizes == sorted(sizes, reverse=True)
        if n >= 8:
            assert min(sizes) >= 4
    assert linesum_cuda.window_tile_sizes(57) == [8] + [7] * 7
    assert linesum_cuda.window_tile_sizes(38) == [8, 8, 8, 7, 7]


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
    assert new.shape == ((lines.n_lines, 2, n, 4) if mode == 4
                         else (lines.n_lines, n, linesum_cuda._N_COEF[mode]))
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
    sig_old = _stand_in_launch(mode, grid, lines, _old_layout_as_new(mode, old), n, n_out, zones,
                               d_near)
    np.testing.assert_array_equal(sig_new.numpy(), sig_old.numpy())


def _old_layout_as_new(mode, old):
    """The tiled pack's values placed where the line-major pack keeps them
    (0 where the stand-in reads nothing; FINE [n_lines, 2, n_states, 4]:
    its window quad's A and k2, then the core's (Sia, ia, y0))."""
    zero = torch.zeros_like(old[0])
    stack = lambda cols: torch.stack([zero if c is None else c for c in cols], -1).transpose(0, 1)
    if mode in (0, 4):
        Sia, ia, y0, A, c1, c2, k2 = old
        if mode == 4:
            return torch.stack([stack((A, None, None, k2)), stack((Sia, ia, y0, None))],
                               dim=1).contiguous()
        return stack((Sia, ia, y0, None, A, c1, c2, k2)).contiguous()
    if mode == 6:
        return stack(old[3:]).contiguous()
    return stack((*old, None)).contiguous()


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


# --- the window modes (FARALL, FINE_STENCIL): work items and arithmetic ----------

def _stream(w_row, n_win):
    """A row's lines as window_kernel streams them: window by window, each in
    line order (the order of JAX's sweeps: the mid window, then the annuli)."""
    return [line for k in range(n_win)
            for line in range(w_row[2 * k], w_row[2 * k] + w_row[2 * k + 1])]


def _stream_line(w_row, n_win, i):
    """csrc/linesum.cu ``WindowItem::line``: the catalog index of the
    stream's line i, from the windows' starts and running ends."""
    end = np.cumsum(w_row[1::2][:n_win])
    for k in range(n_win):
        if i < end[k]:
            return int(w_row[2 * k] + i - (end[k - 1] if k else 0))
    raise IndexError(i)


@pytest.mark.parametrize("P_lines", [1, 7, 64, 256])
def test_window_pieces_cover_each_row_once(cat, P_lines):
    """window_kernel's work items: each row's windows as one stream (the mid
    window, then both annuli, each in line order), cut into pieces of at
    most P lines numbered in stream order, every stream line in exactly one
    piece; pieces listed largest first; rows of several pieces own disjoint
    scratch slots; a row without lines one empty piece."""
    for name, win, n_win in _tables(cat):
        w = np.asarray(win, np.int64).reshape(-1, 2 * n_win)
        table, n_slots = linesum_cuda.window_schedule(w, n_win, P_lines)
        row, win_col, start, count, part, n_parts, slot, zero = table.T.astype(np.int64)
        assert table.dtype == np.int32 and not zero.any() and not win_col.any(), name
        assert count.max() <= P_lines and count.min() >= 0, name
        assert np.all(np.diff(count) <= 0), name
        total = w[:, 1::2].sum(axis=1)
        per_row = np.bincount(row, minlength=w.shape[0])
        assert np.all(per_row == np.maximum(1, -(-total // P_lines))), name
        assert np.all(n_parts == per_row[row]), name
        for r in range(w.shape[0]):
            m = np.flatnonzero(row == r)
            m = m[np.argsort(part[m])]
            np.testing.assert_array_equal(part[m], np.arange(m.size))
            covered = np.concatenate([np.arange(a, a + c) for a, c in zip(start[m], count[m])])
            np.testing.assert_array_equal(covered, np.arange(total[r]))
            if r % 7 == 0:       # the stream's mapping, as the kernel computes it
                assert [_stream_line(w[r], n_win, i) for i in range(total[r])] == \
                    _stream(w[r], n_win)
        owned = per_row[row] > 1
        slots = slot[owned] + part[owned]
        assert len(set(slots.tolist())) == owned.sum(), name
        assert n_slots == 0 or slots.max() < n_slots, name


def _f(x):
    """float64 arithmetic rounded once to float32: a fused multiply-add."""
    return x.float()


def _emulate_window(mode, shape, blocks64, windows, lines, coef, z, T, P_lines, G):
    """csrc/linesum.cu ``window_kernel`` in float32 on its pack and window
    table: per row, each piece's lines streamed in the mode's chunks,
    group g summing lines [g per, (g + 1) per) of each chunk in order, the
    groups' sums added in group order, a row's pieces in piece order; per
    triple the kernel's algebra, each fmaf one rounding (the reciprocal
    exact in float32 where the kernel's rcp.approx is within 1 ulp), and
    within two Doppler widths of a line (D amin <= 4, a point at a time) the
    plain version's algebra."""
    from clearsky_tpu_torch.ops.linesum import two_float

    hi, lo = (torch.as_tensor(x) for x in two_float(blocks64))
    n_rows, B = hi.shape
    n_win = windows.shape[1] // 2
    n = coef.shape[1]
    ph = shape == "phco2"
    if ph:
        LOG2E = np.float32(1.4426950408889634)
        rates = linesum_cuda.chi_rates(T).permute(1, 0, 2).reshape(2, -1)[:, :n]
        b1, b2 = (rates[i][:, None] * torch.tensor(LOG2E) for i in (0, 1))
    m = linesum_cuda.window_mode(mode, shape)
    amin = linesum_cuda.window_core_reach(m, coef)
    table, _ = linesum_cuda.window_schedule(windows, n_win, P_lines)
    table = table[np.lexsort((table[:, 4], table[:, 0]))].astype(np.int64)
    ch = linesum_cuda.WINDOW_CHUNKS[m]
    per = -(-ch // G)
    out = torch.zeros((n, n_rows * B), dtype=torch.float32)
    for r in range(n_rows):
        w = windows[r]
        end0 = w[1]
        tot = None
        for _, _, o, cnt, *_ in table[table[:, 0] == r]:
            sums = torch.zeros((G, n, B), dtype=torch.float32)
            for k in range(-(-cnt // ch)):
                n_k = min(ch, cnt - k * ch)
                for g in range(G):
                    for j in range(g * per, min(n_k, (g + 1) * per)):
                        ci = o + k * ch + j
                        line = _stream_line(w, n_win, ci)
                        dnu = (hi[r] - lines.nu[line]) + (lo[r] - lines.nu_lo[line])
                        adnu, D = dnu.abs(), dnu * dnu
                        wt = torch.ones_like(D)
                        if mode == "fine_stencil" and ci < end0:
                            mask = adnu <= z["cut_f"]
                            wt = 1.0 - _smooth32(D, z["D1"], z["D2"])
                        elif mode == "fine_stencil":
                            mask = (adnu <= z["cut"]) & (D > z["R1"])
                            wt = _smooth32(D, z["R1"], z["R2"])
                        else:
                            mask = adnu <= z["cut"]
                        c = coef[line]                       # [n, 4]
                        D64, wt64 = D.double()[None], wt.double()[None]
                        core = (D * amin[line] <= 4.0)[None]
                        if ph:
                            u, v, ww = _chi_arg2(adnu)
                            e = _f(b1.double() * u.double()
                                   + _f(b2.double() * v.double() + ww.double()).double())
                            chi = torch.exp2(-e)
                            y = c[:, 1:2] * chi
                            y2 = y * y
                            wq = _f(-D64 * c[:, 2:3].double() + (0.5 - y2).double())
                            den = _f(wq.double() ** 2 + (y2 + y2).double())
                            cy = ((c[:, 0:1] * wt[None]) if mode == "fine_stencil"
                                  else c[:, 0:1]) * y
                        else:
                            wq = _f(-D64 * c[:, 0:1].double() + c[:, 1:2].double())
                            den = _f(wq.double() ** 2 + c[:, 2:3].double())
                            cy = (c[:, 3:4] * wt[None]) if mode == "fine_stencil" else \
                                c[:, 3:4].expand_as(den)
                        num = _f(-cy.double() * wq.double() + cy.double())
                        # within a core the correction's algebra (far_parts)
                        if ph:
                            x2 = D[None] * c[:, 2:3]
                            hh = 0.5 + y2
                            br = hh - x2
                            den_c = _f(br.double() ** 2 + (4.0 * (x2 * y2)).double())
                            num_c = c[:, 0:1] * (y * (hh + x2))
                        else:
                            c1 = _f(c[:, 2:3].double() * 0.5 + 0.5)
                            m_ = D[None] * c[:, 0:1]
                            br = c1 - m_
                            den_c = _f(br.double() ** 2
                                       + (((c[:, 2:3] + c[:, 2:3]) * c[:, 0:1]) * D[None]).double())
                            num_c = c[:, 3:4] * (c1 + m_)
                        if mode == "fine_stencil":
                            num_c = num_c * wt[None]
                        den = torch.where(core, den_c, den)
                        num = torch.where(core, num_c, num)
                        r_ = 1.0 / den
                        new = _f(num.double() * r_.double() + sums[g].double())
                        sums[g] = torch.where(mask[None], new, sums[g])
            acc = sums[0]
            for g in range(1, G):
                acc = acc + sums[g]
            tot = acc if tot is None else tot + acc
        out[:, r * B:(r + 1) * B] = tot
    return out


def _smooth32(D, A1, A2):
    """csrc/linesum.cu ``smooth_d2`` in float32, its inverse width rounded
    from float64 as the launch's ``Zones`` holds it."""
    inv = torch.tensor(1.0 / (A2 - A1), dtype=torch.float32)
    w = torch.clamp((D - torch.tensor(A1, dtype=torch.float32)) * inv, 0.0, 1.0)
    return w * w * w * (10.0 + w * (-15.0 + 6.0 * w))


def _chi_arg2(a):
    """csrc/linesum.cu ``chi_arg2`` in float32: the piece's (u, v, w') of
    chi = 2^-(B1' u + B2' v + w')."""
    z = torch.zeros_like(a)
    u = torch.where(a < 3.0, z, torch.where(a < 30.0, a - 3.0, torch.full_like(a, 27.0)))
    v = torch.where(a < 30.0, z, torch.where(a < 120.0, a - 30.0, torch.full_like(a, 90.0)))
    w = torch.where(a < 120.0, z, np.float32(0.0232 * 1.4426950408889634) * (a - 120.0))
    return u, v, w


@pytest.fixture(scope="module")
def window_cases():
    """Per (mode, shape): the window mode's grid, windows, zones and states
    on a 300-line catalog, with the float32 plain route's other parts and
    JAX's float32 route (interpret mode): FARALL in the stencil route on
    610-780 cm^-1 at 512 points, FINE_STENCIL in the coarse route with its
    stencil fine pass on 2300-2350 cm^-1 at 8192 points."""
    from clearsky_tpu.ops import linesum_pallas as jp
    from clearsky_tpu_torch.ops.linesum import DEFAULT_CUT

    par = synthetic_co2_par(300, seed=7)
    jl = JLines.from_par_dict(par)
    tl = convert.spectral_lines(jl, dtype=torch.float64, device="cpu")
    t32 = tl.to(torch.float32)
    Tn, Pn = np.array([200.0, 260.0, 300.0]), np.array([10.0, 3e3, 9e4])
    x32 = [torch.tensor(x, dtype=torch.float32) for x in (Tn, Pn, 0.5 * Pn)]
    x64 = [x.double() for x in x32]
    out = {}
    for mode, nu in (("farall", np.linspace(610.0, 780.0, 512)),
                     ("fine_stencil", np.linspace(2300.0, 2350.0, 8192))):
        for shape in ("voigt", "phco2"):
            cut = DEFAULT_CUT[shape]
            jpl = jplan(nu, np.asarray(jl.nu), cut)
            tpl = build_line_window_plan(nu, tl.positions64(), cut)
            _, co32 = ls.coefficients(t32, *x32, shape=shape)
            _, co64 = ls.coefficients(tl, *x64, shape=shape)
            Tc = ls.chi_T(shape, x32[0])
            Tc64 = ls.chi_T(shape, x64[0])
            strategy = "stencil" if mode == "farall" else "coarse"
            jref = np.asarray(jp.sigma_from_lines_pallas(
                jpl, jl, jnp.asarray(Tn), jnp.asarray(Pn), jnp.asarray(0.5 * Pn), shape,
                interpret=True, strategy=strategy))
            if mode == "farall":
                assert ls.route(tpl, tl, shape, "stencil", 3) == "stencil"
                blocks, windows, z = tpl.nu_blocks, tpl.windows(), {"cut": tpl.cut}
                route32 = ls.sigma_stencil_plain(tpl, t32, *x32, shape=shape)
            else:
                params = ls._resolve(tpl, tl, shape, "coarse", 3)[1]
                geom = ls.coarse_geometry(tpl, tl, params)
                assert geom.stencil is not None
                blocks, windows, z = geom.fine_blocks, geom.fine_windows, geom.zones
                route32 = ls.sigma_coarse_plain(tpl, t32, *x32, params, shape=shape)
            part32 = ls.sigma_mode_plain(mode, blocks, windows, t32, co32, z, T=Tc)
            ref64 = ls.sigma_mode_plain(mode, blocks, windows, tl, co64, z, T=Tc64)
            m = linesum_cuda.window_mode(mode, shape)
            coef = linesum_cuda._pack(m, co32)
            out[mode, shape] = dict(blocks=blocks, windows=np.asarray(windows, np.int64), z=z,
                                    lines=t32, T=x32[0], coef=coef, jref=jref,
                                    rest32=(route32 - part32[:, :tpl.n_nu]).double(),
                                    ref64=ref64, n_nu=tpl.n_nu, m=m)
    return out


@pytest.mark.parametrize("P_lines,G", [(None, None), (7, 4), (64, 2)])
@pytest.mark.parametrize("shape", ["voigt", "phco2"])
@pytest.mark.parametrize("mode", ["farall", "fine_stencil"])
def test_window_kernel_sums_match_plain_and_jax(window_cases, mode, shape, P_lines, G):
    """The window kernel's arithmetic and order (pack (A, 1/2 - y0^2, 2 y0^2,
    k2) or (0.5641896 Sia, y0, A, 0), region 1 as k2 (1 - w) / (w^2 + 2
    y^2), pieces and groups as the plan lays them out, or as given) in a
    float32 emulation: against its plain version in float64 (1e-5 of each
    state's peak, the windowed modes' bar), and, its part swapped into the
    float32 plain route, against JAX's float32 route (1e-5 of peak, the
    bar of the plain routes against JAX's)."""
    c = window_cases[mode, shape]
    n = c["coef"].shape[1]
    if P_lines is None:
        win = c["windows"]
        B = c["blocks"].shape[1]
        grid = {"nu_hi": torch.zeros(win.shape[0] * B), "nu_lo": torch.zeros(win.shape[0] * B),
                "win": torch.as_tensor(win, dtype=torch.int32), "win_host": win}
        plan = linesum_cuda.window_plan(c["m"], grid, n)
        P_lines, G = plan["piece_lines"], plan["groups"]
    got = _emulate_window(mode, shape, c["blocks"], c["windows"], c["lines"], c["coef"],
                          c["z"], c["T"], P_lines, G)
    assert bool(torch.isfinite(got).all())
    ref = c["ref64"]
    pk = ref.abs().amax(dim=1, keepdim=True)
    assert float(((got.double() - ref).abs() / pk).max()) < 1e-5
    route = (got[:, :c["n_nu"]].double() + c["rest32"]).numpy()
    jref = c["jref"]
    assert float((np.abs(route - jref) / np.abs(jref).max(axis=1, keepdims=True)).max()) < 1e-5


@pytest.mark.parametrize("cut", ["none", "arith", "stage", "newton", "no_core"])
def test_probe_cuts_apply_to_the_window_kernel(cut):
    """tools/k1_probe.py's cuts of the window modes find their text in
    csrc/linesum.cu exactly once (a changed source cannot give a silent
    uncut copy), and every cut but ``none`` changes it."""
    from clearsky_tpu_torch.tools import k1_probe
    from clearsky_tpu_torch.utils.cuda_build import CSRC

    src = (CSRC / "linesum.cu").read_text()
    assert k1_probe.window_design(src) == "window"
    out = k1_probe.window_cut_source(src, cut)
    assert (out == src) == (cut == "none")


@pytest.mark.parametrize("cut", ["none", "arith", "stage", "no_near"])
def test_probe_cuts_apply_to_the_fine_path(cut):
    """tools/k1_probe.py's cuts of FINE (``--fine --cuts``) find their text
    in csrc/linesum.cu exactly once, and every cut but ``none`` changes it."""
    from clearsky_tpu_torch.tools import k1_probe
    from clearsky_tpu_torch.utils.cuda_build import CSRC

    src = (CSRC / "linesum.cu").read_text()
    assert k1_probe.fine_design(src) == "window"
    out = k1_probe.fine_cut_source(src, cut)
    assert (out == src) == (cut == "none")


# --- FINE on the window kernel: w4 within each pair's near reach ---------------

def _fma(a, b, c):
    """fmaf: a b + c rounded once to float32."""
    return (a.double() * b.double() + c.double()).float()


def _fine_region1(ph, k, D, wt, b1, b2, chi_q):
    """csrc/linesum.cu ``region1_term<PH, FAST, true>`` of one line at the
    row's points, float32 with each fmaf rounded once: (num, den) [ns, B]
    from its window quads ``k`` [ns, 4], D and the weight wt [B]."""
    if ph:
        u, v, ww = chi_q
        y = k[:, 1:2] * torch.exp2(-_fma(b1[:, None], u[None], _fma(b2[:, None], v[None],
                                                                   ww[None])))
        y2 = y * y
        w = _fma(-D[None], k[:, 2:3], 0.5 - y2)
        den = _fma(w, w, y2 + y2)
        cy = (k[:, 0:1] * wt[None]) * y
    else:
        w = _fma(-D[None], k[:, 0:1], k[:, 1:2])
        den = _fma(w, w, k[:, 2:3])
        cy = (k[:, 3:4] * wt[None]).expand_as(den)
    return _fma(-cy, w, cy), den


def _emulate_fine(ph, b, table, G, PTS):
    """csrc/linesum.cu ``window_kernel``'s FINE path in float32 on a launch's
    operands ``b`` (launch_mode's arguments: grid, flat catalog, pack
    [n_lines, 2, n_states, 4], d_near a shard, zones, chi's rates), the
    pieces ``table`` (:func:`window_plan`'s, or :func:`window_schedule`'s)
    and :func:`fine_reach`: per row and balanced tile, each piece's lines
    streamed in chunks, group g summing lines [g per, (g + 1) per) of each
    in stream order: region 1 on the window quads (each fmaf rounded once,
    the reciprocal exact in float32 where the kernel's rcp.approx errs by at
    most 1 ulp); a near line (a mid-window line whose tile reach meets the
    row) w4 within each (line, state)'s reach, Sia w4 (1 - W), and region 1
    beyond; groups, then pieces, summed in order."""
    from clearsky_tpu_torch.ops.faddeeva import wofz_re

    grid, lines, coef = b["grid"], b["lines"], b["coef"]
    n, n_out, k_sh = b["n_states"], b["n_out"], b.get("n_shards", 1)
    mode = b["mode"]
    z = dict(zip(("cut", "cut_f", "d_lo", "D1", "inv_D", "R1", "inv_R"),
                 (torch.tensor(v, dtype=torch.float32) for v in b["zones"])))
    win = np.asarray(grid["win"], np.int64)
    rows = win.shape[0]
    B = grid["nu_hi"].shape[0] // rows
    nb = rows // k_sh
    hi, lo = grid["nu_hi"].view(rows, B), grid["nu_lo"].view(rows, B)
    d_near = b["d_near"]
    reach = linesum_cuda.fine_reach(coef)
    smooth = lambda D, A1, inv: (lambda w: w * w * w * (10.0 + w * (-15.0 + 6.0 * w)))(
        torch.clamp((D - A1) * inv, 0.0, 1.0))
    if ph:
        rates = b["bcoef"].permute(1, 0, 2).reshape(2, -1)[:, :n]
        b1, b2 = (rates[i] * torch.tensor(np.float32(1.4426950408889634)) for i in (0, 1))
    table = np.asarray(table, np.int64)
    table = table[np.lexsort((table[:, 4], table[:, 0]))]
    ch = linesum_cuda.WINDOW_CHUNKS[mode]
    per = -(-ch // G)
    sizes = linesum_cuda.window_tile_sizes(n)
    out = torch.zeros((n, k_sh * n_out), dtype=torch.float32)
    eps = torch.tensor(1e-5, dtype=torch.float32)
    for r in range(rows):
        sh, rb = divmod(r, nb)
        w_row, end0 = win[r], win[r][1]
        nh, nl = hi[r], lo[r]
        dn = d_near[sh]
        for t, ns in enumerate(sizes):
            s0 = sum(sizes[:t])
            sl = slice(s0, s0 + ns)
            bb = (b1[sl], b2[sl]) if ph else (None, None)
            tot = None
            for _, _, o, cnt, *_ in table[table[:, 0] == r]:
                sums = torch.zeros((G, ns, B), dtype=torch.float32)
                for kc in range(-(-cnt // ch)):
                    c0, nk = o + kc * ch, min(ch, cnt - kc * ch)
                    for g in range(G):
                        for j in range(g * per, min(nk, (g + 1) * per)):
                            l = _stream_line(w_row, 3, c0 + j)
                            dnu = (nh - lines.nu[l]) + (nl - lines.nu_lo[l])
                            a, D = dnu.abs(), dnu * dnu
                            mid = c0 + j < end0
                            if mid:
                                keep, wt = a <= z["cut_f"], 1.0 - smooth(D, z["D1"], z["inv_D"])
                            else:
                                keep = (a <= z["cut"]) & (D > z["R1"])
                                wt = smooth(D, z["R1"], z["inv_R"])
                            num, den = _fine_region1(ph, coef[l, 0, sl], D, wt, *bb, _chi_arg2(a))
                            keep = keep[None].expand(ns, B)
                            rr = torch.minimum(dn, reach[l, t])
                            if ph and dn >= 3.0:
                                rr = torch.where(reach[l, t] > -3e38, dn, -1.0)
                            d0 = (nh[0] - lines.nu[l]) + (nl[0] - lines.nu_lo[l])
                            d1 = (nh[-1] - lines.nu[l]) + (nl[-1] - lines.nu_lo[l])
                            if mid and rr >= 0 and d0 <= rr + eps and d1 >= -rr - eps:
                                # a near line: w4 within each pair's reach
                                nq = coef[l, 1, sl]                          # [ns, 4]
                                rs = torch.minimum(dn, nq[:, 3])
                                if ph and dn >= 3.0:
                                    rs = torch.where(nq[:, 3] > -3e38, dn, -1.0)
                                isc = a[None] <= rs[:, None]                 # [ns, B]
                                chi = 1.0
                                if ph:
                                    u, v, ww = _chi_arg2(a)
                                    chi = torch.exp2(-(b1[sl][:, None] * u[None])
                                                     - b2[sl][:, None] * v[None] - ww[None])
                                x = dnu[None] * nq[:, 1:2]
                                w4 = nq[:, 0:1] * wofz_re(x, (nq[:, 2:3] * chi).expand_as(x))
                                sums[g] = torch.where(isc, sums[g] + w4 * wt[None], sums[g])
                                keep = keep & ~isc
                            sums[g] = torch.where(keep, _fma(num, 1.0 / den, sums[g]), sums[g])
                acc = sums[0]
                for g in range(1, G):
                    acc = acc + sums[g]
                tot = acc if tot is None else tot + acc
            cols = np.arange(B)
            ok = rb * B + cols < n_out
            out[sl, sh * n_out + rb * B + cols[ok]] = tot[:, ok]
    return out


def _fine_operands(lines, plan, states, shape):
    """FINE's launch operands on the coarse split's fine grid of ``plan``
    (where its stencil geometry rejects), as ``sigma_coarse`` makes them,
    float32 on the CPU, with the float64 plain version of the mode."""
    name, params = ls._resolve(plan, lines, shape, "coarse", int(states[0].shape[0]))
    assert name == "coarse"
    geom = ls.coarse_geometry(plan, lines, params)
    assert geom.stencil is None
    l32 = lines.to(torch.float32)
    x32 = [x.float() for x in states]
    alpha, co = ls.coefficients(l32, *x32, shape=shape)
    m = linesum_cuda.window_mode("fine", shape)
    z = geom.zones
    b = dict(mode=m, grid=linesum_cuda._coarse_arrays(geom, torch.device("cpu"))["fine"],
             lines=l32, coef=linesum_cuda._pack(m, co), n_states=int(x32[0].shape[0]),
             n_out=plan.n_nu, zones=linesum_cuda._zones(**z),
             d_near=linesum_cuda.near_distance(alpha, z["cut_f"]),
             bcoef=linesum_cuda.chi_rates(x32[0]) if shape == "phco2" else None)
    a64, co64 = ls.coefficients(lines, *states, shape=shape)
    ref = ls.sigma_mode_plain("fine", geom.fine_blocks, geom.fine_windows, lines, co64, z,
                              torch.clamp(15.0 * a64.max(), max=z["cut_f"]),
                              T=ls.chi_T(shape, states[0]))
    return b, ref, geom


@pytest.fixture(scope="module")
def fine_cases():
    """FINE's operands where the main path runs it (the coarse split where
    the stencil geometry rejects the grid, K > 64), voigt and phco2 at cut
    25 cm^-1 on states from 10 Pa (y0 < 0.01: the small-y repair) to 9e4
    Pa (y0 > 15: no w4 pairs): ``dense``, a 1500-line catalog on 2330-2350
    cm^-1 at 2^14 points (~1.8 near lines a row), with JAX's float32
    coarse route (interpret mode) and the
    float32 plain route's other parts; ``crowded``, a block of 128 points
    on 2340-2350 cm^-1 whose mid window holds ~100 lines within d_near
    (several chunks of near lines), beside 15 empty blocks."""
    from clearsky_tpu.ops import linesum_pallas as jp

    Tn, Pn = np.array([200.0, 260.0, 300.0]), np.array([10.0, 3e3, 9e4])
    states = [torch.tensor(x, dtype=torch.float64) for x in (Tn, Pn, 0.5 * Pn)]
    out = {}
    par = synthetic_co2_par(1500, seed=3)
    jl = JLines.from_par_dict(par)
    tl = convert.spectral_lines(jl, dtype=torch.float64, device="cpu")
    nu = np.linspace(2330.0, 2350.0, 2**14)
    plan = build_line_window_plan(nu, tl.positions64(), 25.0)
    for shape in ("voigt", "phco2"):
        b, ref, geom = _fine_operands(tl, plan, states, shape)
        jref = np.asarray(jp.sigma_from_lines_pallas(
            jplan(nu, np.asarray(jl.nu), 25.0), jl, jnp.asarray(Tn), jnp.asarray(Pn),
            jnp.asarray(0.5 * Pn), shape, interpret=True, strategy="coarse"))
        x32 = [x.float() for x in states]
        route32 = ls.coarse_route_plain(geom, tl.to(torch.float32), *x32, shape=shape)
        _, co32 = ls.coefficients(tl.to(torch.float32), *x32, shape=shape)
        a32 = ls.coefficients(tl.to(torch.float32), *x32, shape=shape)[0]
        part32 = ls.sigma_mode_plain("fine", geom.fine_blocks, geom.fine_windows,
                                     tl.to(torch.float32), co32, geom.zones,
                                     torch.clamp(15.0 * a32.max(), max=geom.zones["cut_f"]),
                                     T=ls.chi_T(shape, x32[0]))[:, :plan.n_nu]
        out["dense", shape] = dict(b=b, ref=ref, jref=jref, n_nu=plan.n_nu,
                                   rest32=(route32 - part32).double())
    crowd = ct.SpectralLines.from_par_dict(synthetic_co2_par(6000, seed=3),
                                           dtype=torch.float64, device="cpu")
    cnu = np.concatenate([np.linspace(2340.0, 2350.0, 128), 2450.0 + 0.1 * np.arange(1920)])
    cplan = build_line_window_plan(cnu, crowd.positions64(), 25.0)
    for shape in ("voigt", "phco2"):
        l32 = crowd.to(torch.float32)
        x32 = [x.float() for x in states]
        alpha, co = ls.coefficients(l32, *x32, shape=shape)
        z = ls.split_zones(25.0, 1.0, 0.1)
        windows, _ = ls.split_windows(crowd.positions64(), cplan.nu_blocks, cplan.nu_blocks,
                                      25.0, 1.0, 0.1)
        hi, lo = (torch.as_tensor(v.reshape(-1)) for v in linesum_cuda.two_float(cplan.nu_blocks))
        m = linesum_cuda.window_mode("fine", shape)
        d32 = linesum_cuda.near_distance(alpha, z["cut_f"])
        b = dict(mode=m, grid={"nu_hi": hi, "nu_lo": lo, "win": torch.as_tensor(windows)},
                 lines=l32, coef=linesum_cuda._pack(m, co), n_states=3, n_out=cplan.n_nu,
                 zones=linesum_cuda._zones(**z), d_near=d32,
                 bcoef=linesum_cuda.chi_rates(x32[0]) if shape == "phco2" else None)
        a64, co64 = ls.coefficients(crowd, *states, shape=shape)
        ref = ls.sigma_mode_plain("fine", cplan.nu_blocks, windows, crowd, co64, z,
                                  torch.clamp(15.0 * a64.max(), max=z["cut_f"]),
                                  T=ls.chi_T(shape, states[0]))
        out["crowded", shape] = dict(b=b, ref=ref)
    return out


def _of_peak(got, ref):
    return float(((got.double() - ref).abs() / ref.abs().amax(dim=1, keepdim=True)).max())


@pytest.mark.parametrize("P_lines,G,pts", [(None, None, None), (7, 4, 1), (64, 2, 2)])
@pytest.mark.parametrize("shape", ["voigt", "phco2"])
@pytest.mark.parametrize("geometry", ["dense", "crowded"])
def test_fine_kernel_sums_match_plain_and_jax(fine_cases, geometry, shape, P_lines, G, pts):
    """FINE on the window kernel (its pack: the window quad, then (Sia, ia,
    y0, reach); w4 within each (line, state)'s near reach, region 1 beyond;
    pieces and groups as the plan lays them out, or as given) in a
    float32 emulation: against its plain version in float64 (1e-5 of each
    state's peak, the windowed modes' bar), and, its part swapped into the
    float32 plain route, against JAX's float32 coarse route with the
    in-kernel fine pass (1e-5 of peak, the bar of the plain routes against
    JAX's)."""
    c = fine_cases[geometry, shape]
    b = c["b"]
    win = np.asarray(b["grid"]["win"], np.int64)
    if P_lines is None:
        plan = linesum_cuda.window_plan(b["mode"], dict(b["grid"]), b["n_states"])
        table, G, pts = plan["table"].numpy(), plan["groups"], plan["points_per_thread"]
    else:
        table = linesum_cuda.window_schedule(win, 3, P_lines)[0]
    got = _emulate_fine(shape == "phco2", b, table, G, pts)
    assert bool(torch.isfinite(got).all())
    assert _of_peak(got, c["ref"]) < 1e-5
    if geometry == "dense":
        route = (got[:, :c["n_nu"]].double() + c["rest32"]).numpy()
        jref = c["jref"]
        assert float((np.abs(route - jref) / np.abs(jref).max(axis=1, keepdims=True)).max()) < 1e-5


@pytest.mark.parametrize("shape", ["voigt", "phco2"])
def test_fine_near_reach(fine_cases, shape):
    """Each (line, state)'s near reach on the dense grid: d_near where y0 <
    0.01 (the small-y repair: the plain version's zone), shorter where y0 is
    larger (w4 is its region 1 beyond |x| + y = 15) and none where y0 >
    15.01 (the high-pressure state, whose w4 is region 1 throughout); a
    line's tile reach with d_near is the largest of its states'; the
    crowded block holds more near lines than a chunk's 32."""
    dense = fine_cases["dense", shape]["b"]
    live = (dense["coef"][:, 1, :, 0] != 0).all(dim=1)
    r = torch.minimum(dense["d_near"], dense["coef"][:, 1, :, 3])[live]   # [live lines, n]
    assert bool((r[:, -1] < 0).all()) and bool((r[:, 0] > 0).all())
    assert bool((r[:, 0] == dense["d_near"]).any())
    assert bool(((r[:, 1] > 0) & (r[:, 1] < dense["d_near"])).any())
    reach = linesum_cuda.fine_reach(dense["coef"])
    assert torch.equal(torch.minimum(dense["d_near"], reach[live, 0]), r.amax(dim=1))
    b = fine_cases["crowded", shape]["b"]
    crowd = torch.minimum(b["d_near"], linesum_cuda.fine_reach(b["coef"])[:, 0])
    hi = b["grid"]["nu_hi"][:128].double()
    pos = b["lines"].nu.double()
    near = (crowd >= 0) & (pos >= hi.min() - crowd.double()) & (pos <= hi.max() + crowd.double())
    assert int(near.sum()) > 32


_LAUNCH_MODE = linesum_cuda.launch_mode


def _captured_dev_launches(monkeypatch, sg, states, shape):
    """K1-dev's coarse-route launches on CPU tensors: {launch-count name:
    launch_mode's bound arguments}, as ``device_launches`` packs them."""
    import inspect

    sig = inspect.signature(_LAUNCH_MODE)
    got = {}

    def record(*a, **k):
        args = sig.bind(*a, **k).arguments
        got[args["count_as"]] = args
        return torch.zeros((args["n_states"], args.get("n_shards", 1) * args["n_out"]))

    monkeypatch.setattr(linesum_cuda, "launch_mode", record)
    monkeypatch.setattr(linesum_cuda, "_checked", lambda lines, T, P, Pp, conc=None:
                        (T.shape[0], T.device))
    launches, _ = linesum_cuda.device_launches(sg.plans, sg.lines, *states, None, shape, "coarse")
    for _, f in launches:
        f()
    return got


@pytest.fixture(scope="module")
def fine_stack():
    """The dense FINE grid (1500 lines, 2330-2350 cm^-1, 2^14 points) in 4
    spectral shards, float32 on the CPU: voigt's fine blocks of 512 points,
    phco2's of 128; the states of :func:`fine_cases`."""
    Tn, Pn = np.array([200.0, 260.0, 300.0]), np.array([10.0, 3e3, 9e4])
    states = [torch.tensor(x, dtype=torch.float32) for x in (Tn, Pn, 0.5 * Pn)]
    lines = ct.SpectralLines.from_par_dict(synthetic_co2_par(1500, seed=3),
                                           dtype=torch.float32, device="cpu")
    nu = np.linspace(2330.0, 2350.0, 2**14)
    return {shape: (shard_line_gas(DirectGas.from_lines(lines, 0.9, nu, shape=shape), 4), states)
            for shape in ("voigt", "phco2")}


@pytest.mark.parametrize("shape", ["voigt", "phco2"])
def test_device_launches_pack_each_mode_on_its_own(monkeypatch, fine_stack, shape):
    """K1-dev's coarse route hands FINE its own pack (the window quad, then
    (Sia, ia, y0, reach), [n_lines, 2, n_states, 4]) and COARSE its own
    (voigt (A, c1, c2, k2), phco2 (Sia, ia, y0, A)), whatever their widths:
    a COARSE launch handed FINE's pack fails here."""
    from clearsky_tpu_torch.ops.linesum import effective_alpha

    sg, states = fine_stack[shape]
    got = _captured_dev_launches(monkeypatch, sg, states, shape)
    fm, cm = (linesum_cuda.window_mode(m, shape) for m in ("fine", "coarse"))
    fine, coarse = got["dev_" + linesum_cuda._MODE_NAMES[fm]], got["dev_" + linesum_cuda._MODE_NAMES[cm]]
    flat = linesum_cuda._flat_lines(sg.lines)
    S, a, g = _line_params(flat, *states)
    co = voigt_coefficients(S, effective_alpha(shape, a), g)
    assert fine["mode"] == fm and coarse["mode"] == cm
    assert torch.equal(fine["coef"], linesum_cuda._pack(fm, co))
    assert torch.equal(coarse["coef"], linesum_cuda._pack(cm, co))
    assert coarse["coef"].shape == (flat.n_lines, 3, 4)
    assert fine["coef"].shape == (flat.n_lines, 2, 3, 4)


@pytest.mark.parametrize("shape", ["voigt", "phco2"])
def test_fine_stack_of_shards_matches_each_shard(monkeypatch, fine_stack, shape):
    """FINE over a stack of 4 shards in one launch (rows s n_blocks + b,
    d_near and columns a shard): every row of every shard in exactly one
    work item of the plan; the float32 emulation of the stacked launch
    against each shard's plain FINE in float64 (1e-5 of each state's
    peak), and each shard's columns the same bits as that shard launched
    alone."""
    from clearsky_tpu_torch.ops.linesum import shard_lines

    sg, states = fine_stack[shape]
    b = _captured_dev_launches(monkeypatch, sg, states, shape)[
        "dev_" + linesum_cuda._MODE_NAMES[linesum_cuda.window_mode("fine", shape)]]
    k, n_nu = sg.plans.n_shards, sg.plans.n_nu
    assert b["n_shards"] == k and b["d_near"].shape == (k,)
    plan = linesum_cuda.window_plan(b["mode"], dict(b["grid"]), 3, n_shards=k)
    table = plan["table"].numpy()
    rows = np.bincount(table[:, 0], minlength=b["grid"]["win"].shape[0])
    total = np.asarray(b["grid"]["win"])[:, 1::2].sum(axis=1)
    P_rows = np.repeat(np.asarray(plan["piece_lines"]), total.size // k)
    assert np.array_equal(rows, np.maximum(1, -(-total // P_rows)))
    got = _emulate_fine(shape == "phco2", b, table, plan["groups"], plan["points_per_thread"])
    d_far, h, _, _ = sg.plans.coarse_meta
    z = ls.split_zones(sg.plans.cut, d_far, h)
    x64 = [x.double() for x in states]
    p = sg.plans
    for s in range(k):
        l64 = shard_lines(sg.lines.to(torch.float64), s)
        alpha, co = ls.coefficients(l64, *x64, shape=shape)
        dn = torch.clamp(15.0 * ls.masked_alpha_max(alpha, l64.nu), max=z["cut_f"])
        blocks = p.fine_blocks[s].double().numpy() + p.fine_blocks_lo[s].double().numpy()
        ref = ls.sigma_mode_plain("fine", blocks, p.fine_windows[s].numpy().astype(np.int64),
                                  l64, co, z, dn, T=ls.chi_T(shape, x64[0]))[:, :n_nu]
        assert _of_peak(got[:, s * n_nu:(s + 1) * n_nu], ref) < 1e-5
    one = sg.spectral_slab(n_nu, 2 * n_nu)
    b1 = _captured_dev_launches(monkeypatch, one, states, shape)[
        "dev_" + linesum_cuda._MODE_NAMES[linesum_cuda.window_mode("fine", shape)]]
    plan1 = linesum_cuda.window_plan(b1["mode"], dict(b1["grid"]), 3)
    assert plan1["piece_lines"] == plan["piece_lines"][1]
    assert (plan1["groups"], plan1["points_per_thread"]) == (plan["groups"],
                                                            plan["points_per_thread"])
    alone = _emulate_fine(shape == "phco2", b1, plan1["table"].numpy(), plan1["groups"],
                          plan1["points_per_thread"])
    assert torch.equal(alone, got[:, n_nu:2 * n_nu])

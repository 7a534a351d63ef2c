"""Wrappers of the CUDA line-sum kernels (K1, K1-seg, K4, K5 and the
near-core correction, ``csrc/linesum.cu``).

K1 replaces ``clearsky_tpu/ops/linesum_pallas.py::_kernel_resident_grouped``
in every mode: split (the Voigt family), no-split (the Voigt family, the full
w4 at every pair) and single sweep (lorentz, doppler) over the plan's
windows, and the windowed modes of the routes, FARALL
(stencil-near) and FINE, FINE_STENCIL and COARSE (coarse-far split). Each
Voigt mode has two instances: voigt (and voigt_ref) and phco2 (and
phco2_ref), whose y carries chi(|dnu|, T) with the per-state rates of
:func:`chi_rates`; the *_ref shapes reach the kernels with alpha / sqrt(ln 2)
folded into their coefficients (:func:`.linesum.effective_alpha`).
:func:`stencil_correction` replaces the XLA-side ``_stencil_apply``: one
block per (row of the stencil's row grid that lines reach, tile of states)
gathers the row's lines in the order of
:func:`.linesum_strategies.correction_rows` (built once per geometry on the
host) and adds each point's terms in that order, with no float atomic, so
every launch gives the same bits. K1-seg
(:func:`sigma_segmented`) runs K1 once per catalog segment, adding in place
(``_pallas_sigma_segmented``); K4 (:func:`sigma_lane`) and K5
(:func:`sigma_gathered`) are the full-profile kernels of the lane and
gathered branches (``_kernel_resident``, ``_kernel``): the window kernel's
FULL modes over the plan's window of each row, read in place from the
catalog (K4 and K5 make the same launch), on a pack of two
quads a (line, state) (:func:`full_pack`) with w4 only within each (line,
state)'s near reach, one launch a call. Before a K1 launch
the per-(state, line) profile coefficients are computed here in plain torch
on the device, as ``_grouped_pack`` does in XLA, and packed line-major in
16-byte quads (:func:`pack_coefficients`), so that a block stages each
chunk of lines for its tile of states with 16-byte asynchronous copies and
reads one state's far-wing values with one 16-byte load. K1 runs one block
per work item: a piece of at most
:data:`PIECE_LINES` lines of a block's windows and a tile of states
(:func:`piece_schedule`, built once per grid on the host), the costliest
first; the pieces of one block add up in piece order, so every launch gives
the same bits. The window modes (FARALL, FINE_STENCIL and FINE, voigt and
phco2; K4/K5's FULL modes) run a kernel of their own on their own pack
(:func:`window_pack`, :func:`full_pack`): work items over a row's windows
as one stream of lines, split among groups
of the row's threads and over balanced tiles of states as
:func:`window_plan` lays them out; they too add pieces and groups in a fixed
order. FINE takes w4 only within each (line, state)'s near reach
(:func:`fine_reach`), and its launch covers a stack of shards (K1-dev).

:func:`sigma_lines` (split mode), :func:`sigma_nosplit`, :func:`sigma_stencil`,
:func:`sigma_coarse`, :func:`sigma_segmented`, :func:`sigma_lane` and
:func:`sigma_gathered` are the routes; :func:`sigma_routed` takes the one
that :func:`.linesum_strategies.route` picks, and is differentiable (the
exact plain sum's derivatives); the route wrappers refuse a tensor that
carries a derivative (``check_operand``). Each launches the kernels for CUDA
tensors and takes its plain version for CPU tensors. On CUDA the
operands are checked for device, dtype (float32), shape and contiguity, and
anything the kernels do not take raises; there is no fallback to a plain
version or to another route.

Every wrapper takes per-line concentrations ``conc`` ([n_lines] or
[n_states, n_lines]), folded into S and gamma before the pack, so no kernel
sees them.

Launch counts (``utils.profiling.counters``): ``launch.linesum`` counts
every launch of K1, K4 and K5 and ``launch.linesum.<mode>`` each mode's
(the phco2 instances under "phco2_...", the no-split sweep under "nosplit"
and "phco2_nosplit"), K1-seg's launches (one per segment) under
"segmented", K4's under "lane" and K5's under "gathered"
("phco2_segmented", "phco2_lane", "phco2_gathered" for the phco2 family),
K1-dev's under "dev_" and the mode's name; ``launch.correction`` the
correction's voigt instance and ``launch.correction.phco2`` its phco2 one.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from ..spectra.lines import PER_LINE_FIELDS
from ..utils import profiling, twin
from ..utils.cuda_build import check_operand, load_library
from .linesum import (
    PHCO2_FAMILY,
    DeviceWindowPlan,
    LineWindowPlan,
    _line_params,
    effective_alpha,
    shard_conc,
    shard_lines,
    sigma_from_lines,
    sigma_from_lines_shards,
    two_float,
    voigt_coefficients,
)
from .linesum_strategies import (
    _resolve,
    chi_T,
    _slice_lines,
    coarse_geometry,
    correction_rows,
    device_route,
    far_from_coarse,
    masked_alpha_max,
    resident_budget,
    routing_states,
    split_zones,
    strided_interp,
    segments,
    sigma_coarse_plain,
    sigma_gathered_plain,
    sigma_lane_plain,
    sigma_nosplit_plain,
    sigma_segmented_plain,
    sigma_stencil_plain,
    split_check,
    stencil_correction_plain,
    stencil_geometry,
)

__all__ = ["sigma_lines", "sigma_nosplit", "sigma_stencil", "sigma_coarse", "sigma_segmented",
           "sigma_lane", "sigma_gathered", "sigma_routed", "sigma_device", "device_launches",
           "stencil_correction", "correction_tiles", "correction_info", "launch_mode",
           "launch_fullprofile", "pack_coefficients", "near_distance", "chi_rates",
           "window_mode", "nosplit_mode", "full_mode", "full_pack", "full_plan",
           "piece_schedule", "state_tiles",
           "far_reciprocal_ok", "kernel_info", "window_pack", "window_core_reach", "fine_reach",
           "window_tiles",
           "window_tile_sizes", "window_schedule", "window_plan", "MODES", "WINDOW_MODES",
           "NOSPLIT_MODES", "FULL_MODES", "PIECE_LINES"]

# kernel modes (csrc/linesum.cu ``Mode``): over the plan's windows, voigt
# and phco2 run the split mode and lorentz and doppler the single sweep; the
# routes run the windowed modes, whose phco2 instances are
# PHCO2_WINDOW_OFFSET further on
MODES = {"voigt": 0, "lorentz": 1, "doppler": 2, "phco2": 7}
WINDOW_MODES = {"farall": 3, "fine": 4, "fine_stencil": 5, "coarse": 6}
# the no-split sweep of the Voigt family over the plan's windows
NOSPLIT_MODES = {"voigt": 12, "voigt_ref": 12, "phco2": 13, "phco2_ref": 13}
PHCO2_WINDOW_OFFSET = 5
_SHAPE_MODES = dict(MODES, voigt_ref=0, phco2_ref=7)
_MODE_NAMES = {0: "voigt_split", 1: "lorentz", 2: "doppler", 3: "farall", 4: "fine",
               5: "fine_stencil", 6: "coarse", 7: "phco2_split", 8: "phco2_farall",
               9: "phco2_fine", 10: "phco2_fine_stencil", 11: "phco2_coarse",
               12: "nosplit", 13: "phco2_nosplit"}
_PHCO2_MODES = (7, 8, 9, 10, 11, 13)
# K4 and K5 (strategies "lane" and "gathered") run window_kernel's FULL
# modes, one a shape (csrc/linesum.cu ``FULL``, ``PH_FULL``, ...); voigt and
# phco2 with w4 within a near reach (their pack two quads a (line, state)),
# lorentz and doppler on one quad
FULL_MODES = {"voigt": 14, "voigt_ref": 14, "phco2": 15, "phco2_ref": 15, "lorentz": 16,
              "doppler": 17}
_FULL_W4 = (14, 15)
_FULL_NAMES = {14: "full", 15: "phco2_full", 16: "full_lorentz", 17: "full_doppler"}
# floats per (line, state) in K1's pack: two quads for the split mode (the
# core's and the far wing's) and FINE (the window quad and the near core's),
# one for every other mode
_FINE_MODES = (4, 9)
_N_COEF = {m: (8 if m in (0,) + _FINE_MODES else 4) for m in _MODE_NAMES}
# the modes whose terms include region 1 (the reciprocal's candidates)
_FAR_MODES = (0, 3, 4, 5, 6, 7, 8, 9, 10, 11)
_N_WIN = {m: (3 if m in (4, 5, 9, 10) else 1) for m in (*_MODE_NAMES, *_FULL_NAMES)}
# the modes that take d_near: the split modes and FINE
_D_NEAR_MODES = (0, 4, 7, 9)
# the modes that may add into sigma (K1-seg): split, no-split and single sweep
_ACC_MODES = (0, 1, 2, 7, 12, 13)
ST = 8  # states per tile at most, and chi's rates' tile; csrc/linesum.cu ``ST``
# lines per K1 work item at most: a block's windows are cut into pieces of
# this many lines (csrc/linesum.cu sums a block's pieces in piece order)
PIECE_LINES = 256
# the window modes (FARALL, FINE_STENCIL, FINE and their phco2 instances)
# run csrc/linesum.cu ``window_kernel``: their own pack, work items over a
# row's windows as one stream, groups of threads splitting a piece's lines,
# balanced state tiles; :func:`window_plan` picks the piece length, the
# groups and the points a thread
_WINDOW_KERNEL_MODES = (3, 4, 5, 8, 9, 10)
# lines a staged chunk by mode (csrc/linesum.cu ``window_chunk``)
WINDOW_CHUNKS = {3: 64, 4: 32, 5: 32, 8: 64, 9: 64, 10: 64, 14: 32, 15: 64, 16: 64, 17: 64}
# FINE's near reach (csrc/linesum.cu ``near_reach``): the margin on |x| + y,
# and w4's small-y repair's bound on y
NEAR_X, SMALL_Y = 15.01, 0.01
MAX_GROUPS = 4
WINDOW_PIECE_MAX = 2048
# the plan's choices a caller may set (launch_mode's ``window``)
_PLAN_KEYS = ("piece_lines", "groups", "points_per_thread")
# an SM's resident warps at window_kernel's 64 registers a thread, and the
# H100's SMs (the plan's count off the card)
_RESIDENT_WARPS, _H100_SMS = 32, 132

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _mode(shape: str) -> int:
    """The split (or single-sweep) mode of ``shape``."""
    if shape not in _SHAPE_MODES:
        raise ValueError(f"the line-sum kernel has no shape {shape!r}")
    return _SHAPE_MODES[shape]


def nosplit_mode(shape: str) -> int:
    """The no-split sweep of ``shape``: NOSPLIT or PH_NOSPLIT for the Voigt
    family; lorentz and doppler have only their single sweep."""
    return NOSPLIT_MODES[shape] if shape in NOSPLIT_MODES else _mode(shape)


def window_mode(name: str, shape: str) -> int:
    """The instance of the windowed mode ``name`` for the Voigt-family
    ``shape``."""
    return WINDOW_MODES[name] + (PHCO2_WINDOW_OFFSET if shape in PHCO2_FAMILY else 0)


def _family(shape: str) -> str:
    """The launch-count prefix of ``shape``'s family."""
    return "phco2_" if shape in PHCO2_FAMILY else ""


def pack_coefficients(mode: int, S, alpha, gamma):
    """K1's per-(line, state) coefficients [n_lines, n_states, n_coef], in
    16-byte quads (csrc/linesum.cu ``n_quads``).

    From :func:`.linesum.voigt_coefficients` on the profile's Doppler width
    ``alpha`` (the *_ref shapes' already divided by sqrt(ln 2)): the split
    mode packs (Sia, ia, y0, 0) and the far wing's (A, c1, c2, k2); COARSE
    (A, c1, c2, k2) alone; the split and no-split phco2 modes and NOSPLIT
    (Sia, ia, y0, A); lorentz and doppler (S, alpha, gamma, 0); the window
    modes (FARALL, FINE_STENCIL, FINE) :func:`window_pack`'s, FINE's as
    [n_lines, 2, n_states, 4]. A tile of states reads each line's run of
    ``n_coef`` floats per state.
    """
    if mode in (1, 2):
        cols = (S, alpha, gamma, torch.zeros_like(S))
        return torch.stack(cols, dim=-1).transpose(0, 1).contiguous()
    return _pack(mode, voigt_coefficients(S, alpha, gamma))


def _pack(mode: int, co):
    """:func:`pack_coefficients` of a Voigt-family mode from the
    :func:`.linesum.voigt_coefficients` ``co``."""
    Sia, ia, y0, A, c1, c2, k2 = co
    if mode in _FINE_MODES:
        return torch.stack([torch.stack(q, dim=-1).transpose(0, 1)
                            for q in window_pack(mode, co)], dim=1).contiguous()
    if mode in _WINDOW_KERNEL_MODES:
        cols = window_pack(mode, co)
    elif mode == 0:
        cols = (Sia, ia, y0, torch.zeros_like(Sia), A, c1, c2, k2)
    elif mode == 6:
        cols = (A, c1, c2, k2)
    else:
        cols = (Sia, ia, y0, A)
    return torch.stack(cols, dim=-1).transpose(0, 1).contiguous()


def window_pack(mode: int, co):
    """The window modes' quad of each (state, line), from the
    :func:`.linesum.voigt_coefficients` ``co``: region 1 as the kernel
    evaluates it, with x^2 = D A and w = 1/2 - y^2 - x^2, den = w^2 + 2 y^2
    and num = (1/2 + y^2 + x^2) = 1 - w. Voigt (FARALL, FINE_STENCIL): (A,
    1/2 - y0^2, 2 y0^2, k2), the term k2 (1 - w) / (w^2 + 2 y0^2); phco2:
    (0.5641896 Sia, y0, A, 0), the term 0.5641896 Sia y (1 - w) / (w^2 + 2
    y^2) at y = y0 chi. A line whose term is zero whatever its denominator
    (k2 = 0; Sia = 0) gets the quad (0, 0, 1, 0) (phco2: (0, 1, 0, 0)),
    whose denominator is 1. FINE (modes 4 and 9) adds the near core's quad
    (Sia, ia, y0, ry), ry the (line, state)'s reach beside d_near
    (:func:`fine_reach`): -inf where Sia = 0, else +inf where y0 < 0.01,
    else (15.01 - y0) / ia; returns the two quads' columns."""
    Sia, ia, y0, A, _, _, k2 = co
    zero = torch.zeros_like(A)
    if mode in _PHCO2_MODES:
        live = Sia != 0
        quad = (Sia * 0.5641896, torch.where(live, y0, 1.0), torch.where(live, A, 0.0), zero)
    else:
        live = k2 != 0
        y2 = y0 * y0
        quad = (torch.where(live, A, 0.0), torch.where(live, 0.5 - y2, 0.0),
                torch.where(live, 2.0 * y2, 1.0), k2)
    if mode not in _FINE_MODES:
        return quad
    near = torch.where(Sia != 0, torch.where(y0 < SMALL_Y, float("inf"), (NEAR_X - y0) / ia),
                       float("-inf"))
    return quad, (Sia, ia, y0, near)


def _packed(mode: int, S, alpha, gamma, n_shards: int, cut: float, bcoef=None):
    """``mode``'s pack (:func:`pack_coefficients`) and its reciprocal's flag
    (:func:`far_reciprocal_ok`), from one set of voigt coefficients."""
    if mode in (1, 2):
        return (pack_coefficients(mode, S, alpha, gamma),
                torch.zeros(n_shards, dtype=torch.int32, device=S.device))
    co = voigt_coefficients(S, alpha, gamma)
    return _pack(mode, co), far_reciprocal_ok(mode, co, n_shards, cut, bcoef)


def state_tiles(n_states: int) -> int:
    """K1's tiles of states: ``n // ST`` of ``ST``, then one of 4, 2 and 1
    for each bit of the remainder (csrc/linesum.cu ``n_state_tiles``)."""
    return n_states // ST + bin(n_states % ST).count("1")


def window_tiles(n_states: int) -> int:
    """The window modes' balanced tiles: ceil(n / ST) tiles of n // T or
    n // T + 1 states (csrc/linesum.cu ``window_tiles``, ``window_tile``)."""
    return -(-n_states // ST)


def window_tile_sizes(n_states: int) -> list:
    """The states of each balanced tile, in tile order."""
    T = window_tiles(n_states)
    q, r = divmod(n_states, T) if T else (0, 0)
    return [q + (t < r) for t in range(T)]


def window_schedule(windows, n_win: int, piece_lines: int):
    """The window modes' work items over a window table [n_rows, 2 n_win] of
    (start, count): (pieces [n_pieces, 8] int32, n_slots).

    A row's windows are one stream of lines in (window, line) order; a
    piece is (row, 0, offset, count, part, n_parts, slot, 0), lines [offset,
    offset + count) of that stream, at most ``piece_lines``. A row's pieces
    are numbered 0..n_parts-1 in stream order, the order in which the kernel
    adds their partial sums; a row of more than one piece owns the scratch
    slots [slot, slot + n_parts), a row without lines one empty piece.
    Pieces are listed by line count, largest first (stable)."""
    w = np.asarray(windows, np.int64).reshape(-1, 2 * n_win)
    total = w[:, 1::2].sum(axis=1)
    per = np.maximum(1, -(-total // piece_lines))
    row = np.repeat(np.arange(w.shape[0]), per)
    part = np.arange(row.size) - np.repeat(np.cumsum(per) - per, per)
    start = part * piece_lines
    count = np.clip(total[row] - start, 0, piece_lines)
    owned = np.where(per > 1, per, 0)
    slot = (np.cumsum(owned) - owned)[row]
    zero = np.zeros_like(row)
    table = np.stack([row, zero, start, count, part, per[row], slot, zero], axis=1)
    order = np.argsort(-count, kind="stable")
    return table[order].astype(np.int32), int(owned.sum())


def _sms(dev) -> int:
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).multi_processor_count
    return _H100_SMS


def window_plan(mode: int, grid: dict, n_states: int, override=None, n_shards: int = 1) -> dict:
    """The launch plan of a window mode over ``grid`` at ``n_states``, cached
    in the grid dict. Where the rows' tiles fill a wave of the card's
    resident warps (:data:`_RESIDENT_WARPS` an SM), a block runs one group
    of the row's threads, each thread of the voigt modes owns two of the
    row's points (which share every staged quad it reads; phco2's, with
    more work a term, one), and a piece holds up to twice the mean lines a
    row (whole chunks, four at least, :data:`WINDOW_PIECE_MAX` at most).
    Where they do not
    (the RCM's 16,384 points), G = 4 groups of the row's threads (at most
    512 threads, a point each) split each piece's lines, and a piece holds
    the mean lines a row: a dense row is cut and no thread's chain is long.
    Over a stack of ``n_shards`` shards (FINE's K1-dev launch) each shard
    is planned from its own rows (its piece length from its own mean, the
    fill from one shard's rows), so that a shard's pieces, groups and
    points a thread, and so its bits, are the same alone or in a stack.
    Returns the plan with its schedule (:func:`window_schedule`):
    piece_lines (a tuple a shard over a stack), groups, points_per_thread,
    threads, tiles, pieces, blocks, rows, scratch_row_share, scratch_slots,
    and ``table`` (the pieces on the grid's device). ``override`` sets any
    of piece_lines, groups and points_per_thread in its place (tests,
    tools/k1_probe.py)."""
    dev = grid["win"].device
    override = dict(override or {})
    if set(override) - set(_PLAN_KEYS):
        raise ValueError(f"a window plan sets only {_PLAN_KEYS}, not {sorted(override)}")
    key = ("window_plan", mode, n_states, tuple(sorted(override.items())), _sms(dev), n_shards)
    got = grid.get(key)
    if got is not None:
        return got
    win = grid.get("win_host")
    if win is None:
        win = grid["win"].cpu().numpy()
    win = np.asarray(win, np.int64)
    n_win = _N_WIN[mode]
    rows = win.shape[0]
    nb = rows // n_shards
    block = grid["nu_hi"].shape[0] // max(rows, 1)
    ch = WINDOW_CHUNKS[mode]
    chunks = lambda x: -(-int(np.ceil(x)) // ch) * ch
    tiles = window_tiles(n_states)
    many = nb * tiles * -(-block // 32) >= _sms(dev) * _RESIDENT_WARPS
    pts = override.get("points_per_thread") or (
        2 if many and mode in (3, 4, 5, 14, 16, 17) and block % 2 == 0 else 1)
    tp = block // pts
    G = override.get("groups") or (1 if many else max(1, min(MAX_GROUPS, 512 // tp)))
    tables, Ps, n_slots = [], [], 0
    for s in range(n_shards):
        w = win[s * nb:(s + 1) * nb]
        mean = float(w[:, 1::2].sum(axis=1).mean()) if nb else 0.0
        P = override.get("piece_lines")
        if P is None:
            P = (min(WINDOW_PIECE_MAX, max(4 * ch, chunks(2.0 * mean))) if many
                 else max(ch, chunks(mean)))
        t, slots = window_schedule(w, n_win, P)
        t[:, 0] += s * nb
        t[:, 6] += n_slots
        tables.append(t)
        Ps.append(P)
        n_slots += slots
    table = np.concatenate(tables)
    table = table[np.argsort(-table[:, 3], kind="stable")]
    parts = np.bincount(table[:, 0], minlength=rows)
    P = Ps[0] if n_shards == 1 else tuple(Ps)
    got = grid[key] = dict(piece_lines=P, groups=G, points_per_thread=pts, threads=G * tp,
                           tiles=tiles,
                           pieces=int(table.shape[0]), blocks=int(table.shape[0]) * tiles,
                           rows=rows, scratch_row_share=float((parts > 1).mean()) if rows else 0.0,
                           scratch_slots=n_slots, table=torch.as_tensor(table, device=dev))
    return got


def piece_schedule(windows, n_win: int, piece_lines: int):
    """K1's work items over a window table [n_rows, 2 n_win] of (start,
    count): (pieces [n_pieces, 8] int32, n_slots).

    Each window is cut into pieces of at most ``piece_lines`` lines in line
    order; a row without lines gets one empty piece (its columns are still
    written). A piece is (row, window, start, count, part, n_parts, slot,
    0): its row's pieces are numbered 0..n_parts-1 in (window, line) order,
    the order in which the kernel adds their partial sums, and a row of more
    than one piece owns the scratch slots [slot, slot + n_parts). Pieces are
    listed by line count, largest first (stable), which is the order the
    kernel's blocks start in.
    """
    w = np.asarray(windows, np.int64).reshape(-1, 2 * n_win)
    n_rows = w.shape[0]
    starts, counts = w[:, 0::2], w[:, 1::2]
    per = -(-counts // piece_lines)
    per[:, 0] += per.sum(axis=1) == 0                       # one empty piece
    flat = per.reshape(-1)
    rw = np.repeat(np.arange(flat.size), flat)              # the piece's (row, window)
    i = np.arange(rw.size) - np.repeat(np.cumsum(flat) - flat, flat)
    row, win = rw // n_win, rw % n_win
    start = starts.reshape(-1)[rw] + i * piece_lines
    count = np.clip(counts.reshape(-1)[rw] - i * piece_lines, 0, piece_lines)
    n_parts = np.bincount(row, minlength=n_rows)
    part = np.arange(row.size) - (np.cumsum(n_parts) - n_parts)[row]
    owned = np.where(n_parts > 1, n_parts, 0)
    slot = (np.cumsum(owned) - owned)[row]
    table = np.stack([row, win, start, count, part, n_parts[row], slot, np.zeros_like(row)],
                     axis=1)
    order = np.argsort(-count, kind="stable")
    return table[order].astype(np.int32), int(owned.sum())


def _pieces(grid: dict, n_win: int):
    """The grid's work items (pieces of :data:`PIECE_LINES`) on its device,
    cached in the grid dict: (pieces tensor, n_pieces, n_slots). The host
    window table is ``win_host`` where the grid carries it, else read back
    once."""
    key = ("pieces", PIECE_LINES)
    got = grid.get(key)
    if got is None:
        win = grid.get("win_host")
        if win is None:
            win = grid["win"].cpu().numpy()
        table, n_slots = piece_schedule(win, n_win, PIECE_LINES)
        got = grid[key] = (torch.as_tensor(table, device=grid["win"].device), table.shape[0],
                           n_slots)
    return got


# the far-wing denominators the reciprocal takes: d and 1/d normal floats
_RCP_LO, _RCP_HI = 2.0**-120, 2.0**120


def _chi_range(bcoef, n_states: int, cut: float):
    """chi(|dnu|, T)'s least and largest value over |dnu| <= cut, per state
    [n_states] (float64), from the rates as the kernel reads them: the
    exponent B1 u + B2 v + w is piecewise linear in |dnu|, so its extremes
    lie at 0 and at the pieces' ends 3, 30, 120 and the cut."""
    B = bcoef.double().permute(1, 0, 2).reshape(2, -1)[:, :n_states]
    e = torch.stack([B[0] * min(max(a - 3.0, 0.0), 27.0) + B[1] * min(max(a - 30.0, 0.0), 90.0)
                     + 0.0232 * max(a - 120.0, 0.0)
                     for a in [0.0] + [x for x in (3.0, 30.0, 120.0) if x < cut] + [cut]],
                    dim=1)                                   # [n_states, points]
    return torch.exp(-e.amax(dim=1)), torch.exp(-e.amin(dim=1))


def far_reciprocal_ok(mode: int, co, n_shards: int, cut: float, bcoef=None):
    """Whether K1's far-wing term may take the reciprocal (one approximate
    reciprocal and a Newton step) instead of the IEEE division: int32
    [n_shards], nonzero where every region-1 denominator of the shard's
    lines of nonzero strength lies in [2^-120, 2^120], so that it and its
    reciprocal are normal floats. ``co``: the
    :func:`.linesum.voigt_coefficients` (Sia, ia, y0, A, c1, c2, k2), each
    [n_states, n_shards L], that ``mode``'s pack is made of (:func:`_pack`);
    computed once a pack, on the device, with no host copy.

    Region 1's denominator at y (y = y0, or y0 chi for the phco2 family) and
    x^2 = D A >= 0 is (1/2 + y^2 - x^2)^2 + 4 x^2 y^2 >= 2 y^2, and at
    |dnu| <= cut at most (1/2 + y^2 + cut^2 A)^2 + 4 cut^2 A y^2; the bound
    takes the least and largest y^2 (the voigt modes' y0^2 as c2 / (4 A),
    as the kernel reads them), chi's range over the cut and the largest A.
    It leaves out the lines whose far term is zero whatever the denominator
    (k2 = 0 for the voigt modes, Sia = 0 for the phco2 ones: padding lines
    among them); the kernel adds 0 for those (csrc/linesum.cu ``add_far``).
    """
    Sia, _, y0, A, _, c2, k2 = (c.reshape(c.shape[0], n_shards, -1) for c in co)  # [n, k, L]
    if mode not in _FAR_MODES:
        return torch.zeros(n_shards, dtype=torch.int32, device=A.device)
    if mode in _PHCO2_MODES:
        live, y2 = Sia != 0, y0 * y0
        lo, hi = _chi_range(bcoef, A.shape[0], cut)
        y2lo, y2hi = y2 * (lo * lo).float()[:, None, None], y2 * (hi * hi).float()[:, None, None]
    else:
        live = k2 != 0
        y2lo = y2hi = c2 / (4.0 * A)
    y2_min = torch.where(live, y2lo, float("inf")).amin(dim=(0, 2)).double()
    y2_max = torch.where(live, y2hi, 0.0).amax(dim=(0, 2)).double()
    a_max = torch.where(live, A, 0.0).amax(dim=(0, 2)).double()
    c2A = cut * cut * a_max
    den_hi = (0.5 + y2_max + c2A) ** 2 + 4.0 * c2A * y2_max
    return ((2.0 * y2_min >= _RCP_LO) & (den_hi <= _RCP_HI)).to(torch.int32)


def near_distance(alpha, limit: float):
    """d_near = min(15 max(alpha), limit) as a one-element tensor.

    At |dnu| > d_near every line's |x| = |dnu|/alpha >= 15, where Humlicek
    region 1 is the w4 value. The limit is the cut (split mode) or the mid
    zone's 2 d_far (FINE). The catalog holds only real lines (no padding
    sentinel), so the maximum runs over all of them.
    """
    return torch.clamp(15.0 * alpha.max(), max=limit).reshape(1).contiguous()


def chi_rates(T):
    """The phco2 family's rates of chi at each state, as the kernels read
    them: [n_tiles, 2, ST] float32, B1 = 0.0888 - 0.16 exp(-0.0041 T) then
    B2 = 0.0526 exp(-0.00152 T) for the tile's ST states (0 past the last
    state), computed in float64 and rounded once."""
    T64 = T.double()
    B = torch.stack([0.0888 - 0.16 * torch.exp(-0.0041 * T64),
                     0.0526 * torch.exp(-0.00152 * T64)])              # [2, n]
    n_tiles = -(-T.shape[0] // ST)
    B = torch.cat([B, B.new_zeros((2, n_tiles * ST - T.shape[0]))], dim=1)
    return B.view(2, n_tiles, ST).permute(1, 0, 2).contiguous().float()


def _check_rates(bcoef, n_states: int, dev):
    check_operand("bcoef", bcoef, (-(-n_states // ST), 2, ST), dev)


def _library():
    lib = load_library("linesum")
    fn = lib.linesum_launch
    if fn.argtypes is None:
        # the coefficient, window and tile layouts are shared with the C
        # side: hold them to it
        layout = (lib.linesum_states_per_tile(),
                  {m: lib.linesum_coef_per_state(m) for m in (*_N_COEF, *_FULL_NAMES)},
                  {m: lib.linesum_windows_per_block(m) for m in _N_WIN},
                  [lib.linesum_state_tiles(n) for n in range(4 * ST)],
                  [lib.linesum_window_tiles(n) for n in range(4 * ST)],
                  {m: lib.linesum_window_chunk(m) for m in WINDOW_CHUNKS})
        want = (ST, {**_N_COEF, **{m: 8 if m in _FULL_W4 else 4 for m in _FULL_NAMES}},
                _N_WIN, [state_tiles(n) for n in range(4 * ST)],
                [window_tiles(n) for n in range(4 * ST)], WINDOW_CHUNKS)
        if layout != want:
            raise RuntimeError(f"csrc/linesum.cu packs {layout}, this wrapper {want}")
        fn.argtypes = [_I, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, ctypes.POINTER(_F),
                       _I, _I, _I, _I, _I, _I, _P, _P, _P, _P]
        fn.restype = _I
        info = lib.linesum_kernel_info
        info.argtypes = [_I, _I, ctypes.POINTER(_I)]
        info.restype = _I
        wl = lib.window_launch
        wl.argtypes = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P,
                       ctypes.POINTER(_F), _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P]
        wl.restype = _I
        wi = lib.window_kernel_info
        wi.argtypes = [_I, _I, _I, ctypes.POINTER(_I)]
        wi.restype = _I
        cor = lib.stencil_correction_launch
        cor.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I,
                        _F, _F, _P, _P]
        cor.restype = _I
        cinfo = lib.stencil_correction_info
        cinfo.argtypes = [_I, _I, _I, ctypes.POINTER(_I)]
        cinfo.restype = _I
    return lib


def kernel_info(mode: int, block: int = 128, points: int = 1) -> dict:
    """K1's build of ``mode`` on the card: registers and local (spill)
    bytes a thread, static shared bytes a block, and resident blocks of
    ``block`` threads an SM with the share of the SM's 64 warps they hold
    (the window modes: ``window_kernel`` at ``points`` points a thread,
    ``block`` the plan's threads; K4/K5's FULL modes likewise)."""
    out = (_I * 4)()
    lib = _library()
    if mode in _WINDOW_KERNEL_MODES or mode in _FULL_NAMES:
        err = lib.window_kernel_info(mode, points, block, out)
    else:
        err = lib.linesum_kernel_info(mode, block, out)
    if err != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed: CUDA error {err}")
    return {"registers": out[0], "shared_bytes": out[1], "local_bytes": out[2],
            "blocks_per_sm": out[3], "resident_warps": out[3] * -(-block // 32) / 64.0}


def _zones(cut, cut_f=0.0, d_lo=0.0, D1=0.0, D2=1.0, R1=0.0, R2=1.0):
    """The kernel's ``Zones`` as float[7]; the switch widths go as
    reciprocals computed in float64, as the TPU kernel folds them."""
    vals = (cut, cut_f, d_lo, D1, 1.0 / (D2 - D1), R1, 1.0 / (R2 - R1))
    return (_F * 7)(*vals)


def _checked(lines, T, P, Pp, conc=None):
    """Check the states, the concentrations and the catalog for the kernels;
    (n_states, dev)."""
    dev = T.device
    if dev.type != "cuda":
        raise ValueError(f"no line-sum kernel for device {dev}")
    if T.dim() != 1:
        raise ValueError("the kernel wrappers take flat state batches [n_states]")
    n_states = T.shape[0]
    for name, x in (("T", T), ("P", P), ("Pp", Pp)):
        check_operand(name, x, (n_states,), dev)
    for name in ("nu", "nu_lo", "S", "ga", "gs", "Epp", "na", "mu"):
        check_operand(f"lines.{name}", getattr(lines, name), (lines.n_lines,), dev)
    if conc is not None:
        shape = (lines.n_lines,) if conc.dim() == 1 else (n_states, lines.n_lines)
        check_operand("conc", conc, shape, dev)
    return n_states, dev


def _check_windows(windows, n_lines: int):
    if int((windows[:, 0::2] + windows[:, 1::2]).max(initial=0)) > n_lines:
        raise ValueError("the line windows exceed the catalog: plan and lines differ")


def _count(name: str) -> None:
    profiling.counters["launch.linesum"] += 1
    profiling.counters["launch.linesum." + name] += 1


def launch_mode(mode: int, grid: dict, lines, coef, n_states: int, n_out: int, zones,
                d_near=None, out=None, count_as=None, bcoef=None, n_shards: int = 1,
                fast=None, window=None):
    """One K1 launch into a new sigma[n_states, n_shards * n_out], or added
    into the first n_out columns of ``out``.

    ``grid`` holds the block grid ``nu_hi``/``nu_lo`` (flat, float32,
    n_shards * n_blocks * block) and the int32 window table ``win``
    [n_shards * n_blocks, 2 * windows per block] on the device (and, where
    the caller has it, its host copy ``win_host``); the work items of its
    windows are cut once (:func:`piece_schedule`, pieces of
    :data:`PIECE_LINES`) and cached in it. ``coef`` is the pack of :func:`pack_coefficients` for
    ``mode``; ``zones`` from :func:`_zones`; ``d_near`` a tensor of one value
    a shard for the split and FINE modes; ``bcoef`` the :func:`chi_rates` of
    the phco2 modes, and only of them; ``fast`` the
    :func:`far_reciprocal_ok` of the pack (None: the IEEE division
    throughout). ``out``
    (the split and single-sweep modes): a float32 [n_states, >= n_shards *
    n_out] view with unit column stride, added to in place (K1-seg).
    ``n_shards`` > 1 is K1-dev: shard s's blocks, window rows and d_near[s]
    give columns [s n_out, (s + 1) n_out); its windows index the catalog
    ``lines`` (the shards' slabs side by side). ``window`` (the window
    modes): :func:`window_plan`'s ``override``. The launch counts under
    ``count_as``, else under its mode.
    """
    win = grid["win"]
    if n_shards < 1 or win.shape[0] % n_shards:
        raise ValueError(f"{win.shape[0]} window rows do not split into {n_shards} shards")
    n_blocks = win.shape[0] // n_shards
    block = grid["nu_hi"].shape[0] // max(win.shape[0], 1)
    dev = coef.device
    if tuple(win.shape) != (n_shards * n_blocks, 2 * _N_WIN[mode]) or win.dtype != torch.int32:
        raise ValueError(f"mode {_MODE_NAMES[mode]} takes an int32 window table "
                         f"[n_shards * n_blocks, {2 * _N_WIN[mode]}]")
    if block > 512 or n_blocks * block < n_out or grid["nu_hi"].shape[0] != win.shape[0] * block:
        raise ValueError(f"a grid of {n_blocks} blocks of {block} points a shard cannot give "
                         f"{n_out} outputs (at most 512 threads a block)")
    check_operand("coef", coef, (lines.n_lines, 2, n_states, 4) if mode in _FINE_MODES
                  else (lines.n_lines, n_states, _N_COEF[mode]), dev)
    if (mode in _D_NEAR_MODES) != (d_near is not None):
        raise ValueError("d_near goes with the split and FINE modes, and only with them")
    if d_near is not None:
        check_operand("d_near", d_near, (n_shards,), dev)
    if (mode in _PHCO2_MODES) != (bcoef is not None):
        raise ValueError("chi's rates go with the phco2 modes, and only with them")
    if bcoef is not None:
        _check_rates(bcoef, n_states, dev)
    accumulate = out is not None
    if accumulate:
        if mode not in _ACC_MODES:
            raise ValueError("only the split and single-sweep modes add into sigma")
        if (out.dtype != torch.float32 or out.device != dev or out.dim() != 2
                or out.shape[0] != n_states or out.shape[1] < n_shards * n_out
                or out.stride(1) != 1):
            raise ValueError(f"out must be a float32 [{n_states}, >= {n_shards * n_out}] view "
                             f"on {dev} with unit column stride")
    else:
        out = torch.empty((n_states, n_shards * n_out), dtype=torch.float32, device=dev)
    if n_states == 0 or lines.n_lines == 0:
        return out if accumulate else out.zero_()
    if fast is None:
        fast = torch.zeros(n_shards, dtype=torch.int32, device=dev)
    check_operand("fast", fast, (n_shards,), dev, torch.int32)
    if window is not None and mode not in _WINDOW_KERNEL_MODES:
        raise ValueError("a window plan goes with the window modes, and only with them")
    if mode in _WINDOW_KERNEL_MODES:
        if n_shards != 1 and mode not in _FINE_MODES:
            raise ValueError(f"mode {_MODE_NAMES[mode]} runs one shard")
        _launch_window(mode, grid, lines, coef, n_states, n_out, zones, bcoef, fast, block, out,
                       window, d_near, n_shards)
        _count(count_as or _MODE_NAMES[mode])
        return out
    pieces, n_pieces, n_slots = _pieces(grid, _N_WIN[mode])
    scratch = counters = None
    if n_slots:
        scratch = torch.empty(n_slots * n_states * block, dtype=torch.float32, device=dev)
        counters = torch.zeros(win.shape[0] * state_tiles(n_states), dtype=torch.int32,
                               device=dev)
    err = _library().linesum_launch(
        mode, grid["nu_hi"].data_ptr(), grid["nu_lo"].data_ptr(), lines.nu.data_ptr(),
        lines.nu_lo.data_ptr(), coef.data_ptr(), pieces.data_ptr(), n_pieces,
        None if d_near is None else d_near.data_ptr(), fast.data_ptr(),
        None if bcoef is None else bcoef.data_ptr(), zones, n_blocks, block, n_states, n_out,
        out.stride(0), int(accumulate), None if scratch is None else scratch.data_ptr(),
        None if counters is None else counters.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"line-sum kernel launch failed: CUDA error {err}")
    _count(count_as or _MODE_NAMES[mode])
    return out


def window_core_reach(mode: int, coef):
    """Each line's least A = ia^2 over the states of the window pack ``coef``
    [n_lines, n_states, 4] (+inf where every state's term is zero): the
    kernel takes the plain version's algebra where D A <= 4 for some state,
    around region 1's pole (x^2 = 1/2 + y^2), which the correction cancels."""
    A = coef[..., 2 if mode in _PHCO2_MODES else 0]
    return torch.where(A > 0, A, float("inf")).amin(dim=1).contiguous()


def fine_reach(coef):
    """Each line's largest reach ry over each balanced tile of states
    [n_lines, n_tiles], from FINE's pack ``coef`` [n_lines, 2, n_states, 4]
    (its w4 quads' last place): the kernel's near lines in a row are those
    whose tile's reach, taken with the shard's d_near as each pair's is,
    meets it.

    A (line, state)'s pair takes w4 where |dnu| <= r = min(d_near, ry), ry
    = (15.01 - y0) / ia, the pairs where |x| + y < 15.01 may hold, and
    region 1 beyond, where w4 is region 1 (|x| + y >= 15, y >= 0.01: no
    small-y repair), the window quad's function (phco2's with w4's
    constant 0.5641896; voigt's takes 1/sqrt(pi), 2.9e-8 apart, below
    float32's rounding). Where y0 < 0.01 ry = +inf, and for phco2 where
    d_near >= 3 cm^-1 (beyond which chi may bring y below y0) r = d_near
    for every line of nonzero strength: the plain version's near zone
    (csrc/linesum.cu ``near_reach``). ry = -inf where Sia = 0."""
    L, _, n, _ = coef.shape
    T = window_tiles(n)
    q, rem = divmod(n, T)
    ry = coef[:, 1, :, 3]
    head = ry[:, :rem * (q + 1)].reshape(L, rem, q + 1).amax(dim=2)
    tail = ry[:, rem * (q + 1):].reshape(L, T - rem, q).amax(dim=2)
    return torch.cat([head, tail], dim=1)


def _launch_window(mode, grid, lines, coef, n_states, n_out, zones, bcoef, fast, block, out,
                   window=None, d_near=None, n_shards=1):
    """window_kernel's launch of ``mode`` into ``out`` by :func:`window_plan`
    (its choices overridden by ``window``)."""
    plan = window_plan(mode, grid, n_states, window, n_shards)
    dev = coef.device
    amin = reach = None
    if mode in _FINE_MODES:
        reach = fine_reach(coef)
    else:
        amin = window_core_reach(mode, coef)
    scratch = counters = None
    if plan["scratch_slots"]:
        scratch = torch.empty(plan["scratch_slots"] * n_states * block, dtype=torch.float32,
                              device=dev)
        counters = torch.zeros(plan["rows"] * plan["tiles"], dtype=torch.int32, device=dev)
    ptr = lambda x: None if x is None else x.data_ptr()
    err = _library().window_launch(
        mode, grid["nu_hi"].data_ptr(), grid["nu_lo"].data_ptr(), lines.nu.data_ptr(),
        lines.nu_lo.data_ptr(), ptr(amin), ptr(reach), coef.data_ptr(), grid["win"].data_ptr(),
        plan["table"].data_ptr(), plan["pieces"], fast.data_ptr(), ptr(d_near), ptr(bcoef),
        zones, block, grid["win"].shape[0] // n_shards, plan["groups"],
        plan["points_per_thread"], n_states, n_out, out.shape[1],
        None if scratch is None else scratch.data_ptr(),
        None if counters is None else counters.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"line-sum window kernel launch failed: CUDA error {err}")


def _prepare(plan: LineWindowPlan, lines, T, P, Pp, shape: str, conc=None,
             nosplit: bool = False):
    """Check K1's operands on the card and build its coefficient pack, for
    its split (or single-sweep) mode, or its no-split sweep (``nosplit``).

    Returns the launch: a function of no arguments that runs the kernel into
    a new sigma[n_states, n_nu] and returns it, so that a caller can time
    the launch apart from the pack. Raises on anything the kernel does not
    take (device, float32, shape, contiguity).
    """
    mode = nosplit_mode(shape) if nosplit else _mode(shape)
    n_states, dev = _checked(lines, T, P, Pp, conc)
    _check_windows(plan.windows(), lines.n_lines)
    grid = plan.device_arrays(dev)
    S, alpha, gamma = _line_params(lines, T, P, Pp, conc)
    alpha = effective_alpha(shape, alpha)
    d_near = near_distance(alpha, plan.cut) if mode in _D_NEAR_MODES else None
    bcoef = chi_rates(T) if mode in _PHCO2_MODES else None
    coef, fast = _packed(mode, S, alpha, gamma, 1, plan.cut, bcoef)
    zones = _zones(plan.cut)
    return lambda: launch_mode(mode, grid, lines, coef, n_states, plan.n_nu, zones, d_near,
                               bcoef=bcoef, fast=fast)


def sigma_lines(plan: LineWindowPlan, lines, T, P, Pp, shape: str = "voigt", conc=None):
    """sigma[n_states, n_nu] over the plan's windows, flat states [n_states].

    CUDA tensors: K1 in its split mode for the Voigt family and its single
    sweep for lorentz and doppler. CPU tensors: the plain
    :func:`sigma_from_lines`.
    """
    if T.device.type == "cpu":
        return sigma_from_lines(plan, lines, T, P, Pp, shape, conc=conc)
    return _prepare(plan, lines, T, P, Pp, shape, conc)()


def sigma_nosplit(plan: LineWindowPlan, lines, T, P, Pp, shape: str = "voigt", conc=None):
    """sigma[n_states, n_nu] over the plan's windows by K1's no-split sweep,
    flat states [n_states]: the full w4 at every in-cut pair of a
    Voigt-family ``shape``. CPU tensors: its plain version."""
    split_check(shape)
    if T.device.type == "cpu":
        return sigma_nosplit_plain(plan, lines, T, P, Pp, conc, shape)
    return _prepare(plan, lines, T, P, Pp, shape, conc, nosplit=True)()


# the correction's blocks: a row's K points x G groups of states, at most
# CORR_THREADS threads; a tile at most CORR_TS states, nse <= 8 a thread
# (csrc/linesum.cu ``CORR_THREADS``, ``CORR_TS``)
CORR_THREADS, CORR_TS = 256, 48


def correction_tiles(K: int, n_states: int):
    """The correction's tiles of states for rows of ``K`` points: (G, nse,
    n_tiles). A block's K G threads (G groups, at most CORR_THREADS // K and
    the states) each own a point and nse states; the n_tiles tiles of G nse
    states share the states out as evenly as nse <= min(8, CORR_TS // G)
    allows."""
    G = max(1, min(CORR_THREADS // K, n_states))
    per = min(8, max(1, CORR_TS // G))
    n_tiles = max(1, -(-n_states // (G * per)))
    return G, -(-(-(-n_states // n_tiles)) // G), n_tiles


def _correction_arrays(geom, cut: float, n_nu: int, dev):
    """:func:`.linesum_strategies.correction_rows` on ``dev``, cached on the
    geometry under the device, the cut and the grid's length."""
    key = (dev, "rows", float(cut), int(n_nu))
    got = geom._on_device.get(key)
    if got is None:
        sch = correction_rows(geom, cut, n_nu)
        got = geom._on_device[key] = {
            "rows": torch.as_tensor(sch["rows"], dtype=torch.int32, device=dev),
            "line": torch.as_tensor(sch["line"], dtype=torch.int32, device=dev),
            "dnu_hi": torch.as_tensor(sch["dnu_hi"], device=dev),
            "dnu_lo": torch.as_tensor(sch["dnu_lo"], device=dev),
            "n_rows": int(sch["rows"].shape[0])}
    return got


def correction_info(K: int, n_states: int, chi: bool = False) -> dict:
    """The correction's build and blocks for rows of ``K`` points and
    ``n_states`` states (the chi instance if ``chi``): registers, shared
    bytes (dynamic) and local (spill) bytes, threads a block, resident blocks
    an SM with the share of its 64 warps they hold, the state tiles and the
    states a thread."""
    G, nse, n_tiles = correction_tiles(K, n_states)
    block = -(-K * G // 32) * 32
    out = (_I * 4)()
    err = _library().stencil_correction_info(int(chi), nse, block, out)
    if err != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed: CUDA error {err}")
    return {"registers": out[0], "shared_bytes": out[1], "local_bytes": out[2],
            "threads": block, "blocks_per_sm": out[3],
            "resident_warps": out[3] * block / 32 / 64.0, "state_tiles": n_tiles,
            "states_per_thread": nse}


def stencil_correction(out, geom, co, cut: float, weight=None, T=None, bcoef=None):
    """Add the near-core correction of the stencil geometry ``geom`` into
    ``out`` [n_states, n_nu] in place, and return ``out``.

    ``co`` are the :func:`.linesum.voigt_coefficients` [n_states, n_lines]
    (the kernel reads Sia, ia, y0); ``weight`` = (D1, D2) multiplies by the
    coarse split's 1 - W(dnu^2); the states' temperatures ``T`` [n_states]
    (the phco2 family) put chi on y, with chi's rates ``bcoef``
    (:func:`chi_rates` of T) where the caller holds them. CUDA tensors: the
    correction kernel, which sums each point's terms in the schedule's
    order (two launches give the same bits). CPU tensors:
    :func:`.linesum_strategies.stencil_correction_plain`.
    """
    n_states, n_nu = out.shape
    if bcoef is not None and T is None:
        raise ValueError("chi's rates bcoef come with the states' temperatures T")
    if out.device.type == "cpu":
        out += stencil_correction_plain(geom, co, cut, n_nu, weight, T)
        return out
    dev = out.device
    n_lines = geom.q.shape[0]
    check_operand("out", out, (n_states, n_nu), dev)
    for name, x in zip(("Sia", "ia", "y0"), co[:3]):
        check_operand(name, x, (n_states, n_lines), dev)
    if T is not None:
        check_operand("T", T, (n_states,), dev)
        if bcoef is None:
            bcoef = chi_rates(T)
        _check_rates(bcoef, n_states, dev)
    arr = _correction_arrays(geom, cut, n_nu, dev)
    G, nse, n_tiles = correction_tiles(geom.K, n_states)
    D1, D2 = weight if weight is not None else (0.0, 1.0)
    err = _library().stencil_correction_launch(
        arr["rows"].data_ptr(), arr["line"].data_ptr(), arr["dnu_hi"].data_ptr(),
        arr["dnu_lo"].data_ptr(), co[0].data_ptr(), co[1].data_ptr(), co[2].data_ptr(),
        None if bcoef is None else bcoef.data_ptr(), arr["n_rows"], geom.K, G, nse, n_tiles,
        n_lines, n_states, n_nu, float(cut), int(weight is not None), float(D1),
        1.0 / (D2 - D1), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"stencil correction launch failed: CUDA error {err}")
    profiling.counters["launch.correction" if T is None else "launch.correction.phco2"] += 1
    return out


def _route_operands(lines, T, P, Pp, n_windows_table, conc, shape, cut: float):
    """Checks and operands of the routes' windowed modes for the Voigt-family
    ``shape``: (n_states, dev, alpha, co, coef, bcoef, fast), alpha the
    profile's Doppler widths, co their :func:`.linesum.voigt_coefficients`,
    coef the family's window pack (FARALL's and FINE_STENCIL's), bcoef its
    :func:`chi_rates` (phco2) or None and fast the reciprocal's flag at
    ``cut`` (every windowed mode's)."""
    split_check(shape)
    n_states, dev = _checked(lines, T, P, Pp, conc)
    _check_windows(n_windows_table, lines.n_lines)
    S, alpha, gamma = _line_params(lines, T, P, Pp, conc)
    alpha = effective_alpha(shape, alpha)
    co = tuple(c.contiguous() for c in voigt_coefficients(S, alpha, gamma))
    m = window_mode("farall", shape)
    bcoef = chi_rates(T) if shape in PHCO2_FAMILY else None
    fast = far_reciprocal_ok(m, co, 1, cut, bcoef)
    return n_states, dev, alpha, co, _pack(m, co), bcoef, fast


def sigma_stencil(plan: LineWindowPlan, lines, T, P, Pp, conc=None, shape: str = "voigt"):
    """The stencil-near route of a Voigt-family ``shape``, flat states
    [n_states]: K1's FARALL mode over the plan's windows, then the
    near-core correction. CPU tensors: its plain version."""
    if T.device.type == "cpu":
        return sigma_stencil_plain(plan, lines, T, P, Pp, conc, shape)
    geom = stencil_geometry(plan, lines)
    if geom is None:
        raise ValueError("the stencil geometry rejects this grid and catalog")
    n_states, dev, _, co, coef, bcoef, fast = _route_operands(lines, T, P, Pp, plan.windows(),
                                                              conc, shape, plan.cut)
    out = launch_mode(window_mode("farall", shape), plan.device_arrays(dev), lines, coef,
                      n_states, plan.n_nu, _zones(plan.cut), bcoef=bcoef, fast=fast)
    return stencil_correction(out, geom, co, plan.cut, T=chi_T(shape, T), bcoef=bcoef)


def _coarse_arrays(geom, dev):
    got = geom._on_device.get(dev)
    if got is None:
        def grid(blocks, windows):
            hi, lo = two_float(blocks)
            return {"nu_hi": torch.as_tensor(hi.reshape(-1), device=dev),
                    "nu_lo": torch.as_tensor(lo.reshape(-1), device=dev),
                    "win": torch.as_tensor(windows, dtype=torch.int32, device=dev),
                    "win_host": windows}
        got = geom._on_device[dev] = {"fine": grid(geom.fine_blocks, geom.fine_windows),
                                      "coarse": grid(geom.coarse_blocks, geom.coarse_windows)}
    return got


def sigma_coarse(plan: LineWindowPlan, lines, T, P, Pp, params, conc=None,
                 shape: str = "voigt"):
    """The coarse-far route of a Voigt-family ``shape``, flat states
    [n_states], for the split's ``params`` (d_far, h, n_cc, c_ratio): on the
    fine grid K1's FINE_STENCIL mode and the weighted correction where the
    stencil geometry accepts, else its FINE mode; K1's COARSE mode on the
    coarse grid; the far field interpolated back in plain torch. CPU
    tensors: its plain version."""
    if T.device.type == "cpu":
        return sigma_coarse_plain(plan, lines, T, P, Pp, params, conc, shape)
    geom = coarse_geometry(plan, lines, params)
    n_states, dev, alpha, co, coef, bcoef, fast = _route_operands(
        lines, T, P, Pp, geom.coarse_windows, conc, shape, geom.zones["cut"])
    _check_windows(geom.fine_windows, lines.n_lines)
    arrs = _coarse_arrays(geom, dev)
    z = geom.zones
    zones = _zones(**z)
    if geom.stencil is not None:
        fine = launch_mode(window_mode("fine_stencil", shape), arrs["fine"], lines, coef,
                           n_states, plan.n_nu, zones, bcoef=bcoef, fast=fast)
        stencil_correction(fine, geom.stencil, co, z["cut"], weight=(z["D1"], z["D2"]),
                           T=chi_T(shape, T), bcoef=bcoef)
    else:
        fm = window_mode("fine", shape)
        fine = launch_mode(fm, arrs["fine"], lines, _pack(fm, co), n_states, plan.n_nu, zones,
                           near_distance(alpha, z["cut_f"]), bcoef=bcoef, fast=fast)
    cm = window_mode("coarse", shape)
    far_c = launch_mode(cm, arrs["coarse"], lines, _pack(cm, co), n_states, geom.params[2],
                        zones, bcoef=bcoef, fast=fast)
    return fine + far_from_coarse(far_c, geom)


def _segment_windows(plan: LineWindowPlan, n_lines: int, L_seg: int, dev):
    """(segment, its block grid and int32 window table on ``dev``) for each
    of the catalog's segments (:func:`.linesum_strategies.segments`), cached
    on the plan under the segments' own key and the device."""
    key = (dev, "segments", int(n_lines), int(L_seg))
    got = plan._on_device.get(key)
    if got is None:
        full = plan.device_arrays(dev)
        B = plan.block
        got = plan._on_device[key] = [
            (g, {"nu_hi": full["nu_hi"][g.blo * B: g.bhi * B],
                 "nu_lo": full["nu_lo"][g.blo * B: g.bhi * B],
                 "win": torch.as_tensor(g.windows, dtype=torch.int32, device=dev),
                 "win_host": g.windows})
            for g in segments(plan, n_lines, L_seg)]
    return got


def sigma_segmented(plan: LineWindowPlan, lines, T, P, Pp, L_seg: int, shape: str = "voigt",
                    conc=None, nosplit: bool = False):
    """K1-seg, flat states [n_states]: the catalog cut into segments of
    ``L_seg`` lines (:func:`.linesum_strategies.segments`); for each, its own
    coefficient pack and (the Voigt family's split mode) its own d_near from
    its own largest Doppler width, and one K1 launch over the blocks its
    windows meet, added in place into one sigma [n_states, n_nu]; the
    no-split sweep in each segment with ``nosplit``, as JAX's segments take
    the call's strategy. CPU tensors: its plain version (the exact profile,
    whichever sweep)."""
    if T.device.type == "cpu":
        return sigma_segmented_plain(plan, lines, T, P, Pp, L_seg, shape, conc)
    mode = nosplit_mode(shape) if nosplit else _mode(shape)
    n_states, dev = _checked(lines, T, P, Pp, conc)
    _check_windows(plan.windows(), lines.n_lines)
    if L_seg < 1:
        raise ValueError(f"segments need at least one line, not {L_seg}")
    out = torch.zeros((n_states, plan.n_nu), dtype=torch.float32, device=dev)
    zones = _zones(plan.cut)
    bcoef = chi_rates(T) if mode in _PHCO2_MODES else None
    for seg, grid in _segment_windows(plan, lines.n_lines, L_seg, dev):
        sub = _slice_lines(lines, seg.a, seg.b)
        S, alpha, gamma = _line_params(sub, T, P, Pp,
                                       None if conc is None else conc[..., seg.a:seg.b])
        alpha = effective_alpha(shape, alpha)
        d_near = near_distance(alpha, plan.cut) if mode in _D_NEAR_MODES else None
        coef, fast = _packed(mode, S, alpha, gamma, 1, plan.cut, bcoef)
        launch_mode(mode, grid, sub, coef, n_states, seg.n_out, zones, d_near,
                    out=out[:, seg.blo * plan.block:], count_as=_family(shape) + "segmented",
                    bcoef=bcoef, fast=fast)
    return out


def full_mode(shape: str) -> int:
    """K4/K5's window-kernel mode of ``shape``."""
    if shape not in FULL_MODES:
        raise ValueError(f"the full-profile kernels have no shape {shape!r}")
    return FULL_MODES[shape]


def full_reach(ry, small=None):
    """Each line's largest near reach over each balanced tile of states and,
    with ``small`` ([n_lines, n_states] bool), whether some state of the tile
    takes the small-y form: [n_lines, n_tiles, 2] from ``ry`` [n_lines,
    n_states] (-inf where a line has no state of nonzero strength)."""
    L, n = ry.shape
    T = window_tiles(n)
    q, rem = divmod(n, T)

    def tiles(x, reduce):
        head = reduce(x[:, :rem * (q + 1)].reshape(L, rem, q + 1))
        tail = reduce(x[:, rem * (q + 1):].reshape(L, T - rem, q))
        return torch.cat([head, tail], dim=1)

    r = tiles(ry, lambda x: x.amax(dim=2))
    f = torch.zeros_like(r) if small is None else tiles(small, lambda x: x.any(dim=2)).to(r.dtype)
    return torch.stack([r, f], dim=-1).contiguous()


def full_pack(shape: str, S, alpha, gamma, cut: float, bcoef=None):
    """K4/K5's operands from the per-(state, line) (S, alpha, gamma)
    [n_states, n_lines] (alpha the profile's width, a *_ref shape's already
    divided by sqrt(ln 2)): (coef, reach, fast), made on the device once a
    call.

    Voigt and phco2: coef [n_lines, 2, n_states, 4], the window quad, then
    w4's (Sia, ia, y0, r), r the (line, state)'s near reach beyond which
    |x| + y >= 15 (w4's region 1): (15.01 - y0) / ia (phco2 where 3 ia <
    15.01, beyond 3 cm^-1 chi may bring y below y0: 15.01 / ia), -inf where
    Sia = 0. The window quad: voigt's (A, 1/2 - y0^2, 2 y0^2, k2), or where
    y0 < 0.01 (A, 0, -1, 2 Sia y0 / sqrt(pi)), the small-y repair's term
    Sia y0 g(x) beyond the reach; phco2's (0.5641896 Sia, y0, A, 0); a line
    of zero strength (0, 0, 1, 0) (phco2: (0, 1, 1, 0)), whose term is 0.
    reach: :func:`full_reach` of r (voigt with each tile's small-y flag).
    Lorentz: coef [n_lines, n_states, 4] of (S gamma / pi, gamma^2, 0, 0);
    Doppler: (Sia, A, 0, 0); reach None. fast: int32 [1], the reciprocal's
    flag (:func:`far_reciprocal_ok` of the FINE instance's denominators,
    whose bound also holds the small-y form's x^2)."""
    mode = full_mode(shape)
    no = torch.zeros(1, dtype=torch.int32, device=S.device)
    if mode == 16:
        cols = (S * gamma * (1.0 / math.pi), gamma * gamma)
    elif mode == 17:
        co = voigt_coefficients(S, alpha, gamma)
        cols = (co[0], co[3])
    if mode in (16, 17):
        z = torch.zeros_like(S)
        return torch.stack(cols + (z, z), dim=-1).transpose(0, 1).contiguous(), None, no
    co = voigt_coefficients(S, alpha, gamma)
    Sia, ia, y0, A, _, _, k2 = co
    live = Sia != 0
    zero = torch.zeros_like(A)
    if mode == 15:
        quad = (Sia * 0.5641896, torch.where(live, y0, 1.0), torch.where(live, A, 1.0), zero)
        reach = torch.where(3.0 * ia >= NEAR_X, (NEAR_X - y0) / ia, NEAR_X / ia)
        small = None
    else:
        small = live & (y0 < SMALL_Y)
        y2 = y0 * y0
        quad = (torch.where(live, A, 0.0), torch.where(live & ~small, 0.5 - y2, 0.0),
                torch.where(small, -1.0, torch.where(live, 2.0 * y2, 1.0)),
                torch.where(small, Sia * y0 * (2.0 / math.sqrt(math.pi)), k2))
        reach = (NEAR_X - y0) / ia
    ry = torch.where(live, reach, float("-inf"))
    coef = torch.stack([torch.stack(quad, dim=-1).transpose(0, 1),
                        torch.stack((Sia, ia, y0, ry), dim=-1).transpose(0, 1)],
                       dim=1).contiguous()
    rt = full_reach(ry.transpose(0, 1), None if small is None else small.transpose(0, 1))
    return coef, rt, far_reciprocal_ok(9 if mode == 15 else 4, co, 1, cut, bcoef)


def full_plan(shape: str, grid: dict, n_states: int, window=None) -> dict:
    """The launch plan of K4 and K5 over the plan's ``grid`` at
    ``n_states``: :func:`window_plan` of the shape's FULL mode, cached in
    the grid dict."""
    return window_plan(full_mode(shape), grid, n_states, window)


def launch_fullprofile(shape: str, gathered: bool, grid: dict, lines, coef, n_states: int,
                       n_out: int, cut: float, reach=None, fast=None, bcoef=None, window=None):
    """One K4 (``gathered`` False) or K5 launch into a new sigma[n_states,
    n_out]: the window kernel's FULL mode of ``shape`` over one window a row
    of ``grid`` (the plan's ``nu_hi``/``nu_lo`` block grid and window table
    ``win``), every state in one launch. K4 and K5 make the same launch:
    the lane layout's windows add, before each of the plan's, lines beyond
    every point's cut, whose terms are 0. ``lines`` is
    the catalog the windows index (positions read in place), ``coef``,
    ``reach`` and ``fast`` the :func:`full_pack` of its (S, alpha, gamma),
    ``bcoef`` the :func:`chi_rates` of the phco2 family, and only of it;
    ``window`` :func:`window_plan`'s ``override``. Counts under "gathered"
    where ``gathered`` is true, else "lane" (the phco2 family's under
    "phco2_")."""
    mode = full_mode(shape)
    win = grid["win"]
    dev = coef.device
    n_rows = win.shape[0]
    block = grid["nu_hi"].shape[0] // max(n_rows, 1)
    if (tuple(win.shape) != (n_rows, 2) or win.dtype != torch.int32 or block > 512
            or n_rows * block != grid["nu_hi"].shape[0] or n_rows * block < n_out):
        raise ValueError(f"a grid of {n_rows} blocks of {block} points and an int32 window "
                         f"table [n_blocks, 2] cannot give {n_out} outputs")
    w4 = mode in _FULL_W4
    check_operand("coef", coef, (lines.n_lines, 2, n_states, 4) if w4
                  else (lines.n_lines, n_states, 4), dev)
    if w4 != (reach is not None):
        raise ValueError("the near reach goes with voigt and phco2, and only with them")
    if reach is not None:
        check_operand("reach", reach, (lines.n_lines, window_tiles(n_states), 2), dev)
    if (mode == 15) != (bcoef is not None):
        raise ValueError("chi's rates go with the phco2 family, and only with it")
    if bcoef is not None:
        _check_rates(bcoef, n_states, dev)
    if fast is None:
        fast = torch.zeros(1, dtype=torch.int32, device=dev)
    check_operand("fast", fast, (1,), dev, torch.int32)
    _check_windows(grid["win_host"], lines.n_lines)
    out = torch.empty((n_states, n_out), dtype=torch.float32, device=dev)
    if n_states == 0 or lines.n_lines == 0:
        return out.zero_()
    plan = window_plan(mode, grid, n_states, window)
    scratch = counters = None
    if plan["scratch_slots"]:
        scratch = torch.empty(plan["scratch_slots"] * n_states * block, dtype=torch.float32,
                              device=dev)
        counters = torch.zeros(plan["rows"] * plan["tiles"], dtype=torch.int32, device=dev)
    ptr = lambda x: None if x is None else x.data_ptr()
    err = _library().window_launch(
        mode, grid["nu_hi"].data_ptr(), grid["nu_lo"].data_ptr(), lines.nu.data_ptr(),
        lines.nu_lo.data_ptr(), None, ptr(reach), coef.data_ptr(), win.data_ptr(),
        plan["table"].data_ptr(), plan["pieces"], fast.data_ptr(), None, ptr(bcoef),
        _zones(cut), block, n_rows, plan["groups"], plan["points_per_thread"], n_states, n_out,
        n_out, ptr(scratch), ptr(counters), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"full-profile kernel launch failed: CUDA error {err}")
    _count(_family(shape) + ("gathered" if gathered else "lane"))
    return out


def _full_call(plan: LineWindowPlan, lines, T, P, Pp, shape: str, conc, gathered: bool):
    """K4 or K5 on the card: the pack made on the device (the line
    parameters freed before sigma is allocated), one launch."""
    n_states, dev = _checked(lines, T, P, Pp, conc)
    _check_windows(plan.windows(), lines.n_lines)
    full_mode(shape)
    S, alpha, gamma = _line_params(lines, T, P, Pp, conc)
    bcoef = chi_rates(T) if shape in PHCO2_FAMILY else None
    coef, reach, fast = full_pack(shape, S, effective_alpha(shape, alpha), gamma, plan.cut, bcoef)
    del S, alpha, gamma
    return launch_fullprofile(shape, gathered, plan.device_arrays(dev), lines, coef, n_states,
                              plan.n_nu, plan.cut, reach, fast, bcoef)


def sigma_lane(plan: LineWindowPlan, lines, T, P, Pp, shape: str = "voigt", conc=None):
    """K4, flat states [n_states]: the full profile over each block's window,
    read in place from the catalog (the lines of the lane layout's window,
    :func:`.linesum_strategies.lane_layout`, that some point's cut
    reaches), every state in one launch. CPU tensors: its plain version."""
    if T.device.type == "cpu":
        return sigma_lane_plain(plan, lines, T, P, Pp, shape, conc)
    return _full_call(plan, lines, T, P, Pp, shape, conc, False)


def sigma_gathered(plan: LineWindowPlan, lines, T, P, Pp, shape: str = "voigt", conc=None):
    """K5, flat states [n_states]: the full profile over each block's window
    (the lines its gathered slab holds,
    :func:`.linesum_strategies.gathered_slabs`), read in place from the
    catalog, every state in one launch. CPU tensors: its plain version."""
    if T.device.type == "cpu":
        return sigma_gathered_plain(plan, lines, T, P, Pp, shape, conc)
    return _full_call(plan, lines, T, P, Pp, shape, conc, True)


def sigma_routed(plan: LineWindowPlan, lines, T, P, Pp, shape: str = "voigt",
                 strategy: str = "auto", conc=None, resident_limit=None):
    """sigma[n_states, n_nu] through the route that ``strategy`` gives for
    this plan, catalog and number of states
    (:func:`.linesum_strategies.route`), with the residency gates at
    ``resident_limit`` bytes (by default the card's L2 cache,
    :func:`.linesum_strategies.resident_budget`).

    Differentiable in T, P, Pp and conc: whatever the route, the tangents
    and cotangents are those of the exact plain :func:`.linesum.sigma_from_lines`
    in the states' dtype (:func:`..utils.twin.with_twin`), as the JAX
    package's ``_pallas_jvp_rule`` runs its ``sigma_from_lines``. The
    catalog carries no derivative (a catalog tensor that needs one raises).
    """
    for f in PER_LINE_FIELDS:
        twin.refuse_derivatives(f"lines.{f}", getattr(lines, f))
    return twin.with_twin(
        lambda *x: _routed_launch(plan, lines, *x, shape, strategy, resident_limit),
        lambda T, P, Pp, conc: sigma_from_lines(plan, lines, T, P, Pp, shape, conc=conc),
        T, P, Pp, conc)


def _routed_launch(plan: LineWindowPlan, lines, T, P, Pp, conc, shape, strategy,
                   resident_limit):
    """:func:`sigma_routed`'s primal: the route's kernels (its plain
    versions for CPU tensors)."""
    name, param = _resolve(plan, lines, shape, strategy, routing_states(T.shape[0]),
                           resident_limit)
    if name == "coarse":
        return sigma_coarse(plan, lines, T, P, Pp, param, conc, shape)
    if name == "stencil":
        return sigma_stencil(plan, lines, T, P, Pp, conc, shape)
    if name == "nosplit":
        return sigma_nosplit(plan, lines, T, P, Pp, shape, conc)
    if name == "segmented":
        return sigma_segmented(plan, lines, T, P, Pp, param, shape, conc,
                               nosplit=strategy == "nosplit")
    if name == "lane":
        return sigma_lane(plan, lines, T, P, Pp, shape, conc)
    if name == "gathered":
        return sigma_gathered(plan, lines, T, P, Pp, shape, conc)
    return sigma_lines(plan, lines, T, P, Pp, shape, conc)


# --- K1-dev: the sharded path's line sum --------------------------------------

def _flat_lines(lines):
    """A stack of line slabs [k, L_pad] as one catalog of k L_pad lines (views)."""
    return dataclasses.replace(lines, **{f: getattr(lines, f).reshape(-1)
                                         for f in PER_LINE_FIELDS})


def _dev_grid(dplan: DeviceWindowPlan, kind: str, L: int, dev):
    """K1-dev's operands of one grid of a stacked plan, on ``dev`` and
    cached on the plan: the flat two-float grid of every shard and its
    int32 window table [k n_blocks, 2 n_windows], each shard's starts moved
    by s L into the side-by-side catalog. ``kind``: "plan" (the plan's
    windows), "fine" or "coarse" (the split's passes)."""
    key = ("dev_grid", kind, int(L), dev)
    got = dplan._cache.get(key)
    if got is None:
        k = dplan.n_shards
        if kind == "plan":
            hi, lo = dplan.nu_blocks.float(), dplan.nu_blocks_lo
            win = torch.stack([dplan.start, dplan.count], dim=-1)
        else:
            hi, lo = getattr(dplan, f"{kind}_blocks"), getattr(dplan, f"{kind}_blocks_lo")
            win = getattr(dplan, f"{kind}_windows")
        win = win.to(device=dev, dtype=torch.int64)
        shift = torch.zeros_like(win)
        shift[..., 0::2] = (torch.arange(k, device=dev) * L)[:, None, None]
        win = (win + shift).reshape(-1, win.shape[-1]).to(torch.int32).contiguous()
        host = win.cpu().numpy().astype(np.int64)
        _check_windows(host, k * L)
        got = dplan._cache[key] = {"nu_hi": hi.to(dev).reshape(-1).contiguous(),
                                   "nu_lo": lo.to(dev).reshape(-1).contiguous(), "win": win,
                                   "win_host": host}
    return got


def sigma_device(dplan: DeviceWindowPlan, lines, T, P, Pp, shape: str = "voigt",
                 strategy: str = "auto", conc=None):
    """K1-dev, flat states [n_states]: the line sum over a stacked device
    plan (k shards) and the shards' padded line slabs (per-line fields
    [k, L_pad]; ``conc`` [k, L_pad] or [n_states, k, L_pad]),
    sigma[n_states, k n_nu], through the route
    :func:`.linesum_strategies.device_route` gives at the card's L2
    (:func:`.linesum_strategies.resident_budget`). The coarse split and
    K1's windowed sweeps run every shard in one launch a mode; "lane" and
    "gathered" run K4 or K5 once a shard.

    Differentiable in T, P, Pp and conc with the derivatives of the exact
    plain sum (:func:`.linesum.sigma_from_lines_shards`). CPU tensors take
    that plain sum.
    """
    for f in PER_LINE_FIELDS:
        twin.refuse_derivatives(f"lines.{f}", getattr(lines, f))
    plain = lambda T, P, Pp, conc: sigma_from_lines_shards(dplan, lines, T, P, Pp, shape, conc)
    if not twin.kernel_path(T):
        return plain(T, P, Pp, conc)
    return twin.with_twin(lambda *x: _device_launch(dplan, lines, *x, shape, strategy),
                          plain, T, P, Pp, conc)


def _device_launch(dplan: DeviceWindowPlan, lines, T, P, Pp, conc, shape, strategy):
    """:func:`sigma_device`'s primal on the card."""
    k, L = lines.nu.shape
    if dplan.n_shards != k or dplan.start.dim() != 2:
        raise ValueError(f"a stacked plan of {dplan.n_shards} shards for {k} line slabs")
    n = T.shape[0]
    if n == 0:
        return torch.zeros((0, k * dplan.n_nu), dtype=torch.float32, device=T.device)
    name = device_route(dplan, L, shape, strategy, routing_states(n), resident_budget(T.device))
    if name in ("lane", "gathered"):
        run = sigma_lane if name == "lane" else sigma_gathered
        return torch.cat([run(dplan.shard(s).host_plan(), shard_lines(lines, s), T, P, Pp, shape,
                              shard_conc(conc, s)) for s in range(k)], dim=-1)
    launches, finish = device_launches(dplan, lines, T, P, Pp, conc, shape, name)
    return finish(*(launch() for _, launch in launches))


def device_launches(dplan: DeviceWindowPlan, lines, T, P, Pp, conc, shape: str, route: str):
    """K1-dev's launches for a windowed ``route`` ("grouped", "nosplit" or
    "coarse"), with their operands checked and packed: (launches, finish).
    ``launches`` lists (launch-count name, a function of no arguments that
    launches one mode over every shard and returns its output); ``finish``
    makes sigma [n_states, k n_nu] of the outputs (the coarse route adds
    the far field interpolated from its coarse grids). A caller can so time
    each launch apart from the pack."""
    k, L = lines.nu.shape
    n = T.shape[0]
    flat = _flat_lines(lines)
    if conc is not None:
        conc = conc.reshape(conc.shape[:-2] + (k * L,))
    _, dev = _checked(flat, T, P, Pp, conc)
    S, alpha, gamma = _line_params(flat, T, P, Pp, conc)
    alpha = effective_alpha(shape, alpha)
    # each shard's largest Doppler width over its real lines
    amax = masked_alpha_max(alpha.view(n, k, L), lines.nu[None], dims=(0, 2))
    if route == "coarse":
        split_check(shape)
        d_far, h, n_cc, c_ratio = dplan.coarse_meta
        z = split_zones(dplan.cut, d_far, h)
        zones = _zones(**z)
        bcoef = chi_rates(T) if shape in PHCO2_FAMILY else None
        d_near = torch.clamp(15.0 * amax, max=z["cut_f"]).contiguous()
        fm, cm = window_mode("fine", shape), window_mode("coarse", shape)
        co = voigt_coefficients(S, alpha, gamma)
        fcoef, ccoef = _pack(fm, co), _pack(cm, co)   # each mode its own layout
        fast = far_reciprocal_ok(fm, co, k, dplan.cut, bcoef)
        fgrid, cgrid = _dev_grid(dplan, "fine", L, dev), _dev_grid(dplan, "coarse", L, dev)
        interp = strided_interp(c_ratio, dplan.n_nu)
        launches = [
            ("dev_" + _MODE_NAMES[fm],
             lambda: launch_mode(fm, fgrid, flat, fcoef, n, dplan.n_nu, zones, d_near,
                                 bcoef=bcoef, n_shards=k, count_as="dev_" + _MODE_NAMES[fm],
                                 fast=fast)),
            ("dev_" + _MODE_NAMES[cm],
             lambda: launch_mode(cm, cgrid, flat, ccoef, n, n_cc, zones, bcoef=bcoef, n_shards=k,
                                 count_as="dev_" + _MODE_NAMES[cm], fast=fast))]
        finish = lambda fine, far_c: fine + far_from_coarse(far_c.view(n * k, n_cc),
                                                            interp).view(n, k * dplan.n_nu)
        return launches, finish
    mode = nosplit_mode(shape) if route == "nosplit" else _mode(shape)
    d_near = (torch.clamp(15.0 * amax, max=dplan.cut).contiguous()
              if mode in _D_NEAR_MODES else None)
    bcoef = chi_rates(T) if mode in _PHCO2_MODES else None
    coef, fast = _packed(mode, S, alpha, gamma, k, dplan.cut, bcoef)
    grid, zones = _dev_grid(dplan, "plan", L, dev), _zones(dplan.cut)
    return [("dev_" + _MODE_NAMES[mode],
             lambda: launch_mode(mode, grid, flat, coef, n, dplan.n_nu, zones, d_near, bcoef=bcoef,
                                 n_shards=k, count_as="dev_" + _MODE_NAMES[mode], fast=fast))], \
        lambda x: x

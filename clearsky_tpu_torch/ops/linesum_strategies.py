"""The routes of the line sum, their residency gates and plain versions.

Counterpart of the strategy half of ``clearsky_tpu/ops/linesum_pallas.py``:
the geometry of each voigt route (``_coarse_far_params``,
``_stencil_width``, ``_build_stencil_geom``), the routing policy of
``sigma_from_lines_pallas`` with its residency gates (:func:`route`), and
the plain versions of the kernels' layouts and modes, composed as
``_pallas_sigma_impl`` + ``_stencil_apply`` (stencil), ``_coarse_core``
(coarse), ``_pallas_sigma_segmented`` (segmented) and the lane-major and
gathered branches of ``_pallas_sigma_impl`` compose them.

Routes of a line sum:

* ``"grouped"``: K1 over the plan's windows, in its split mode (the Voigt
  family: voigt, voigt_ref, phco2, phco2_ref) or its single sweep (lorentz,
  doppler);
* ``"nosplit"``: K1 over the plan's windows in its no-split sweep, the full
  w4 at every in-cut pair (the Voigt family; strategy "nosplit");
* ``"stencil"``: K1's FARALL mode, Humlicek region 1 over each whole window,
  then the correction Sia (w4 - region 1) on the 2K grid points around each
  line, where |x| <= 15 (region 1 is exact elsewhere);
* ``"coarse"``: each line's truncated profile split by a C^2 switch W(dnu^2)
  over [d_far, 2 d_far] and an outer roll over [cut - w_roll, cut]. On the
  fine grid, the FINE mode (near w4 and mid region 1, weighted 1 - W) or
  FINE_STENCIL (mid region 1 weighted 1 - W, plus the correction weighted
  alike) and two thin annuli at the cut that keep its hard truncation exact;
  the smooth far field W Wout region 1 on a uniform coarse grid of spacing
  h (COARSE), brought back by Catmull-Rom interpolation in sqrt space;
* ``"segmented"``: the catalog cut into segments of at most L_seg lines,
  K1 over each segment's block range, summed in place (K1-seg);
* ``"lane"``: the full profile over each block's CHUNK-aligned window of
  unpacked per-state rows (K4);
* ``"gathered"``: the full profile over per-block line slabs gathered
  before the launch (K5).

Every route takes the four shapes of the Voigt family. The *_ref shapes
differ from voigt and phco2 only by alpha -> alpha / sqrt(ln 2), folded into
the coefficients; phco2 multiplies y by chi(|dnu|, T), so its far wing is
region 1 in the explicit (x, y) form instead of the voigt form in D.

The residency gates are the JAX package's cost model (``_grouped_lane_cost``,
``_resident_bytes_est``, ``_segment_cap``, ``_coarse_resident_ok``) over a
byte budget: JAX's is its 6 MiB of VMEM, the port's the card's L2 cache
(:func:`resident_budget`; the decisions are JAX's, the budget only
larger). The geometry is the JAX package's, bit for bit,
in float64 numpy. What the port drops: the stencil's one-hot placement
tensors and chunk pad classes (the TPU's matrix-unit placement; the port
gathers each row's lines in a fixed order, :func:`correction_rows`) and the
branches for traced catalogs (torch has no tracers).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import types
import weakref

import numpy as np
import torch

from ..constants import C_LIGHT, R_GAS
from ..spectra.lines import PER_LINE_FIELDS
from .faddeeva import wofz_re
from .lineshape import chi_phco2
from .linesum import (
    PHCO2_FAMILY,
    SPLIT_SHAPES,
    VOIGT_FAMILY,
    LineWindowPlan,
    _line_params,
    block_sum,
    effective_alpha,
    grid_blocks,
    region1_xy,
    tile_exact,
    tile_region1,
    tile_T,
    tile_w4,
    voigt_coefficients,
)

__all__ = [
    "STRATEGIES",
    "check_strategy",
    "resident_budget",
    "routing_states",
    "route",
    "segments",
    "lane_layout",
    "gathered_slabs",
    "coarse_params",
    "stencil_geometry",
    "coarse_geometry",
    "mode_zones",
    "sigma_mode_plain",
    "stencil_correction_plain",
    "correction_rows",
    "far_from_coarse",
    "sigma_stencil_plain",
    "sigma_nosplit_plain",
    "sigma_coarse_plain",
    "coarse_route_plain",
    "device_route",
    "fine_block",
    "split_windows",
    "sigma_coarse_device_plain",
    "sigma_segmented_plain",
    "sigma_lane_plain",
    "sigma_gathered_plain",
    "coefficients",
    "chi_T",
]

STRATEGIES = ("auto", "grouped", "nosplit", "stencil", "coarse", "lane", "gathered")

# lines per chunk of the JAX package's kernels: its packs and the lane
# layout pad the catalog by whole chunks, and segments are CHUNK multiples
CHUNK = 128
# the JAX package's residency budget (its VMEM), for comparing decisions
JAX_RESIDENT_LIMIT = 6 * 2**20
# the H100's L2 cache: the budget of a catalog that is not on a card
H100_L2_BYTES = 50 * 2**20

# coarse-far split constants of the JAX package: h = d_far / Q coarse
# spacing, outer roll width W_ROLL_CELLS h; the auto route takes the split
# only where its work fraction is under AUTO_COARSE_FRAC, an explicit
# "coarse" under EXPLICIT_COARSE_FRAC
Q_COARSE = 16
W_ROLL_CELLS = 4
AUTO_COARSE_FRAC = 0.2
EXPLICIT_COARSE_FRAC = 0.6

_SQRT_LN2 = 0.8325546111576977


def check_strategy(strategy: str) -> None:
    """Raise unless the port has the line-sum strategy ``strategy``."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown line-sum strategy {strategy!r} (have {STRATEGIES})")


_COLUMNS = contextvars.ContextVar("line_sum_columns", default=None)


@contextlib.contextmanager
def _column_batch(n_columns: int):
    """Route the line sums inside as one column's: their states are
    ``n_columns`` columns flattened into one batch (a batched absorber
    refresh, ``AcceleratedAbsorber.update``), and the route gates read one
    column's share of them (:func:`routing_states`), as the JAX package's
    gates see one column under ``vmap``. The route's kernels then run over
    every state at once. Scopes do not nest."""
    if n_columns < 1:
        raise ValueError(f"a batch of {n_columns} columns")
    if _COLUMNS.get() is not None:
        raise RuntimeError("a batch of columns is already being routed")
    tok = _COLUMNS.set(int(n_columns))
    try:
        yield
    finally:
        _COLUMNS.reset(tok)


def routing_states(n_states: int) -> int:
    """The state count the route gates read for a line sum of ``n_states``
    states: one column's inside :func:`_column_batch`, else all of them."""
    return -(-int(n_states) // (_COLUMNS.get() or 1))


def _coarse_far_params(plan: LineWindowPlan, frac_limit: float = EXPLICIT_COARSE_FRAC):
    """Applicability and sizing of the coarse-far split from the grid alone:
    ``(d_far, h, n_cc, c_ratio)`` or None where the split cannot win.

    With mean spacing dbar and block span bs, the fine share of the dense
    work is ~(4 d_far + bs)/(2 cut + bs) and the coarse share ~dbar/h; d_far
    minimises their sum and is held to the three-zone constraints. Q (coarse
    points per d_far) tries 16, then 8. A grid within 0.05 h of the uniform
    lattice snaps h to c_ratio spacings (strided interpolation); any other
    grid keeps c_ratio = 0 (gathered interpolation).
    """
    nu = np.asarray(plan.nu, np.float64)
    if plan.n_nu < 2048:
        return None
    cut = float(plan.cut)
    diffs = np.diff(nu)
    dbar = float((nu[-1] - nu[0]) / max(plan.n_nu - 1, 1))
    dmax = float(diffs.max())
    bs = plan.block * dbar
    # the strided interpolation assumes nu[i] = nu[0] + i dbar: bound each
    # point's cumulative deviation from that lattice, not the local jitter
    lattice_dev = float(np.abs(nu - (nu[0] + np.arange(nu.shape[0]) * dbar)).max())
    for Q in (Q_COARSE, 8):
        d_far = float(np.sqrt(Q * dbar * (2.0 * cut + bs) / 4.0))
        h = d_far / Q
        c_ratio = 0
        if lattice_dev <= 0.05 * h:
            c_ratio = int(h / dbar)
            if c_ratio < 2:
                continue
            h = c_ratio * dbar
        w_roll = W_ROLL_CELLS * h
        if cut <= 2.0 * d_far + w_roll:       # the three zones must be disjoint
            continue
        if h < 2.0 * dmax:                    # coarsening below 2x cannot pay
            continue
        fine_frac = (4.0 * d_far + bs) / (2.0 * cut + bs)
        coarse_frac = dbar / h
        ann_frac = 2.0 * w_roll / (2.0 * cut + bs)
        if fine_frac + coarse_frac + ann_frac > frac_limit:
            continue
        n_cc = int(np.ceil((nu[-1] - nu[0] + 8.0 * h) / h)) + 6
        return d_far, h, n_cc, c_ratio
    return None


def coarse_params(plan: LineWindowPlan, frac_limit: float):
    """:func:`_coarse_far_params`, cached on the plan."""
    key = ("coarse_params", float(frac_limit))
    if key not in plan._geometry:
        plan._geometry[key] = _coarse_far_params(plan, frac_limit)
    return plan._geometry[key]


def _cr_weights(t) -> np.ndarray:
    """Catmull-Rom cubic weights [4, ...] at fractional offsets t (float64)."""
    t = np.asarray(t, np.float64)
    return np.stack([
        -0.5 * t**3 + t**2 - 0.5 * t,
        1.5 * t**3 - 2.5 * t**2 + 1.0,
        -1.5 * t**3 + 2.0 * t**2 + 0.5 * t,
        0.5 * t**3 - 0.5 * t**2,
    ])


def _catalog64(lines):
    """Line positions and molar masses as float64 numpy."""
    return lines.positions64(), lines.mu.detach().cpu().double().numpy()


def _doppler_1000(nu_l, mu):
    """1/e Doppler widths at 1000 K, the ceiling of the TIPS fits."""
    return nu_l / C_LIGHT * np.sqrt(2.0 * R_GAS * 1000.0 / mu)


def _stencil_width(plan: LineWindowPlan, lines) -> int:
    """Stencil width K: K/2 steps of the finest grid spacing reach
    15 alpha(1000 K) / sqrt(ln 2) for every line within the cut of the grid,
    the |x| <= 15 core where region 1 is not w4."""
    grid = np.asarray(plan.nu, np.float64)
    if grid.shape[0] < 2:
        return 8
    dmin = float(np.diff(grid).min())
    nu_c, mu_c = _catalog64(lines)
    m = (nu_c >= grid[0] - plan.cut) & (nu_c <= grid[-1] + plan.cut)
    amax = float(_doppler_1000(nu_c[m], mu_c[m]).max()) if m.any() else 0.0
    amax = amax * (1.0 / _SQRT_LN2)
    k = 2 * (int(np.ceil(15.0 * amax / dmin)) + 2)
    k = -(-k // 8) * 8
    return max(8, min(k, int(plan.n_nu)))


@dataclasses.dataclass(frozen=True, eq=False)
class StencilGeom:
    """Each line's window of 2K grid points, rows q and q + 1 of the K-wide
    row grid (K/2 points of reach on each side of the line)."""

    K: int
    R: int                  # rows: ceil(n_nu / K)
    q: np.ndarray           # [L] int64, first row of each line's window
    dnu_hi: np.ndarray      # [2K, L] float32 point-minus-line offsets (two-float)
    dnu_lo: np.ndarray      # [2K, L] float32 residuals
    _on_device: dict = dataclasses.field(default_factory=dict, repr=False)


def _build_stencil_geom(plan: LineWindowPlan, lines) -> StencilGeom | None:
    """The stencil geometry, or None where the route does not apply: a near
    zone reaching the cut, K > 64 (a line-resolving grid, the coarse split's
    regime), fewer than 4K points, or fewer than two rows."""
    nu_l64, mu_c = _catalog64(lines)
    L = int(nu_l64.shape[0])
    grid = np.asarray(plan.nu, np.float64)
    n_nu = int(plan.n_nu)
    if L == 0 or grid.shape[0] < 2:
        return None
    K = _stencil_width(plan, lines)
    mrange = (nu_l64 >= grid[0] - plan.cut) & (nu_l64 <= grid[-1] + plan.cut)
    if not mrange.any():
        return None
    amax = float(_doppler_1000(nu_l64[mrange], mu_c[mrange]).max()) / _SQRT_LN2
    if K > 64 or n_nu < 4 * K or 15.0 * amax >= 0.99 * plan.cut:
        return None
    R = -(-n_nu // K)
    if R < 2:
        return None
    idx0 = np.searchsorted(grid, nu_l64).astype(np.int64)
    q = np.clip((idx0 - K // 2) // K, 0, R - 2).astype(np.int64)
    gwin = q[:, None] * K + np.arange(2 * K, dtype=np.int64)[None, :]
    gval = grid[np.minimum(gwin, n_nu - 1)]
    dnu64 = gval - nu_l64[:, None]                                  # [L, 2K]
    dnu_hi = dnu64.astype(np.float32)
    dnu_lo = (dnu64 - dnu_hi.astype(np.float64)).astype(np.float32)
    return StencilGeom(K=int(K), R=int(R), q=q, dnu_hi=dnu_hi.T.copy(),
                       dnu_lo=dnu_lo.T.copy())


def _cached(plan: LineWindowPlan, key, lines, build):
    """``build()`` for this catalog object, cached on the plan."""
    got = plan._geometry.get(key)
    if got is not None and got[0]() is lines:
        return got[1]
    value = build()
    plan._geometry[key] = (weakref.ref(lines), value)
    return value


def stencil_geometry(plan: LineWindowPlan, lines) -> StencilGeom | None:
    """:func:`_build_stencil_geom`, built once per (plan, catalog)."""
    return _cached(plan, "stencil", lines, lambda: _build_stencil_geom(plan, lines))


def correction_rows(geom: StencilGeom, cut: float, n_nu: int) -> dict:
    """The correction's gather schedule over the K-point rows of ``geom``.

    Line l's window covers rows q[l] (its points k < K) and q[l] + 1 (k >=
    K). Each half that holds a grid point within ``cut`` of the line and
    inside the ``n_nu``-point grid is an entry of its row. The entries are
    sorted by (row, q, catalog index), stably and whatever the catalog's
    order, so each row's entries are one contiguous run: its lines of q =
    row - 1, then those of q = row, each in catalog order. That is the
    order in which the kernel sums a point's terms. Numpy arrays:

    * ``line`` [E]: each entry's catalog index;
    * ``dnu_hi``, ``dnu_lo`` [E, K] float32: the entry's half of the
      line's two-float offsets, the row's K points in order;
    * ``rows`` [n_rows, 3]: (row, first entry, end) of every row that an
      entry reaches, costliest (most entries) first, stably; rows that no
      entry reaches are not listed;
    * ``max_entries``: the most entries of a row.
    """
    K, L = geom.K, int(geom.q.shape[0])
    q = np.asarray(geom.q, np.int64)
    hi = np.asarray(geom.dnu_hi).reshape(2, K, L)
    lo = np.asarray(geom.dnu_lo).reshape(2, K, L)
    inside = (q[None, None, :] + np.arange(2)[:, None, None]) * K \
        + np.arange(K)[None, :, None] < n_nu                        # [2, K, L]
    reach = ((np.abs(hi) <= cut) & inside).any(axis=1)              # [2, L]
    half, line = np.nonzero(reach)                                  # half-major, lines ascending
    row = q[line] + half
    order = np.argsort(2 * row - half, kind="stable")               # (row, q, line)
    half, line, row = half[order], line[order], row[order]
    first = np.flatnonzero(np.r_[True, row[1:] != row[:-1]]) if row.size else \
        np.zeros(0, np.int64)
    end = np.r_[first[1:], row.size].astype(np.int64)
    count = end - first
    by_cost = np.argsort(-count, kind="stable")
    rows = np.stack([row[first], first, end], axis=1)[by_cost].astype(np.int64)
    return {"line": line.astype(np.int64),
            "dnu_hi": np.ascontiguousarray(hi[half, :, line]),
            "dnu_lo": np.ascontiguousarray(lo[half, :, line]),
            "rows": rows.reshape(-1, 3), "max_entries": int(count.max(initial=0))}


@dataclasses.dataclass(frozen=True, eq=False)
class CoarseGeom:
    """Grids, line windows and interpolation of the coarse-far split.

    ``zones`` holds the route's distances: cut, cut_f = 2 d_far (the mid
    zone's support), d_lo = d_far (the coarse field's inner edge), the
    switch W over D in [D1, D2] = [d_far^2, 4 d_far^2] and the outer roll
    over [R1, R2] = [(cut - w_roll)^2, cut^2]. The fine grid is the plan's
    grid in its blocks; its windows [n_blocks, 6] are (mid, left annulus,
    right annulus) as (start, count). The coarse grid starts 2h below the
    first point, with windows [n_blocks_c, 2].
    """

    params: tuple                    # (d_far, h, n_cc, c_ratio)
    n_nu: int
    zones: dict
    fine_blocks: np.ndarray          # [n_blocks, B] float64
    fine_windows: np.ndarray         # [n_blocks, 6] int64
    coarse_blocks: np.ndarray        # [n_blocks_c, B] float64
    coarse_windows: np.ndarray       # [n_blocks_c, 2] int64
    interp_j: np.ndarray | None      # gathered interpolation: base index [n_nu]
    interp_w: np.ndarray             # Catmull-Rom weights [4, c_ratio] or [4, n_nu]
    stencil: StencilGeom | None      # FINE_STENCIL where the stencil applies, else FINE
    _on_device: dict = dataclasses.field(default_factory=dict, repr=False)


def coarse_grid(nu0: float, h: float, n_cc: int, B: int) -> np.ndarray:
    """The split's coarse grid [n_blocks_c, B] (float64): n_cc points of
    spacing h from nu0 - 2h, the last block padded with the last point."""
    nu_c0 = nu0 - 2.0 * h
    n_blocks_c = -(-n_cc // B)
    pad_c = np.full(n_blocks_c * B - n_cc, nu_c0 + (n_cc - 1) * h)
    return np.concatenate([nu_c0 + np.arange(n_cc) * h, pad_c]).reshape(n_blocks_c, B)


def split_zones(cut: float, d_far: float, h: float) -> dict:
    """The coarse split's distances (:class:`CoarseGeom` ``zones``)."""
    w_roll = W_ROLL_CELLS * h
    return dict(cut=cut, cut_f=2.0 * d_far, d_lo=d_far, D1=d_far * d_far,
                D2=4.0 * d_far * d_far, R1=(cut - w_roll) ** 2, R2=cut * cut)


def split_windows(pos, fine_blocks, coarse_blocks, cut: float, d_far: float, h: float):
    """The line windows of the split's two passes, as the JAX package's
    ``_coarse_core`` searches them: (fine [n_blocks_f, 6] as (mid, left
    annulus, right annulus), coarse [n_blocks_c, 2]) of (start, count)
    against the sorted float64 positions ``pos``, with 0.01 cm^-1 margins
    (membership is decided in the kernel by the |dnu| masks)."""
    w_roll = W_ROLL_CELLS * h

    def win(nb, lo_off, hi_off):
        s = np.searchsorted(pos, nb[:, 0] + lo_off, side="left")
        e = np.searchsorted(pos, nb[:, -1] + hi_off, side="right")
        return [s, np.maximum(e - s, 0)]

    fine = np.stack(
        win(fine_blocks, -2.0 * d_far - 0.01, 2.0 * d_far + 0.01)
        + win(fine_blocks, -cut - 0.01, -cut + w_roll + 0.01)
        + win(fine_blocks, cut - w_roll - 0.01, cut + 0.01), axis=1).astype(np.int64)
    coarse = np.stack(win(coarse_blocks, -cut - 0.01, cut + 0.01), axis=1).astype(np.int64)
    return fine, coarse


def _build_coarse_geom(plan: LineWindowPlan, lines, params) -> CoarseGeom:
    d_far, h, n_cc, c_ratio = params
    cut = float(plan.cut)
    nu_f = np.asarray(plan.nu, np.float64)
    n_nu, B = plan.n_nu, plan.block
    nu_c0 = nu_f[0] - 2.0 * h
    cnb = coarse_grid(nu_f[0], h, n_cc, B)
    fnb = np.asarray(plan.nu_blocks, np.float64)
    fine_windows, coarse_windows = split_windows(lines.positions64(), fnb, cnb, cut, d_far, h)
    if c_ratio < 2:
        u = (nu_f - nu_c0) / h
        j = np.clip(np.floor(u).astype(np.int64), 1, n_cc - 3)
        interp_j, interp_w = j, _cr_weights(u - j)
    else:
        interp_j, interp_w = None, _cr_weights(np.arange(c_ratio, dtype=np.float64) / c_ratio)
    zones = split_zones(cut, d_far, h)
    return CoarseGeom(params=tuple(params), n_nu=n_nu, zones=zones, fine_blocks=fnb,
                      fine_windows=fine_windows, coarse_blocks=cnb,
                      coarse_windows=coarse_windows, interp_j=interp_j, interp_w=interp_w,
                      stencil=stencil_geometry(plan, lines))


def coarse_geometry(plan: LineWindowPlan, lines, params) -> CoarseGeom:
    """:class:`CoarseGeom` for ``params``, built once per (plan, catalog)."""
    return _cached(plan, ("coarse", tuple(params)), lines,
                   lambda: _build_coarse_geom(plan, lines, params))


def resident_budget(device, resident_limit=None) -> int:
    """The byte budget of the residency gates: ``resident_limit`` where
    given, else the L2 cache of the card ``device`` (the H100's 50 MiB for a
    catalog that is not on a card).

    The CUDA K1 streams any window through shared memory, so no on-chip
    memory caps the pack as VMEM caps the JAX package's (6 MiB); the L2
    size only keeps the packs of existing shapes (<= 11 MB) on the routes
    JAX takes. Measured on an NVIDIA H100 80GB HBM3 at a 700 W limit
    (chip_smoke.py's ``mix`` phase; PERF.md, section 6), the budget does
    not pick the fastest route on a catalog that exceeds it: on 55,000
    lines at 57 states x 2^19 points the segmented route it chooses took
    63 ms, one K1 launch over the whole 98 MB pack 55 ms, the coarse route
    23 ms. K1 reads the pack one 8-state tile (12 MB) at a time, which
    fits L2 either way. Whether one fixed budget would route as well is
    an open question (ROADMAP 4a).
    """
    if resident_limit is not None:
        return int(resident_limit)
    device = torch.device(device)
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).L2_cache_size)
    return H100_L2_BYTES


def _grouped_lane_cost(shape: str, strategy: str, n_states: int) -> int:
    """Per-line pack cost (in float32 values) of K1 in the JAX package's
    layout: the voigt and voigt_ref split pack is (2 + 7 rows a state), its
    stencil pack (2 + 4), every other pack (phco2's and the no-split
    sweep's included) (2 + 3) padded to a multiple of 128."""
    voigt_split = shape in VOIGT_FAMILY and strategy != "nosplit"
    rows = (4 if strategy == "stencil" else 7) if voigt_split else 3
    n_params = rows * n_states + 2
    return n_params if voigt_split else -(-n_params // 128) * 128


def _resident_bytes_est(n_lines: int, slab: int, lane_cost: int) -> int:
    slab_pad = -(-max(1, slab) // CHUNK) * CHUNK
    n_lines_pad = -(-(n_lines + slab_pad + CHUNK) // 128) * 128
    return n_lines_pad * lane_cost * 4


def _segment_cap(shape: str, strategy: str, n_states: int, limit: int, slab: int) -> int:
    """The longest CHUNK-multiple segment whose worst-case pack fits
    ``limit`` (a segment's slab is at most min(slab, its length)); 0 if
    none does."""
    lane_cost = _grouped_lane_cost(shape, strategy, n_states)
    L = (limit // (4 * lane_cost) // CHUNK) * CHUNK
    while L >= CHUNK:
        if _resident_bytes_est(L, min(slab, L), lane_cost) <= limit:
            return L
        L -= CHUNK
    return 0


def _coarse_resident_ok(shape: str, n_states: int, n_lines: int, limit: int) -> bool:
    """Both passes of the coarse split read one pack of the whole catalog."""
    n_lines_pad = -(-(n_lines + 2 * CHUNK) // 128) * 128
    return n_lines_pad * _grouped_lane_cost(shape, "grouped", n_states) * 4 <= limit


def _resolve(plan: LineWindowPlan, lines, shape: str, strategy: str, n_states: int = 1,
             resident_limit=None):
    """(route, parameter): the JAX package's policy at the byte budget
    :func:`resident_budget`; the parameter is the coarse split's
    (d_far, h, n_cc, c_ratio) or the segment length, else None.

    The voigt and voigt_ref "auto" takes the coarse split where it accepts
    at a work fraction of 0.2 and its pack fits, else the stencil route where
    its geometry accepts and its (slimmer) pack fits; the phco2 and
    phco2_ref "auto" takes the coarse split as an explicit "coarse" does
    (at 0.6), and never the stencil route. "auto", "grouped", "nosplit"
    and "stencil" then take K1 over the whole catalog where its pack fits
    ("nosplit": its no-split sweep, for the Voigt family), else over
    segments of ``_segment_cap`` lines (an oversize stencil pack becomes
    segmented, in the split mode; "nosplit" segments sweep without the
    split), else the gathered kernel. An
    explicit "coarse" takes the split where it accepts at 0.6 and its pack
    fits, and auto's route where the geometry rejects it, else the
    grouped-or-segmented decision. "stencil" (any Voigt-family shape)
    without a stencil geometry takes the split mode, as the JAX package's
    compiled body does. Lorentz and Doppler take neither split. "lane"
    takes the lane-major kernel where its rows fit, else the gathered one;
    "gathered" always the gathered one.
    """
    check_strategy(strategy)
    limit = resident_budget(lines.device, resident_limit)
    n_lines = lines.n_lines
    voigt = shape in VOIGT_FAMILY
    split = shape in SPLIT_SHAPES
    frac = EXPLICIT_COARSE_FRAC
    if strategy == "coarse" and voigt and coarse_params(plan, EXPLICIT_COARSE_FRAC) is None:
        strategy = "auto"
    if strategy == "auto" and voigt:
        if (coarse_params(plan, AUTO_COARSE_FRAC) is not None
                and _coarse_resident_ok(shape, n_states, n_lines, limit)):
            strategy, frac = "coarse", AUTO_COARSE_FRAC
        elif (_resident_bytes_est(n_lines, plan.slab,
                                  _grouped_lane_cost(shape, "stencil", n_states)) <= limit
              and stencil_geometry(plan, lines) is not None):
            strategy = "stencil"
    elif strategy == "auto" and split:
        strategy = "coarse"
    if strategy == "coarse":
        params = coarse_params(plan, frac) if split else None
        if params is not None and _coarse_resident_ok(shape, n_states, n_lines, limit):
            return "coarse", params
        strategy = "auto"
    if strategy == "stencil" and not (split and stencil_geometry(plan, lines) is not None):
        strategy = "auto"
    if strategy in ("auto", "grouped", "nosplit", "stencil"):
        lane_cost = _grouped_lane_cost(shape, strategy, n_states)
        if _resident_bytes_est(n_lines, plan.slab, lane_cost) <= limit:
            if strategy == "nosplit" and split:
                return "nosplit", None
            return ("stencil" if strategy == "stencil" else "grouped"), None
        if strategy == "stencil":
            strategy = "auto"
        L_seg = _segment_cap(shape, strategy, n_states, limit, plan.slab)
        if CHUNK <= L_seg < n_lines:
            return "segmented", L_seg
        return "gathered", None
    # K4's unpacked rows: positions and 3 per state, on the padded catalog
    if strategy == "lane" and _resident_bytes_est(n_lines, plan.slab, 3 * n_states + 2) <= limit:
        return "lane", None
    return "gathered", None


def fine_block(shape: str, n_nu: int, B: int) -> int:
    """The block width of the split's fine pass on the sharded path, the
    JAX package's ``_fine_block``: 512 points for the voigt family on grids
    of at least 2048 points, else the plan's block."""
    return 512 if n_nu >= 2048 and shape in VOIGT_FAMILY else B


DEVICE_ROUTES = ("coarse", "grouped", "nosplit", "lane", "gathered")


def device_route(dplan, n_lines: int, shape: str = "voigt", strategy: str = "auto",
                 n_states: int = 1, budget: int = H100_L2_BYTES) -> str:
    """The route of a line sum over a device plan (the sharded path) on the
    card, one of :data:`DEVICE_ROUTES`: the JAX package's
    ``sigma_from_lines_pallas_device`` and ``_pallas_sigma_impl`` at the
    byte ``budget`` (:func:`resident_budget`) for slabs of ``n_lines``.

    The coarse-far split where the plan carries it (``coarse_meta``), the
    shape is of the Voigt family, and the strategy is "coarse", or "auto"
    for the phco2 family, or "auto" where the split passed the auto work
    fraction (``coarse_auto``), and only where its pack fits; otherwise
    "coarse" reads as "auto", and "auto", "grouped", "stencil" and
    "nosplit" take K1 over the plan's windows where the pack fits (the
    no-split sweep for "nosplit" on the Voigt family; the device path has
    no stencil geometry, so "stencil" runs the split mode), "lane" the
    lane-major kernel where its rows fit, and everything else the gathered
    kernel. There is no segmented route on this path.
    """
    check_strategy(strategy)
    if (dplan.coarse_meta is not None and shape in SPLIT_SHAPES
            and (strategy == "coarse" or (strategy == "auto" and shape in PHCO2_FAMILY)
                 or (strategy == "auto" and dplan.coarse_auto))
            and _coarse_resident_ok(shape, n_states, n_lines, budget)):
        return "coarse"
    if strategy == "coarse":
        strategy = "auto"
    if strategy in ("auto", "grouped", "nosplit", "stencil"):
        cost = _grouped_lane_cost(shape, "grouped" if strategy == "stencil" else strategy,
                                  n_states)
        if _resident_bytes_est(n_lines, dplan.slab, cost) <= budget:
            return "nosplit" if strategy == "nosplit" and shape in SPLIT_SHAPES else "grouped"
    if strategy == "lane" and _resident_bytes_est(n_lines, dplan.slab, 3 * n_states + 2) <= budget:
        return "lane"
    return "gathered"


def route(plan: LineWindowPlan, lines, shape: str = "voigt", strategy: str = "auto",
          n_states: int = 1, resident_limit=None) -> str:
    """The route a line sum of ``n_states`` states on the card takes:
    "coarse", "stencil", "grouped", "nosplit", "segmented", "lane" or "gathered"
    (:func:`_resolve`), at the budget :func:`resident_budget`. Raises on a
    strategy the port does not have."""
    return _resolve(plan, lines, shape, strategy, n_states, resident_limit)[0]


def warm(plan: LineWindowPlan, lines, shape: str, strategy: str) -> None:
    """Build the geometry of the route (for one state) while nothing waits
    for it."""
    name, param = _resolve(plan, lines, shape, strategy)
    if name == "coarse":
        coarse_geometry(plan, lines, param)


# --- plain versions -----------------------------------------------------------

def _smoothstep_d2(D, A1, A2):
    """C^2 smootherstep in squared distance: 0 below A1, 1 above A2."""
    w = torch.clamp((D - A1) * (1.0 / (A2 - A1)), 0.0, 1.0)
    return w * w * w * (10.0 + w * (-15.0 + 6.0 * w))


def mode_zones(mode: str, z: dict, co, d_near=None, T=None):
    """The zones of K1's windowed ``mode`` for :func:`block_sum`: window,
    tile, mask and weight of each of the TPU kernel's sweeps
    (``_kernel_resident_grouped``, wmodes farall, fine, fine_stencil,
    coarse, and the no-split sweep, "nosplit", w4 over the whole window). ``co`` are :func:`voigt_coefficients`, ``z`` the distances of
    :class:`CoarseGeom` (FARALL needs only the cut), ``d_near`` the FINE
    mode's core distance (a one-element tensor); ``T`` (the phco2 family,
    from :func:`tile_T`) puts chi(dnu, T) on y in every tile."""
    r1 = tile_region1(co, T)
    cut = z["cut"]
    if mode == "farall":
        return [(0, r1, lambda a, D: a <= cut, None)]
    if mode == "nosplit":
        return [(0, tile_w4(co, T), lambda a, D: a <= cut, None)]
    D1, D2, R1, R2 = z["D1"], z["D2"], z["R1"], z["R2"]
    one_minus_w = lambda D: 1.0 - _smoothstep_d2(D, D1, D2)
    annuli = [(w, r1, lambda a, D: (a <= cut) & (D > R1), lambda D: _smoothstep_d2(D, R1, R2))
              for w in (1, 2)]
    cut_f = z["cut_f"]
    if mode == "fine":
        return [(0, r1, lambda a, D: (a <= cut_f) & (a > d_near), one_minus_w),
                (0, tile_w4(co, T), lambda a, D: a <= d_near, one_minus_w)] + annuli
    if mode == "fine_stencil":
        return [(0, r1, lambda a, D: a <= cut_f, one_minus_w)] + annuli
    if mode == "coarse":
        d_lo = z["d_lo"]
        return [(0, r1, lambda a, D: (a <= cut) & (a > d_lo),
                 lambda D: _smoothstep_d2(D, D1, D2) * (1.0 - _smoothstep_d2(D, R1, R2)))]
    raise ValueError(f"no windowed line-sum mode {mode!r}")


def sigma_mode_plain(mode: str, blocks64, windows, lines, co, z, d_near=None, T=None):
    """The plain version of K1's windowed ``mode``: [n_states, n_blocks * B]
    on the float64 block grid ``blocks64`` and its ``windows``, in the
    dtype and on the device of the coefficients ``co``; with the states'
    temperatures ``T`` [n_states], the phco2 family's."""
    nb, nb_lo = grid_blocks(blocks64, co[0].dtype, co[0].device)
    batch = tuple(co[0].shape[:-1])
    Tt = None if T is None else tile_T(T, batch)
    return block_sum(nb, nb_lo, lines, windows, mode_zones(mode, z, co, d_near, Tt), batch)


def stencil_correction_plain(geom: StencilGeom, co, cut: float, n_nu: int, weight=None,
                             T=None):
    """The near-core correction [n_states, n_nu] (``_stencil_apply``):
    Sia (w4 - region 1) on each line's 2K window, where x^2 <= 225 and
    |dnu_hi| <= cut, times 1 - W(dnu^2) with ``weight`` = (D1, D2), placed by
    ``index_add_`` on a buffer of R K points. Region 1 is in the explicit
    (x, y) algebra of the TPU code. With the states' temperatures ``T``
    [n_states] (the phco2 family), y = y0 chi(dnu_hi + dnu_lo, T)."""
    Sia, ia, y0 = co[:3]
    dev, dt = ia.device, ia.dtype
    n_states, L = ia.shape
    K = geom.K
    hi = torch.as_tensor(geom.dnu_hi, device=dev).to(dt)            # [2K, L]
    lo = torch.as_tensor(geom.dnu_lo, device=dev).to(dt)
    w = 1.0
    if weight is not None:
        dD = hi + lo
        w = 1.0 - _smoothstep_d2(dD * dD, *weight)
    in_cut = torch.abs(hi) <= cut
    q = torch.as_tensor(geom.q, device=dev)
    index = (q[:, None] * K + torch.arange(2 * K, device=dev)[None, :]).reshape(-1)
    buf = torch.zeros((n_states, geom.R * K), dtype=dt, device=dev)
    step = max(1, (2**24 if dev.type == "cuda" else 2**20) // max(1, 2 * K * L))
    for a in range(0, n_states, step):
        b = min(a + step, n_states)
        x = ia[a:b, None, :] * hi + ia[a:b, None, :] * lo           # [st, 2K, L]
        if T is None:
            y = y0[a:b, None, :].expand_as(x)
        else:
            y = y0[a:b, None, :] * chi_phco2((hi + lo)[None], T[a:b, None, None])
        corr = Sia[a:b, None, :] * (wofz_re(x, y) - region1_xy(x, y)) * w
        corr = torch.where((x * x <= 225.0) & in_cut, corr, torch.zeros((), dtype=dt, device=dev))
        buf[a:b].index_add_(1, index, corr.transpose(1, 2).reshape(b - a, -1))
    return buf[:, :n_nu]


def far_from_coarse(far_c, geom: CoarseGeom):
    """The far field on the fine grid [n_states, n_nu] from its values on the
    coarse grid [n_states, n_cc]: Catmull-Rom in sqrt space, clamped at 0.

    A uniform grid (c_ratio >= 2) takes JAX's strided form: fine point
    m c + r interpolates coarse points m + 1 .. m + 4 at t = r / c. Any other
    grid gathers at the host-computed base indices j and offsets u - j.
    Both are plain PyTorch around the kernels, as the JAX package leaves
    them to XLA.
    """
    dev, dt = far_c.device, far_c.dtype
    key = (dev, dt)
    w = geom._on_device.get(key)
    if w is None:
        w = geom._on_device[key] = torch.as_tensor(geom.interp_w, dtype=dt, device=dev)
    G = torch.sqrt(torch.clamp(far_c, min=0.0))
    n_states, n_nu = far_c.shape[0], geom.n_nu
    if geom.interp_j is None:
        c = w.shape[1]
        n_m = -(-n_nu // c)
        acc = torch.zeros((n_states, n_m, c), dtype=dt, device=dev)
        for k in range(4):
            acc = acc + G[:, 1 + k: 1 + k + n_m, None] * w[k][None, None, :]
        far = acc.reshape(n_states, n_m * c)[:, :n_nu]
    else:
        j = torch.as_tensor(geom.interp_j, device=dev)
        far = torch.zeros((n_states, n_nu), dtype=dt, device=dev)
        for k in range(4):
            far = far + w[k] * G[:, j + (k - 1)]
    return torch.square(torch.clamp(far, min=0.0))


def split_check(shape: str) -> None:
    """Raise unless ``shape`` is of the Voigt family, which the stencil and
    coarse routes take."""
    if shape not in SPLIT_SHAPES:
        raise ValueError(f"the stencil and coarse routes take {SPLIT_SHAPES}, not {shape!r}")


def coefficients(lines, T, P, Pp, conc=None, shape: str = "voigt"):
    """(alpha, co) of a Voigt-family line sum at flat states: the Doppler
    widths the profile uses (:func:`.linesum.effective_alpha`) and their
    :func:`voigt_coefficients`."""
    S, alpha, gamma = _line_params(lines, T, P, Pp, conc)
    alpha = effective_alpha(shape, alpha)
    return alpha, voigt_coefficients(S, alpha, gamma)


def chi_T(shape: str, T):
    """The states' temperatures where ``shape`` has chi (the phco2 family),
    else None: the ``T`` argument of the plain modes."""
    return T if shape in PHCO2_FAMILY else None


def sigma_stencil_plain(plan: LineWindowPlan, lines, T, P, Pp, conc=None,
                        shape: str = "voigt"):
    """The stencil route in plain PyTorch, flat states [n_states]: FARALL
    over the plan's windows plus the near-core correction."""
    split_check(shape)
    geom = stencil_geometry(plan, lines)
    if geom is None:
        raise ValueError("the stencil geometry rejects this grid and catalog")
    _, co = coefficients(lines, T, P, Pp, conc, shape)
    Tc = chi_T(shape, T)
    out = sigma_mode_plain("farall", plan.nu_blocks, plan.windows(), lines, co,
                           {"cut": plan.cut}, T=Tc)[:, : plan.n_nu]
    return out + stencil_correction_plain(geom, co, plan.cut, plan.n_nu, T=Tc)


def sigma_nosplit_plain(plan: LineWindowPlan, lines, T, P, Pp, conc=None,
                        shape: str = "voigt"):
    """K1's no-split sweep in plain PyTorch, flat states [n_states]: Sia Re
    w(dnu ia, y) at every in-cut pair of the plan's windows, on the
    coefficients the kernel packs (y = y0, or y0 chi(dnu, T) for the phco2
    family)."""
    split_check(shape)
    _, co = coefficients(lines, T, P, Pp, conc, shape)
    return sigma_mode_plain("nosplit", plan.nu_blocks, plan.windows(), lines, co,
                            {"cut": plan.cut}, T=chi_T(shape, T))[:, : plan.n_nu]


def sigma_coarse_plain(plan: LineWindowPlan, lines, T, P, Pp, params=None, conc=None,
                       shape: str = "voigt"):
    """The coarse-far route in plain PyTorch, flat states [n_states]
    (``_coarse_core``); ``params`` default to the explicit strategy's."""
    params = params or coarse_params(plan, EXPLICIT_COARSE_FRAC)
    if params is None:
        raise ValueError("the coarse-far split rejects this grid")
    return coarse_route_plain(coarse_geometry(plan, lines, params), lines, T, P, Pp, conc,
                              shape)


def coarse_route_plain(geom: CoarseGeom, lines, T, P, Pp, conc=None, shape: str = "voigt"):
    """:func:`sigma_coarse_plain` on a given geometry: FINE_STENCIL and the
    weighted correction where ``geom.stencil`` is set, else FINE."""
    split_check(shape)
    alpha, co = coefficients(lines, T, P, Pp, conc, shape)
    Tc = chi_T(shape, T)
    z, n_nu = geom.zones, geom.n_nu
    if geom.stencil is not None:
        fine = sigma_mode_plain("fine_stencil", geom.fine_blocks, geom.fine_windows, lines,
                                co, z, T=Tc)[:, :n_nu]
        fine = fine + stencil_correction_plain(geom.stencil, co, z["cut"], n_nu,
                                               weight=(z["D1"], z["D2"]), T=Tc)
    else:
        d_near = torch.clamp(15.0 * alpha.max(), max=z["cut_f"])
        fine = sigma_mode_plain("fine", geom.fine_blocks, geom.fine_windows, lines, co, z,
                                d_near, T=Tc)[:, :n_nu]
    far_c = sigma_mode_plain("coarse", geom.coarse_blocks, geom.coarse_windows, lines, co,
                             z, T=Tc)[:, : geom.params[2]]
    return fine + far_from_coarse(far_c, geom)


def strided_interp(c_ratio: int, n_nu: int):
    """The interpolation of a uniform grid's far field for
    :func:`far_from_coarse` (its strided form: fine point m c + r from
    coarse points m + 1 .. m + 4 at t = r / c)."""
    return types.SimpleNamespace(n_nu=int(n_nu), interp_j=None, _on_device={},
                                 interp_w=_cr_weights(np.arange(c_ratio, dtype=np.float64)
                                                      / c_ratio))


def masked_alpha_max(alpha, nu, dims=None):
    """The largest Doppler width over real lines: padding lines (positions
    at 1e30 cm^-1) are kept out, or their alpha ~ nu would set d_near to its
    limit and turn the whole window into core sweeps. ``alpha`` [..., L]
    against positions ``nu`` [L]; over all of it, or ``dims``."""
    a = torch.where(nu < 1e29, alpha, torch.zeros((), dtype=alpha.dtype, device=alpha.device))
    return a.amax() if dims is None else a.amax(dim=dims)


def sigma_coarse_device_plain(dplan, lines, T, P, Pp, conc=None, shape: str = "voigt"):
    """The coarse-far route over one shard's device plan in plain PyTorch,
    flat states [n_states] (``_coarse_core`` on the shard's prebuilt grids):
    FINE on the shard's fine grid with d_near = min(15 max alpha, 2 d_far)
    over its real lines, COARSE on its coarse grid, the far field
    interpolated back (strided: the sharded path takes the split only on
    uniform lattices)."""
    split_check(shape)
    d_far, h, n_cc, c_ratio = dplan.coarse_meta
    alpha, co = coefficients(lines, T, P, Pp, conc, shape)
    Tc = chi_T(shape, T)
    z = split_zones(dplan.cut, d_far, h)
    d_near = torch.clamp(15.0 * masked_alpha_max(alpha, lines.nu), max=z["cut_f"])
    grid64 = lambda hi, lo: hi.double().cpu().numpy() + lo.double().cpu().numpy()
    fine = sigma_mode_plain("fine", grid64(dplan.fine_blocks, dplan.fine_blocks_lo),
                            dplan.fine_windows.cpu().numpy().astype(np.int64), lines, co, z,
                            d_near, T=Tc)[:, : dplan.n_nu]
    far_c = sigma_mode_plain("coarse", grid64(dplan.coarse_blocks, dplan.coarse_blocks_lo),
                             dplan.coarse_windows.cpu().numpy().astype(np.int64), lines, co, z,
                             T=Tc)[:, :n_cc]
    return fine + far_from_coarse(far_c, strided_interp(c_ratio, dplan.n_nu))


# --- the large-catalog and baseline layouts (K1-seg, K4, K5) ----------------

def _slice_lines(lines, a: int, b: int):
    """Lines a..b of a catalog (views; the TIPS table is shared)."""
    return dataclasses.replace(lines, **{f: getattr(lines, f)[a:b] for f in PER_LINE_FIELDS})


@dataclasses.dataclass(frozen=True, eq=False)
class Segment:
    """Lines [a, b) of the catalog and the blocks [blo, bhi) whose windows
    meet them: ``windows`` [bhi - blo, 2] are those blocks' windows clipped
    to the segment, relative to its first line; ``n_out`` the grid points
    of the block range that lie on the grid."""

    a: int
    b: int
    blo: int
    bhi: int
    n_out: int
    windows: np.ndarray


def segments(plan: LineWindowPlan, n_lines: int, L_seg: int) -> list:
    """The catalog's segments of ``L_seg`` lines that meet a window
    (``_pallas_sigma_segmented``), cached on the plan. Each (block, line)
    pair of a window falls in exactly one segment."""
    key = ("segments", int(n_lines), int(L_seg))
    got = plan._geometry.get(key)
    if got is not None:
        return got
    start = np.asarray(plan.start, np.int64)
    end = start + np.asarray(plan.count, np.int64)
    B = plan.block
    out = []
    for a in range(0, n_lines, L_seg):
        b = min(n_lines, a + L_seg)
        s_c = np.clip(start, a, b)
        c_s = np.clip(end, a, b) - s_c
        nz = np.nonzero(c_s > 0)[0]
        if nz.size == 0:
            continue
        blo, bhi = int(nz[0]), int(nz[-1]) + 1
        out.append(Segment(a=a, b=b, blo=blo, bhi=bhi,
                           n_out=min((bhi - blo) * B, plan.n_nu - blo * B),
                           windows=np.stack([(s_c - a)[blo:bhi], c_s[blo:bhi]], axis=1)))
    plan._geometry[key] = out
    return out


def _exact_zone(shape, S, alpha, gamma, cut, T):
    batch = tuple(S.shape[:-1])
    return [(0, tile_exact(shape, S, alpha, gamma, tile_T(T, batch)),
             lambda adnu, D: adnu <= cut, None)]


def sigma_segmented_plain(plan: LineWindowPlan, lines, T, P, Pp, L_seg: int,
                          shape: str = "voigt", conc=None):
    """K1-seg's plain version, flat states [n_states]: the exact profile
    summed segment by segment over each segment's block range, added into
    one sigma [n_states, n_nu]."""
    S, alpha, gamma = _line_params(lines, T, P, Pp, conc)
    nb, nb_lo = grid_blocks(plan.nu_blocks, S.dtype, S.device)
    out = torch.zeros(S.shape[:-1] + (plan.n_nu,), dtype=S.dtype, device=S.device)
    B = plan.block
    for seg in segments(plan, lines.n_lines, L_seg):
        part = lambda x: x[..., seg.a:seg.b]
        sig = block_sum(nb[seg.blo:seg.bhi], None if nb_lo is None else nb_lo[seg.blo:seg.bhi],
                        _slice_lines(lines, seg.a, seg.b), seg.windows,
                        _exact_zone(shape, part(S), part(alpha), part(gamma), plan.cut, T),
                        tuple(S.shape[:-1]))
        out[..., seg.blo * B: seg.blo * B + seg.n_out] += sig[..., :seg.n_out]
    return out


def lane_layout(plan: LineWindowPlan, lines, S, alpha, gamma):
    """K4's operands (the lane branch of ``_pallas_sigma_impl``): positions
    ``nu``/``nu_lo`` [n_lines_pad] and the per-state rows ``S``, ``alpha``,
    ``gamma`` [n_states, n_lines_pad], padded past the catalog with lines at
    1e30 cm^-1 of zero strength (n_lines_pad = the catalog plus a slab and a
    chunk, rounded to 128); ``windows`` [n_blocks, 2] each block's window
    with its start aligned down to a CHUNK multiple, and a block without
    lines at count 0."""
    n_lines = lines.n_lines
    slab_pad = -(-max(1, plan.slab) // CHUNK) * CHUNK
    pad = -(-(n_lines + slab_pad + CHUNK) // 128) * 128 - n_lines
    rows = lambda x, v: torch.cat([x, x.new_full(x.shape[:-1] + (pad,), v)], dim=-1)
    start = np.asarray(plan.start, np.int64)
    count = np.asarray(plan.count, np.int64)
    start_al = (start // CHUNK) * CHUNK
    cnt_al = np.where(count == 0, 0, start - start_al + count)
    return types.SimpleNamespace(
        nu=rows(lines.nu, 1e30), nu_lo=rows(lines.nu_lo, 0.0), S=rows(S, 0.0),
        alpha=rows(alpha, 1.0), gamma=rows(gamma, 1.0),
        windows=np.stack([start_al, cnt_al], axis=1))


def sigma_lane_plain(plan: LineWindowPlan, lines, T, P, Pp, shape: str = "voigt", conc=None):
    """K4's plain version, flat states [n_states]: the exact profile over
    each block's aligned window of the lane layout (:func:`lane_layout`)."""
    S, alpha, gamma = _line_params(lines, T, P, Pp, conc)
    lay = lane_layout(plan, lines, S, alpha, gamma)
    nb, nb_lo = grid_blocks(plan.nu_blocks, S.dtype, S.device)
    return block_sum(nb, nb_lo, lay, lay.windows,
                     _exact_zone(shape, lay.S, lay.alpha, lay.gamma, plan.cut, T),
                     tuple(S.shape[:-1]))[..., : plan.n_nu]


def gathered_slabs(plan: LineWindowPlan, lines, S, alpha, gamma):
    """K5's operands (the gathered branch of ``_pallas_sigma_impl``): each
    block's slab of ``slab_pad`` lines from its window start, gathered by
    plain indexing, flattened to ``nu``/``nu_lo`` [n_blocks * slab_pad] and
    ``S``, ``alpha``, ``gamma`` [n_states, n_blocks * slab_pad]; ``windows``
    [n_blocks, 2] = (b * slab_pad, count)."""
    n_lines = lines.n_lines
    slab_pad = -(-max(1, plan.slab) // CHUNK) * CHUNK
    dev = lines.device
    start = torch.as_tensor(np.asarray(plan.start, np.int64), device=dev)
    idx = torch.clamp(start[:, None] + torch.arange(slab_pad, device=dev), 0,
                      max(n_lines - 1, 0)).reshape(-1)
    n_blocks = plan.n_blocks
    return types.SimpleNamespace(
        nu=lines.nu[idx], nu_lo=lines.nu_lo[idx], S=S[..., idx], alpha=alpha[..., idx],
        gamma=gamma[..., idx], slab_pad=slab_pad,
        windows=np.stack([np.arange(n_blocks, dtype=np.int64) * slab_pad,
                          np.asarray(plan.count, np.int64)], axis=1))


def sigma_gathered_plain(plan: LineWindowPlan, lines, T, P, Pp, shape: str = "voigt",
                         conc=None):
    """K5's plain version, flat states [n_states]: the exact profile over
    each block's gathered slab (:func:`gathered_slabs`)."""
    S, alpha, gamma = _line_params(lines, T, P, Pp, conc)
    g = gathered_slabs(plan, lines, S, alpha, gamma)
    nb, nb_lo = grid_blocks(plan.nu_blocks, S.dtype, S.device)
    return block_sum(nb, nb_lo, g, g.windows,
                     _exact_zone(shape, g.S, g.alpha, g.gamma, plan.cut, T),
                     tuple(S.shape[:-1]))[..., : plan.n_nu]

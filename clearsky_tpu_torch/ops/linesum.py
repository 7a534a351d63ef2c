"""Block-banded line sum: line profiles accumulated onto a wavenumber grid.

Counterpart of ``clearsky_tpu.ops.linesum``. Lines are sorted by wavenumber,
so the lines within ``cut`` of a contiguous block of the grid form a
contiguous index window; :func:`build_line_window_plan` finds the windows once
on the host (numpy, float64), and the line sum then runs dense over
[block x window] tiles.

:func:`sigma_from_lines` is the plain PyTorch version: the CPU path and the
oracle of the CUDA kernel. It is one case of :func:`block_sum`, the plain
sum over line windows that every mode of the kernel has as its plain
version (the modes of the stencil-near and coarse-far routes are in
:mod:`.linesum_strategies`). :func:`sigma_from_lines_auto` takes the exact
plain sum for CPU tensors and, for CUDA tensors, the route that
:func:`.linesum_strategies.route` picks, through the kernel wrappers in
:mod:`.linesum_cuda`.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .faddeeva import wofz_re
from .lineshape import (
    scale_intensity,
    cheb_qref_q,
    alpha_doppler,
    gamma_lorentz,
    fdoppler,
    florentz,
    fvoigt,
    chi_phco2,
)

__all__ = [
    "LineWindowPlan",
    "build_line_window_plan",
    "sigma_from_lines",
    "sigma_from_lines_auto",
    "block_sum",
    "voigt_coefficients",
    "PROFILES",
    "DEFAULT_CUT",
    "VOIGT_FAMILY",
    "PHCO2_FAMILY",
    "SPLIT_SHAPES",
]

_SQRT_LN2 = 0.8325546111576977  # sqrt(ln 2)

# unified profile signature f(dnu, S, alpha, gamma, T) -> cross-section. The
# *_ref shapes are the reference's HWHM-convention Voigt formula, which is
# the internal one with alpha -> alpha / sqrt(ln 2); phco2 scales gamma by
# the sub-Lorentzian chi(dnu, T) of the CO2 far wing
PROFILES = {
    "voigt": lambda dnu, S, a, g, T: S * fvoigt(dnu, a, g),
    "lorentz": lambda dnu, S, a, g, T: S * florentz(dnu, g),
    "doppler": lambda dnu, S, a, g, T: S * fdoppler(dnu, a),
    "phco2": lambda dnu, S, a, g, T: S * fvoigt(dnu, a, chi_phco2(dnu, T) * g),
    "voigt_ref": lambda dnu, S, a, g, T: S * fvoigt(dnu, a / _SQRT_LN2, g),
    "phco2_ref": lambda dnu, S, a, g, T: S * fvoigt(dnu, a / _SQRT_LN2, chi_phco2(dnu, T) * g),
}

DEFAULT_CUT = {"voigt": 25.0, "lorentz": 25.0, "doppler": 25.0, "phco2": 500.0,
               "voigt_ref": 25.0, "phco2_ref": 500.0}

# the Voigt-family shapes, which every route of the line sum takes: the
# voigt far wing is Humlicek region 1 on per-line coefficients, phco2's
# depends on dnu through chi
VOIGT_FAMILY = ("voigt", "voigt_ref")
PHCO2_FAMILY = ("phco2", "phco2_ref")
SPLIT_SHAPES = VOIGT_FAMILY + PHCO2_FAMILY


def effective_alpha(shape: str, alpha):
    """The Doppler width the profile of ``shape`` uses: alpha / sqrt(ln 2)
    for the *_ref shapes (folded into the coefficients, as the JAX package
    folds it into its pack), alpha otherwise."""
    return alpha * (1.0 / _SQRT_LN2) if shape.endswith("_ref") else alpha


@dataclasses.dataclass(frozen=True, eq=False)
class LineWindowPlan:
    """Static banding plan mapping wavenumber blocks to line-index windows."""

    nu: np.ndarray          # [n_nu] sorted wavenumber grid (float64)
    cut: float              # profile truncation distance [cm^-1]
    block: int              # wavenumber block size
    n_blocks: int
    nu_blocks: np.ndarray   # [n_blocks, block] padded grid (float64)
    start: np.ndarray       # [n_blocks] first line index per block
    count: np.ndarray       # [n_blocks] number of in-window lines per block
    slab: int               # padded window length (max over blocks)
    _on_device: dict = dataclasses.field(default_factory=dict, repr=False)
    # host geometry of the routes (stencil windows, coarse grids), built once
    # per catalog by .linesum_strategies
    _geometry: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n_nu(self) -> int:
        return len(self.nu)

    def device_arrays(self, device) -> dict:
        """The plan's per-block arrays as tensors on ``device``, cached.

        ``nu_hi``/``nu_lo`` are the float32 two-float split of the float64
        block grid (nu_hi + nu_lo reproduces it to ~1e-11 relative), flat
        [n_blocks * block]; ``win`` is the int32 window table [n_blocks, 2]
        of (start, count).
        """
        device = torch.device(device)
        got = self._on_device.get(device)
        if got is None:
            hi, lo = two_float(self.nu_blocks)
            got = {
                "nu_hi": torch.as_tensor(hi.reshape(-1), device=device),
                "nu_lo": torch.as_tensor(lo.reshape(-1), device=device),
                "win": torch.as_tensor(self.windows(), dtype=torch.int32, device=device),
            }
            self._on_device[device] = got
        return got

    def windows(self) -> np.ndarray:
        """The line windows as a table [n_blocks, 2] of (start, count)."""
        return np.stack([self.start, self.count], axis=1).astype(np.int64)


def two_float(x64) -> tuple[np.ndarray, np.ndarray]:
    """float64 values as float32 (hi, lo) with hi + lo ~ x64 to ~1e-11 relative."""
    x64 = np.asarray(x64, np.float64)
    hi = x64.astype(np.float32)
    return hi, (x64 - hi.astype(np.float64)).astype(np.float32)


def build_line_window_plan(
    nu_grid: np.ndarray,
    nu_lines: np.ndarray,
    cut: float,
    block: int = 128,
) -> LineWindowPlan:
    """Construct the static block -> line-window banding (host-side, set-up time)."""
    nu_grid = np.asarray(nu_grid, dtype=np.float64)
    nu_lines = np.asarray(nu_lines, dtype=np.float64)
    if np.any(np.diff(nu_grid) <= 0):
        raise ValueError("wavenumber grid must be strictly ascending")
    if len(nu_lines) > 1 and np.any(np.diff(nu_lines) < 0):
        raise ValueError("line wavenumbers must be sorted ascending")
    n = len(nu_grid)
    block = int(min(block, max(8, n)))
    n_blocks = -(-n // block)
    npad = n_blocks * block
    # pad with the last grid value; padded outputs are sliced away
    pad = np.full(npad - n, nu_grid[-1])
    nu_blocks = np.concatenate([nu_grid, pad]).reshape(n_blocks, block)
    lo = np.searchsorted(nu_lines, nu_blocks[:, 0] - cut, side="left")
    hi = np.searchsorted(nu_lines, nu_blocks[:, -1] + cut, side="right")
    count = (hi - lo).astype(np.int32)
    slab = int(max(1, count.max() if len(count) else 1))
    slab = -(-slab // 128) * 128 if slab > 128 else slab
    return LineWindowPlan(
        nu=nu_grid,
        cut=float(cut),
        block=block,
        n_blocks=n_blocks,
        nu_blocks=nu_blocks,
        start=lo.astype(np.int32),
        count=count,
        slab=slab,
    )


def _line_params(lines, T, P, Pp, conc=None):
    """Per-line (S, alpha, gamma), each [..., n_lines], at states T, P, Pp [...].

    ``conc`` gives per-line molar concentrations, [n_lines] (fixed, a merged
    catalog of several molecules) or [..., n_lines] (per state): each line's
    partial pressure is then conc P (``Pp`` is not read) and its intensity
    is scaled by conc, so one pass sums a whole gas mixture.
    """
    T = T[..., None]
    P = P[..., None]
    Pp = conc * P if conc is not None else Pp[..., None]
    qq = cheb_qref_q(T, lines.tips_coeffs[lines.iso_ptr])
    S = scale_intensity(lines.S, lines.nu, lines.Epp, qq, T)
    if conc is not None:
        S = S * conc
    alpha = alpha_doppler(lines.nu, lines.mu, T)
    gamma = gamma_lorentz(lines.ga, lines.gs, lines.na, T, P, Pp)
    return S, alpha, gamma


def voigt_coefficients(S, alpha, gamma):
    """Per-(state, line) coefficients of the Voigt tiles, as ``_grouped_pack``
    computes them: the core's (Sia, ia, y0) = (S ia / sqrt(pi), 1/alpha,
    gamma/alpha), with which the profile is Sia Re w(dnu ia, y0), and the far
    wing's (A, c1, c2, k2) = (ia^2, 0.5 + y0^2, 4 y0^2 A, S gamma A / pi),
    with which Humlicek region 1 in D = dnu^2 is
    k2 (c1 + m) / ((c1 - m)^2 + c2 D), m = D A."""
    ia = 1.0 / alpha
    y0 = gamma * ia
    A = ia * ia
    y2 = y0 * y0
    return (S * ia * (1.0 / math.sqrt(math.pi)), ia, y0, A, 0.5 + y2, 4.0 * y2 * A,
            S * gamma * A * (1.0 / math.pi))


def tile_T(T, batch):
    """Per-state temperatures T (broadcast to ``batch``) shaped to meet a
    tile of :func:`block_sum`, [*batch, 1, 1, 1]."""
    return torch.broadcast_to(T, batch).reshape(tuple(batch) + (1, 1, 1))


def tile_exact(shape, S, alpha, gamma, T=None):
    """The exact profile of ``shape`` on (S, alpha, gamma), as a tile of
    :func:`block_sum`; ``T`` from :func:`tile_T` (read by phco2's chi)."""
    profile = PROFILES[shape]
    return lambda dnu, D, g: profile(dnu, g(S), g(alpha), g(gamma), T)


def tile_w4(co, T=None):
    """The Voigt core on :func:`voigt_coefficients`: Sia Re w(dnu ia, y), y =
    y0, or y0 chi(dnu, T) for the phco2 family (``T`` from :func:`tile_T`)."""
    Sia, ia, y0 = co[:3]
    if T is None:
        return lambda dnu, D, g: g(Sia) * wofz_re(dnu * g(ia), g(y0))
    return lambda dnu, D, g: g(Sia) * wofz_re(dnu * g(ia), g(y0) * chi_phco2(dnu, T))


def region1_xy(x, y):
    """Re of Humlicek's region 1, 0.5641896 t / (0.5 + t^2) at t = y - ix,
    in the explicit (x, y) algebra of the TPU kernels."""
    t2r = y * y - x * x
    t2i = -2.0 * x * y
    br = 0.5 + t2r
    d2 = br * br + t2i * t2i
    return 0.5641896 * (y * br - x * t2i) / d2


def tile_region1(co, T=None):
    """Humlicek region 1 (valid where |x| >= 15, or as the far term the
    stencil correction completes). Voigt family: in D = dnu^2 on
    :func:`voigt_coefficients`; phco2 family (``T`` given): Sia times the
    explicit form at (dnu ia, y0 chi(dnu, T))."""
    if T is not None:
        Sia, ia, y0 = co[:3]
        return lambda dnu, D, g: g(Sia) * region1_xy(dnu * g(ia),
                                                     g(y0) * chi_phco2(dnu, T))
    A, c1, c2, k2 = co[3:]

    def tile(dnu, D, g):
        m = D * g(A)
        br = g(c1) - m
        return (g(k2) * (g(c1) + m)) / (br * br + g(c2) * D)

    return tile


def block_sum(nu_blocks, nu_blocks_lo, lines, windows, zones, batch):
    """Plain sum over line windows: sigma[*batch, n_blocks * block].

    ``nu_blocks`` [n_blocks, block] is the grid in the catalog's dtype on its
    device; ``nu_blocks_lo`` its float32 residual for a float32 catalog (two-
    float dnu, as in the kernel), or None in float64, where one subtraction
    suffices. ``windows`` [n_blocks, 2 n_win] (numpy) holds each block's line
    windows as (start, count) pairs. Each zone ``(w, tile, mask, weight)``
    adds, over window ``w``, ``tile(dnu, D, g)`` where ``mask(adnu, D)`` holds,
    times ``weight(D)`` unless that is None; D = dnu^2, and ``g`` gathers a
    per-(state, line) tensor [*batch, n_lines] onto the tile. Zones are summed
    in turn, as the kernel's sweeps are. Blocks go in batches that keep each
    temporary near 2^24 elements on a GPU and 2^20 on the CPU, where larger
    temporaries fall out of cache.
    """
    dev, dt = nu_blocks.device, nu_blocks.dtype
    n_blocks, block = nu_blocks.shape
    n_lines = lines.nu.shape[0]
    zero = torch.zeros((), dtype=dt, device=dev)
    out = torch.zeros(batch + (n_blocks, block), dtype=dt, device=dev)
    for w, tile, mask, weight in zones:
        starts = torch.as_tensor(windows[:, 2 * w], dtype=torch.int64, device=dev)
        counts = torch.as_tensor(windows[:, 2 * w + 1], dtype=torch.int64, device=dev)
        slab = max(1, int(windows[:, 2 * w + 1].max(initial=0)))
        offs = torch.arange(slab, device=dev)
        per_block = max(1, int(np.prod(batch))) * block * slab
        step = max(1, (2**24 if dev.type == "cuda" else 2**20) // per_block)
        for a in range(0, n_blocks, step):
            b = min(a + step, n_blocks)
            idx = torch.clamp(starts[a:b, None] + offs, 0, max(n_lines - 1, 0))  # [nb, slab]
            valid = offs < counts[a:b, None]
            dnu = nu_blocks[a:b, :, None] - lines.nu[idx][:, None, :]             # [nb, B, slab]
            if nu_blocks_lo is not None:
                # the hi difference is exact for nearby values (Sterbenz); the
                # residuals restore the sub-f32 position information
                dnu = dnu + (nu_blocks_lo[a:b, :, None] - lines.nu_lo[idx][:, None, :])
            D = dnu * dnu
            m = valid[:, None, :] & mask(torch.abs(dnu), D)
            g = lambda x: x[..., idx][..., None, :]                     # [..., nb, 1, slab]
            f = tile(dnu, D, g)                                         # [..., nb, B, slab]
            if weight is not None:
                f = f * weight(D)
            out[..., a:b, :] += torch.where(m, f, zero).sum(-1)
    return out.reshape(batch + (n_blocks * block,))


def grid_blocks(nu_blocks64, dtype, device):
    """A float64 block grid for :func:`block_sum`: (hi, lo) tensors in float32,
    (grid, None) in float64."""
    if dtype == torch.float32:
        hi, lo = two_float(nu_blocks64)
        return torch.as_tensor(hi, device=device), torch.as_tensor(lo, device=device)
    return torch.as_tensor(np.asarray(nu_blocks64, np.float64), dtype=dtype, device=device), None


def sigma_from_lines(plan: LineWindowPlan, lines, T, P, Pp, shape: str = "voigt",
                     conc=None):
    """Cross-sections sigma[..., n_nu] [cm^2/molecule]: the plain version.

    ``T``, ``P``, ``Pp`` (temperature [K], pressure and partial pressure
    [Pa]) are tensors of one batch shape [...], in the catalog's dtype and on
    its device; ``conc`` optional per-line concentrations
    (:func:`_line_params`). The exact profile of ``shape`` over each block's
    window within ``plan.cut`` (:func:`block_sum`; two-float dnu in float32).
    """
    # one batch shape for all three: T sets S and alpha, P and Pp set gamma
    S, alpha, gamma = torch.broadcast_tensors(*_line_params(lines, T, P, Pp, conc))
    nb, nb_lo = grid_blocks(plan.nu_blocks, S.dtype, S.device)
    cut = plan.cut
    batch = tuple(S.shape[:-1])
    zones = [(0, tile_exact(shape, S, alpha, gamma, tile_T(T, batch)),
              lambda adnu, D: adnu <= cut, None)]
    sig = block_sum(nb, nb_lo, lines, plan.windows(), zones, batch)
    return sig[..., : plan.n_nu]


def _flatten_states(T, P, Pp, conc, n_lines):
    """Broadcast (T, P, Pp[, conc]) to a flat state batch: (batch shape, T,
    P, Pp [n], conc [n_lines] or [n, n_lines] or None). ``Pp`` None (the
    concentration callers) reads as P."""
    Pp = P if Pp is None else Pp
    shp = torch.broadcast_shapes(T.shape, P.shape, Pp.shape)
    if conc is not None and conc.dim() > 1:     # per-state concentrations
        shp = torch.broadcast_shapes(shp, conc.shape[:-1])
        conc = torch.broadcast_to(conc, shp + (n_lines,)).reshape(-1, n_lines).contiguous()
    flat = [torch.broadcast_to(x, shp).reshape(-1).contiguous() for x in (T, P, Pp)]
    return (shp, *flat, conc)


def sigma_from_lines_auto(plan: LineWindowPlan, lines, T, P, Pp, shape: str = "voigt",
                          conc=None, strategy: str = "auto"):
    """Line sum through the kernel wrappers (CUDA) or the exact plain sum (CPU).

    ``strategy`` (:data:`.linesum_strategies.STRATEGIES`) picks the route on
    the card as the JAX package does on its accelerator
    (:func:`.linesum_strategies.route`, at the card's own budget): the
    coarse-far split, the stencil-near route, K1's split mode over the whole
    catalog or over catalog segments, or the lane-major and gathered
    kernels. CPU tensors always take the exact plain sum, whatever the
    strategy, as the JAX package does off its accelerator. ``conc``: per-line
    concentrations (:func:`_line_params`; ``Pp`` may then be None). Accepts
    any common batch shape of (T, P, Pp[, conc]); the wrappers take a flat
    state batch, so leading dimensions are flattened and restored around
    them.
    """
    from .linesum_strategies import check_strategy

    check_strategy(strategy)
    if T.device.type == "cpu":
        return sigma_from_lines(plan, lines, T, P, P if Pp is None else Pp, shape, conc)
    from .linesum_cuda import sigma_routed

    shp, Tf, Pf, Ppf, concf = _flatten_states(T, P, Pp, conc, lines.n_lines)
    sig = sigma_routed(plan, lines, Tf, Pf, Ppf, shape=shape, strategy=strategy, conc=concf)
    return sig.reshape(shp + (plan.n_nu,))

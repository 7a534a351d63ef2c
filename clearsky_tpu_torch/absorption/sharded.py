"""Spectrally sharded line-by-line opacity: per-shard line slabs with halos.

Counterpart of ``clearsky_tpu.absorption.sharded``. The wavenumber grid is
cut into contiguous shards; since a grid point only sees lines within
``cut`` of it, each shard's lines form a compact slab of the catalog, found
once on the host (``searchsorted``, with the halo widened to cut + 4h where
the coarse-far split engages). Every shard keeps its slab, padded with inert
lines to a common length, and its own banding plan (a
:class:`..ops.linesum.DeviceWindowPlan`), all stacked along a leading shard
axis, so the sharded evaluation needs no communication.

:class:`ShardedLineGas` holds the ``k_local`` shards of one rank (all of
them in a single process). On the card :meth:`ShardedLineGas.raw_sigma`
runs them in one launch of K1-dev a mode (``ops/linesum_cuda.sigma_device``);
on the CPU, the exact plain line sum shard by shard. Either way the shards'
cross-sections lie side by side: on one rank with every shard, the grid of
the unsharded ``DirectGas``/``MultiGas``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..ops.linesum import DeviceWindowPlan, build_line_window_plan, sigma_from_lines_auto_device
from ..ops.linesum_strategies import (
    _coarse_far_params,
    coarse_grid,
    fine_block,
    split_windows,
)
from ..spectra.lines import PER_LINE_FIELDS, SpectralLines
from .gas import AbstractGas, DirectGas, GasComponent, MultiGas, as_concentration

__all__ = ["ShardedLineGas", "shard_line_gas", "PAD_VALUES"]

_PAD = 128  # slab length alignment (the JAX package's kernel CHUNK)

# inert padding lines: far away (no window reaches them), zero strength,
# harmless broadening, a valid TIPS row (the JAX package's _PAD_VALUES)
PAD_VALUES = dict(nu=1e30, nu_lo=0.0, S=0.0, ga=0.0, gs=0.0, Epp=0.0, na=0.0, mu=1.0,
                  A=1.0, iso=1, iso_ptr=0)


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedLineGas(AbstractGas):
    """A line-by-line gas as per-shard line slabs and banding plans.

    ``lines`` hold the slabs (every per-line field [k_local, L_pad]),
    ``plans`` the stacked plans, ``nu`` the grid of the shards held
    ([k_local n_nu_local]). ``conc``/``mol_ptr`` [k_local, L_pad]: the
    per-line concentrations of a fused mixture (fixed, or the molecule of
    each line for state-dependent ones); None for one molecule, whose
    concentration is ``fC``. ``n_shards`` counts the shards of the whole
    grid; ``molecules`` keeps a mixture's components for CIA pairing.
    """

    lines: SpectralLines
    plans: DeviceWindowPlan
    nu: torch.Tensor
    conc: torch.Tensor | None = None
    mol_ptr: torch.Tensor | None = None
    shape: str = "voigt"
    fC: Callable = None
    fCs: tuple = ()
    name: str = ""
    formula: str = ""
    mu: float = float("nan")
    n_shards: int = 1
    strategy: str = "auto"
    molecules: tuple = ()

    @property
    def k_local(self) -> int:
        """Shards held here (n_shards in a single process)."""
        return self.plans.n_shards

    @property
    def n_local(self) -> int:
        """Grid points of one shard."""
        return self.plans.n_nu

    def _conc(self, T, P):
        """Per-line concentrations [k, L_pad] or [..., k, L_pad], or None."""
        if self.mol_ptr is not None:
            shp = torch.broadcast_shapes(T.shape, P.shape)
            cs = torch.stack([torch.broadcast_to(torch.as_tensor(f(T, P), dtype=T.dtype,
                                                                 device=T.device), shp)
                              for f in self.fCs], dim=-1)                # [..., n_mols]
            return cs[..., self.mol_ptr]
        return self.conc

    def raw_sigma(self, T, P):
        """Cross-sections [..., k_local n_nu_local]: the shards held, side by
        side (one launch of K1-dev a mode on the card)."""
        if self.conc is None and self.mol_ptr is None:
            C = torch.as_tensor(self.fC(T, P), dtype=T.dtype, device=T.device)
            Pp, conc = C * P, None
        else:
            Pp, conc = None, self._conc(T, P)
        return sigma_from_lines_auto_device(self.plans, self.lines, T, P, Pp, self.shape,
                                            conc=conc, strategy=self.strategy)

    def concentration(self, T, P):
        """1 where the concentrations are folded into the lines, else fC."""
        if self.conc is not None or self.mol_ptr is not None:
            return torch.ones(torch.broadcast_shapes(T.shape, P.shape), dtype=self.nu.dtype,
                              device=self.nu.device)
        return self.fC(T, P)

    def __call__(self, T, P):
        if self.conc is not None or self.mol_ptr is not None:
            return self.raw_sigma(T, P)      # already concentration-scaled
        return super().__call__(T, P)

    def reconcentrate(self, fC) -> "ShardedLineGas":
        if self.conc is not None or self.mol_ptr is not None:
            raise ValueError("cannot reconcentrate a fused multi-molecule sharded gas")
        return dataclasses.replace(self, fC=as_concentration(fC))

    def components(self) -> tuple:
        """The molecules for CIA pairing: a mixture's, or the gas itself."""
        if self.molecules:
            return self.molecules
        return (GasComponent(formula=self.formula, name=self.name, fC=self.fC),)

    def spectral_slab(self, lo: int, hi: int) -> "ShardedLineGas":
        """The gas on grid points [lo, hi) of the shards held: the shards
        that cover them, which the bounds must fall between."""
        n = self.n_local
        if lo % n or hi % n or not 0 <= lo < hi <= self.nu.shape[0]:
            raise ValueError(f"[{lo}, {hi}) does not fall on the {n}-point shard boundaries")
        sl = slice(lo // n, hi // n)
        pick = lambda x: None if x is None else x[sl]
        return dataclasses.replace(
            self, nu=self.nu[lo:hi], plans=self.plans.shard(sl),
            lines=dataclasses.replace(self.lines, **{f: getattr(self.lines, f)[sl]
                                                     for f in PER_LINE_FIELDS}),
            conc=pick(self.conc), mol_ptr=pick(self.mol_ptr))

    def pspecs(self) -> dict:
        """The fields split along the spectral axis and how: every stacked
        field by its leading shard axis, the grid by its only axis."""
        out = {f"lines.{f}": ("nu", None) for f in PER_LINE_FIELDS}
        for f in DeviceWindowPlan.TENSORS:
            x = getattr(self.plans, f)
            if x is not None:
                out[f"plans.{f}"] = ("nu",) + (None,) * (x.dim() - 1)
        for f in ("conc", "mol_ptr"):
            if getattr(self, f) is not None:
                out[f] = ("nu", None)
        out["nu"] = ("nu",)
        return out

    def __repr__(self):  # pragma: no cover - cosmetic
        return (f"ShardedLineGas({self.name} [{self.formula}], n_shards={self.n_shards}, "
                f"k_local={self.k_local}, n_nu={self.nu.shape[0]}, "
                f"slab_pad={self.lines.nu.shape[-1]})")


def coarse_split_params(nu, n_local: int, nu_l, cut: float, block: int):
    """The coarse-far split of a shard's grid geometry (shard 0's, which
    covers all shards): (meta, auto). ``meta`` = (d_far, h, n_cc, c_ratio)
    at the auto work fraction 0.2, else at the explicit 0.6, or None (or
    where c_ratio < 2: the sharded path interpolates only strided); ``auto``
    whether 0.2 accepted."""
    plan0 = build_line_window_plan(nu[:n_local], nu_l, cut, block=block)
    meta02 = _coarse_far_params(plan0, 0.2)
    meta = meta02 if meta02 is not None else _coarse_far_params(plan0)
    if meta is not None and meta[3] < 2:
        meta = None
    return meta, meta is not None and meta02 is not None


def split_grids(nu, n_shards: int, shape: str, block: int, meta):
    """Each shard's fine grid, re-blocked at :func:`fine_block`'s width,
    and coarse grid (origin 2h below its first point), float64
    [k, n_blocks_f, Bf] and [k, n_blocks_c, block]."""
    _, h, n_cc, _ = meta
    n_local = len(nu) // n_shards
    Bf = fine_block(shape, n_local, block)
    n_bf = -(-n_local // Bf)
    fb, cb = [], []
    for s in range(n_shards):
        nus = nu[s * n_local:(s + 1) * n_local]
        fb.append(np.concatenate([nus, np.full(n_bf * Bf - n_local, nus[-1])]).reshape(n_bf, Bf))
        cb.append(coarse_grid(nus[0], h, n_cc, block))
    return np.stack(fb), np.stack(cb)


def coarse_fields(pos_slabs, fine64, coarse64, cut: float, meta, auto: bool, device) -> dict:
    """The coarse split's fields of a stacked :class:`DeviceWindowPlan`: the
    two-float grids and each shard's windows into its slab (positions
    ``pos_slabs`` [k, L_pad], float64, padding at 1e30)."""
    d_far, h, _, _ = meta
    wins = [split_windows(pos, f, c, cut, d_far, h)
            for pos, f, c in zip(pos_slabs, fine64, coarse64)]

    def two(x64):
        hi = x64.astype(np.float32)
        return (torch.as_tensor(hi, device=device),
                torch.as_tensor((x64 - hi.astype(np.float64)).astype(np.float32), device=device))

    (fh, fl), (ch, cl) = two(fine64), two(coarse64)
    i32 = lambda i: torch.as_tensor(np.stack([w[i] for w in wins]), dtype=torch.int32,
                                    device=device)
    return dict(fine_blocks=fh, fine_blocks_lo=fl, coarse_blocks=ch, coarse_blocks_lo=cl,
                coarse_meta=tuple(meta), coarse_auto=bool(auto), fine_windows=i32(0),
                coarse_windows=i32(1))


def shard_line_gas(gas, n_shards: int, block: int | None = None) -> ShardedLineGas:
    """Split a DirectGas or MultiGas into ``n_shards`` contiguous spectral
    shards (host set-up, numpy float64).

    For each shard the line slab [nu_min - halo, nu_max + halo] is found by
    ``searchsorted`` on the float64 positions, halo = cut, or cut + 4h
    where the coarse-far split's geometry accepts (its coarse grid reaches
    2h past the shard's edges); a shard with no lines keeps one (count-
    masked) line. The plans are built from the float64 grid of the gas's
    plan, never from its (float32) ``nu``: a float32 grid moves line
    membership at |dnu| = cut. Slabs are padded to a multiple of 128 lines
    with :data:`PAD_VALUES`. A ShardedLineGas of ``n_shards`` comes back as
    it is; another count raises.
    """
    if isinstance(gas, ShardedLineGas):
        if gas.n_shards == n_shards:
            return gas
        raise ValueError(f"gas already sharded {gas.n_shards}-way, cannot re-shard to {n_shards}")
    if not isinstance(gas, (DirectGas, MultiGas)):
        raise TypeError("shard_line_gas requires a DirectGas or MultiGas")
    nu = np.asarray(gas.plan.nu, np.float64)
    n_nu = len(nu)
    if n_nu % n_shards != 0:
        raise ValueError(f"n_nu={n_nu} not divisible by n_shards={n_shards}; pad the grid")
    n_local = n_nu // n_shards
    cut = float(gas.plan.cut)
    block = int(gas.plan.block if block is None else block)
    lines = gas.lines
    nu_l = lines.positions64()

    meta, auto = coarse_split_params(nu, n_local, nu_l, cut, block)
    halo = cut + (4.0 * meta[1] if meta is not None else 0.0)
    bounds, plans = [], []
    for s in range(n_shards):
        nus = nu[s * n_local:(s + 1) * n_local]
        a = int(np.searchsorted(nu_l, nus[0] - halo, side="left"))
        b = int(np.searchsorted(nu_l, nus[-1] + halo, side="right"))
        # clamp a before widening b, so that a shard above the whole
        # catalog (a == b == n_lines) stays in range
        a = min(a, len(nu_l) - 1)
        b = max(b, a + 1)
        bounds.append((a, b))
        plans.append(build_line_window_plan(nus, nu_l[a:b], cut, block=block))
    L_pad = -(-max(b - a for a, b in bounds) // _PAD) * _PAD
    dev = lines.device

    def stack(x, fill):
        x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        out = np.full((n_shards, L_pad), fill, dtype=x.dtype)
        for s, (a, b) in enumerate(bounds):
            out[s, : b - a] = x[a:b]
        return torch.as_tensor(out, device=dev)

    lines_s = dataclasses.replace(lines, **{f: stack(getattr(lines, f), PAD_VALUES[f])
                                            for f in PER_LINE_FIELDS})
    coarse = {}
    if meta is not None:
        pos = np.full((n_shards, L_pad), 1e30)
        for s, (a, b) in enumerate(bounds):
            pos[s, : b - a] = nu_l[a:b]
        coarse = coarse_fields(pos, *split_grids(nu, n_shards, gas.shape, plans[0].block, meta),
                               cut, meta, auto, dev)
    conc = getattr(gas, "conc", None)
    mol_ptr = getattr(gas, "mol_ptr", None)
    return ShardedLineGas(
        lines=lines_s, plans=DeviceWindowPlan.stack(plans, dev, **coarse), nu=gas.nu,
        conc=None if conc is None else stack(conc, 0.0),
        mol_ptr=None if mol_ptr is None else stack(mol_ptr, 0), shape=gas.shape,
        fC=gas.fC if isinstance(gas, DirectGas) else None,
        fCs=tuple(getattr(gas, "fCs", ()) or ()), name=gas.name, formula=gas.formula,
        mu=gas.mu, n_shards=n_shards, strategy=gas.strategy,
        molecules=gas.components() if isinstance(gas, MultiGas) else ())

"""Consolidated absorbers: the unified stack and the accelerated column cache.

Counterpart of ``clearsky_tpu.absorption.absorbers``. An
:class:`AbsorberStack` produces dense ``sigma[..., n_nu]`` for batches of
(T, P) states; an :class:`AcceleratedAbsorber` caches ln sigma on a model's
own pressure column, for one column or a batch of columns (a sweep), and
interpolates it in ln P. Collision-induced absorption tables in a stack are
bound to its grid and paired with its gases by formula (through a
``MultiGas``'s per-molecule components too).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ops.linesum_strategies import _column_batch
from ..utils.interp import interp_linear
from .cia import CIA, BoundCIA, CIATables
from .gas import AbstractGas, DirectGas, Gas, MultiGas
from .sharded import ShardedLineGas

__all__ = [
    "AbsorberStack",
    "AcceleratedAbsorber",
    "unify_absorbers",
    "check_pressures",
    "pressure_limits",
    "temperature_limits",
]

_LOG_TINY = float(np.log(np.finfo(np.float64).tiny))


@dataclasses.dataclass(frozen=True, eq=False)
class AbsorberStack:
    """Unified absorber: gases, CIA pairs and user functions sigma(nu, T, P)."""

    gases: tuple
    cias: tuple
    nu: torch.Tensor
    funs: tuple = ()

    @classmethod
    def create(cls, *absorbers) -> "AbsorberStack":
        if len(absorbers) == 1 and isinstance(absorbers[0], (tuple, list)):
            absorbers = tuple(absorbers[0])
        if len(absorbers) == 0:
            raise ValueError("no absorbers... nothing to group")
        if any(isinstance(a, (AbsorberStack, AcceleratedAbsorber)) for a in absorbers):
            if len(absorbers) == 1:
                return absorbers[0]
            raise ValueError("cannot mix consolidated absorbers with others")
        gases = tuple(a for a in absorbers if isinstance(a, AbstractGas))
        if not gases:
            raise ValueError(
                "must have at least one gas object, which specifies wavenumber samples"
            )
        raw_cias = [a for a in absorbers if isinstance(a, (CIATables, BoundCIA))]
        funs = tuple(a for a in absorbers
                     if not isinstance(a, (AbstractGas, CIATables, BoundCIA)))
        for f in funs:
            if not callable(f):
                raise TypeError(
                    "absorbers must be gases, CIA objects, or callables sigma(nu, T, P)")
        nu0 = gases[0].nu
        for g in gases[1:]:
            if g.nu.shape != nu0.shape or g.nu.device != nu0.device or not torch.equal(g.nu, nu0):
                raise ValueError("gases must have identical wavenumber vectors")
        # CIA pairs with the line gases by formula, with a mixture (or a
        # sharded gas) through its per-molecule components
        realgases = tuple(g for g in gases if isinstance(g, (Gas, DirectGas)))
        for g in gases:
            if isinstance(g, (MultiGas, ShardedLineGas)):
                realgases = realgases + g.components()
        # the host grid only where a table binds to it (a stack built under
        # a torch.func transform has no host view of its tensors)
        nu64 = nu0.detach().cpu().double().numpy() if raw_cias else None
        cias = tuple(
            CIA.pair(c.bind(nu64, dtype=nu0.dtype, device=nu0.device)
                     if isinstance(c, CIATables) else c, realgases)
            for c in raw_cias)
        return cls(gases, cias, nu0, funs)

    @property
    def n_nu(self) -> int:
        return self.nu.shape[0]

    def spectral_slab(self, lo: int, hi: int) -> "AbsorberStack":
        """The stack on grid points [lo, hi): each gas's and CIA pair's slab
        (a line-by-line gas must be sharded first); the functions see the
        slab's wavenumbers."""
        return dataclasses.replace(self, nu=self.nu[lo:hi],
                                   gases=tuple(g.spectral_slab(lo, hi) for g in self.gases),
                                   cias=tuple(c.spectral_slab(lo, hi) for c in self.cias))

    def sigma(self, T, P):
        """Total cross-section sigma[..., n_nu] [cm^2/molecule] at (T, P) tensors."""
        total = torch.zeros(torch.broadcast_shapes(T.shape, P.shape) + (self.n_nu,),
                            dtype=self.nu.dtype, device=self.nu.device)
        for g in self.gases:
            total = total + g(T, P)
        for c in self.cias:
            total = total + c.sigma(T, P)
        for f in self.funs:
            total = total + f(self.nu, T[..., None], P[..., None])
        return total

    def update(self, T) -> "AbsorberStack":
        """The stack itself: it caches nothing (the interface of
        :meth:`AcceleratedAbsorber.update`)."""
        return self


@dataclasses.dataclass(frozen=True, eq=False)
class AcceleratedAbsorber:
    """Per-column cached cross-sections: ln sigma on the model's own ln P grid.

    One column caches ``ln_sigma`` [np_col, n_nu] at temperatures ``T``
    [np_col]; a batch of columns (a sweep, :meth:`stacked`) caches
    [..., np_col, n_nu] at [..., np_col], every column on the same pressures
    ``lnP`` [np_col] and grid ``nu``.
    """

    ln_sigma: torch.Tensor   # [..., np_col, n_nu]
    lnP: torch.Tensor        # [np_col]
    T: torch.Tensor          # [..., np_col]
    nu: torch.Tensor
    stack: AbsorberStack

    @classmethod
    def create(cls, T, P, *absorbers) -> "AcceleratedAbsorber":
        stack = unify_absorbers(absorbers)
        P = torch.as_tensor(P, dtype=stack.nu.dtype, device=stack.nu.device)
        T = torch.as_tensor(T, dtype=stack.nu.dtype, device=stack.nu.device)
        idx = torch.argsort(P)
        P, T = P[idx], T[idx]
        inst = cls(ln_sigma=torch.zeros((P.shape[0], stack.n_nu), dtype=P.dtype,
                                        device=P.device),
                   lnP=torch.log(P), T=T, nu=stack.nu, stack=stack)
        return inst.update(T)

    @property
    def n_nu(self) -> int:
        return self.nu.shape[0]

    @property
    def batch_shape(self) -> tuple:
        """The columns' batch shape: () for one column."""
        return tuple(self.T.shape[:-1])

    def stacked(self, n: int) -> "AcceleratedAbsorber":
        """``n`` copies of a one-column cache as a batch [n, ...] (views:
        :meth:`update` makes each column its own)."""
        if self.batch_shape:
            raise ValueError(f"the cache is already a batch {self.batch_shape} of columns")
        return dataclasses.replace(self, ln_sigma=self.ln_sigma.expand(n, -1, -1),
                                   T=self.T.expand(n, -1))

    def update(self, T) -> "AcceleratedAbsorber":
        """Re-evaluate the cached cross-sections for new temperatures ``T``
        [..., np_col]: every column of a batch in one evaluation of the
        stack, its line sums routed as one column's
        (:func:`..ops.linesum_strategies._column_batch`).

        ln sigma is floored at log(float64 tiny) where sigma is not positive.
        """
        with _column_batch(math.prod(T.shape[:-1])):
            sig = self.stack.sigma(T, torch.exp(self.lnP))
        tiny = torch.finfo(sig.dtype).tiny
        ln = torch.where(sig > 0, torch.log(torch.clamp(sig, min=tiny)),
                         torch.full_like(sig, _LOG_TINY))
        return dataclasses.replace(self, ln_sigma=ln, T=T)

    def spectral_slab(self, lo: int, hi: int) -> "AcceleratedAbsorber":
        """The cache on grid points [lo, hi), with its stack's slab."""
        return dataclasses.replace(self, ln_sigma=self.ln_sigma[..., lo:hi].contiguous(),
                                   nu=self.nu[lo:hi], stack=self.stack.spectral_slab(lo, hi))

    def sigma(self, T, P):
        """Total cross-section [..., n_nu] at pressures ``P`` [...] (each
        column's of a batch: [*batch, ..., n_nu]); T is ignored (cached)."""
        v = interp_linear(torch.log(P), self.lnP, self.ln_sigma.movedim(-2, -1))
        return torch.exp(v.movedim(len(self.batch_shape), -1))


def unify_absorbers(absorbers):
    """Normalize user absorber inputs to one AbsorberStack or AcceleratedAbsorber."""
    if isinstance(absorbers, (AbsorberStack, AcceleratedAbsorber)):
        return absorbers
    if isinstance(absorbers, (tuple, list)):
        if len(absorbers) == 1 and isinstance(absorbers[0], (AbsorberStack, AcceleratedAbsorber)):
            return absorbers[0]
        return AbsorberStack.create(*absorbers)
    return AbsorberStack.create(absorbers)


def _table_gases(stack):
    if isinstance(stack, AcceleratedAbsorber):
        stack = stack.stack
    return [g for g in stack.gases if isinstance(g, Gas)]


def pressure_limits(stack) -> tuple[float, float]:
    """Intersection of the baked tables' pressure domains ((0, inf) with none)."""
    gs = _table_gases(stack)
    if not gs:
        return 0.0, np.inf
    return max(g.domain.Pmin for g in gs), min(g.domain.Pmax for g in gs)


def temperature_limits(stack) -> tuple[float, float]:
    """Intersection of the baked tables' temperature domains ((0, inf) with none)."""
    gs = _table_gases(stack)
    if not gs:
        return 0.0, np.inf
    return max(g.domain.Tmin for g in gs), min(g.domain.Tmax for g in gs)


def check_pressures(stack, Ps, Pt):
    """Domain guard for pressure endpoints: ordered, and inside every baked
    table's pressure domain."""
    if not Ps > Pt:
        raise ValueError("Ps must be greater than Pt")
    Pmin, Pmax = pressure_limits(stack)
    for P in (Ps, Pt):
        if P < Pmin:
            raise ValueError(f"Pressure {P} Pa too low, gas table domain minimum is {Pmin}")
        if P > Pmax:
            raise ValueError(f"Pressure {P} Pa too high, gas table domain maximum is {Pmax}")

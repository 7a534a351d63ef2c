"""Batched RCE sweeps: many columns of one model through one launch set a step.

Counterpart of ``clearsky_tpu.models.sweep`` (BASELINE config 5): a grid of
radiative-convective columns, for instance an insolation sweep across
latitudes, integrates as one program. The JAX package ``vmap``s the
single-column model over the columns; here the batch is an axis of every
tensor of :mod:`.rcm`'s heating: the cached absorber holds [B, np, n_nu]
and refreshes every column in one line sum, routed as one column's
(``ops.linesum_strategies._column_batch``), and the march runs once over
the columns folded into the wavenumber axis. A sweep step so launches the
same kernels whatever the number of columns. :func:`shard_sweep` places
the columns on the rows of a ('batch', 'nu') mesh and the spectrum on its
ranks within a row.

Typical use composes with :mod:`..orbital`:

    theta, F = annualfluxfactors(e, gamma, p, ntheta=64)   # latitude factors
    T_b, A_b = run_sweep(rcm, F * S0, dt, nsteps)          # 64 columns at once
"""

from __future__ import annotations

import dataclasses

import torch

from ..atmosphere.adiabats import lapse
from ..utils import profiling
from ..utils.interp import interp_linear
from . import rcm as rcm_mod

__all__ = ["batched_heating", "run_sweep", "shard_sweep"]


def _factors(rcm, factors) -> torch.Tensor:
    """The insolation factors as a vector [B] in the model's dtype and on its device."""
    f = torch.as_tensor(factors, dtype=rcm.T.dtype, device=rcm.T.device)
    if f.dim() != 1:
        raise ValueError(f"factors must be a vector [batch], not of shape {tuple(f.shape)}")
    return f


def _with_insolation(rcm, factor):
    """Column variant of the template with scaled TOA stellar flux: a scalar
    ``factor``, or a vector [B] of them for a batch of columns (``S_nu``
    [B, n_nu])."""
    f = torch.as_tensor(factor, dtype=rcm.S_nu.dtype, device=rcm.S_nu.device)
    return dataclasses.replace(rcm, S_nu=rcm.S_nu * f[..., None] if f.dim() else rcm.S_nu * f)


def _columns(rcm, T_b, nb: int, what: str) -> torch.Tensor:
    T_b = torch.as_tensor(T_b, dtype=rcm.T.dtype, device=rcm.T.device)
    if T_b.shape != (nb, rcm.T.shape[0]):
        raise ValueError(f"{what} must be [{nb}, {rcm.T.shape[0]}] for {nb} insolation "
                         f"factors, not {tuple(T_b.shape)}")
    return T_b


def batched_heating(rcm, T_b, factors):
    """Heating rates [batch, np] for a batch of columns.

    ``T_b`` [batch, np] are per-column temperatures; ``factors`` [batch]
    scale the template's stellar spectrum per column (insolation sweep).
    All other model structure (grids, absorbers, closures, a sharded
    model's spectral sum) is shared: one heating of the whole batch.
    """
    factors = _factors(rcm, factors)
    T_b = _columns(rcm, T_b, factors.shape[0], "T_b")
    return rcm_mod.heating(_with_insolation(rcm, factors), T_b)


def run_sweep(rcm, factors, dt, nsteps: int, T0_b=None, update_every: int = 0,
              adjust_every: int = 0, cp: float | None = None, mu: float | None = None,
              A0_b=None):
    """Integrate a batch of RCE columns with per-column insolation factors.

    Returns (T_b, A_b): final temperatures [batch, np] and the per-column
    cached absorbers (one cache of [batch, np, n_nu]). The step is
    :func:`.rcm.run`'s composed loop for every column at once: an Euler
    step on the batch's heating; after step i (from 0) the convective
    adjustment where (i + 1) is a multiple of ``adjust_every``, then every
    column's absorber refreshed at its new temperatures where (i + 1) is a
    multiple of ``update_every``. The JAX package scans this on its device;
    here it is a Python loop of one launch set a step. ``A0_b`` (the port's
    addition) starts from a batch cache, for instance a JAX sweep's carried
    over by ``convert.accelerated_absorber``; by default every column starts
    from the model's cache.
    """
    factors = _factors(rcm, factors)
    nb = factors.shape[0]
    T = (rcm.T.expand(nb, -1) if T0_b is None else _columns(rcm, T0_b, nb, "T0_b"))
    if adjust_every and (cp is None or mu is None):
        raise ValueError("convective adjustment requires scalar cp and mu")
    if A0_b is None:
        A = rcm.A.stacked(nb)
    elif A0_b.batch_shape != (nb,):
        raise ValueError(f"A0_b caches {A0_b.batch_shape} columns, not ({nb},)")
    else:
        A = A0_b
    r_b = _with_insolation(rcm, factors)
    lnPe, lnP = torch.log(rcm.Pe), torch.log(rcm.P)
    for i in range(nsteps):
        with profiling.span("cs.step", T):
            T = T + dt * rcm_mod.heating(r_b, T, A)
            if adjust_every and (i + 1) % adjust_every == 0:
                with profiling.span("cs.adjust", T):
                    T = lapse(T, rcm.P, cp, mu)
            if update_every and (i + 1) % update_every == 0:
                with profiling.span("cs.refresh", T):
                    A = A.update(interp_linear(lnPe, lnP, T))
    return T, A


def shard_sweep(mesh, rcm, factors, T0_b=None):
    """Place sweep inputs on a ('batch', 'nu') mesh (``parallel.spectral_mesh``).

    Returns (rcm_sharded, factors_sharded, T0_b_sharded) for this rank, ready
    for :func:`batched_heating` and :func:`run_sweep`: the columns of its
    batch row (``mesh.batch_index``), and the model on its slab of the
    spectrum with its line-by-line gases as per-shard line slabs
    (``parallel.shard_lbl``), carrying its spectral sum (its slice of the
    global trapezoid weights, then one all-reduce over the row's ranks,
    ``mesh.nu_group``). The batch must divide over the mesh's rows.
    """
    from ..parallel.mesh import replicate
    from ..parallel.spectral import _local

    factors = _factors(rcm, factors)
    nb = factors.shape[0]
    if nb % mesh.shape["batch"] != 0:
        raise ValueError(
            f"batch size {nb} not divisible by batch-mesh size {mesh.shape['batch']}")
    T0_b = rcm.T.expand(nb, -1) if T0_b is None else _columns(rcm, T0_b, nb, "T0_b")
    rows = nb // mesh.n_batch
    lo = mesh.batch_index * rows
    return (_local(mesh, rcm), replicate(factors[lo:lo + rows], mesh),
            replicate(T0_b[lo:lo + rows].contiguous(), mesh))

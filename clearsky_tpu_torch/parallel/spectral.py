"""Sharded spectral programs: flux solves and RCE steps over a process mesh.

Counterpart of ``clearsky_tpu.parallel.spectral``. Each rank radiates its
own slab of the wavenumber grid (its line-by-line gases as per-shard line
slabs, ``shard_lbl``) through the same kernels as the unsharded path (K1-dev
for the line sum, K2/K3 for the march), and the spectral integrals are the
rank's slice of the global :func:`.mesh.trapz_weights` summed locally and
then added over the ranks by one all-reduce. The JAX package places the
model with GSPMD (``sharded_radiate``) or ``shard_map``
(``make_sharded_heating``/``make_sharded_step``); both are the same
rank-local program here. Its XLA partitioning of the march kernel
(``march_gspmd``) has no counterpart: each rank runs K2/K3 on its slab.
"""

from __future__ import annotations

import dataclasses

import torch

from ..absorption.absorbers import AbsorberStack, AcceleratedAbsorber
from ..absorption.gas import DirectGas, MultiGas
from ..absorption.sharded import shard_line_gas
from ..models import rcm as rcm_mod
from ..rt.discretized import FluxPack
from ..utils.interp import interp_linear
from .mesh import SpectralMesh, shard_spectral, spectral_all_reduce, trapz_weights

__all__ = ["pad_nu", "shard_lbl", "sharded_radiate", "make_sharded_heating",
           "make_sharded_step"]


def pad_nu(n_nu: int, n_shards: int) -> int:
    """The padded grid length divisible by the shard count (the caller
    appends the pad points with zero weight, so they change nothing)."""
    return -(-n_nu // n_shards) * n_shards


def _map_gases(x, fn):
    """``x`` with ``fn`` applied to every gas of a model, absorber cache,
    stack or tuple of absorbers (``x`` itself otherwise)."""
    if isinstance(x, rcm_mod.RCM):
        return dataclasses.replace(x, A=_map_gases(x.A, fn))
    if isinstance(x, AcceleratedAbsorber):
        return dataclasses.replace(x, stack=_map_gases(x.stack, fn))
    if isinstance(x, AbsorberStack):
        return dataclasses.replace(x, gases=tuple(fn(g) for g in x.gases))
    if isinstance(x, (tuple, list)):
        return type(x)(_map_gases(v, fn) for v in x)
    return fn(x)


def shard_lbl(tree, n_shards: int):
    """Every DirectGas/MultiGas of a model (or absorber) as a ShardedLineGas
    of ``n_shards`` shards.

    A line-by-line gas holds one banding plan for the whole grid against the
    whole catalog, so a slab of its grid has no meaning on its own; the
    sharded gas gives each shard its own line slab and plan
    (``absorption.sharded``). The sharded programs below apply it
    themselves.
    """
    return _map_gases(tree, lambda g: shard_line_gas(g, n_shards)
                      if isinstance(g, (DirectGas, MultiGas)) else g)


def _local(mesh: SpectralMesh, rcm):
    """This rank's slab of the model, carrying its spectral sum
    ([..., n_slab] -> [...]: the weighted sum of the slab with its slice of
    the global trapezoid weights, added over the ranks)."""
    n_nu = rcm.nu.shape[0]
    lo, hi = mesh.slab(n_nu)
    rcm_s = shard_spectral(shard_lbl(rcm, mesh.n_shards), mesh, n_nu)
    w = trapz_weights(rcm.nu)[lo:hi]
    return dataclasses.replace(
        rcm_s, spectral_sum=lambda y: spectral_all_reduce((y * w).sum(dim=-1), mesh))


def sharded_radiate(mesh: SpectralMesh, rcm) -> FluxPack:
    """The FluxPack of the model's state with the spectrum sharded over the
    mesh: ``tau``, ``M_up``, ``M_down`` of this rank's slab, and the
    spectral integrals ``F_up``, ``F_down``, ``F_net`` of the whole grid
    (one all-reduce for both). Needs n_nu divisible by the shard count."""
    rcm_s = _local(mesh, rcm)
    tau, M_up, M_down = rcm_mod._mono_on_radiative_grid(rcm_s, rcm_s.T, rcm_s.A)
    F_up, F_down = rcm_s.spectral_sum(torch.stack([M_up, M_down]))
    return FluxPack(tau, M_up, M_down, F_up, F_down, F_up - F_down)


def make_sharded_heating(mesh: SpectralMesh, rcm):
    """The sharded heating program ``f(T, A=None) -> H``: each rank computes
    its slab's monochromatic fluxes for the whole column, and the only
    collective is one all-reduce of the weighted spectral sums. ``A`` is the
    rank's slab of the absorber cache (by default the model's);
    ``f.rcm_sharded`` is the rank's slab of the model."""
    rcm_s = _local(mesh, rcm)

    def heating_fn(T, A=None):
        return rcm_mod.heating(rcm_s, T, rcm_s.A if A is None else A)

    heating_fn.rcm_sharded = rcm_s
    return heating_fn


def make_sharded_step(mesh: SpectralMesh, rcm, dt, update_every: int = 0):
    """The sharded RCE step ``f(T, A=None, i=0) -> (T', A')``: one Euler
    step on the sharded heating (one all-reduce), then, where (i + 1) is a
    multiple of ``update_every``, the rank's absorber cache refreshed at the
    new temperatures interpolated to the edges (per wavenumber: no
    communication)."""
    rcm_s = _local(mesh, rcm)
    lnPe, lnP = torch.log(rcm.Pe), torch.log(rcm.P)

    def step_fn(T, A=None, i=0):
        A = rcm_s.A if A is None else A
        T = T + dt * rcm_mod.heating(rcm_s, T, A)
        if update_every and (i + 1) % update_every == 0:
            A = A.update(interp_linear(lnPe, lnP, T))
        return T, A

    step_fn.rcm_sharded = rcm_s
    return step_fn

"""Carry state from the JAX package over to the port.

Each function reads the JAX object's fields with ``np.asarray`` (no import
of JAX or of ``clearsky_tpu``) and builds the port's object on the given
device in the given dtype (by default float32 on the card, as every
constructor of the port), so that both packages compute on identical
inputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .spectra.lines import SpectralLines, PER_LINE_FIELDS
from .absorption.cia import BoundCIA, CIATables
from .absorption.gas import DirectGas, Gas, MultiGas, as_concentration
from .absorption.sharded import ShardedLineGas, coarse_fields
from .ops.linesum import DeviceWindowPlan
from .absorption.domain import AtmosphericDomain
from .ops.linesum import build_line_window_plan
from .absorption.absorbers import AcceleratedAbsorber, unify_absorbers
from .models.rcm import RCM
from .utils.device import placement

__all__ = ["spectral_lines", "direct_gas", "multi_gas", "sharded_line_gas", "cia", "domain",
           "gas", "rcm_arrays", "rcm", "accelerated_absorber"]


def spectral_lines(jax_lines, dtype=None, device=None) -> SpectralLines:
    """A ``clearsky_tpu`` SpectralLines as the port's SpectralLines.

    The float64 positions and their float32 residuals are carried as they
    are, so a float32 port catalog gets the JAX catalog's two-float split.
    """
    fields = {f: np.asarray(getattr(jax_lines, f)) for f in PER_LINE_FIELDS}
    fields["tips_coeffs"] = np.asarray(jax_lines.tips_coeffs)
    return SpectralLines.from_arrays(fields, dtype=dtype, device=device,
                                     name=jax_lines.name, formula=jax_lines.formula,
                                     M=jax_lines.M)


def direct_gas(jax_gas, fC, dtype=None, device=None) -> DirectGas:
    """A ``clearsky_tpu`` DirectGas (lines, nu, shape, cut, block, strategy)
    on the port.

    ``fC`` is the concentration, a scalar or a callable on tensors: the JAX
    gas's own closure computes on JAX arrays.
    """
    return DirectGas.from_lines(
        spectral_lines(jax_gas.lines, dtype, device), fC, np.asarray(jax_gas.nu),
        shape=jax_gas.shape, cut=jax_gas.plan.cut, block=jax_gas.plan.block,
        strategy=jax_gas.strategy,
    )


def multi_gas(jax_gas, fCs=None, dtype=None, device=None) -> MultiGas:
    """A ``clearsky_tpu`` MultiGas (merged lines, per-line ``conc`` or
    ``mol_ptr``, nu, shape, cut, block, formulas) on the port.

    ``fCs`` are the molecules' concentrations, scalars or callables on
    tensors; by default the JAX gas's own, passed through as they are (a
    callable given to the JAX gas must then compute on tensors too). With
    fixed concentrations only CIA pairing reads them: the lines carry the
    JAX gas's ``conc``.
    """
    lines = spectral_lines(jax_gas.lines, dtype, device)
    t = lambda x, **kw: None if x is None else torch.tensor(np.asarray(x), device=lines.device,
                                                            **kw)
    fCs = tuple(as_concentration(c) for c in (jax_gas.fCs if fCs is None else fCs))
    nu = np.asarray(jax_gas.nu, np.float64)
    return MultiGas(
        lines=lines, conc=t(jax_gas.conc, dtype=lines.dtype), mol_ptr=t(jax_gas.mol_ptr,
                                                                        dtype=torch.int64),
        nu=torch.tensor(nu, dtype=lines.dtype, device=lines.device),
        plan=build_line_window_plan(nu, lines.positions64(), jax_gas.plan.cut,
                                    block=jax_gas.plan.block),
        shape=jax_gas.shape, fCs=fCs, formulas=tuple(jax_gas.formulas),
        names=tuple(jax_gas.names), name=jax_gas.name, formula=jax_gas.formula,
        mu=float(jax_gas.mu))


def sharded_line_gas(jax_gas, fC=None, fCs=None, dtype=None, device=None) -> ShardedLineGas:
    """A ``clearsky_tpu`` ShardedLineGas on the port: its stacked line slabs
    (with their padding) and stacked plans carried across as they are, the
    coarse split's windows found on them (the port keeps them in the plan).

    ``fC`` (one molecule) or ``fCs`` (a mixture's molecules, by default the
    JAX gas's own) are concentrations on tensors, as for :func:`direct_gas`
    and :func:`multi_gas`.
    """
    lines = spectral_lines(jax_gas.lines, dtype, device)
    dev = lines.device
    jp = jax_gas.plans
    arr = lambda x, dt: torch.tensor(np.asarray(x), dtype=dt, device=dev)
    coarse = {}
    if jp.coarse_meta is not None:
        f64 = lambda hi, lo: np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
        coarse = coarse_fields(lines.positions64(), f64(jp.fine_blocks, jp.fine_blocks_lo),
                               f64(jp.coarse_blocks, jp.coarse_blocks_lo), float(jp.cut),
                               tuple(jp.coarse_meta), bool(jp.coarse_auto), dev)
    plans = DeviceWindowPlan(
        nu_blocks=arr(np.asarray(jp.nu_blocks, np.float64), torch.float64),
        nu_blocks_lo=arr(jp.nu_blocks_lo, torch.float32), start=arr(jp.start, torch.int32),
        count=arr(jp.count, torch.int32), cut=float(jp.cut), block=int(jp.block),
        n_blocks=int(jp.n_blocks), slab=int(jp.slab), n_nu=int(jp.n_nu), **coarse)
    fcs = tuple(as_concentration(c) for c in (jax_gas.fCs if fCs is None else fCs))
    return ShardedLineGas(
        lines=lines, plans=plans,
        nu=torch.tensor(np.asarray(jax_gas.nu, np.float64), dtype=lines.dtype, device=dev),
        conc=None if jax_gas.conc is None else arr(jax_gas.conc, lines.dtype),
        mol_ptr=None if jax_gas.mol_ptr is None else arr(jax_gas.mol_ptr, torch.int64),
        shape=jax_gas.shape, fC=None if fC is None else as_concentration(fC), fCs=fcs,
        name=jax_gas.name, formula=jax_gas.formula, mu=float(jax_gas.mu),
        n_shards=int(jax_gas.n_shards), strategy=jax_gas.strategy)


def cia(jax_cia, dtype=None, device=None):
    """A ``clearsky_tpu`` CIATables (host tables, copied) or BoundCIA (its
    bound ln k, temperatures and masks as float64 tensors on ``device``,
    giving values in ``dtype``) on the port."""
    if type(jax_cia).__name__ == "CIATables":
        copy = lambda rows: tuple(tuple(np.array(x) if isinstance(x, np.ndarray) else x
                                        for x in r) for r in rows)
        return CIATables(name=jax_cia.name, formulae=tuple(jax_cia.formulae),
                         grids=copy(jax_cia.grids), singles_data=copy(jax_cia.singles_data),
                         extrapolate=bool(jax_cia.extrapolate), singles=bool(jax_cia.singles))
    dtype, device = placement(dtype, device)
    f = lambda xs: tuple(torch.tensor(np.asarray(x, np.float64), device=device) for x in xs)
    m = lambda xs: tuple(torch.tensor(np.asarray(x, bool), device=device) for x in xs)
    return BoundCIA(logk=f(jax_cia.logk), T=f(jax_cia.T), mask=m(jax_cia.mask),
                    s_logk=f(jax_cia.s_logk), s_mask=m(jax_cia.s_mask), name=jax_cia.name,
                    formulae=tuple(jax_cia.formulae), extrapolate=bool(jax_cia.extrapolate),
                    use_singles=bool(jax_cia.use_singles), dtype=dtype)


def domain(jax_domain) -> AtmosphericDomain:
    """A ``clearsky_tpu`` AtmosphericDomain as the port's (same float64 nodes)."""
    return AtmosphericDomain(
        T=np.array(jax_domain.T, np.float64), Tmin=float(jax_domain.Tmin),
        Tmax=float(jax_domain.Tmax), nT=int(jax_domain.nT),
        P=np.array(jax_domain.P, np.float64), Pmin=float(jax_domain.Pmin),
        Pmax=float(jax_domain.Pmax), nP=int(jax_domain.nP))


def gas(jax_gas, fC, dtype=None, device=None) -> Gas:
    """A ``clearsky_tpu`` baked Gas, full or split, on the port.

    ``coeffs`` in ``dtype``; a split gas's bfloat16 tail goes through
    float32 numpy (exact) back to bfloat16, with its ``lead_idx`` and
    ``tail_idx``. ``fC`` is the concentration, as for :func:`direct_gas`.
    """
    dtype, device = placement(dtype, device)
    tail = None
    if jax_gas.coeffs_tail is not None:
        tail = torch.tensor(np.asarray(jax_gas.coeffs_tail).astype(np.float32),
                            device=device).to(torch.bfloat16)
    return Gas(
        nu=torch.tensor(np.asarray(jax_gas.nu, np.float64), dtype=dtype, device=device),
        coeffs=torch.tensor(np.asarray(jax_gas.coeffs), dtype=dtype, device=device),
        name=jax_gas.name, formula=jax_gas.formula, mu=float(jax_gas.mu),
        domain=domain(jax_gas.domain), fC=as_concentration(fC),
        coeffs_tail=tail,
        lead_idx=None if jax_gas.lead_idx is None else tuple(jax_gas.lead_idx),
        tail_idx=None if jax_gas.tail_idx is None else tuple(jax_gas.tail_idx),
    )


def rcm_arrays(jax_rcm) -> dict:
    """The RCM's grids and temperatures as float64 numpy arrays.

    ``Pe`` edges, ``P`` cell centres, ``T`` cell temperatures, ``Pr`` the
    radiative grid, ``Te`` the edge temperatures of the cached absorber,
    ``S_nu``/``a_nu`` the spectral boundary conditions.
    """
    out = {k: np.array(getattr(jax_rcm, k), np.float64)
           for k in ("Pe", "P", "T", "Pr", "S_nu", "a_nu")}
    out["Te"] = np.array(jax_rcm.A.T, np.float64)
    return out


def rcm(jax_rcm, *absorbers, fmu=None, fcp=None) -> RCM:
    """The JAX RCM's state on the port, with its cross-sections cached anew.

    ``absorbers`` are port absorbers (a ``ShardedLineGas`` among them);
    their dtype and device are the RCM's.
    The cache is rebuilt at the JAX absorber's edge temperatures. ``fmu``
    and ``fcp`` default to the JAX model's closures, which must then compute
    on tensors (constants and plain arithmetic do).
    """
    arr = rcm_arrays(jax_rcm)
    A = AcceleratedAbsorber.create(arr["Te"], arr["Pe"], unify_absorbers(absorbers))
    t = lambda x: torch.as_tensor(x, dtype=A.nu.dtype, device=A.nu.device)
    from .rt import fluxes

    core = jax_rcm.core
    if type(core).__name__ not in ("Discretized", "RadauEq", "Radau"):
        raise ValueError(f"core {core!r} has no counterpart in the port")
    port_core = getattr(fluxes, type(core).__name__)(**dataclasses.asdict(core))
    return RCM(Pe=t(arr["Pe"]), P=t(arr["P"]), T=t(arr["T"]), Pr=t(arr["Pr"]), A=A,
               S_nu=t(arr["S_nu"]), a_nu=t(arr["a_nu"]), g=float(jax_rcm.g),
               cs=float(jax_rcm.cs), theta_s=float(jax_rcm.theta_s),
               fmu=jax_rcm.fmu if fmu is None else fmu,
               fcp=jax_rcm.fcp if fcp is None else fcp,
               core=port_core)


def accelerated_absorber(jax_A, *absorbers) -> AcceleratedAbsorber:
    """A JAX ``AcceleratedAbsorber``'s cache on the port as it stands (not
    evaluated anew): one column's, or a batch of columns' (a JAX sweep's
    ``A_b``, stacked copies whose every field has the batch axis in front;
    their pressures and grid are one column's), so that a JAX sweep's
    ``(T_b, A_b)`` continues in ``models.sweep.run_sweep(..., A0_b=)``.

    ``absorbers`` are the port's counterparts of the JAX cache's stack
    (refreshes evaluate them); the cache takes their dtype and device.
    """
    stack = unify_absorbers(absorbers)
    t = lambda x: torch.as_tensor(x, dtype=stack.nu.dtype, device=stack.nu.device)
    ln_sigma, T = np.array(jax_A.ln_sigma, np.float64), np.array(jax_A.T, np.float64)
    lnP = np.array(jax_A.lnP, np.float64).reshape(-1, T.shape[-1])
    nu = np.array(jax_A.nu, np.float64).reshape(-1, ln_sigma.shape[-1])
    if ln_sigma.shape != T.shape + (nu.shape[-1],):
        raise ValueError(f"a cache of ln sigma {ln_sigma.shape} at temperatures {T.shape}")
    if not ((lnP == lnP[0]).all() and (nu == nu[0]).all()):
        raise ValueError("the columns of a batch cache must share their pressures and grid")
    if not torch.equal(t(nu[0]), stack.nu):
        raise ValueError("the absorbers' grid is not the cache's")
    return AcceleratedAbsorber(ln_sigma=t(ln_sigma), lnP=t(lnP[0]), T=t(T), nu=stack.nu,
                               stack=stack)

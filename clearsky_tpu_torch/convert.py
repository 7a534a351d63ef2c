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
from .absorption.gas import DirectGas, Gas, as_concentration
from .absorption.domain import AtmosphericDomain
from .absorption.absorbers import AcceleratedAbsorber, unify_absorbers
from .models.rcm import RCM
from .utils.device import placement

__all__ = ["spectral_lines", "direct_gas", "domain", "gas", "rcm_arrays", "rcm"]


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

    ``absorbers`` are port absorbers; their dtype and device are the RCM's.
    The cache is rebuilt at the JAX absorber's edge temperatures. ``fmu``
    and ``fcp`` default to the JAX model's closures, which must then compute
    on tensors (constants and plain arithmetic do).
    """
    arr = rcm_arrays(jax_rcm)
    A = AcceleratedAbsorber.create(arr["Te"], arr["Pe"], unify_absorbers(absorbers))
    t = lambda x: torch.as_tensor(x, dtype=A.nu.dtype, device=A.nu.device)
    core = jax_rcm.core
    if type(core).__name__ != "Discretized":
        raise NotImplementedError(f"core {core!r} is not ported yet")
    from .rt.fluxes import Discretized

    return RCM(Pe=t(arr["Pe"]), P=t(arr["P"]), T=t(arr["T"]), Pr=t(arr["Pr"]), A=A,
               S_nu=t(arr["S_nu"]), a_nu=t(arr["a_nu"]), g=float(jax_rcm.g),
               cs=float(jax_rcm.cs), theta_s=float(jax_rcm.theta_s),
               fmu=jax_rcm.fmu if fmu is None else fmu,
               fcp=jax_rcm.fcp if fcp is None else fcp,
               core=Discretized(**dataclasses.asdict(core)))

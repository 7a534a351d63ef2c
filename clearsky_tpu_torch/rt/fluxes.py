"""One-shot flux API: OLR spectra and whole-column flux packs.

Counterpart of ``clearsky_tpu.rt.fluxes`` for the :class:`Discretized` core:
cross-sections for the whole spectrum at the Lobatto nodes of every layer,
the quadrature to layer optical depth, and the marches of
:mod:`.discretized`. Pressures arrive as numpy arrays or scalars (set-up
input, float64); the computation runs in the absorbers' dtype on their
device.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from ..ops.planck import planck
from ..atmosphere.profile import formprofiles
from ..absorption.absorbers import AbsorberStack, unify_absorbers, check_pressures
from .discretized import (
    FluxPack,
    lobatto_pressures,
    layer_tau_flat,
    monoflux,
    outgoing_flux,
    integrate_flux,
)
from .fused_table import (
    MAX_LAYERS,
    fused_table_applicable,
    table_olr_fused,
    table_monoflux_fused,
)
from .fused_table_cuda import MAX_NODES_PER_LAYER
from .march_cuda import MAX_STREAMS

__all__ = [
    "Discretized",
    "Radau",
    "RadauEq",
    "outgoing",
    "monochromatic_fluxes",
    "fluxes",
    "net_fluxes",
    "radiate",
]

DEFAULT_THETA_S = 0.841  # stellar zenith angle, cos(theta) ~ 2/3


@dataclasses.dataclass(frozen=True)
class Discretized:
    """Layered-core selector."""

    nstream: int = 5
    nlobatto: int = 2


@dataclasses.dataclass(frozen=True)
class Radau:
    """Adaptive-core selector of ``clearsky_tpu``; not ported yet."""

    nstream: int = 5
    tol: float = 1e-5
    nlevels: int = 0
    max_steps: int = 10_000


@dataclasses.dataclass(frozen=True)
class RadauEq:
    """Grid-refined core selector of ``clearsky_tpu``; not ported yet."""

    nstream: int = 5
    nlobatto: int = 3
    refine: int = 8


def _reject_unported(core):
    if isinstance(core, (Radau, RadauEq)):
        raise NotImplementedError(
            f"{type(core).__name__} is not ported yet (ROADMAP.md, queue A, "
            "still to port: A6, Radau); use Discretized"
        )
    if core is not None and not isinstance(core, Discretized):
        raise ValueError(f"unknown core selector {core!r}")


def _check_azimuth(theta):
    if not (0 <= theta < np.pi / 2):
        raise ValueError("zenith angle theta must be in [0, pi/2)")


def _check_streams(n):
    if n < 4:
        warnings.warn("careful! using nstream < 4 is likely to be inaccurate!")


def _tensor(x, like):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _spectral_fn(x):
    """Normalize a spectral input (scalar or f(nu)) to f(nu) -> [n_nu]."""
    if callable(x):
        return lambda nu: torch.broadcast_to(_tensor(x(nu), nu), nu.shape)
    return lambda nu: torch.full(nu.shape, float(x), dtype=nu.dtype, device=nu.device)


def _eval_profiles(Pn, fT, fmu):
    Tn = torch.broadcast_to(_tensor(fT(Pn), Pn), Pn.shape)
    mun = torch.broadcast_to(_tensor(fmu(Tn, Pn), Pn), Pn.shape)
    return Tn, mun


def _column_tau(P, g, fT, fmu, A, nlobatto):
    """tau[np-1, n_nu] on an ascending pressure column (flat node sigma)."""
    Pf = lobatto_pressures(P, nlobatto).reshape(-1)
    Tf, muf = _eval_profiles(Pf, fT, fmu)
    sig = A.sigma(Tf, Pf)                          # [L*k, n_nu]
    return layer_tau_flat(P, muf, sig, g, nlobatto)


def _omega_grid(P1, P2, n):
    """Dense grid between two pressures, spaced in omega = -sqrt(P), ascending."""
    hi, lo = max(P1, P2), min(P1, P2)
    w = np.linspace(np.sqrt(lo), np.sqrt(hi), n)
    P = w * w
    P[0], P[-1] = lo, hi
    return P


def _planck_levels(P, nu, fT):
    T = torch.broadcast_to(_tensor(fT(P), P), P.shape)
    return planck(nu[None, :], T[:, None])


def _fused_table_ok(A, L: int, nstream: int, nlobatto: int) -> bool:
    """Route to the fused table kernels (K6/K7): one split-precision Gas,
    1 <= L <= MAX_LAYERS layers, at most MAX_STREAMS streams and
    MAX_NODES_PER_LAYER Lobatto nodes per layer."""
    return (1 <= L <= MAX_LAYERS and nstream <= MAX_STREAMS
            and nlobatto <= MAX_NODES_PER_LAYER and fused_table_applicable(A))


def _only_gas(A):
    return A.gases[0] if isinstance(A, AbsorberStack) else A


def outgoing(P, g, T, mu, *absorbers, Ptop: float = 1.0, nstream: int = 5,
             nlobatto: int = 3, nlevels: int = 128, vertical: bool = False,
             core=None):
    """Outgoing monochromatic flux at the top [n_nu] (the OLR spectrum).

    Surface Planck emission marched up through the column with ``nstream``
    hemispheric streams (one vertical beam with ``vertical``). ``P`` is a
    scalar surface pressure (omega-spaced grid of ``nlevels`` up to ``Ptop``)
    or a pressure vector; ``T`` and ``mu`` are vectors on ``P``, scalars or
    callables fT(P), fmu(T, P). A ``Discretized`` core overrides
    ``nstream``/``nlobatto``. A single split-precision table gas takes the
    fused table kernel (K6) unless ``vertical``.
    """
    A = unify_absorbers(absorbers)
    _reject_unported(core)
    if isinstance(core, Discretized):
        nstream, nlobatto = core.nstream, core.nlobatto
    _check_streams(nstream)
    P = np.asarray(P, dtype=np.float64)
    Pgrid = _omega_grid(float(P), Ptop, nlevels) if P.ndim == 0 else np.sort(P)
    check_pressures(A, Pgrid[-1], Pgrid[0])
    Pg = _tensor(Pgrid, A.nu)
    fT, fmu = formprofiles(Pg, T, mu)
    if not vertical and _fused_table_ok(A, Pg.shape[0] - 1, nstream, nlobatto):
        return table_olr_fused(_only_gas(A), Pg, g, fT, fmu, nlobatto, nstream)
    tau = _column_tau(Pg, g, fT, fmu, A, nlobatto)
    B = _planck_levels(Pg, A.nu, fT)
    return outgoing_flux(tau, B, nstream, vertical=vertical)


def monochromatic_fluxes(P, g, T, mu, fS, fa, *absorbers, core=Discretized(),
                         theta_s: float = DEFAULT_THETA_S):
    """Whole-column monochromatic fluxes (M_up, M_down, tau).

    P must be ascending [Pa]; T/mu may be vectors on P, scalars or callables;
    fS(nu) is the stellar spectral flux at the top, fa(nu) the surface albedo.
    A single split-precision table gas takes the fused table kernel (K7).
    """
    A = unify_absorbers(absorbers)
    _reject_unported(core)
    _check_streams(core.nstream)
    _check_azimuth(theta_s)
    P = np.asarray(P, dtype=np.float64)
    if np.any(np.diff(P) <= 0):
        raise ValueError("pressure coordinates must be in ascending order (sorted)")
    check_pressures(A, P[-1], P[0])
    Pg = _tensor(P, A.nu)
    fT, fmu = formprofiles(Pg, T, mu)
    S_nu = _spectral_fn(fS)(A.nu)
    a_nu = _spectral_fn(fa)(A.nu)
    if _fused_table_ok(A, Pg.shape[0] - 1, core.nstream, core.nlobatto):
        return table_monoflux_fused(_only_gas(A), Pg, g, fT, fmu, S_nu, a_nu, theta_s,
                                    core.nlobatto, core.nstream)
    tau = _column_tau(Pg, g, fT, fmu, A, core.nlobatto)
    B = _planck_levels(Pg, A.nu, fT)
    M_up, M_down = monoflux(tau, B, A.nu, S_nu, a_nu, theta_s, core.nstream)
    return M_up, M_down, tau


def radiate(P, g, T, mu, fS, fa, *absorbers, core=Discretized(),
            theta_s: float = DEFAULT_THETA_S) -> FluxPack:
    """Full radiation pack: monochromatic and spectrally integrated fluxes."""
    A = unify_absorbers(absorbers)
    M_up, M_down, tau = monochromatic_fluxes(P, g, T, mu, fS, fa, A, core=core,
                                             theta_s=theta_s)
    F_up, F_down = integrate_flux(M_up, M_down, A.nu)
    return FluxPack(tau, M_up, M_down, F_up, F_down, F_up - F_down)


def fluxes(P, g, T, mu, fS, fa, *absorbers, **kwargs):
    """(F_up, F_down) spectrally integrated flux profiles."""
    F = radiate(P, g, T, mu, fS, fa, *absorbers, **kwargs)
    return F.F_up, F.F_down


def net_fluxes(P, g, T, mu, fS, fa, *absorbers, **kwargs):
    """F_up - F_down."""
    return radiate(P, g, T, mu, fS, fa, *absorbers, **kwargs).F_net

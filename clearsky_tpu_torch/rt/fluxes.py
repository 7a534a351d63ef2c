"""One-shot flux API: optical depth, transmittance, OLR spectra and
whole-column flux packs.

Counterpart of ``clearsky_tpu.rt.fluxes`` for its three cores: the
:class:`Discretized` core (cross-sections for the whole spectrum at the
Lobatto nodes of every layer, the quadrature to layer optical depth, and
the marches of :mod:`.discretized`), its grid-refined form
:class:`RadauEq` (the same march on a grid with ``refine`` sub-layers a
caller layer, spaced in sqrt P, the fluxes returned on the caller's
levels), and the adaptive :class:`Radau` core (:mod:`.radau`: a column
cache of ln sigma, then one error-controlled integration a stream and
wavenumber, one kernel launch a leg on the card). Pressures arrive as numpy
arrays or scalars (set-up input, float64); the computation runs in the
absorbers' dtype on their device.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from ..ops.planck import planck
from ..utils import profiling
from ..atmosphere.profile import formprofiles
from ..absorption.absorbers import AbsorberStack, unify_absorbers, check_pressures
from .discretized import (
    FluxPack,
    lobatto_pressures,
    layer_tau_flat,
    path_tau,
    monoflux,
    outgoing_flux,
    integrate_flux,
    fused_route_on,
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
    "optical_depth",
    "transmittance",
    "outgoing",
    "monochromatic_fluxes",
    "fluxes",
    "net_fluxes",
    "radiate",
    "top_fluxes",
    "top_imbalance",
    "bottom_fluxes",
]

DEFAULT_THETA_S = 0.841  # stellar zenith angle, cos(theta) ~ 2/3


@dataclasses.dataclass(frozen=True)
class Discretized:
    """Layered-core selector."""

    nstream: int = 5
    nlobatto: int = 2


@dataclasses.dataclass(frozen=True)
class Radau:
    """Adaptive-core selector: error-controlled Radau IIA(5) marches, one
    adaptive integration a (stream x wavenumber) lane (:mod:`.radau`), a
    thread a lane on the card (``csrc/radau.cu``). ``nlevels`` sets the
    column cache's levels for a stack that is not an AcceleratedAbsorber (0:
    an AcceleratedAbsorber's own grid, else 256 levels spaced in sqrt P).
    An independent integrator with an explicit tolerance, for cross-checks;
    the discretized core converges under refinement (``RadauEq``)."""

    nstream: int = 5
    tol: float = 1e-5
    nlevels: int = 0
    max_steps: int = 10_000


@dataclasses.dataclass(frozen=True)
class RadauEq:
    """Grid-refined core selector: the discretized march with ``refine``
    sub-layers a caller layer, spaced in sqrt P, in place of adaptive steps."""

    nstream: int = 5
    nlobatto: int = 3
    refine: int = 8


def _check_core(core):
    if core is not None and not isinstance(core, (Discretized, RadauEq, Radau)):
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
    with profiling.span("cs.column_tau", A.nu):
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


def _refined(P, refine: int):
    """``refine - 1`` sqrt-P-spaced interior levels inserted in each layer of
    the ascending levels P: (refined levels, indices of P's levels in them)."""
    P = np.asarray(P, dtype=np.float64)
    L = len(P) - 1
    out = []
    for i in range(L):
        w = np.linspace(np.sqrt(P[i]), np.sqrt(P[i + 1]), refine + 1)[:-1]
        out.append(w * w)
    Pr = np.concatenate(out + [P[-1:]])
    idx = np.arange(0, L * refine + 1, refine)
    return Pr, idx


def _fused_table_ok(A, L: int, nstream: int, nlobatto: int) -> bool:
    """Route to the fused table kernels (K6/K7): one split-precision Gas,
    1 <= L <= MAX_LAYERS layers, at most MAX_STREAMS streams and
    MAX_NODES_PER_LAYER Lobatto nodes per layer, outside
    ``march_kernel_mode("off")``."""
    return (fused_route_on() and 1 <= L <= MAX_LAYERS and nstream <= MAX_STREAMS
            and nlobatto <= MAX_NODES_PER_LAYER and fused_table_applicable(A))


def _only_gas(A):
    return A.gases[0] if isinstance(A, AbsorberStack) else A


def optical_depth(P, g, T, mu, theta, *absorbers, nlobatto: int = 4, nlevels: int = 128,
                  core=None, Ptop: float = 1.0):
    """Monochromatic slant-path optical depth [n_nu] between two pressures.

    ``P`` a pressure vector: Lobatto quadrature on its levels (sorted). ``P``
    a 2-tuple (P1, P2), or a scalar (from it to ``Ptop``): a dense grid of
    ``nlevels`` levels spaced in sqrt P between the two. ``theta`` is the
    zenith angle of the path; ``T`` and ``mu`` are vectors on the levels,
    scalars or callables. ``core=Radau(...)`` integrates the depth ODE
    adaptively instead, on a column cache (:mod:`.radau`).
    """
    A = unify_absorbers(absorbers)
    _check_azimuth(theta)
    if core is not None and not isinstance(core, Radau):
        raise ValueError("optical_depth supports core=None (Lobatto quadrature) or "
                         f"core=Radau(...); got {core!r}")
    P = np.asarray(P, dtype=np.float64)
    if P.ndim == 0 or len(P) == 2:
        P1, P2 = (float(P), float(Ptop)) if P.ndim == 0 else (float(P[0]), float(P[1]))
        Pgrid = _omega_grid(P1, P2, nlevels)
    else:
        Pgrid = np.sort(P)
    check_pressures(A, Pgrid[-1], Pgrid[0])
    Pg = _tensor(Pgrid, A.nu)
    fT, fmu = formprofiles(Pg, T, mu)
    if isinstance(core, Radau):
        from .radau import build_column_cache, radau_path_tau

        cache = build_column_cache(Pgrid, fT, fmu, A, nlevels=core.nlevels)
        return radau_path_tau(cache, Pgrid[0], Pgrid[-1], g, m=1.0 / np.cos(theta),
                              tol=core.tol, max_steps=core.max_steps)
    Pn = lobatto_pressures(Pg, nlobatto)
    Tn, mun = _eval_profiles(Pn, fT, fmu)
    sig = A.sigma(Tn, Pn)
    return path_tau(Pg, Tn, mun, sig, g, 1.0 / np.cos(theta), nlobatto)


def transmittance(*args, **kwargs):
    """exp(-optical_depth(...)) [n_nu].

    A line-by-line gas's optical depth takes the JAX package's route
    (``ops.linesum_strategies.route``), and on a dense grid "auto" takes the
    coarse-far split, which bounds its error against the peak cross-section
    (about 1e-5 of it), not below it: where tau ~ 1 lies many decades under
    tau's peak the transmittance there carries that error (1.87e-2 at worst
    on a 2^19-point CO2 column whose tau peaks at 2.2e8, in float32 on an
    NVIDIA H100 80GB HBM3 at 700 W, the same in the plain float32 route as
    in the kernels). A caller who needs tau ~ 1
    exactly builds the gas with ``strategy="grouped"`` (the exact line sum).
    """
    return torch.exp(-optical_depth(*args, **kwargs))


def outgoing(P, g, T, mu, *absorbers, Ptop: float = 1.0, nstream: int = 5,
             nlobatto: int = 3, nlevels: int = 128, vertical: bool = False,
             core=None):
    """Outgoing monochromatic flux at the top [n_nu] (the OLR spectrum).

    Surface Planck emission marched up through the column with ``nstream``
    hemispheric streams (one vertical beam with ``vertical``). ``P`` is a
    scalar surface pressure (omega-spaced grid of ``nlevels`` up to ``Ptop``)
    or a pressure vector; ``T`` and ``mu`` are vectors on ``P``, scalars or
    callables fT(P), fmu(T, P). A ``Discretized`` or ``RadauEq`` core
    overrides ``nstream``/``nlobatto``; ``RadauEq`` marches on ``refine``
    times the levels (``nlevels * refine`` for a scalar P; each layer of a
    vector P refined in sqrt P, its T and mu interpolated against the
    caller's levels). A single split-precision table gas takes the fused
    table kernel (K6) unless ``vertical``, where the marched layers are
    within its bound. ``Radau`` marches every (stream x wavenumber) lane up
    adaptively on a column cache (:mod:`.radau`), with its own ``nstream``.
    """
    A = unify_absorbers(absorbers)
    _check_core(core)
    if isinstance(core, (Discretized, RadauEq)):
        nstream, nlobatto = core.nstream, core.nlobatto
    refine = core.refine if isinstance(core, RadauEq) else 1
    _check_streams(nstream)
    P = np.asarray(P, dtype=np.float64)
    if P.ndim == 0:
        Pgrid = P_base = _omega_grid(float(P), Ptop, nlevels * refine)
    else:
        P_base = np.sort(P)
        Pgrid = _refined(P_base, refine)[0] if refine > 1 else P_base
    check_pressures(A, Pgrid[-1], Pgrid[0])
    Pg = _tensor(Pgrid, A.nu)
    fT, fmu = formprofiles(_tensor(P_base, A.nu), T, mu)
    if isinstance(core, Radau):
        from .radau import build_column_cache, radau_outgoing

        _check_streams(core.nstream)
        cache = build_column_cache(Pgrid, fT, fmu, A, nlevels=core.nlevels)
        return radau_outgoing(cache, Pgrid[-1], Pgrid[0], g, nstream=core.nstream,
                              tol=core.tol, vertical=vertical, max_steps=core.max_steps)
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
    ``RadauEq`` marches on P refined ``refine`` times in sqrt P and returns
    the fluxes at P's levels, and tau summed over each layer's sub-layers.
    ``Radau`` integrates the three legs adaptively on a column cache
    (:mod:`.radau`; tau from the beam's leg).
    """
    A = unify_absorbers(absorbers)
    _check_core(core)
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
    if isinstance(core, Radau):
        from .radau import build_column_cache, radau_monoflux

        cache = build_column_cache(P, fT, fmu, A, nlevels=core.nlevels)
        return radau_monoflux(cache, P, g, S_nu, a_nu, theta_s, nstream=core.nstream,
                              tol=core.tol, max_steps=core.max_steps)
    if isinstance(core, RadauEq):
        # the caller's levels are every refine-th refined level (_refined's idx)
        Prg = _tensor(_refined(P, core.refine)[0], A.nu)
        tau_r = _column_tau(Prg, g, fT, fmu, A, core.nlobatto)
        B_r = _planck_levels(Prg, A.nu, fT)
        M_up_r, M_down_r = monoflux(tau_r, B_r, A.nu, S_nu, a_nu, theta_s, core.nstream)
        tau = tau_r.reshape(len(P) - 1, core.refine, -1).sum(dim=1)
        return M_up_r[::core.refine], M_down_r[::core.refine], tau
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
    with profiling.span("cs.radiate", A.nu):
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


def top_fluxes(P, g, T, mu, fS, fa, *absorbers, **kwargs):
    """(outgoing, incoming) spectrally integrated fluxes at the top: radiate's
    F_up[0] and F_down[0] (the reflected stellar flux included)."""
    F = radiate(P, g, T, mu, fS, fa, *absorbers, **kwargs)
    return F.F_up[0], F.F_down[0]


def top_imbalance(P, g, T, mu, fS, fa, *absorbers, **kwargs):
    """Outgoing minus incoming flux at the top (positive: net cooling)."""
    up, dn = top_fluxes(P, g, T, mu, fS, fa, *absorbers, **kwargs)
    return up - dn


def bottom_fluxes(P, g, T, mu, fS, fa, *absorbers, **kwargs):
    """(upward, downward) spectrally integrated fluxes at the surface."""
    F = radiate(P, g, T, mu, fS, fa, *absorbers, **kwargs)
    return F.F_up[-1], F.F_down[-1]

"""Radiative-convective model: the time-stepping column model.

Counterpart of ``clearsky_tpu.models.rcm`` for the discretized core, its
grid-refined form ``RadauEq`` (the radiative grid refined once more in
sqrt P at creation; the heating then runs on it unchanged) and the adaptive
``Radau`` core (the column cache taken from the model's cached absorber,
with T and mu resampled onto its ln P grid). The
model is a frozen dataclass of tensors and every operation returns a new one:
:func:`heating` radiates on the refined grid, :func:`step` takes one Euler
step, :func:`update_absorber` refreshes the cached cross-sections and
:func:`convective_adjustment` applies the dry lapse-rate sweep. A bare
``step`` neither refreshes cross-sections nor adjusts convection;
:func:`run` composes the three at chosen cadences. The JAX package scans
its steps on the device; here :func:`step_n` and :func:`run` are Python
loops over the same steps. :func:`jacobian` differentiates the heating
with ``torch.func.jacfwd`` through every kernel, whose derivatives are
those of its plain twin (``utils/twin.py``), or by the reference's
one-sided finite differences.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..ops.planck import planck
from ..utils import profiling
from ..utils.interp import interp_linear, full_float32
from ..utils.grids import trapz
from ..absorption.absorbers import AcceleratedAbsorber, unify_absorbers
from ..atmosphere.adiabats import lapse
from ..rt.discretized import FluxPack, integrate_flux, layer_tau_flat, lobatto_pressures, monoflux
from ..rt.fluxes import (Discretized, Radau, RadauEq, DEFAULT_THETA_S, _spectral_fn,
                         _check_core, _refined)

__all__ = ["RCM", "heating", "radiate_state", "step", "step_n", "run", "jacobian",
           "update_absorber", "convective_adjustment", "radiative_grid"]


def radiative_grid(Pe: np.ndarray, radmul: int) -> np.ndarray:
    """Refined radiative grid: each edge layer split into ``radmul`` equal parts."""
    Pe = np.asarray(Pe, dtype=np.float64)
    if radmul < 1:
        raise ValueError("radmul must be a positive integer")
    if radmul == 1:
        return Pe.copy()
    sub = np.linspace(Pe[:-1], Pe[1:], radmul, endpoint=False, axis=1).ravel()
    return np.concatenate([sub, Pe[-1:]])


@dataclasses.dataclass(frozen=True, eq=False)
class RCM:
    """Radiative-convective column model state.

    Tensors: edge pressures ``Pe`` [np], cell-centre pressures ``P`` [np]
    (last entry = surface), prognostic temperatures ``T`` [np], refined
    radiative grid ``Pr`` [nrad], the cached absorber ``A`` and the spectral
    boundary conditions ``S_nu``/``a_nu`` [n_nu], all in the absorber's
    dtype on its device. Scalars and closures: gravity ``g``, surface heat
    capacity ``cs``, stellar zenith angle ``theta_s``, ``fmu(T, P)``,
    ``fcp(T, P)`` and the core selector. ``spectral_sum`` is the spectral
    integral of :func:`heating` ([..., n_nu] -> [...]): None for the
    trapezoid rule over the model's grid; a rank's slab of a sharded model
    (``models.sweep.shard_sweep``) carries its weighted sum and all-reduce.
    """

    Pe: torch.Tensor
    P: torch.Tensor
    T: torch.Tensor
    Pr: torch.Tensor
    A: AcceleratedAbsorber
    S_nu: torch.Tensor
    a_nu: torch.Tensor
    g: float = 9.8
    cs: float = 1e7
    theta_s: float = DEFAULT_THETA_S
    fmu: Callable = None
    fcp: Callable = None
    core: Discretized = Discretized()
    spectral_sum: Callable = None

    @classmethod
    def create(cls, Pe, Te, g, fmu, fS, fa, fcp, cs, *absorbers, core=Discretized(),
               radmul: int = 2, theta_s: float = DEFAULT_THETA_S) -> "RCM":
        """Construct from edge pressures and temperatures and physics closures."""
        _check_core(core)
        Pe = np.asarray(Pe, dtype=np.float64)
        Te = np.asarray(Te, dtype=np.float64)
        if len(Pe) != len(Te):
            raise ValueError(
                "must have same number of initial temperature and pressure values"
            )
        if not callable(fmu) or not callable(fcp):
            raise TypeError("fmu and fcp must be callables (T, P) -> value")
        idx = np.argsort(Pe)
        Pe, Te = Pe[idx], Te[idx]
        # cell centres; the last cell is the surface itself
        P = np.concatenate([0.5 * (Pe[:-1] + Pe[1:]), Pe[-1:]])
        T = np.concatenate([0.5 * (Te[:-1] + Te[1:]), Te[-1:]])
        Pr = radiative_grid(Pe, radmul)
        if isinstance(core, RadauEq):
            Pr, _ = _refined(Pr, core.refine)
        stack = unify_absorbers(absorbers)
        A = AcceleratedAbsorber.create(Te, Pe, stack)
        t = lambda x: torch.as_tensor(x, dtype=A.nu.dtype, device=A.nu.device)
        return cls(Pe=t(Pe), P=t(P), T=t(T), Pr=t(Pr), A=A,
                   S_nu=_spectral_fn(fS)(A.nu), a_nu=_spectral_fn(fa)(A.nu),
                   g=float(g), cs=float(cs), theta_s=float(theta_s),
                   fmu=fmu, fcp=fcp, core=core)

    @property
    def n_cells(self) -> int:
        return self.P.shape[0]

    @property
    def nu(self) -> torch.Tensor:
        return self.A.nu

    def spectral_slab(self, lo: int, hi: int) -> "RCM":
        """The model on grid points [lo, hi): its boundary spectra and its
        absorber's slab (``parallel.shard_spectral``)."""
        return dataclasses.replace(self, S_nu=self.S_nu[lo:hi], a_nu=self.a_nu[lo:hi],
                                   A=self.A.spectral_slab(lo, hi))


def _mono_on_radiative_grid(rcm: RCM, T, A: AcceleratedAbsorber):
    """(tau, M_up, M_down) on the refined grid for cell temperatures T and
    the cached absorber A.

    A batch of columns on the model's levels, T [B, np] with a cache of B
    columns or the model's one (and ``rcm.S_nu`` [n_nu] or per column [B,
    n_nu]), gives [B, ...] of each: the closures and the cache's
    interpolation see the whole batch, the layer quadrature is one batched
    product and the march one launch over the columns folded into the
    wavenumber axis (:func:`..rt.discretized.monoflux`).
    """
    lnP = torch.log(rcm.P)

    def fT(P):
        return interp_linear(torch.log(P), lnP, T)

    core = rcm.core
    if isinstance(core, Radau):
        # the adaptive core on the refined grid: ln sigma from the cached
        # absorber, T and mu resampled onto its ln P grid
        from ..rt.radau import build_column_cache, radau_monoflux

        cache = build_column_cache(rcm.Pr, fT, rcm.fmu, A)
        M_up, M_down, tau = radau_monoflux(cache, rcm.Pr, rcm.g, rcm.S_nu, rcm.a_nu,
                                           rcm.theta_s, nstream=core.nstream, tol=core.tol,
                                           max_steps=core.max_steps)
        return tau, M_up, M_down
    with profiling.span("cs.heating.opacity", T):
        Pf = lobatto_pressures(rcm.Pr, core.nlobatto).reshape(-1)
        Tf = fT(Pf)
        muf = torch.broadcast_to(torch.as_tensor(rcm.fmu(Tf, Pf), dtype=Pf.dtype,
                                                 device=Pf.device), Tf.shape)
        sig = A.sigma(Tf, Pf)
        tau = layer_tau_flat(rcm.Pr, muf, sig, rcm.g, core.nlobatto)
    B = planck(rcm.nu, fT(rcm.Pr)[..., None])
    M_up, M_down = monoflux(tau, B, rcm.nu, rcm.S_nu, rcm.a_nu, rcm.theta_s, core.nstream)
    return tau, M_up, M_down


def _heating_operator(rcm: RCM, T):
    """The linear map G: M_net [nr, n_nu] -> heating rows, applied per wavenumber.

    Heating is interp(ln Pr -> ln Pe), level difference and scale applied
    to the net flux. Applying that map before the spectral integral
    (difference, then integrate) keeps float32 rounding at the level of the
    differences; integrating first amplifies it ~100x (F_net is O(100)
    W/m^2, its level differences O(0.1-1)). Rows 0..np-2 are the cell
    weights g/cp dInterp/dP, the last row the surface term 1/cs; for a
    batch of columns T [B, np] and a cp that depends on T, [B, np, nr].
    """
    lnPe, lnPr = torch.log(rcm.Pe), torch.log(rcm.Pr)
    nr = rcm.Pr.shape[0]
    npe = rcm.Pe.shape[0]
    i = torch.clamp(torch.searchsorted(lnPr, lnPe, right=True) - 1, 0, nr - 2)
    t = (lnPe - lnPr[i]) / (lnPr[i + 1] - lnPr[i])
    rows = torch.arange(npe, device=i.device)
    W = torch.zeros(npe * nr, dtype=rcm.Pr.dtype, device=rcm.Pr.device)
    W.index_add_(0, rows * nr + i, -(1.0 - t))        # R = -interp
    W.index_add_(0, rows * nr + i + 1, -t)
    W = W.view(npe, nr)
    cp = torch.as_tensor(rcm.fcp(T[..., :-1], rcm.P[:-1]), dtype=W.dtype, device=W.device)
    dP = rcm.Pe[1:] - rcm.Pe[:-1]
    Gc = (W[:-1] - W[1:]) * ((rcm.g / cp) / dP)[..., None]
    Gs = torch.broadcast_to(W[-1:] / rcm.cs, Gc.shape[:-2] + (1, nr))
    return torch.cat([Gc, Gs], dim=-2)


def heating(rcm: RCM, T=None, A: AcceleratedAbsorber | None = None, spectral_sum=None):
    """Cell heating rates H [K/s] (last entry = surface) at cell temperatures
    ``T`` and the cached absorber ``A`` (by default the model's own).

    Radiates on the refined grid, applies the interpolate/difference/scale
    operator to the net flux per wavenumber, then integrates over the
    spectrum: the trapezoid rule, or ``spectral_sum`` (a map of
    [..., n_nu] -> [...], the JAX package's hook for a sharded sum; by
    default the model's own, ``rcm.spectral_sum``). ``T`` [B, np] heats a
    batch of columns at once ([B, np]; :func:`_mono_on_radiative_grid`).
    """
    T = rcm.T if T is None else T
    A = rcm.A if A is None else A
    spectral_sum = rcm.spectral_sum if spectral_sum is None else spectral_sum
    with profiling.span("cs.heating", T):
        _, M_up, M_down = _mono_on_radiative_grid(rcm, T, A)
        with profiling.span("cs.heating.spectral", T):
            # full float32, as the JAX package's Precision.HIGHEST: TF32 would
            # round the per-nu net flux that the level differences cancel (trap C5)
            with full_float32():
                dH = torch.matmul(_heating_operator(rcm, T), M_up - M_down)   # [..., np, n_nu]
            if spectral_sum is None:
                return trapz(rcm.nu, dH, axis=-1)
            return spectral_sum(dH)


def radiate_state(rcm: RCM) -> FluxPack:
    """The FluxPack on the refined radiative grid for the model's state."""
    tau, M_up, M_down = _mono_on_radiative_grid(rcm, rcm.T, rcm.A)
    F_up, F_down = integrate_flux(M_up, M_down, rcm.nu)
    return FluxPack(tau, M_up, M_down, F_up, F_down, F_up - F_down)


def step(rcm: RCM, dt) -> RCM:
    """One explicit Euler step T <- T + dt H (no absorber refresh, no adjustment)."""
    return dataclasses.replace(rcm, T=rcm.T + dt * heating(rcm))


def update_absorber(rcm: RCM, Te=None) -> RCM:
    """Refresh the cached cross-sections for edge temperatures ``Te``, by
    default the cell temperatures interpolated in ln P to the edges."""
    if Te is None:
        Te = interp_linear(torch.log(rcm.Pe), torch.log(rcm.P), rcm.T)
    return dataclasses.replace(rcm, A=rcm.A.update(Te))


def convective_adjustment(rcm: RCM, cp: float, mu: float) -> RCM:
    """Dry convective adjustment of the cell temperatures
    (:func:`..atmosphere.adiabats.lapse`)."""
    return dataclasses.replace(rcm, T=lapse(rcm.T, rcm.P, cp, mu))


def step_n(rcm: RCM, dt, nsteps: int) -> RCM:
    """``nsteps`` Euler steps on the model's cached absorber (no refresh, no
    adjustment): the same arithmetic as ``nsteps`` calls of :func:`step`."""
    T = rcm.T
    for _ in range(nsteps):
        T = T + dt * heating(rcm, T)
    return dataclasses.replace(rcm, T=T)


def run(rcm: RCM, dt, nsteps: int, update_every: int = 0, adjust_every: int = 0,
        cp: float | None = None, mu: float | None = None, record_every: int = 0,
        spectral_sum=None):
    """Integrate toward radiative-convective equilibrium: ``nsteps`` Euler
    steps; after step i (from 0), the convective adjustment where (i + 1) is
    a multiple of ``adjust_every``, then the absorber refreshed at the new
    temperatures where (i + 1) is a multiple of ``update_every`` (0: never).

    Returns ``(rcm, history)``: the final model and the cell temperatures
    after every ``record_every``-th step, [nsteps // record_every, np]
    (empty [0, np] when ``record_every`` is 0). The cadences and records are
    the JAX package's; its scan on the device is a Python loop here.
    """
    if adjust_every and (cp is None or mu is None):
        raise ValueError("convective adjustment requires scalar cp and mu")
    lnPe, lnP = torch.log(rcm.Pe), torch.log(rcm.P)
    T, A = rcm.T, rcm.A
    recs = []
    for i in range(nsteps):
        with profiling.span("cs.step", T):
            T = T + dt * heating(rcm, T, A, spectral_sum=spectral_sum)
            if adjust_every and (i + 1) % adjust_every == 0:
                with profiling.span("cs.adjust", T):
                    T = lapse(T, rcm.P, cp, mu)
            if update_every and (i + 1) % update_every == 0:
                with profiling.span("cs.refresh", T):
                    A = A.update(interp_linear(lnPe, lnP, T))
        if record_every and (i + 1) % record_every == 0:
            recs.append(T)
    history = (torch.stack(recs) if recs
               else torch.zeros((0, rcm.T.shape[0]), dtype=rcm.T.dtype, device=rcm.T.device))
    return dataclasses.replace(rcm, T=T, A=A), history


def jacobian(rcm: RCM, mode: str = "fwd", eps: float = 1.0, update_sigma: bool = False):
    """Jacobian dH/dT [np, np] of the heating rates with respect to the cell
    temperatures, J[i, j] = dH_i/dT_j.

    ``mode="fwd"``: ``torch.func.jacfwd`` through the whole radiation
    calculation, exact; on the card the kernels' derivatives are their plain
    twins' (the line sum's the exact plain sum's, the march's the plain
    march's), so the primal runs the kernels once and the np tangents the
    twins. ``mode="fd"``: the reference's one-sided differences with step
    ``eps``, np + 1 heatings. ``update_sigma=True`` also differentiates
    through the absorber refresh at the cell temperatures interpolated to
    the edges (``rcm.A.update``), the dependence of sigma on T that the
    cached cross-sections otherwise freeze.
    """
    lnPe, lnP = torch.log(rcm.Pe), torch.log(rcm.P)

    def H_of_T(T):
        if update_sigma:
            return heating(rcm, T, rcm.A.update(interp_linear(lnPe, lnP, T)))
        return heating(rcm, T)

    if mode == "fwd":
        return torch.func.jacfwd(H_of_T)(rcm.T)
    if mode == "fd":
        H0 = H_of_T(rcm.T)
        eye = torch.eye(rcm.T.shape[0], dtype=rcm.T.dtype, device=rcm.T.device)
        return torch.stack([(H_of_T(rcm.T + eps * e) - H0) / eps for e in eye], dim=1)
    raise ValueError("mode must be 'fwd' or 'fd'")

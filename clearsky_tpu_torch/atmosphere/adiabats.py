"""Adiabatic temperature profiles, dry (closed form) and moist (integrated),
and the convective adjustment.

Counterpart of ``clearsky_tpu.atmosphere.adiabats``. The moist adiabat is
integrated once at construction on a dense omega = -sqrt(P) grid (host RK4)
and evaluated by linear interpolation; both profiles take an isothermal
stratosphere by temperature (``Tstrat``) or pressure (``Ptropo``) with the
cubic-Hermite smoothing patch. Profiles evaluate on tensors in their dtype
and on their device; numbers and arrays become float64 CPU tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..constants import R_GAS, P_MIN
from ..utils.device import as_tensor
from ..utils.grids import logrange, p2omega
from ..utils.interp import interp_linear
from ..utils.ode import rk4_dense
from ..utils.rootfind import regula_falsi

__all__ = [
    "lapse_rate_moist",
    "lapse_rate_dry",
    "lapse",
    "DryAdiabat",
    "MoistAdiabat",
    "tropopause",
    "pressure_of_temperature",
]


def lapse_rate_moist(T, P, cpn, cpv, mun, muv, L, psat):
    """One-condensible moist lapse rate dT/dP."""
    alpha = psat(T) / P
    Rn = R_GAS / mun
    Rv = R_GAS / muv
    N = 1.0 + alpha * L / (Rn * T)
    D = 1.0 + alpha * (cpv / cpn + (L / (T * Rv) - 1.0) * L / (cpn * T))
    return (T / P) * (Rn / cpn) * (N / D)


def lapse_rate_dry(T, P, cp, mu):
    """Dry adiabatic lapse rate dT/dP."""
    return (T / P) * (R_GAS / (mu * cp))


def lapse(T, P, cp, mu):
    """Convective adjustment: from the highest pressure up, each next point is
    warmed to the dry adiabat from the point below where the profile is
    superadiabatic (dT/dP above the dry lapse rate). ``P`` may be unsorted.

    A sequential sweep over a short column (about twenty cells): it runs as
    a plain loop on the host in T's dtype, and the result goes back to T's
    device.
    """
    T = as_tensor(T)
    Th = T.detach().cpu()
    Ph = as_tensor(P).detach().cpu().to(Th.dtype)
    order = torch.argsort(-Ph, stable=True)     # descending pressure
    Ts, Ps = Th[order].clone(), Ph[order]
    for k in range(1, Ts.shape[0]):
        Ti, Pi, Pj = Ts[k - 1], Ps[k - 1], Ps[k]
        gamma_e = lapse_rate_dry(Ti, Pi, cp, mu)
        gamma_p = (Ts[k] - Ti) / (Pj - Pi)
        if bool(gamma_p > gamma_e):
            Ts[k] = Ti + gamma_e * (Pj - Pi)
    out = torch.empty_like(Th)
    out[order] = Ts
    return out.to(T.device)


def _smooth_patch(P, Ptropo, smooth, Tstrat, T2, h2, T_raw):
    """Below Ptropo the stratosphere's Tstrat; inside [Ptropo, Ptropo +
    smooth] a cubic Hermite connection; elsewhere the raw profile floored at
    Tstrat."""
    psi = (P - Ptropo) / smooth
    hermite = psi**3 * (2 * Tstrat - 2 * T2 + h2) + psi**2 * (-3 * Tstrat + 3 * T2 - h2) + Tstrat
    use_smooth = (Ptropo != 0.0) & (smooth != 0.0) & (P > Ptropo) & (P < Ptropo + smooth)
    T = torch.where(use_smooth, hermite, torch.clamp(T_raw, min=Tstrat))
    return torch.where(P < Ptropo, torch.full_like(T, Tstrat), T)


def _check_adiabat(Ts, Ps, Pt, Tstrat, Ptropo, smooth):
    if not Ps > Pt:
        raise ValueError("Ps must be greater than Pt")
    if not Pt > 0:
        raise ValueError("Pt must be greater than 0")
    if Tstrat < 0 or Ptropo < 0 or smooth < 0:
        raise ValueError("Tstrat/Ptropo/smooth cannot be negative")
    if Tstrat > 0 and Tstrat >= Ts:
        raise ValueError("Tstrat cannot be greater than Ts")
    if Tstrat != 0 and Ptropo != 0:
        raise ValueError("Cannot have nonzero Tstrat and Ptropo, use one or the other")


def _stratosphere(profile, P, T_raw):
    """The raw profile with the profile's stratosphere and patch applied."""
    if profile.Ptropo == 0.0:
        return torch.clamp(T_raw, min=profile.Tstrat) if profile.Tstrat > 0 else T_raw
    return _smooth_patch(P, profile.Ptropo, profile.smooth, profile.Tstrat, profile.T2,
                         profile.h2, T_raw)


@dataclasses.dataclass(frozen=True, eq=False)
class DryAdiabat:
    """Dry adiabat T = Ts (P/Ps)^(R/(mu cp)) with an optional isothermal
    stratosphere; callable on pressures."""

    Ts: float
    Ps: float
    Pt: float
    cp: float
    mu: float
    Tstrat: float
    Ptropo: float
    smooth: float
    T2: float
    h2: float

    @classmethod
    def create(cls, Ts, Ps, cp, mu, Tstrat=0.0, Ptropo=0.0, smooth=1e2, Pt=P_MIN):
        _check_adiabat(Ts, Ps, Pt, Tstrat, Ptropo, smooth)
        raw = lambda P: Ts * (P / Ps) ** (R_GAS / (mu * cp))
        if Tstrat != 0:
            Ptropo = regula_falsi(lambda P, _: raw(P) - Tstrat, Ps, Pt)
        elif Ptropo != 0:
            Tstrat = raw(Ptropo)
        T2 = h2 = 0.0
        if Ptropo != 0:
            P2 = Ptropo + smooth
            T2 = raw(P2)
            h2 = smooth * lapse_rate_dry(T2, P2, cp, mu)
        return cls(Ts=float(Ts), Ps=float(Ps), Pt=float(Pt), cp=float(cp), mu=float(mu),
                   Tstrat=float(Tstrat), Ptropo=float(Ptropo), smooth=float(smooth),
                   T2=float(T2), h2=float(h2))

    def temperature_raw(self, P):
        """The adiabat without the stratosphere."""
        return self.Ts * (as_tensor(P) / self.Ps) ** (R_GAS / (self.mu * self.cp))

    def __call__(self, P):
        P = as_tensor(P)
        return _stratosphere(self, P, self.temperature_raw(P))


@dataclasses.dataclass(frozen=True, eq=False)
class MoistAdiabat:
    """Single-condensible moist adiabat with an optional isothermal
    stratosphere: integrated once (RK4 on a dense omega grid, float64 on the
    host) and interpolated linearly in omega."""

    omega: torch.Tensor
    T: torch.Tensor
    Ps: float = 0.0
    Pt: float = P_MIN
    Tstrat: float = 0.0
    Ptropo: float = 0.0
    smooth: float = 1e2
    T2: float = 0.0
    h2: float = 0.0

    @classmethod
    def create(cls, Ts, Ps, cpn, cpv, mun, muv, L, psat,
               Tstrat=0.0, Ptropo=0.0, smooth=1e2, N=1000, Pt=P_MIN, substeps=8):
        _check_adiabat(Ts, Ps, Pt, Tstrat, Ptropo, smooth)

        def dTdomega(w, T, _):
            P = max(w * w, P_MIN)
            return -2.0 * np.sqrt(P) * lapse_rate_moist(T, P, cpn, cpv, mun, muv, L, psat)

        w1, w2 = -np.sqrt(Ps), -np.sqrt(Pt)
        w = logrange(w1, w2, N)
        T = rk4_dense(dTdomega, float(Ts), w, substeps=substeps)
        raw = lambda P: np.interp(-np.sqrt(P), w, T)
        if Tstrat != 0:
            Ptropo = regula_falsi(lambda P, _: raw(P) - Tstrat, Ps, Pt)
        elif Ptropo != 0:
            Tstrat = float(raw(Ptropo))
        T2 = h2 = 0.0
        if Ptropo != 0:
            P2 = Ptropo + smooth
            T2 = float(raw(P2))
            h2 = smooth * lapse_rate_moist(T2, P2, cpn, cpv, mun, muv, L, psat)
        return cls(omega=torch.as_tensor(w), T=torch.as_tensor(T), Ps=float(Ps), Pt=float(Pt),
                   Tstrat=float(Tstrat), Ptropo=float(Ptropo), smooth=float(smooth),
                   T2=float(T2), h2=float(h2))

    def temperature_raw(self, P):
        """The profile without the stratosphere, interpolated in omega."""
        P = as_tensor(P)
        w = self.omega.to(P.device, P.dtype)
        return interp_linear(p2omega(P), w, self.T.to(P.device, P.dtype))

    def __call__(self, P):
        P = as_tensor(P)
        return _stratosphere(self, P, self.temperature_raw(P))


def tropopause(adiabat):
    """(T, P) of the tropopause of an adiabat with a stratosphere."""
    if adiabat.Ptropo != 0 and adiabat.Tstrat != 0:
        return adiabat.Tstrat, adiabat.Ptropo
    raise ValueError("no stratosphere temperature or pressure has been defined")


def pressure_of_temperature(adiabat, T):
    """The pressure where the adiabat's raw profile reaches T (host root find)."""
    Ts = float(adiabat.temperature_raw(adiabat.Ps))
    Tt = float(adiabat.temperature_raw(adiabat.Pt))
    if not (Tt <= T <= Ts):
        raise ValueError(f"temperature {T} K out of adiabat range [{Ts},{Tt}] K")
    return regula_falsi(
        lambda P, _: float(adiabat.temperature_raw(P)) - T, adiabat.Ps, adiabat.Pt
    )

"""Saturation curves, composition profiles and column utilities.

Counterpart of ``clearsky_tpu.atmosphere.saturation``: Murphy and Koop's
water saturation pressure, Fanale's CO2 saturation temperature, the
triangular ozone layer, condensible concentration profiles, the saturation
haircut and CO2 Rayleigh scattering, elementwise on tensors (numbers and
arrays as float64 CPU tensors).
"""

from __future__ import annotations

import torch

from ..constants import P_ATM
from ..ops.planck import nu2lam
from ..utils.device import as_tensor
from .adiabats import tropopause

__all__ = [
    "psat_h2o",
    "tsat_co2",
    "ozonelayer",
    "condensible_profile",
    "haircut",
    "rayleigh_co2",
]


def psat_h2o(T):
    """Saturation vapour pressure of water [Pa], Murphy and Koop (2005) eq.
    10 at T >= 273.15 K, eq. 7 (ice) below."""
    T = as_tensor(T)
    a = torch.log(T)
    b = 1.0 / T
    c = 53.878 - 1331.22 * b - 9.44523 * a + 0.014025 * T
    d = c * torch.tanh(0.0415 * (T - 218.8))
    warm = torch.exp(54.842763 - 6763.22 * b - 4.21 * a + 3.67e-4 * T + d)
    cold = torch.exp(9.550426 - 5723.265 * b + 3.53068 * a - 0.00728332 * T)
    return torch.where(T >= 273.15, warm, cold)


def tsat_co2(P):
    """CO2 saturation temperature [K], Fanale et al. (1982) eq. 19 inverted;
    valid for P <= 518000 Pa."""
    A = 1.2264e12  # [Pa]
    B = -3167.8  # [K]
    return B / torch.log(as_tensor(P) / A)


def ozonelayer(P, Cmax: float = 8e-6):
    """Ozone concentration triangular in ln P: Cmax at 1600 Pa, zero at 100
    and 25500 Pa."""
    lnP = torch.log(as_tensor(P))
    P1 = 10.146433731146518  # ln(25500)
    P2 = 7.3777589082278725  # ln(1600)
    P3 = 4.605170185988092   # ln(100)
    upper = Cmax * (P1 - lnP) / (P1 - P2)
    lower = Cmax * (lnP - P3) / (P2 - P3)
    zero = torch.zeros((), dtype=lnP.dtype, device=lnP.device)
    out = torch.where((lnP >= P2) & (lnP <= P1), upper, zero)
    return torch.where((lnP >= P3) & (lnP < P2), lower, out)


def condensible_profile(adiabat, fPsat):
    """Concentration fC(T, P) of a condensible: Psat(T) / (Psat(T) + P)
    below the adiabat's tropopause, frozen at its tropopause value above."""
    Tt, Pt = tropopause(adiabat)
    Pst = fPsat(as_tensor(Tt))

    def fC(T, P):
        P = as_tensor(P)
        Ps = fPsat(T)
        below = Ps / (Ps + P)
        above = (Pst / (Pt + Pst)).to(below.device, below.dtype)
        return torch.where(P >= Pt, below, above)

    return fC


def haircut(T, P, fTsat):
    """The temperatures floored at the saturation temperature fTsat(P)."""
    return torch.maximum(as_tensor(T), fTsat(as_tensor(P)))


def rayleigh_co2(nu, Ps, g, theta):
    """CO2 Rayleigh-scattering albedo: the plane albedo of a purely
    scattering layer over a black surface, ((0.5 - gam mu) beta + f) /
    (1 + f), beta = 1 - exp(-tau / mu), f = gam tau, gam = 3/4 (the JAX
    package's form, not the reference's unfinished one)."""
    lam = nu2lam(as_tensor(nu)) * 1e6  # micrometres
    tau0 = 1.527 * (1.0 / lam**4) * (1.0 + 0.013 / lam**2)
    tau0 = tau0 * 8.7 / (93.0 * P_ATM)
    tau = (Ps / g) * tau0
    gam = 0.75
    mu = torch.cos(as_tensor(theta))
    beta = 1.0 - torch.exp(-tau / mu)
    f = gam * tau
    return ((0.5 - gam * mu) * beta + f) / (1.0 + f)

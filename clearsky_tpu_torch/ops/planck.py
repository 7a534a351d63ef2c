"""Radiation primitives: spectral unit conversions, the Planck law and its
derivative, and the Schwarzschild right-hand sides.

Counterpart of ``clearsky_tpu.ops.planck``. Every function is elementwise on
broadcasting tensors (or Python numbers where no tensor function is needed)
and computes in the dtype and on the device of its inputs.
"""

from __future__ import annotations

import math

import torch

from ..constants import C_LIGHT, H_PLANCK, K_BOLTZ, SIGMA_SB, N_AVOGADRO, C2_RADIATION

__all__ = [
    "nu2f",
    "f2nu",
    "nu2lam",
    "lam2nu",
    "lam2f",
    "f2lam",
    "planck",
    "normplanck",
    "dplanck",
    "stefanboltzmann",
    "equilibrium_temperature",
    "equilibrium_temperature_luminosity",
    "dtau_dP",
    "transmittance",
    "schwarzschild_dIdz",
    "schwarzschild_dIdP",
    "absorption_dIdP",
    "emission_dIdP",
]


def nu2f(nu):
    """Wavenumber [cm^-1] to frequency [1/s]."""
    return 100.0 * C_LIGHT * nu


def f2nu(f):
    """Frequency [1/s] to wavenumber [cm^-1]."""
    return f / (100.0 * C_LIGHT)


def nu2lam(nu):
    """Wavenumber [cm^-1] to wavelength [m]."""
    return 0.01 / nu


def lam2nu(lam):
    """Wavelength [m] to wavenumber [cm^-1]."""
    return 0.01 / lam


def lam2f(lam):
    """Wavelength [m] to frequency [1/s]."""
    return C_LIGHT / lam


def f2lam(f):
    """Frequency [1/s] to wavelength [m] (c / f, the inverse of :func:`lam2f`)."""
    return C_LIGHT / f


def planck(nu, T):
    """Blackbody intensity [W/m^2/cm^-1/sr] at wavenumber nu [cm^-1], temp T [K].

    Underflow-safe form ``p e^{-x} / (1 - e^{-x})``, with the exponent formed
    from the pre-folded radiation constant (the float32 intermediate ``k T``
    would underflow when squared).
    """
    nu_m = 100.0 * nu
    x = C2_RADIATION * nu / T
    p = 2.0 * H_PLANCK * C_LIGHT**2 * nu_m**3
    em = torch.exp(-x)
    return 100.0 * p * em / (-torch.expm1(-x))


def normplanck(nu, T):
    """planck normalized by sigma T^4 [1/cm^-1/sr]."""
    return planck(nu, T) / stefanboltzmann(T)


def dplanck(nu, T):
    """dB/dT [W/m^2/cm^-1/sr/K].

    Folded as ``(2 h c^2 nu^3) (x / T) e^{-x} / (1 - e^{-x})^2``: the bare
    prefactor 2 h^2 c^3 is 2.35e-41, below float32's normal range (zero
    where subnormals flush), so it is never formed.
    """
    nu_m = 100.0 * nu
    x = C2_RADIATION * nu / T
    em = torch.exp(-x)
    frac = em / torch.square(-torch.expm1(-x))
    p = (2.0 * H_PLANCK * C_LIGHT**2 * nu_m**3) * (x / T)
    return 100.0 * p * frac


def stefanboltzmann(T):
    """sigma T^4 [W/m^2]."""
    return SIGMA_SB * T**4


def equilibrium_temperature(F, A):
    """Planetary equilibrium temperature [K] from stellar flux F [W/m^2] and albedo A."""
    return ((1.0 - A) * F / (4.0 * SIGMA_SB)) ** 0.25


def equilibrium_temperature_luminosity(L, A, R):
    """Equilibrium temperature [K] from luminosity L [W], albedo A and distance R [m]."""
    return (L * (1.0 - A) / (16.0 * SIGMA_SB * math.pi * R**2)) ** 0.25


def dtau_dP(sigma, g, mu):
    """dtau/dP [1/Pa] = 1e-4 sigma Na / (mu g)."""
    return 1e-4 * sigma * N_AVOGADRO / (mu * g)


def transmittance(tau):
    """e^{-tau}."""
    return torch.exp(-tau)


def schwarzschild_dIdz(I, nu, sigma, T, P):
    """dI/dz [per m], the Schwarzschild equation in height."""
    return 1e-4 * sigma * (P / (K_BOLTZ * T)) * (planck(nu, T) - I)


def schwarzschild_dIdP(I, nu, sigma, g, mu, T):
    """dI/dP, the Schwarzschild equation in pressure."""
    return 1e-4 * sigma * (N_AVOGADRO / (mu * g)) * (planck(nu, T) - I)


def absorption_dIdP(I, sigma, g, mu):
    """The absorption term of dI/dP alone (no emission)."""
    return -1e-4 * sigma * (N_AVOGADRO / (mu * g)) * I


def emission_dIdP(nu, sigma, g, mu, T):
    """The emission term of dI/dP alone."""
    return 1e-4 * sigma * (N_AVOGADRO / (mu * g)) * planck(nu, T)

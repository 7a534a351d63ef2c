"""TIPS intensity scaling and Doppler/Lorentz/Voigt line shapes, and the
sub-Lorentzian CO2 far wing (Perrin and Hartmann's chi factor).

Counterpart of ``clearsky_tpu.ops.lineshape`` (HITRAN units: cm^-1,
cm^2/molecule); every function is elementwise on broadcasting tensors.
"""

from __future__ import annotations

import math

import torch

from ..constants import C2_RADIATION, T_REF_HITRAN, C_LIGHT, R_GAS, P_ATM, TIPS_TMIN, TIPS_TMAX
from .faddeeva import wofz_re

__all__ = [
    "cheb_qref_q",
    "scale_intensity",
    "alpha_doppler",
    "gamma_lorentz",
    "fdoppler",
    "florentz",
    "fvoigt",
    "fvoigt_ref",
    "doppler_xsec",
    "lorentz_xsec",
    "voigt_xsec",
    "chi_phco2",
    "phco2_xsec",
]

_SQRT_PI = 1.7724538509055159
_SQRT_LN2 = 0.8325546111576977  # sqrt(ln 2)


def cheb_qref_q(T, coeffs):
    """Qref/Q(T) from the TIPS Chebyshev fit, batched over lines.

    ``coeffs`` [..., ncheb] are the zero-padded fit coefficients of Q/Qref.
    The argument is clamped to the fit's [TIPS_TMIN, TIPS_TMAX] range, so an
    out-of-range temperature holds Q at the edge value instead of letting the
    Chebyshev sum diverge (possibly negative).
    """
    n = coeffs.shape[-1]
    tau = torch.clamp(2.0 * (T - TIPS_TMIN) / (TIPS_TMAX - TIPS_TMIN) - 1.0, -1.0, 1.0)
    c1 = torch.ones_like(tau)
    c2 = tau
    y = coeffs[..., 0] * c1
    if n > 1:
        y = y + coeffs[..., 1] * c2
    for k in range(2, n):
        c3 = 2.0 * tau * c2 - c1
        y = y + coeffs[..., k] * c3
        c1, c2 = c2, c3
    return 1.0 / y


def scale_intensity(S, nu_l, Epp, qref_q, T):
    """HITRAN line-intensity temperature scaling.

    S(T) = S (Qref/Q(T)) [e^{-c2 Epp/T}(1 - e^{-c2 nu/T})]
                         / [e^{-c2 Epp/Tref}(1 - e^{-c2 nu/Tref})]
    """
    a = -C2_RADIATION * Epp
    b = -C2_RADIATION * nu_l
    n = torch.exp(a / T) * (-torch.expm1(b / T))
    d = torch.exp(a / T_REF_HITRAN) * (-torch.expm1(b / T_REF_HITRAN))
    return S * qref_q * (n / d)


def alpha_doppler(nu_l, mu, T):
    """Doppler 1/e half-width alpha = (nu_l / c) sqrt(2 R T / mu)."""
    return (nu_l / C_LIGHT) * torch.sqrt(2.0 * R_GAS * T / mu)


def gamma_lorentz(ga, gs, na, T, P, Pp):
    """Pressure-broadened Lorentz HWHM [cm^-1]; pressures in Pa."""
    return ((T_REF_HITRAN / T) ** na) * (ga * (P - Pp) + gs * Pp) / P_ATM


def fdoppler(dnu, alpha):
    """Doppler (gaussian) profile at distance dnu = nu - nu_l."""
    return torch.exp(-(dnu * dnu) / (alpha * alpha)) / (alpha * _SQRT_PI)


def florentz(dnu, gamma):
    """Lorentz profile at distance dnu."""
    return gamma / (math.pi * (dnu * dnu + gamma * gamma))


def fvoigt(dnu, alpha, gamma):
    """Voigt profile Re w((dnu + i gamma)/alpha) / (alpha sqrt(pi)), alpha the
    Gaussian 1/e half-width (the internally consistent convention of
    ``clearsky_tpu.ops.lineshape.fvoigt``)."""
    beta = 1.0 / alpha
    return (beta / _SQRT_PI) * wofz_re(dnu * beta, gamma * beta)


def fvoigt_ref(dnu, alpha, gamma):
    """The reference's HWHM-convention Voigt profile on the 1/e width alpha:
    x = sqrt(ln2) dnu/alpha, y = sqrt(ln2) gamma/alpha, sqrt(ln2/pi)/alpha
    Re w(x + iy); the same as ``fvoigt(dnu, alpha/sqrt(ln2), gamma)``
    (``clearsky_tpu.ops.lineshape.fvoigt_ref``)."""
    x = _SQRT_LN2 * dnu / alpha
    y = _SQRT_LN2 * gamma / alpha
    return (_SQRT_LN2 / (alpha * _SQRT_PI)) * wofz_re(x, y)


def doppler_xsec(dnu, S, alpha):
    """Doppler cross-section contribution S fdoppler(dnu, alpha)."""
    return S * fdoppler(dnu, alpha)


def lorentz_xsec(dnu, S, gamma):
    """Lorentz cross-section contribution S florentz(dnu, gamma)."""
    return S * florentz(dnu, gamma)


def voigt_xsec(dnu, S, alpha, gamma):
    """Voigt cross-section contribution S fvoigt(dnu, alpha, gamma)."""
    return S * fvoigt(dnu, alpha, gamma)


def chi_phco2(dnu, T):
    """Perrin and Hartmann's sub-Lorentzian chi factor of the CO2 far wing:
    1 below |dnu| = 3 cm^-1, then exponential decays with breakpoints at 30
    and 120 cm^-1 and rates B1(T), B2(T). Three exponentials and a
    selection, as ``clearsky_tpu.ops.lineshape.chi_phco2``."""
    adnu = torch.abs(dnu)
    B1 = 0.0888 - 0.16 * torch.exp(-0.0041 * T)
    B2 = 0.0526 * torch.exp(-0.00152 * T)
    chi2 = torch.exp(-B1 * (adnu - 3.0))
    chi3 = torch.exp(-B1 * 27.0 - B2 * (adnu - 30.0))
    chi4 = torch.exp(-B1 * 27.0 - B2 * 90.0 - 0.0232 * (adnu - 120.0))
    one = torch.ones((), dtype=chi2.dtype, device=chi2.device)
    return torch.where(adnu < 3.0, one,
                       torch.where(adnu < 30.0, chi2, torch.where(adnu < 120.0, chi3, chi4)))


def phco2_xsec(dnu, T, S, alpha, gamma):
    """Sub-Lorentzian CO2 cross-section: the Voigt profile with gamma scaled
    by chi(dnu, T)."""
    return voigt_xsec(dnu, S, alpha, chi_phco2(dnu, T) * gamma)

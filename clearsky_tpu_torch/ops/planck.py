"""Planck law and the wavenumber-wavelength conversion. Counterpart of
``clearsky_tpu.ops.planck.planck`` and ``nu2lam``."""

from __future__ import annotations

import torch

from ..constants import C_LIGHT, H_PLANCK, C2_RADIATION

__all__ = ["planck", "nu2lam"]


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


def nu2lam(nu):
    """Wavenumber [cm^-1] to wavelength [m]."""
    return 0.01 / nu

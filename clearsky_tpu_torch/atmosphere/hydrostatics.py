"""Hydrostatic pressure and altitude.

Counterpart of ``clearsky_tpu.atmosphere.hydrostatics``: the scale height,
dlnP/dz = -mu g / (R T) integrated on the host (fixed-grid RK4), its
inversion for the altitude, and the :class:`Hydrostatic` profile, integrated
once and interpolated.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..constants import R_GAS, P_MIN
from ..utils.device import as_tensor
from ..utils.grids import logrange
from ..utils.interp import interp_linear
from ..utils.ode import rk4_dense, rk4_to
from ..utils.rootfind import regula_falsi

__all__ = ["scale_height", "hydrostatic", "altitude", "Hydrostatic"]


def scale_height(g, mu, T):
    """Atmospheric scale height R T / (mu g) [m]."""
    return R_GAS * T / (mu * g)


def _dlnPdz(z, lnP, p):
    """dlnP/dz = -mu g / (R T), 0 below P_MIN, the pressure held at Ps."""
    Ps, g, fT, fmu = p
    P = np.exp(lnP)
    if P < P_MIN:
        return 0.0
    P = min(P, Ps)
    T = float(fT(P))
    mu = float(fmu(T, P))
    return -mu * g / (R_GAS * T)


def hydrostatic(z, Ps, g, fT, fmu, n: int = 512):
    """Hydrostatic pressure [Pa] at altitude z [m]; ``fT(P)`` and
    ``fmu(T, P)`` are called on floats."""
    if z < 0:
        raise ValueError(f"cannot compute pressure at negative altitude {z} m")
    if not Ps > P_MIN:
        raise ValueError(f"pressure cannot be less than {P_MIN} Pa")
    if z == 0:
        return float(Ps)
    return float(np.exp(rk4_to(_dlnPdz, np.log(Ps), 0.0, z, (Ps, g, fT, fmu), n=n)))


def altitude(P, Ps, g, fT, fmu):
    """Altitude [m] where the hydrostatic pressure is P."""
    if not P < Ps:
        raise ValueError("surface pressure must be greater than pressure aloft")
    z1, z2 = 0.0, 1e2
    P2 = hydrostatic(z2, Ps, g, fT, fmu)
    while P2 > P:
        z1, z2 = z2, z2 * 2
        P2 = hydrostatic(z2, Ps, g, fT, fmu)
    return regula_falsi(
        lambda z, _: np.log(hydrostatic(z, Ps, g, fT, fmu)) - np.log(P), z1, z2
    )


@dataclasses.dataclass(frozen=True, eq=False)
class Hydrostatic:
    """Pressure against altitude, integrated once on a stretched grid
    (float64, host) and interpolated: callable z -> P [Pa], held at the end
    values outside the grid."""

    z: torch.Tensor
    lnP: torch.Tensor
    zt: float = 0.0

    @classmethod
    def create(cls, Ps, Pt, g, fT, fmu, N: int = 100) -> "Hydrostatic":
        zt = altitude(Pt, Ps, g, fT, fmu)
        z = logrange(0.0, zt, N)
        lnP = rk4_dense(_dlnPdz, np.log(Ps), z, (Ps, g, fT, fmu))
        return cls(z=torch.as_tensor(z), lnP=torch.as_tensor(lnP), zt=float(zt))

    def __call__(self, z):
        z = as_tensor(z)
        return torch.exp(interp_linear(z, self.z.to(z.device, z.dtype),
                                       self.lnP.to(z.device, z.dtype), extrapolate=False))

    def altitude(self, P):
        """The altitude where the profile's pressure is P."""
        return float(np.interp(-np.log(P), -self.lnP.numpy(), self.z.numpy()))

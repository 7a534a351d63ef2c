"""Keplerian orbital mechanics.

Counterpart of ``clearsky_tpu.orbital.orbits``: every function takes
tensors or numbers and broadcasts (numbers become float64 tensors on the
CPU, :func:`..utils.device.as_tensor`; tensors keep their dtype and
device). Kepler's equation is solved by a fixed count of Newton steps, as
the JAX package solves it, not by the reference's bracketing regula falsi.
"""

from __future__ import annotations

import math

import torch

from ..constants import G_GRAV
from ..utils.device import as_tensor, placement

__all__ = [
    "periapsis",
    "apoapsis",
    "semimajoraxis",
    "eccentricity",
    "meananomaly",
    "trueanomaly",
    "eccentricanomaly",
    "orbitalperiod",
    "orbitaldistance",
    "orbit",
]

_KEPLER_ITERS = 20


def _like(*xs, dtype=None, device=None) -> tuple[torch.dtype, torch.device]:
    """(dtype, device) of a constructed grid: the arguments', else those of
    the first tensor among ``xs``, else :func:`..utils.device.placement`'s."""
    t = next((x for x in xs if isinstance(x, torch.Tensor)), None)
    if t is not None:
        dtype = t.dtype if dtype is None else dtype
        device = t.device if device is None else device
    return placement(dtype, device)


def periapsis(a, e):
    """Closest-approach distance a (1 - e)."""
    return a * (1.0 - e)


def apoapsis(a, e):
    """Farthest distance a (1 + e)."""
    return a * (1.0 + e)


def semimajoraxis(T, m):
    """Semi-major axis [m] from the period T [s] and the host's mass m [kg]."""
    return (G_GRAV * m * T**2 / (4.0 * math.pi**2)) ** (1.0 / 3.0)


def eccentricity(rp, ra):
    """Eccentricity from the periapsis and apoapsis distances."""
    return (ra - rp) / (ra + rp)


def meananomaly(E, e):
    """Mean anomaly M = E - e sin E."""
    return E - e * torch.sin(as_tensor(E))


def orbitalperiod(a, m):
    """Orbital period 2 pi sqrt(a^3 / (G m)) [s]."""
    return 2.0 * math.pi * torch.sqrt(as_tensor(a**3 / (G_GRAV * m)))


def _kepler_newton(M, e):
    """E with M = E - e sin E: ``_KEPLER_ITERS`` Newton steps from
    E0 = M + e sin M."""
    M, e = as_tensor(M), as_tensor(e)
    E = M + e * torch.sin(M)
    for _ in range(_KEPLER_ITERS):
        E = E - (E - e * torch.sin(E) - M) / (1.0 - e * torch.cos(E))
    return E


def eccentricanomaly(t, a, m, e):
    """Eccentric anomaly at time t [s] (periapsis at t = 0)."""
    T = orbitalperiod(a, m)
    M = 2.0 * math.pi * torch.remainder(as_tensor(t), T) / T
    return _kepler_newton(M, e)


def _trueanomaly_from_E(E, e):
    """True anomaly from the eccentric anomaly, in [0, 2 pi)."""
    E, e = as_tensor(E), as_tensor(e)
    f = 2.0 * torch.arctan(torch.sqrt((1.0 + e) / (1.0 - e)) * torch.tan(E / 2.0))
    return torch.where(f < 0, f + 2.0 * math.pi, f)


def trueanomaly(*args):
    """True anomaly: ``trueanomaly(E, e)`` or ``trueanomaly(t, a, m, e)``."""
    if len(args) == 2:
        return _trueanomaly_from_E(*args)
    if len(args) == 4:
        t, a, m, e = args
        return _trueanomaly_from_E(eccentricanomaly(t, a, m, e), e)
    raise TypeError("trueanomaly takes (E, e) or (t, a, m, e)")


def orbitaldistance(*args):
    """Host-planet distance: ``orbitaldistance(a, f, e)`` from the true
    anomaly, or ``orbitaldistance(t, a, m, e)`` from the time (periapsis at
    t = 0)."""
    if len(args) == 3:
        a, f, e = args
        return a * (1.0 - e**2) / (1.0 + e * torch.cos(as_tensor(f)))
    if len(args) == 4:
        t, a, m, e = args
        return orbitaldistance(a, trueanomaly(t, a, m, e), e)
    raise TypeError("orbitaldistance takes (a, f, e) or (t, a, m, e)")


def orbit(a, m, e, N: int = 1000, dtype=None, device=None):
    """One orbit sampled at N times from periapsis: (t, r, f); the samples in
    ``dtype`` on ``device`` (by default the arguments', see :func:`_like`)."""
    dtype, device = _like(a, m, e, dtype=dtype, device=device)
    T = orbitalperiod(a, m).to(dtype=dtype, device=device)
    t = T * torch.arange(N, dtype=dtype, device=device) / N
    f = trueanomaly(t, a, m, e)
    return t, orbitaldistance(a, f, e), f

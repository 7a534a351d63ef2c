"""Insolation: diurnally and annually averaged stellar flux factors.

Counterpart of ``clearsky_tpu.orbital.insolation``. The annual average is a
fixed composite Gauss-Legendre rule over one period, as the JAX package
takes it (the reference integrates adaptively). Every function broadcasts;
numbers become float64 CPU tensors, tensors keep their dtype and device,
and a constructed grid follows :func:`.orbits._like`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.device import as_tensor
from .orbits import orbitalperiod, trueanomaly, orbitaldistance, _like

__all__ = [
    "substellarlatitude",
    "hourangle",
    "diurnalfluxfactor",
    "diurnalfluxfactors",
    "annualfluxfactor",
    "annualfluxfactors",
]


def substellarlatitude(f, gamma):
    """Latitude of the substellar point at solar longitude f, obliquity gamma."""
    return torch.arcsin(torch.cos(as_tensor(f)) * torch.sin(as_tensor(gamma)))


def hourangle(theta, theta_s):
    """Sunrise/sunset hour angle at latitude theta, substellar latitude
    theta_s, clamped to 0 (polar night) and pi (polar day).

    The product of cosines is floored at 1e-30: at float32's nearest pi/2
    it comes out negative (~-4.4e-8), which would flip the clamp.
    """
    theta, theta_s = as_tensor(theta), as_tensor(theta_s)
    denom = torch.clamp(torch.cos(theta) * torch.cos(theta_s), min=1e-30)
    x = -torch.sin(theta) * torch.sin(theta_s) / denom
    return torch.arccos(torch.clamp(x, -1.0, 1.0))


def _diurnal_factor(theta, theta_s):
    """Diurnal average of the cosine of the stellar zenith angle."""
    theta, theta_s = as_tensor(theta), as_tensor(theta_s)
    h = hourangle(theta, theta_s)
    return (torch.sin(h) * torch.cos(theta) * torch.cos(theta_s)
            + h * torch.sin(theta) * torch.sin(theta_s)) / math.pi


def diurnalfluxfactor(*args):
    """Diurnally averaged fraction of the incoming stellar flux:
    ``(theta, theta_s)``, latitude and substellar latitude;
    ``(theta, f, gamma)``, solar longitude and obliquity; or
    ``(t, a, m, e, theta, gamma, p)``, an elliptical orbit with precession
    angle p and the (a / r)^2 distance factor."""
    if len(args) == 2:
        return _diurnal_factor(*args)
    if len(args) == 3:
        theta, f, gamma = args
        return _diurnal_factor(theta, substellarlatitude(f, gamma))
    if len(args) == 7:
        t, a, m, e, theta, gamma, p = args
        f = trueanomaly(t, a, m, e)
        r = orbitaldistance(a, f, e)
        return diurnalfluxfactor(theta, f - p, gamma) * (a / r) ** 2
    raise TypeError("diurnalfluxfactor takes (theta, theta_s), (theta, f, gamma), or "
                    "(t, a, m, e, theta, gamma, p)")


def diurnalfluxfactors(*args, nf: int = 251, nt: int = 251, ntheta: int = 181,
                       dtype=None, device=None):
    """Grids of diurnally averaged flux factors: ``(gamma)``, a circular
    orbit, gives (f, theta, F[ntheta, nf]); ``(a, m, e, gamma, p)``, an
    elliptical one over a period, gives (t, theta, F[ntheta, nt])."""
    dtype, device = _like(*args, dtype=dtype, device=device)
    theta = torch.linspace(-math.pi / 2, math.pi / 2, ntheta, dtype=dtype, device=device)
    if len(args) == 1:
        (gamma,) = args
        f = torch.linspace(0.0, 2.0 * math.pi, nf, dtype=dtype, device=device)
        return f, theta, diurnalfluxfactor(theta[:, None], f[None, :], gamma)
    if len(args) == 5:
        a, m, e, gamma, p = args
        T = float(orbitalperiod(a, m))
        t = torch.linspace(0.0, T, nt, dtype=dtype, device=device)
        F = diurnalfluxfactor(t[None, :], a, m, e, theta[:, None], gamma, p)
        return t, theta, F
    raise TypeError("diurnalfluxfactors takes (gamma) or (a, m, e, gamma, p)")


def _annual_quad_nodes(npanel: int, order: int):
    """Composite Gauss-Legendre nodes and weights on [0, 1] (host float64)."""
    x, w = np.polynomial.legendre.leggauss(order)
    edges = np.linspace(0.0, 1.0, npanel + 1)
    mid = 0.5 * (edges[:-1] + edges[1:])
    half = 0.5 * np.diff(edges)
    return (mid[:, None] + half[:, None] * x[None, :]).ravel(), \
        (half[:, None] * w[None, :]).ravel()


def annualfluxfactor(e, theta, gamma, p, npanel: int = 32, order: int = 8):
    """Annually averaged flux factor at latitude theta on an elliptical orbit
    (a = m = 1): ``npanel`` panels of an ``order``-point Gauss-Legendre rule
    over one period; broadcasts over theta."""
    dtype, device = _like(theta, e, gamma, p)
    x, w = (torch.as_tensor(v, dtype=dtype, device=device)
            for v in _annual_quad_nodes(npanel, order))
    t = x * float(orbitalperiod(1.0, 1.0))
    theta = torch.as_tensor(theta, dtype=dtype, device=device)
    F = diurnalfluxfactor(t, 1.0, 1.0, e, theta[..., None], gamma, p)
    return torch.sum(F * w, dim=-1)


def annualfluxfactors(e, gamma, p, ntheta: int = 181, dtype=None, device=None):
    """Annually averaged flux factors at ``ntheta`` latitudes from pole to
    pole: (theta, F[ntheta])."""
    dtype, device = _like(e, gamma, p, dtype=dtype, device=device)
    theta = torch.linspace(-math.pi / 2, math.pi / 2, ntheta, dtype=dtype, device=device)
    return theta, annualfluxfactor(e, theta, gamma, p)

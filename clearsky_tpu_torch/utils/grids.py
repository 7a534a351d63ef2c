"""Grid construction, the trapezoid integral, derivatives and the sqrt(P)
pressure coordinates.

Node placement is host-side numpy (set-up work); ``trapz``, ``meshgrid``,
``deriv`` and the coordinate transforms run on tensors. Counterpart of
``clearsky_tpu.utils.grids``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["chebygrid", "pressuregrid", "logrange", "trapz", "meshgrid", "deriv", "p2omega",
           "omega2p", "domega_fac", "p2iota", "iota2p", "diota_fac"]


def chebygrid(a: float, b: float, n: int) -> np.ndarray:
    """Chebyshev-extreme (Gauss-Lobatto) points on [a, b], ascending."""
    if n < 2:
        raise ValueError("chebygrid needs n >= 2")
    k = np.arange(n)
    x = -np.cos(np.pi * k / (n - 1))
    return a + (b - a) * (x + 1.0) / 2.0


def pressuregrid(p_top: float, p_surf: float, n: int) -> np.ndarray:
    """Chebyshev-spaced log-pressure grid from top to surface, ascending [Pa]."""
    if not p_surf > p_top:
        raise ValueError("p_surf must exceed p_top")
    if n < 3:
        raise ValueError("need n >= 3")
    return np.exp(chebygrid(np.log(p_top), np.log(p_surf), n))


def logrange(a: float, b: float, n: int = 101, gamma: float = 1.0) -> np.ndarray:
    """Stretched range with logarithmic clustering toward ``a``."""
    return ((10.0 ** np.linspace(0.0, gamma, n)) - 1.0) * (b - a) / (10.0**gamma - 1.0) + a


def trapz(x, y, axis: int = -1):
    """Trapezoid-rule integral of y(x) along ``axis``; ``y`` may be batched."""
    return torch.trapezoid(y, x, dim=axis)


def meshgrid(x, y):
    """Matrix-style meshgrid: X, Y of shape [len(y), len(x)]."""
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    X = torch.ones((y.shape[0], 1), dtype=x.dtype, device=x.device) * x.reshape(1, -1)
    Y = y.reshape(-1, 1) * torch.ones((1, x.shape[0]), dtype=y.dtype, device=y.device)
    return X, Y


def _quaddiff_deriv(x, x1, x2, x3, y1, y2, y3):
    """First derivative at x of the parabola through three points."""
    z1 = x1**2 - x2**2
    z2 = x2**2 - x3**2
    w = z1 / z2
    b = (y1 - y2 - (y2 - y3) * w) / (x1 - x2 - (x2 - x3) * w)
    a = (y2 - y3 - b * (x2 - x3)) / z2
    return 2.0 * a * x + b


def deriv(x, y):
    """Derivative of y(x) on a (possibly nonuniform) grid: one-sided at the
    ends, the three-point parabola inside."""
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    d_first = (y[1] - y[0]) / (x[1] - x[0])
    d_last = (y[-1] - y[-2]) / (x[-1] - x[-2])
    d_mid = _quaddiff_deriv(x[1:-1], x[:-2], x[1:-1], x[2:], y[:-2], y[1:-1], y[2:])
    return torch.cat([d_first[None], d_mid, d_last[None]])


# transformed pressure coordinates: sqrt(P) puts resolution in the upper
# atmosphere for column integrations

def p2omega(P):
    """Upward coordinate omega = -sqrt(P)."""
    return -torch.sqrt(torch.as_tensor(P))


def omega2p(omega):
    """Inverse of :func:`p2omega`."""
    return omega * omega


def domega_fac(P):
    """Jacobian factor |dP/domega| = 2 sqrt(P)."""
    return 2.0 * torch.sqrt(torch.as_tensor(P))


def p2iota(P):
    """Downward coordinate iota = +sqrt(P)."""
    return torch.sqrt(torch.as_tensor(P))


def iota2p(iota):
    """Inverse of :func:`p2iota`."""
    return iota * iota


def diota_fac(P):
    """Jacobian factor of the iota coordinate, 2 sqrt(P)."""
    return 2.0 * torch.sqrt(torch.as_tensor(P))

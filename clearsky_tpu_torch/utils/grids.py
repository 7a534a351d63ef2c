"""Grid construction and the trapezoid integral.

Node placement is host-side numpy (set-up work); ``trapz`` runs on tensors.
Counterpart of ``clearsky_tpu.utils.grids``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["chebygrid", "pressuregrid", "logrange", "trapz"]


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

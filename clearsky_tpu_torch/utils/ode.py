"""Fixed-grid RK4 for set-up-time profiles (hydrostatic balance, moist
adiabats), on the host in numpy.

Counterpart of ``clearsky_tpu.utils.ode``: dense fixed-grid RK4 with
substeps; accuracy comes from the resolution, and the profile is then
interpolated linearly.
"""

from __future__ import annotations

import numpy as np

__all__ = ["rk4_dense", "rk4_to"]


def _rk4_step(f, x, y, h, p):
    k1 = f(x, y, p)
    k2 = f(x + 0.5 * h, y + 0.5 * h * k1, p)
    k3 = f(x + 0.5 * h, y + 0.5 * h * k2, p)
    k4 = f(x + h, y + h * k3, p)
    return y + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


def rk4_dense(f, y0: float, x: np.ndarray, p=None, substeps: int = 8) -> np.ndarray:
    """Integrate dy/dx = f(x, y, p) from x[0]; y on every node of x, with
    ``substeps`` RK4 steps inside each interval."""
    x = np.asarray(x, dtype=float)
    y = np.empty_like(x)
    y[0] = y0
    yi = float(y0)
    for i in range(len(x) - 1):
        h = (x[i + 1] - x[i]) / substeps
        xi = x[i]
        for _ in range(substeps):
            yi = _rk4_step(f, xi, yi, h, p)
            xi += h
        y[i + 1] = yi
    return y


def rk4_to(f, y0: float, x1: float, x2: float, p=None, n: int = 256) -> float:
    """Integrate dy/dx = f(x, y, p) from x1 to x2 in n RK4 steps; y(x2)."""
    h = (x2 - x1) / n
    y = float(y0)
    x = x1
    for _ in range(n):
        y = _rk4_step(f, x, y, h, p)
        x += h
    return y

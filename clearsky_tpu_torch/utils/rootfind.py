"""Root finding on the host, for set-up work.

Counterpart of the host solvers of ``clearsky_tpu.utils.rootfind``:
bracketing false position (Illinois) and the secant method on Python
floats. The traced bisection of the JAX package (``bisect_jax``) serves its
compiled orbital code and is not ported.
"""

from __future__ import annotations

import numpy as np

__all__ = ["regula_falsi", "secant"]


def _terminate(a, b, tol):
    return abs(a - b) < (tol + tol * abs(b))


def regula_falsi(F, x1, x2, p=None, tol: float = 1e-6):
    """Bracketing false-position root of F(x, p) (Illinois variant): the
    stale endpoint's ordinate is halved when the same side moves twice, and
    the last false-position estimate is returned."""
    if x1 == x2:
        raise ValueError("starting points must not be identical")
    y1 = F(x1, p)
    if y1 == 0:
        return x1
    y2 = F(x2, p)
    if y2 == 0:
        return x2
    if np.sign(y1) == np.sign(y2):
        raise ValueError("regula falsi non-bracketing")
    xm = x1
    side = 0
    for _ in range(10000):
        xm_prev = xm
        xm = x1 - y1 * (x2 - x1) / (y2 - y1)
        ym = F(xm, p)
        if ym == 0 or _terminate(xm_prev, xm, tol):
            return xm
        if np.sign(ym) == np.sign(y1):
            x1, y1 = xm, ym
            if side == 1:
                y2 *= 0.5
            side = 1
        else:
            x2, y2 = xm, ym
            if side == -1:
                y1 *= 0.5
            side = -1
    return xm


def secant(F, x1, x2, p=None, tol: float = 1e-6):
    """Secant root of F(x, p) from the two starting points."""
    if x1 == x2:
        raise ValueError("starting points must not be identical")
    y1 = F(x1, p)
    if y1 == 0:
        return x1
    y2 = F(x2, p)
    if y2 == 0:
        return x2
    x3 = 0.0
    n = 0
    while (not (_terminate(x1, x2, tol) and _terminate(y1, y2, tol))) or (n < 2):
        x3 = x1 - y1 * (x2 - x1) / (y2 - y1)
        y3 = F(x3, p)
        x1, x2 = x2, x3
        y1, y2 = y2, y3
        n += 1
        if n > 10000:
            break
    return x3

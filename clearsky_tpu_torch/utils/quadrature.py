"""Gaussian quadrature nodes and weights (host-side numpy, cached).

Counterpart of ``clearsky_tpu.utils.quadrature``; numpy only, so it is the
same code.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

__all__ = ["gauss_legendre", "gauss_lobatto", "stream_nodes", "lobatto_unit_nodes"]


@lru_cache(maxsize=None)
def gauss_legendre(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre nodes/weights on [-1, 1]."""
    x, w = np.polynomial.legendre.leggauss(n)
    return x, w


@lru_cache(maxsize=None)
def gauss_lobatto(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Lobatto nodes/weights on [-1, 1] (endpoints included).

    Interior nodes are the roots of P'_{n-1}; weights 2/(n(n-1) P_{n-1}(x)^2).
    """
    if n < 2:
        raise ValueError("gauss_lobatto needs n >= 2")
    if n == 2:
        return np.array([-1.0, 1.0]), np.array([1.0, 1.0])
    cP = np.zeros(n)
    cP[-1] = 1.0
    dP = np.polynomial.legendre.legder(cP)
    xi = np.polynomial.legendre.legroots(dP)
    x = np.concatenate([[-1.0], np.sort(xi), [1.0]])
    Pn1 = np.polynomial.legendre.legval(x, cP)
    w = 2.0 / (n * (n - 1) * Pn1**2)
    return x, w


@lru_cache(maxsize=None)
def lobatto_unit_nodes(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Lobatto nodes/weights shifted to [0, 1]."""
    x, w = gauss_lobatto(n)
    return (x + 1.0) / 2.0, w / 2.0


@lru_cache(maxsize=None)
def stream_nodes(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Hemispheric stream secants and weights for flux quadrature.

    Gauss-Legendre nodes mapped to zenith angle theta in [0, pi/2]; returns
    (m, W) with m_i = 1/cos(theta_i) and W_i = 2*pi*w_i*cos(theta_i)*sin(theta_i),
    so that sum_i W_i * I_i approximates the hemispheric flux integral.
    """
    x, w = gauss_legendre(n)
    theta = (np.pi / 2.0) * (x + 1.0) / 2.0
    wm = (np.pi / 2.0) * w / 2.0
    m = 1.0 / np.cos(theta)
    W = 2.0 * np.pi * wm * np.cos(theta) * np.sin(theta)
    return m, W

"""The benchmark's inputs, made from numbers and a seed: pressure levels,
columns, wavenumber grids, insolation factors and the samples the check
reads. Plain numpy, handed alike to the program and to the reference."""

from __future__ import annotations

import math

import numpy as np

from .catalog import BANDS

__all__ = ["R_GAS", "pressure_levels", "dry_adiabat", "line_grid", "annual_flux_factors",
           "van_der_corput", "surface_temperature", "sample_points", "rng"]

R_GAS = 8.31446262


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one purpose of one run: ``seed`` (any whole number
    up to a little over 2**31) and a fixed tag per purpose."""
    return np.random.default_rng([int(seed) & (2**64 - 1), *stream])


def pressure_levels(p_top: float, p_surf: float, n: int) -> np.ndarray:
    """``n`` levels from ``p_top`` to ``p_surf`` [Pa], ascending, at the
    Chebyshev-Lobatto points of ln P."""
    k = np.arange(n)
    x = -np.cos(np.pi * k / (n - 1))
    a, b = math.log(p_top), math.log(p_surf)
    return np.exp(a + (b - a) * (x + 1.0) / 2.0)


def dry_adiabat(P: np.ndarray, T_surf, p_surf: float, mu: float, cp: float,
                T_floor: float) -> np.ndarray:
    """Temperatures on P of a dry adiabat from a surface at T_surf (a number
    or a vector of them: one column each), floored at T_floor."""
    Ts = np.asarray(T_surf, np.float64)[..., None]
    return np.maximum(Ts * (P / p_surf) ** (R_GAS / (mu * cp)), T_floor)


def line_grid(line_nu: np.ndarray, n: int, cut: float) -> np.ndarray:
    """``n`` evenly spaced wavenumbers over the lines' span +- ``cut``
    (never below 1 cm^-1)."""
    return np.linspace(max(line_nu.min() - cut, 1.0), line_nu.max() + cut, n)


def _kepler(M: np.ndarray, e: float) -> np.ndarray:
    E = M + e * np.sin(M)
    for _ in range(8):
        E = E - (E - e * np.sin(E) - M) / (1.0 - e * np.cos(E))
    return E


def annual_flux_factors(e: float, gamma: float, p: float, n: int,
                        panels: int = 32, order: int = 8) -> np.ndarray:
    """Annually averaged insolation factors at ``n`` latitudes from pole to
    pole, on an orbit of eccentricity ``e``, obliquity ``gamma`` and
    precession ``p`` [rad]: the diurnal mean cosine of the stellar zenith
    angle times (a / r)^2, averaged over one period in time (a composite
    Gauss-Legendre rule of ``panels`` x ``order`` nodes)."""
    x, w = np.polynomial.legendre.leggauss(order)
    edges = np.linspace(0.0, 1.0, panels + 1)
    mid, half = 0.5 * (edges[:-1] + edges[1:]), 0.5 * np.diff(edges)
    t = (mid[:, None] + half[:, None] * x[None, :]).ravel()
    wt = (half[:, None] * w[None, :]).ravel()
    E = _kepler(2.0 * np.pi * t, e)
    f = 2.0 * np.arctan(np.sqrt((1.0 + e) / (1.0 - e)) * np.tan(E / 2.0))
    r = (1.0 - e * e) / (1.0 + e * np.cos(f))
    theta_s = np.arcsin(np.cos(f - p) * np.sin(gamma))
    theta = np.linspace(-np.pi / 2, np.pi / 2, n)[:, None]
    cc = np.maximum(np.cos(theta) * np.cos(theta_s), 1e-30)
    h = np.arccos(np.clip(-np.sin(theta) * np.sin(theta_s) / cc, -1.0, 1.0))
    F = (np.sin(h) * np.cos(theta) * np.cos(theta_s) + h * np.sin(theta) * np.sin(theta_s)) \
        / np.pi / r ** 2
    return (F * wt).sum(axis=1)


def van_der_corput(k) -> np.ndarray:
    """The base-2 radical inverse of each whole number in ``k``: 0, 1/2,
    1/4, 3/4, 1/8, ... Any 2^m consecutive numbers from a multiple of 2^m
    put one point in each of 2^m equal strata of [0, 1), and no two numbers
    below 2^53 share a point."""
    k = np.asarray(k, np.int64).copy()
    out = np.zeros(k.shape, np.float64)
    f = 0.5
    while np.any(k):
        out += f * (k & 1)
        k >>= 1
        f *= 0.5
    return out


def surface_temperature(seed: int, k, lo: float, hi: float) -> np.ndarray:
    """The surface temperature of the ``k``-th column of a run (a number or
    an array of them): the van der Corput sequence over [lo, hi), rotated by
    a seeded offset. Every column is a new one, every run of calls spreads
    evenly over [lo, hi) and so does the same work on every seed, and the
    seed changes every column."""
    u = rng(seed, 1).uniform(0.0, 1.0)
    return lo + (hi - lo) * np.mod(van_der_corput(k) + u, 1.0)


def sample_points(seed: int, grid: np.ndarray, k: int, tag: int = 2) -> np.ndarray:
    """Indices of ``k`` grid points the check compares: the point nearest each
    CO2 band centre inside the grid, then one seeded point in each of the
    remaining equal strata of the grid (sorted, unique)."""
    g = rng(seed, tag)
    centres = [c for c, _, _ in BANDS[2] if grid[0] <= c <= grid[-1]]
    fixed = [int(np.argmin(np.abs(grid - c))) for c in centres]
    m = max(1, k - len(fixed))
    edges = np.linspace(0, len(grid), m + 1).astype(np.int64)
    pick = edges[:-1] + (g.uniform(0.0, 1.0, m) * np.maximum(np.diff(edges), 1)).astype(np.int64)
    return np.unique(np.clip(np.concatenate([fixed, pick]), 0, len(grid) - 1))

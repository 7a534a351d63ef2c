"""Linear and Chebyshev interpolation.

Counterpart of ``clearsky_tpu.utils.interp``: ``interp_linear``,
``bilinear`` and the Chebyshev basis, coefficient transform and evaluation behind the baked
opacity tables. The float32 contractions here run with TF32 switched off
(:func:`full_float32`): ln sigma values of magnitude 50-90 lose ~1e-3 of
their value to TF32's 10-bit mantissa, which is a 5-10% error in sigma.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

__all__ = [
    "interp_linear",
    "bilinear",
    "full_float32",
    "cheb_basis",
    "cheb_coeff_matrix",
    "cheb2d_coeffs",
    "cheb2d_eval",
]


def interp_linear(x, xp, fp, extrapolate: bool = True):
    """Linear interpolation of fp(xp) at x, extrapolating with the edge slopes
    (``extrapolate=False``: clamping to the edge values instead).

    ``xp`` must be ascending. ``fp`` may be batched, [..., len(xp)], and the
    result has shape fp.shape[:-1] + x.shape.
    """
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x, right=True) - 1, 0, n - 2)
    x0 = xp[i]
    x1 = xp[i + 1]
    f0 = fp[..., i]
    f1 = fp[..., i + 1]
    t = (x - x0) / (x1 - x0)
    if not extrapolate:
        t = torch.clamp(t, 0.0, 1.0)
    return f0 + t * (f1 - f0)


def bilinear(x, y, xp, yp, fp, extrapolate: bool = True):
    """Bilinear interpolation of fp on the grid (xp, yp) at paired points (x, y).

    ``fp`` [..., len(xp), len(yp)]; ``x`` and ``y`` broadcast together. Outside
    the grid the edge cells extrapolate linearly (``extrapolate=False``:
    clamped to the edge values).
    """
    nx, ny = xp.shape[0], yp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x, right=True) - 1, 0, nx - 2)
    j = torch.clamp(torch.searchsorted(yp, y, right=True) - 1, 0, ny - 2)
    tx = (x - xp[i]) / (xp[i + 1] - xp[i])
    ty = (y - yp[j]) / (yp[j + 1] - yp[j])
    if not extrapolate:
        tx = torch.clamp(tx, 0.0, 1.0)
        ty = torch.clamp(ty, 0.0, 1.0)
    return (fp[..., i, j] * (1 - tx) * (1 - ty) + fp[..., i + 1, j] * tx * (1 - ty)
            + fp[..., i, j + 1] * (1 - tx) * ty + fp[..., i + 1, j + 1] * tx * ty)


@contextlib.contextmanager
def full_float32():
    """Float32 matrix products in full float32 (no TF32) inside the block.

    The process-wide setting is restored on exit, so a caller that allows
    TF32 elsewhere keeps it there (the per-call ``precision=`` pins of the
    JAX package). PyTorch refuses to read one of its two TF32 interfaces
    once the other was set, so the pin uses the one the process uses.
    """
    try:
        before = torch.get_float32_matmul_precision()
    except RuntimeError:  # the process set torch.backends.*.fp32_precision
        mm = torch.backends.cuda.matmul
        before = mm.fp32_precision
        mm.fp32_precision = "ieee"
        try:
            yield
        finally:
            mm.fp32_precision = before
        return
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


def cheb_basis(x, a: float, b: float, n: int):
    """Chebyshev polynomials T_0..T_{n-1} at x mapped from [a, b] to [-1, 1].

    Returns x.shape + (n,), by the three-term recurrence.
    """
    xi = 2.0 * (x - a) / (b - a) - 1.0
    cols = [torch.ones_like(xi), xi]
    for _ in range(2, n):
        cols.append(2.0 * xi * cols[-1] - cols[-2])
    return torch.stack(cols[:n], dim=-1)


def cheb_coeff_matrix(n: int) -> np.ndarray:
    """Matrix M with coeffs = M @ values for values on ascending chebygrid nodes."""
    k = np.arange(n)
    xi = -np.cos(np.pi * k / (n - 1))
    A = np.cos(np.arange(n)[None, :] * np.arccos(np.clip(xi, -1, 1))[:, None])
    return np.linalg.solve(A, np.eye(n))


def cheb2d_coeffs(values):
    """2-D Chebyshev coefficients of values on a chebygrid x chebygrid grid.

    ``values`` [..., nx, ny] (the trailing two axes are the grid); returns
    coefficients of the same shape, C = Mx V My^T, in full float32 for
    float32 input.
    """
    nx, ny = values.shape[-2], values.shape[-1]
    Mx = torch.as_tensor(cheb_coeff_matrix(nx), dtype=values.dtype, device=values.device)
    My = torch.as_tensor(cheb_coeff_matrix(ny), dtype=values.dtype, device=values.device)
    with full_float32():
        return torch.einsum("ij,...jk,lk->...il", Mx, values, My)


def cheb2d_eval(coeffs, x, ax: float, bx: float, y, ay: float, by: float):
    """The 2-D expansion ``coeffs`` [..., nx, ny] at paired points (x[l], y[l]).

    Returns [..., L].
    """
    Bx = cheb_basis(x, ax, bx, coeffs.shape[-2])
    By = cheb_basis(y, ay, by, coeffs.shape[-1])
    with full_float32():
        return torch.einsum("li,...ij,lj->...l", Bx, coeffs, By)

"""Piecewise-linear interpolation with linear extrapolation.

Counterpart of ``clearsky_tpu.utils.interp.interp_linear``.
"""

from __future__ import annotations

import torch

__all__ = ["interp_linear"]


def interp_linear(x, xp, fp):
    """Linear interpolation of fp(xp) at x, extrapolating with the edge slopes.

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
    return f0 + t * (f1 - f0)

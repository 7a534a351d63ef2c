"""Atmospheric profiles: quantities interpolated linearly in ln P.

Counterpart of ``clearsky_tpu.atmosphere.profile``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils.interp import interp_linear

__all__ = ["AtmosphericProfile", "formprofile", "formprofiles"]


@dataclasses.dataclass(frozen=True, eq=False)
class AtmosphericProfile:
    """Callable y(P) by linear interpolation in ln P, extrapolating linearly."""

    lnP: torch.Tensor
    y: torch.Tensor

    @classmethod
    def create(cls, P: torch.Tensor, y: torch.Tensor) -> "AtmosphericProfile":
        if P.shape != y.shape:
            raise ValueError("cannot form AtmosphericProfile with unequal numbers of points")
        idx = torch.argsort(P)
        return cls(lnP=torch.log(P[idx]), y=y[idx])

    def __call__(self, P):
        return interp_linear(torch.log(P), self.lnP, self.y)


def formprofile(P: torch.Tensor, x):
    """Normalize a profile input against the pressure tensor ``P``.

    A vector becomes an interpolated profile, a scalar a constant, a callable
    stays itself. The returned callable accepts ``fT(P)``, ``fmu(T, P)`` and
    ``fcp(T, P)`` alike by interpolating against its LAST argument.
    """
    if callable(x):
        return x
    x = torch.as_tensor(x, dtype=P.dtype, device=P.device)
    if x.ndim == 0:
        return lambda *args: x
    prof = AtmosphericProfile.create(P, x)
    return lambda *args: prof(args[-1])


def formprofiles(P, *xs):
    return tuple(formprofile(P, x) for x in xs)

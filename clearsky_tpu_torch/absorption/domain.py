"""Temperature/pressure domain of a baked opacity table.

Counterpart of ``clearsky_tpu.absorption.domain``: Chebyshev nodes in
temperature and in ln pressure, host numpy (set-up data). About 12
temperature x 24 pressure nodes give ~1% maximum interpolation error.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..constants import TIPS_TMIN, TIPS_TMAX
from ..utils.grids import chebygrid

__all__ = ["AtmosphericDomain"]


@dataclasses.dataclass(frozen=True, eq=False)
class AtmosphericDomain:
    """T x P box with its Chebyshev node coordinates (float64 numpy)."""

    T: np.ndarray
    Tmin: float
    Tmax: float
    nT: int
    P: np.ndarray
    Pmin: float
    Pmax: float
    nP: int

    @classmethod
    def create(
        cls,
        Trange: tuple[float, float] = (25.0, 550.0),
        nT: int = 12,
        Prange: tuple[float, float] = (1.0, 1e6),
        nP: int = 24,
    ) -> "AtmosphericDomain":
        T1, T2 = float(Trange[0]), float(Trange[1])
        P1, P2 = float(Prange[0]), float(Prange[1])
        if not (T1 > 0 and T2 > 0 and P1 > 0 and P2 > 0):
            raise ValueError("temperature and pressure ranges must be positive")
        if not (TIPS_TMIN <= T1 and T2 <= TIPS_TMAX):
            raise ValueError(
                f"temperature range must lie in the TIPS Qref/Q validity range "
                f"[{TIPS_TMIN}, {TIPS_TMAX}] K"
            )
        if not (T1 < T2 and P1 < P2):
            raise ValueError("ranges must be increasing (min, max)")
        T = chebygrid(T1, T2, nT)
        P = np.exp(chebygrid(np.log(P1), np.log(P2), nP))
        return cls(T=T, Tmin=T1, Tmax=T2, nT=nT, P=P, Pmin=P1, Pmax=P2, nP=nP)

    def __repr__(self):  # pragma: no cover - cosmetic
        return (
            f"AtmosphericDomain({self.nT} T nodes in [{self.Tmin},{self.Tmax}] K, "
            f"{self.nP} P nodes in [{self.Pmin},{self.Pmax}] Pa)"
        )

"""Gas absorbers: direct line-by-line evaluation and the gray analytic gas.

Counterpart of the direct mode of ``clearsky_tpu.absorption.gas``:
:class:`DirectGas` recomputes cross-sections from its lines at every call
through the line-sum kernel wrapper, and :class:`GrayGas` is the
constant-cross-section absorber of the analytic tests. A gas lives on one
device in one dtype, those of its wavenumber tensor ``nu``; the baked-table
``Gas`` and ``MultiGas`` are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..ops.linesum import LineWindowPlan, build_line_window_plan, sigma_from_lines_auto, DEFAULT_CUT
from ..spectra.lines import SpectralLines

__all__ = ["AbstractGas", "DirectGas", "GrayGas", "as_concentration"]


def _check_nu(nu) -> np.ndarray:
    """Validate a wavenumber grid: positive, unique, ascending."""
    nu = np.asarray(nu, dtype=np.float64)
    if nu.ndim != 1 or len(nu) < 2:
        raise ValueError("wavenumber grid must be a 1-D vector of at least 2 points")
    if np.any(nu <= 0) or np.any(np.diff(nu) <= 0):
        raise ValueError(
            "wavenumbers must be positive, unique, and in ascending order "
            "(negative wavenumbers silently poison the Planck function)"
        )
    return nu


def as_concentration(fC) -> Callable:
    """Normalize a concentration spec (scalar or fC(T, P)) to a callable."""
    if callable(fC):
        return fC
    c = float(fC)
    if not (0.0 <= c <= 1.0):
        raise ValueError(f"gas molar concentration must be in [0,1], not {c}")
    return lambda T, P: torch.full(torch.broadcast_shapes(T.shape, P.shape), c,
                                   dtype=T.dtype, device=T.device)


class AbstractGas:
    """Interface: ``raw_sigma(T, P) -> [..., n_nu]`` and concentration scaling."""

    nu: torch.Tensor

    def raw_sigma(self, T, P):  # pragma: no cover - interface
        raise NotImplementedError

    def concentration(self, T, P):
        """Molar concentration [mole/mole]."""
        return self.fC(T, P)

    def __call__(self, T, P):
        """Concentration-scaled cross-sections [..., n_nu]."""
        C = torch.as_tensor(self.concentration(T, P), dtype=self.nu.dtype,
                            device=self.nu.device)
        return C[..., None] * self.raw_sigma(T, P)


@dataclasses.dataclass(frozen=True, eq=False)
class DirectGas(AbstractGas):
    """Direct line-by-line gas: cross-sections recomputed from lines per call.

    ``nu`` and ``lines`` share the dtype and device the gas computes in; the
    banding plan is built on the host from the float64 grid and positions.
    """

    lines: SpectralLines
    nu: torch.Tensor
    plan: LineWindowPlan
    shape: str = "voigt"
    fC: Callable = None
    name: str = ""
    formula: str = ""
    mu: float = float("nan")

    @classmethod
    def from_lines(cls, lines: SpectralLines, fC, nu, shape: str = "voigt",
                   cut: float | None = None, block: int = 128) -> "DirectGas":
        """A direct gas on ``lines``' device and dtype over the grid ``nu``."""
        if shape not in DEFAULT_CUT:
            raise ValueError(f"line shape {shape!r} is not ported (have {sorted(DEFAULT_CUT)})")
        cut = DEFAULT_CUT[shape] if cut is None else float(cut)
        nu = _check_nu(nu)
        plan = build_line_window_plan(nu, lines.positions64(), cut, block=block)
        return cls(
            lines=lines,
            nu=torch.tensor(nu, dtype=lines.dtype, device=lines.device),
            plan=plan,
            shape=shape,
            fC=as_concentration(fC),
            name=lines.name,
            formula=lines.formula,
            mu=lines.mean_molar_mass,
        )

    def raw_sigma(self, T, P):
        C = torch.as_tensor(self.fC(T, P), dtype=T.dtype, device=T.device)
        return sigma_from_lines_auto(self.plan, self.lines, T, P, C * P, self.shape)


@dataclasses.dataclass(frozen=True, eq=False)
class GrayGas(AbstractGas):
    """Constant cross-section absorber."""

    nu: torch.Tensor
    sigma: float = 0.0
    name: str = "Gray"
    formula: str = "Gray"
    mu: float = float("nan")

    @classmethod
    def create(cls, sigma: float, nu, dtype=torch.float64, device="cpu") -> "GrayGas":
        return cls(nu=torch.tensor(_check_nu(nu), dtype=dtype, device=device),
                   sigma=float(sigma))

    def raw_sigma(self, T, P):
        shp = torch.broadcast_shapes(T.shape, P.shape)
        return torch.full(shp + (self.nu.shape[0],), self.sigma, dtype=self.nu.dtype,
                          device=self.nu.device)

    def concentration(self, T, P):
        return torch.ones(torch.broadcast_shapes(T.shape, P.shape), dtype=self.nu.dtype,
                          device=self.nu.device)

"""Gas absorbers: baked opacity tables, direct line-by-line evaluation and
the gray analytic gas.

Counterpart of ``clearsky_tpu.absorption.gas``. :class:`Gas` bakes
cross-sections once on an :class:`AtmosphericDomain` grid through the
line-sum kernel wrapper and evaluates them by a Chebyshev contraction over
(T, ln P); :meth:`Gas.split_precision` stores the coefficients as a float
lead and a bfloat16 tail, the operand of the fused table kernels
(``rt/fused_table.py``). :class:`DirectGas` recomputes cross-sections from
its lines at every call, and :class:`GrayGas` is the constant-cross-section
absorber of the analytic tests. A gas lives on one device in one dtype,
those of its wavenumber tensor ``nu``. ``Gas.from_par``, ``WellMixedGas``,
``VariableGas`` and ``MultiGas`` are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..ops.linesum import (
    LineWindowPlan,
    build_line_window_plan,
    sigma_from_lines,
    sigma_from_lines_auto,
    DEFAULT_CUT,
)
from ..ops.linesum_strategies import check_strategy, warm
from ..spectra.lines import SpectralLines
from ..utils.device import placement
from ..utils.interp import cheb2d_coeffs, cheb_basis, full_float32
from .domain import AtmosphericDomain

__all__ = [
    "AbstractGas",
    "Gas",
    "DirectGas",
    "GrayGas",
    "as_concentration",
    "bake_sigma_grid",
    "table_basis",
    "opacity_error",
]

_LOG_TINY = float(np.log(np.finfo(np.float64).tiny))


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


def _check_shape(shape: str):
    if shape not in DEFAULT_CUT:
        raise ValueError(f"line shape {shape!r} is not ported (have {sorted(DEFAULT_CUT)})")


def bake_sigma_grid(lines: SpectralLines, fC, nu, domain: AtmosphericDomain,
                    shape: str = "voigt", cut: float | None = None, block: int = 128,
                    tp_batch: int = 16, device_out: bool = False):
    """The cross-section grid sigma[nT, nP, n_nu] of a table (the bake).

    The line sum runs at every (T, P) node of ``domain``, ``tp_batch`` nodes
    per call of :func:`sigma_from_lines_auto` on its "auto" route (on CUDA
    the kernels of the route the JAX package takes on its accelerator, on
    the CPU the exact plain line sum), in the catalog's dtype on its
    device. Wavenumbers where zero and nonzero values mix across the grid
    (underflow) are zeroed everywhere.
    Returns float numpy, or with ``device_out`` a tensor on the catalog's
    device (a [12, 24, 2^19] float32 grid is 0.6 GB: no host round trip).
    """
    _check_shape(shape)
    cut = DEFAULT_CUT[shape] if cut is None else float(cut)
    fC = as_concentration(fC)
    nu = _check_nu(nu)
    plan = build_line_window_plan(nu, lines.positions64(), cut, block=block)
    TT, PP = np.meshgrid(domain.T, domain.P, indexing="ij")
    Tf = torch.tensor(TT.ravel(), dtype=lines.dtype, device=lines.device)
    Pf = torch.tensor(PP.ravel(), dtype=lines.dtype, device=lines.device)
    Cf = torch.broadcast_to(torch.as_tensor(fC(Tf, Pf), dtype=Tf.dtype, device=Tf.device),
                            Tf.shape)
    bad = (Cf < 0) | (Cf > 1)
    if bool(bad.any()):
        i = int(torch.argmax(bad.to(torch.int8)))
        raise ValueError(f"gas molar concentrations must be in [0,1], not {float(Cf[i])} "
                         f"(encountered @ {TT.ravel()[i]} K, {PP.ravel()[i]} Pa)")
    Ppf = Cf * Pf
    chunks = []
    for a in range(0, Tf.shape[0], tp_batch):
        b = min(a + tp_batch, Tf.shape[0])
        chunk = sigma_from_lines_auto(plan, lines, Tf[a:b], Pf[a:b], Ppf[a:b], shape)
        chunks.append(chunk if device_out else chunk.cpu().numpy())
    if device_out:
        sigma = torch.cat(chunks).reshape(domain.nT, domain.nP, len(nu))
        mixed = (sigma.amin(dim=(0, 1)) == 0.0) & (sigma.amax(dim=(0, 1)) > 0.0)
        return torch.where(mixed, torch.zeros((), dtype=sigma.dtype, device=sigma.device),
                           sigma)
    sigma = np.concatenate(chunks).reshape(domain.nT, domain.nP, len(nu))
    mixed = (sigma.min(axis=(0, 1)) == 0.0) & (sigma.max(axis=(0, 1)) > 0.0)
    if mixed.any():
        sigma[:, :, mixed] = 0.0
    return sigma


# Per-column floor of ln sigma before the Chebyshev fit: max(column peak -
# LN_CLIP, LN_F32_FLOOR), never above the column's own peak. Values below
# 1e-20 of the peak, and below the float32 underflow boundary, are flattened
# to it, so that a cold, low-pressure node whose far-wing sigma underflowed
# to 0 does not pull a global fit 600 log units down. All-zero columns are
# the constant log(float64 tiny).
LN_CLIP = float(np.log(1e20))
LN_F32_FLOOR = float(np.log(np.finfo(np.float32).tiny))


def _ln_sigma_coeffs_device(sigma, domain: AtmosphericDomain):
    """Device twin of :func:`_ln_sigma_coeffs` on a sigma tensor, in its dtype.

    Returns [nT*nP, n_nu] on sigma's device.
    """
    tiny = torch.finfo(sigma.dtype).tiny
    ln = torch.where(sigma > 0.0, torch.log(torch.clamp(sigma, min=tiny)),
                     torch.full((), _LOG_TINY, dtype=sigma.dtype, device=sigma.device))
    allzero = (sigma <= tiny).all(dim=0).all(dim=0)
    peak = ln.amax(dim=(0, 1), keepdim=True)
    floor = torch.minimum(peak, torch.clamp(peak - LN_CLIP, min=LN_F32_FLOOR))
    ln = torch.where(allzero, torch.full((), _LOG_TINY, dtype=ln.dtype, device=ln.device),
                     torch.maximum(ln, floor))
    coeffs = cheb2d_coeffs(ln.movedim(-1, 0))                  # [n_nu, nT, nP]
    return coeffs.reshape(coeffs.shape[0], -1).t().contiguous()


def _ln_sigma_coeffs(sigma: np.ndarray, domain: AtmosphericDomain) -> np.ndarray:
    """Chebyshev coefficients of ln sigma over (T, ln P), [nT*nP, n_nu], host float64.

    All-zero wavenumbers hold the constant log(float64 tiny); see LN_CLIP
    for the per-column floor.
    """
    ln = np.where(sigma > 0.0, np.log(np.maximum(sigma, np.finfo(np.float64).tiny)), _LOG_TINY)
    allzero = (sigma <= np.finfo(np.float64).tiny).all(axis=(0, 1))
    peak = ln.max(axis=(0, 1), keepdims=True)
    floor = np.minimum(peak, np.maximum(peak - LN_CLIP, LN_F32_FLOOR))
    ln = np.maximum(ln, floor)
    ln[:, :, allzero] = _LOG_TINY
    coeffs = cheb2d_coeffs(torch.from_numpy(np.ascontiguousarray(np.moveaxis(ln, -1, 0))))
    return coeffs.numpy().reshape(coeffs.shape[0], -1).T


def table_basis(domain: AtmosphericDomain, T, P):
    """Chebyshev basis rows [n, nT*nP] of a table at flat states T, P [n]."""
    BT = cheb_basis(T, domain.Tmin, domain.Tmax, domain.nT)
    BP = cheb_basis(torch.log(P), np.log(domain.Pmin), np.log(domain.Pmax), domain.nP)
    return (BT[:, :, None] * BP[:, None, :]).reshape(T.shape[0], -1)


@dataclasses.dataclass(frozen=True, eq=False)
class Gas(AbstractGas):
    """Baked-table gas: Chebyshev coefficients of ln sigma over (T, ln P).

    ``coeffs`` [nT*nP, n_nu] (full), or after :meth:`split_precision` the
    float lead rows ``lead_idx`` [K, n_nu] beside the bfloat16 tail
    ``coeffs_tail`` (rows ``tail_idx``). Evaluation is a [n, nT*nP] x
    [nT*nP, n_nu] contraction and an exp.
    """

    nu: torch.Tensor
    coeffs: torch.Tensor
    name: str = ""
    formula: str = ""
    mu: float = float("nan")
    domain: AtmosphericDomain = None
    fC: Callable = None
    coeffs_tail: torch.Tensor | None = None
    lead_idx: tuple | None = None
    tail_idx: tuple | None = None

    @classmethod
    def from_lines(cls, lines: SpectralLines, fC, nu, domain: AtmosphericDomain,
                   shape: str = "voigt", cut: float | None = None, dtype=None,
                   **bake_kwargs) -> "Gas":
        """Bake a gas from ``lines`` on their device; coefficients in ``dtype``
        (default the catalog's). A catalog on the card keeps the bake, the
        log and the fit there; one on the CPU fits in float64 numpy."""
        if lines.device.type == "cuda":
            sigma = bake_sigma_grid(lines, fC, nu, domain, shape=shape, cut=cut,
                                    device_out=True, **bake_kwargs)
            coeffs = _ln_sigma_coeffs_device(sigma, domain)
        else:
            sigma = bake_sigma_grid(lines, fC, nu, domain, shape=shape, cut=cut,
                                    **bake_kwargs)
            coeffs = _ln_sigma_coeffs(sigma, domain)
        dtype = dtype or lines.dtype
        return cls(
            nu=torch.tensor(_check_nu(nu), dtype=dtype, device=lines.device),
            coeffs=torch.as_tensor(coeffs, dtype=dtype, device=lines.device),
            name=lines.name,
            formula=lines.formula,
            mu=lines.mean_molar_mass,
            domain=domain,
            fC=as_concentration(fC),
        )

    def _rows(self, idx):
        return torch.as_tensor(idx, dtype=torch.int64, device=self.coeffs.device)

    def raw_sigma(self, T, P):
        """Cross-sections [..., n_nu] without the concentration.

        The contraction runs in the coefficients' dtype, float32 ones in
        full float32 (:func:`full_float32`). In split precision the basis
        columns of the tail are rounded to bfloat16 and both bfloat16
        operands are widened before the product, which is then exact: a
        product of two bfloat16 tensors would come back in bfloat16, ~0.3
        absolute on ln sigma.
        """
        shp = torch.broadcast_shapes(T.shape, P.shape)
        Tq = torch.broadcast_to(T, shp).reshape(-1)
        Pq = torch.broadcast_to(P, shp).reshape(-1)
        basis = table_basis(self.domain, Tq, Pq)
        acc = self.coeffs.dtype
        with full_float32():
            if self.coeffs_tail is None:
                ln = torch.matmul(basis.to(acc), self.coeffs)
            else:
                b_lead = basis[:, self._rows(self.lead_idx)].to(acc)
                b_tail = basis[:, self._rows(self.tail_idx)].to(torch.bfloat16).to(acc)
                ln = torch.matmul(b_lead, self.coeffs) + torch.matmul(
                    b_tail, self.coeffs_tail.to(acc))
        return torch.exp(ln).reshape(shp + (self.coeffs.shape[-1],))

    def split_precision(self, k: int = 16) -> "Gas":
        """Store the coefficients in split precision: the ``k`` rows (flattened
        (T, P) nodes) with the largest max-over-nu magnitude stay in the
        working dtype, the rest are rounded to bfloat16 and widened again at
        evaluation. Same selection as the JAX package (numpy argsort of the
        row maxima)."""
        if self.coeffs_tail is not None:
            raise ValueError("gas is already split-precision")
        nc = self.coeffs.shape[0]
        if not (0 < k < nc):
            raise ValueError(f"k must be in (0, {nc}), not {k}")
        score = self.coeffs.abs().amax(dim=1).cpu().numpy()
        order = np.argsort(-score)
        lead = np.sort(order[:k])
        tail = np.sort(order[k:])
        return dataclasses.replace(
            self,
            coeffs=self.coeffs[self._rows(lead)],
            coeffs_tail=self.coeffs[self._rows(tail)].to(torch.bfloat16),
            lead_idx=tuple(int(i) for i in lead),
            tail_idx=tuple(int(i) for i in tail),
        )

    def reconcentrate(self, fC) -> "Gas":
        """The gas with another concentration; the self-broadening baked into
        the table is not recomputed (fine at low partial pressure)."""
        fC = as_concentration(fC)
        TT, PP = np.meshgrid(self.domain.T, self.domain.P, indexing="ij")
        t = lambda x: torch.tensor(x.ravel(), dtype=self.nu.dtype, device=self.nu.device)
        C = torch.as_tensor(fC(t(TT), t(PP)))
        if bool(((C < 0) | (C > 1)).any()):
            raise ValueError("gas molar concentrations must be in [0,1]")
        return dataclasses.replace(self, fC=fC)

    def select(self, idx) -> "Gas":
        """The gas on a subset of its wavenumbers (indices or a bool mask)."""
        idx = torch.as_tensor(np.asarray(idx), device=self.nu.device)
        return dataclasses.replace(
            self, nu=self.nu[idx], coeffs=self.coeffs[:, idx].contiguous(),
            coeffs_tail=None if self.coeffs_tail is None
            else self.coeffs_tail[:, idx].contiguous(),
        )

    def __repr__(self):  # pragma: no cover - cosmetic
        return f"Gas({self.name} [{self.formula}], n_nu={self.nu.shape[0]}, mu={self.mu:.6g})"


def opacity_error(gas: Gas, lines: SpectralLines, nu_index: int, shape: str = "voigt",
                  cut: float | None = None, N: int = 50):
    """Table against the exact line sum on a dense N x N (T, P) grid.

    ``lines`` share the gas's dtype and device. Returns (T, P, abs_err,
    rel_err) as numpy, the errors [N, N] (rel NaN where the exact value is 0).
    """
    d = gas.domain
    T = np.linspace(d.Tmin, d.Tmax, N)
    P = 10 ** np.linspace(np.log10(d.Pmin), np.log10(d.Pmax), N)
    TT, PP = np.meshgrid(T, P, indexing="ij")
    Tf = torch.tensor(TT.ravel(), dtype=gas.nu.dtype, device=gas.nu.device)
    Pf = torch.tensor(PP.ravel(), dtype=gas.nu.dtype, device=gas.nu.device)
    approx = gas.raw_sigma(Tf, Pf)[:, nu_index].cpu().numpy().reshape(N, N)
    cutv = DEFAULT_CUT[shape] if cut is None else float(cut)
    nu_val = float(gas.nu[nu_index])
    plan = build_line_window_plan(np.array([nu_val]), lines.positions64(), cutv, block=8)
    C = torch.broadcast_to(torch.as_tensor(gas.fC(Tf, Pf), dtype=Tf.dtype, device=Tf.device),
                           Tf.shape)
    exact = sigma_from_lines(plan, lines, Tf, Pf, C * Pf, shape)[:, 0].cpu().numpy()
    aerr = approx - exact.reshape(N, N)
    rerr = aerr / np.where(exact.reshape(N, N) == 0, np.nan, exact.reshape(N, N))
    return T, P, aerr, rerr


@dataclasses.dataclass(frozen=True, eq=False)
class DirectGas(AbstractGas):
    """Direct line-by-line gas: cross-sections recomputed from lines per call.

    ``nu`` and ``lines`` share the dtype and device the gas computes in; the
    banding plan is built on the host from the float64 grid and positions.
    ``strategy`` picks the voigt route on the card ("auto", "grouped",
    "stencil" or "coarse", :func:`..ops.linesum_strategies.route`); on the
    CPU every strategy gives the exact plain line sum.
    """

    lines: SpectralLines
    nu: torch.Tensor
    plan: LineWindowPlan
    shape: str = "voigt"
    fC: Callable = None
    name: str = ""
    formula: str = ""
    mu: float = float("nan")
    strategy: str = "auto"

    @classmethod
    def from_lines(cls, lines: SpectralLines, fC, nu, shape: str = "voigt",
                   cut: float | None = None, block: int = 128,
                   strategy: str = "auto") -> "DirectGas":
        """A direct gas on ``lines``' device and dtype over the grid ``nu``;
        the geometry of its route is built here, not at the first call."""
        _check_shape(shape)
        check_strategy(strategy)
        cut = DEFAULT_CUT[shape] if cut is None else float(cut)
        nu = _check_nu(nu)
        plan = build_line_window_plan(nu, lines.positions64(), cut, block=block)
        if lines.device.type == "cuda":
            warm(plan, lines, shape, strategy)
        return cls(
            lines=lines,
            nu=torch.tensor(nu, dtype=lines.dtype, device=lines.device),
            plan=plan,
            shape=shape,
            fC=as_concentration(fC),
            name=lines.name,
            formula=lines.formula,
            mu=lines.mean_molar_mass,
            strategy=strategy,
        )

    def raw_sigma(self, T, P):
        C = torch.as_tensor(self.fC(T, P), dtype=T.dtype, device=T.device)
        return sigma_from_lines_auto(self.plan, self.lines, T, P, C * P, self.shape,
                                     strategy=self.strategy)


@dataclasses.dataclass(frozen=True, eq=False)
class GrayGas(AbstractGas):
    """Constant cross-section absorber."""

    nu: torch.Tensor
    sigma: float = 0.0
    name: str = "Gray"
    formula: str = "Gray"
    mu: float = float("nan")

    @classmethod
    def create(cls, sigma: float, nu, dtype=None, device=None) -> "GrayGas":
        """A gray gas over ``nu``, by default in float32 on the card."""
        dtype, device = placement(dtype, device)
        return cls(nu=torch.tensor(_check_nu(nu), dtype=dtype, device=device),
                   sigma=float(sigma))

    def raw_sigma(self, T, P):
        shp = torch.broadcast_shapes(T.shape, P.shape)
        return torch.full(shp + (self.nu.shape[0],), self.sigma, dtype=self.nu.dtype,
                          device=self.nu.device)

    def concentration(self, T, P):
        return torch.ones(torch.broadcast_shapes(T.shape, P.shape), dtype=self.nu.dtype,
                          device=self.nu.device)

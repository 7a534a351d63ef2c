"""SpectralLines: one molecule's line catalog as a dataclass of tensors.

Counterpart of ``clearsky_tpu.spectra.lines``: per-line parameters sorted
ascending in wavenumber, molar masses and abundances resolved from the
molparam table, and the packed TIPS Chebyshev fits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.device import placement
from .molparam import molparam, ISOINDEX

__all__ = ["SpectralLines", "PER_LINE_FIELDS"]

# every field with leading dimension n_lines (tips_coeffs is a shared table)
PER_LINE_FIELDS = (
    "nu", "nu_lo", "S", "ga", "gs", "Epp", "na", "mu", "A", "iso", "iso_ptr"
)
_FLOAT_FIELDS = ("nu", "S", "ga", "gs", "Epp", "na", "mu", "A", "tips_coeffs")


@dataclasses.dataclass(frozen=True, eq=False)
class SpectralLines:
    """One molecule's spectral lines.

    Float fields are in the catalog's working dtype, except ``nu_lo``: the
    float32 residual of the float64 positions (nu64 - f32(nu64)), from which
    float32 code rebuilds dnu to ~1e-7 cm^-1 (f32 positions alone round by
    ~1e-4 cm^-1). ``iso`` is the local isotopologue index and ``iso_ptr``
    its row in ``tips_coeffs`` [n_iso_present, ncheb].
    """

    nu: torch.Tensor
    nu_lo: torch.Tensor
    S: torch.Tensor
    ga: torch.Tensor
    gs: torch.Tensor
    Epp: torch.Tensor
    na: torch.Tensor
    mu: torch.Tensor
    A: torch.Tensor
    iso: torch.Tensor
    iso_ptr: torch.Tensor
    tips_coeffs: torch.Tensor
    name: str = ""
    formula: str = ""
    M: int = 0

    @property
    def n_lines(self) -> int:
        return self.nu.shape[0]

    @property
    def device(self) -> torch.device:
        return self.nu.device

    @property
    def dtype(self) -> torch.dtype:
        return self.nu.dtype

    def to(self, dtype=None, device=None) -> "SpectralLines":
        """The catalog in another working dtype and/or on another device."""
        dtype = self.dtype if dtype is None else dtype
        device = self.device if device is None else device
        fields = {f: getattr(self, f).detach().cpu().numpy()
                  for f in _FLOAT_FIELDS + ("nu_lo", "iso", "iso_ptr")}
        fields["nu"] = self.positions64()
        return SpectralLines.from_arrays(fields, dtype=dtype, device=device,
                                         name=self.name, formula=self.formula, M=self.M)

    def positions64(self) -> np.ndarray:
        """Line positions in float64 on the host (hi + lo in a float32 catalog)."""
        nu = self.nu.detach().cpu().double()
        if self.nu.dtype != torch.float64:
            nu = nu + self.nu_lo.detach().cpu().double()
        return nu.numpy()

    @property
    def mean_molar_mass(self) -> float:
        """Abundance-weighted mean molar mass [kg/mole]."""
        A = self.A.double().cpu().numpy()
        mu = self.mu.double().cpu().numpy()
        return float(np.sum(A * mu) / np.sum(A))

    @classmethod
    def from_arrays(cls, fields: dict, dtype=None, device=None,
                    name: str = "", formula: str = "", M: int = 0) -> "SpectralLines":
        """Build from numpy arrays keyed by field name (``nu`` in float64),
        by default in float32 on the card (:func:`..utils.device.placement`)."""
        dtype, device = placement(dtype, device)
        nu64 = np.asarray(fields["nu"], dtype=np.float64)
        nu_lo = fields.get("nu_lo")
        if nu_lo is None:
            nu_lo = nu64 - nu64.astype(np.float32).astype(np.float64)
        # torch.tensor copies: the inputs may be read-only views (JAX arrays)
        out = {"nu_lo": torch.tensor(np.asarray(nu_lo, np.float32), device=device)}
        for f in _FLOAT_FIELDS:
            out[f] = torch.tensor(np.asarray(fields[f], np.float64), dtype=dtype,
                                  device=device)
        for f in ("iso", "iso_ptr"):
            out[f] = torch.tensor(np.asarray(fields[f], np.int64), device=device)
        return cls(**out, name=name, formula=formula, M=M)

    @classmethod
    def from_par_dict(cls, par: dict, dtype=None, device=None) -> "SpectralLines":
        """Build from a ``read_par``-style dict of numpy columns, by default in
        float32 on the card."""
        Ms = np.unique(par["M"])
        if len(Ms) != 1:
            raise ValueError("SpectralLines must contain only one molecule's lines")
        M = int(Ms[0])
        mp = molparam(M)
        iso = np.array([ISOINDEX[c] for c in par["I"]], dtype=np.int64)
        if iso.max(initial=0) > mp.n_iso:
            raise ValueError(
                f"isotopologue index {iso.max()} outside molparam table for {mp.formula}"
            )
        present = np.unique(iso)
        missing = [int(i) for i in present if not mp.hascheb[i - 1]]
        if missing:
            raise ValueError(
                f"no TIPS Chebyshev fit for isotopologue(s) {missing} of "
                f"{mp.name} ({mp.formula})"
            )
        ptr_of_iso = {int(i): k for k, i in enumerate(present)}
        iso_ptr = np.array([ptr_of_iso[int(i)] for i in iso], dtype=np.int64)
        ncheb_used = int(mp.ncheb[present - 1].max())
        tips = mp.cheb[present - 1][:, :ncheb_used]

        idx = np.argsort(par["nu"], kind="stable")
        fields = {k: np.asarray(par[k])[idx] for k in ("nu", "S", "ga", "gs", "Epp", "na")}
        fields.update(mu=mp.mu[iso - 1][idx], A=mp.A[iso - 1][idx], iso=iso[idx],
                      iso_ptr=iso_ptr[idx], tips_coeffs=tips)
        return cls.from_arrays(fields, dtype=dtype, device=device,
                               name=mp.name, formula=mp.formula, M=M)

    def __repr__(self):  # pragma: no cover - cosmetic
        return (
            f"SpectralLines({self.name} [{self.formula}], M={self.M}, "
            f"n_lines={self.n_lines}, {self.dtype}, {self.device})"
        )

"""HITRAN molecule/isotopologue metadata and TIPS partition-function fits.

Counterpart of ``clearsky_tpu.spectra.molparam``. The data file
``molparam_data.npz`` is a copy of the JAX package's, kept beside this module
so the port reads nothing outside its own package.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from pathlib import Path

import numpy as np

__all__ = ["MolParam", "molparam", "ISOINDEX"]

_DATA_PATH = Path(__file__).resolve().parent / "molparam_data.npz"

# HITRAN isotopologue label -> local integer index, including the 0,A-Z extension
ISOINDEX = {c: i + 1 for i, c in enumerate("123456789")}
ISOINDEX["0"] = 10
for i, c in enumerate("ABCDEFGHIJKLMNOPQRSTUVWXYZ"):
    ISOINDEX[c] = 11 + i


@dataclasses.dataclass(frozen=True)
class MolParam:
    """Per-molecule isotopologue metadata."""

    M: int
    formula: str
    name: str
    iso_global: np.ndarray
    afgl: np.ndarray
    A: np.ndarray           # abundance fractions
    mu: np.ndarray          # molar masses [kg/mole]
    Qref: np.ndarray
    hascheb: np.ndarray     # bool per isotopologue
    ncheb: np.ndarray
    maxrelerr: np.ndarray
    cheb: np.ndarray        # [n_iso, ncheb_max] zero-padded Q(T)/Qref coefficients

    @property
    def n_iso(self) -> int:
        return len(self.A)


@lru_cache(maxsize=1)
def _load():
    with np.load(_DATA_PATH, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


@lru_cache(maxsize=None)
def molparam(M: int) -> MolParam:
    """Look up the MolParam record for HITRAN molecule number ``M`` (1-based)."""
    d = _load()
    sel = d["iso_mol"] == M
    if not sel.any():
        raise KeyError(f"no molparam data for HITRAN molecule number {M}")
    order = np.argsort(d["iso_local"][sel])

    def take(key):
        return d[key][sel][order]

    return MolParam(
        M=M,
        formula=str(d["mol_formula"][M - 1]),
        name=str(d["mol_name"][M - 1]),
        iso_global=take("iso_global"),
        afgl=take("iso_afgl"),
        A=take("iso_A"),
        mu=take("iso_mu"),
        Qref=take("iso_Qref"),
        hascheb=take("iso_hascheb"),
        ncheb=take("iso_ncheb"),
        maxrelerr=take("iso_maxrelerr"),
        cheb=take("iso_cheb"),
    )

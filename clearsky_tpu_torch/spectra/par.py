"""HITRAN ``.par`` line-catalog reader (host, numpy).

Counterpart of ``clearsky_tpu.spectra.par``: 160-character records in the
HITRAN 2004 column layout, parsed as one byte matrix with column slices,
then filtered by wavenumber range, intensity cutoff, isotopologue
selection and the strongest ``maxlines``, and sorted by wavenumber.
``strings=False`` leaves the string columns out and parses through the
port's multithreaded C++ parser (``clearsky_tpu_torch/native``, built with
g++ at first use) where it builds, with the same numbers as the numpy path,
which it falls back to otherwise.
"""

from __future__ import annotations

import numpy as np

from .molparam import ISOINDEX

__all__ = ["read_par", "PAR_COLUMNS"]

# HITRAN 2004 .par record layout: (key, start, stop) as 0-based slices
PAR_COLUMNS = [
    ("M", 0, 2),
    ("I", 2, 3),
    ("nu", 3, 15),
    ("S", 15, 25),
    ("A", 25, 35),
    ("ga", 35, 40),
    ("gs", 40, 45),
    ("Epp", 45, 55),
    ("na", 55, 59),
    ("da", 59, 67),
    ("Vp", 67, 82),
    ("Vpp", 82, 97),
    ("Qp", 97, 112),
    ("Qpp", 112, 127),
    ("Ierr", 127, 133),
    ("Iref", 133, 145),
    ("flag", 145, 146),
    ("gp", 146, 153),
    ("gpp", 153, 160),
]

_FLOAT_KEYS = ("nu", "S", "A", "ga", "gs", "Epp", "na", "da")
_STRING_KEYS = ("Vp", "Vpp", "Qp", "Qpp", "Ierr", "Iref", "flag", "gp", "gpp")


def _records_to_bytes(path: str) -> np.ndarray:
    """A .par file as an [n_records, 160] uint8 matrix (lines shorter than
    160 characters are dropped; any line ending is accepted)."""
    raw = np.fromfile(path, dtype=np.uint8)
    nl = np.flatnonzero(raw == ord("\n"))
    if len(nl) == 0 or (len(raw) - 1) not in nl:
        nl = np.append(nl, len(raw))        # no trailing newline: EOF ends a record
    starts = np.concatenate([[0], nl[:-1] + 1])
    starts = starts[nl - starts >= 160]
    return raw[starts[:, None] + np.arange(160)[None, :]]


def _column(mat: np.ndarray, a: int, b: int) -> np.ndarray:
    return np.frombuffer(np.ascontiguousarray(mat[:, a:b]).tobytes(), dtype=f"S{b - a}")


def _parse_float_col(mat: np.ndarray, a: int, b: int) -> np.ndarray:
    col = np.char.strip(_column(mat, a, b))
    return np.where(col == b"", b"0", col).astype(np.float64)


def parse_par_numpy(filename: str, strings: bool = True) -> dict:
    """Every record's columns (the string ones with ``strings``), unfiltered,
    through numpy byte-matrix slices."""
    mat = _records_to_bytes(filename)
    par = {"M": _parse_float_col(mat, 0, 2).astype(np.int16),
           "I": _column(mat, 2, 3).astype("U1")}
    for key, a, b in PAR_COLUMNS:
        if key in _FLOAT_KEYS:
            par[key] = _parse_float_col(mat, a, b)
        elif strings and key in _STRING_KEYS:
            par[key] = _column(mat, a, b).astype(f"U{b - a}")
    return par


def read_par(filename: str, numin: float = 0.0, numax: float = np.inf, Scut: float = 0.0,
             I=(), maxlines: int = -1, strings: bool = True) -> dict:
    """Parse a HITRAN .par file into a dict of numpy columns.

    Filters, in this order: ``numin <= nu <= numax``, ``S >= Scut``, the
    isotopologues ``I`` (characters, or local integer indices), then the
    ``maxlines`` strongest lines; the result is sorted by wavenumber
    (stable). ``strings=False`` leaves out the quantum-state and reference
    string columns, which the physics never reads, and takes the native
    parser where it is built.
    """
    if not str(filename).endswith(".par"):
        raise ValueError(
            "expected file with .par extension, downloaded from https://hitran.org/lbl/"
        )
    par = None
    if not strings:
        from ..native import parse_par_native

        par = parse_par_native(str(filename))
    if par is None:
        par = parse_par_numpy(str(filename), strings)
    n = len(par["nu"])

    mask = (par["nu"] >= numin) & (par["nu"] <= numax) & (par["S"] >= Scut)
    if len(I) > 0:
        chars = {c for c in I if isinstance(c, str)}
        ints = {i for i in I if not isinstance(i, str)}
        iso_int = np.array([ISOINDEX[c] for c in par["I"]], dtype=np.int64)
        ok = np.zeros(n, dtype=bool)
        for c in chars:
            ok |= par["I"] == c
        for i in ints:
            ok |= iso_int == i
        mask &= ok
    if not mask.any():
        raise ValueError("par information has been filtered to nothing!")
    par = {k: v[mask] for k, v in par.items()}

    if 0 < maxlines < len(par["nu"]):
        idx = np.argsort(par["S"])[::-1][:maxlines]
        par = {k: v[idx] for k, v in par.items()}

    idx = np.argsort(par["nu"], kind="stable")
    return {k: v[idx] for k, v in par.items()}

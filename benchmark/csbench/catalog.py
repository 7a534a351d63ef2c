"""Seeded synthetic line catalogs, frozen for the benchmark.

The repository carries no HITRAN file, so a configuration's catalog is made
here from a seed: HITRAN's line count of a molecule, its band centres and
widths, and its ranges of intensity, broadening and lower-state energy.
This is a frozen copy of the generator the program's tests use, so that a
later change to the program's copy cannot move the benchmark's inputs
(``tests/test_bench_inputs.py`` holds the two equal as long as the program
keeps its copy).

:func:`make_par` returns a ``read_par``-style dict of numpy columns, which
the benchmark hands to the program (``SpectralLines.from_par_dict``), and
:func:`line_table` the float64 per-line arrays the plain reference reads.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

__all__ = ["BANDS", "make_par", "line_table", "molparam"]

# (centre, half-width [cm^-1], share of the lines) by HITRAN molecule number:
# CO2's 15 um bending band, the 10.4/9.4 um laser bands and the 4.3 um
# asymmetric stretch; water's pure-rotation band, 6.3 um bend and 2.7 um
# stretches
BANDS = {
    2: ((667.4, 90.0, 0.50), (961.0, 40.0, 0.08), (1063.7, 40.0, 0.08), (2349.1, 70.0, 0.34)),
    1: ((300.0, 290.0, 0.45), (1595.0, 150.0, 0.30), (3700.0, 180.0, 0.25)),
}
# isotopologues and their shares, log10 intensity range, air and self
# broadening, lower-state energy and temperature exponent ranges
_FIELDS = {
    2: ("123", [0.9, 0.07, 0.03], (-28.0, -18.0), (0.055, 0.085), (0.075, 0.105),
        (0.0, 3000.0), (0.65, 0.78)),
    1: ("1234", [0.85, 0.07, 0.05, 0.03], (-27.0, -19.0), (0.06, 0.10), (0.20, 0.50),
        (0.0, 4000.0), (0.50, 0.80)),
}
_MOLPARAM = Path(__file__).resolve().parent / "data" / "molparam.json"


def make_par(molecule: int, n_lines: int, seed: int) -> dict:
    """``n_lines`` synthetic lines of HITRAN molecule ``molecule`` (2 CO2,
    1 H2O) from ``seed``, sorted ascending in wavenumber."""
    isos, iso_p, logS, ga, gs, Epp, na = _FIELDS[molecule]
    bands = BANDS[molecule]
    rng = np.random.default_rng(seed)
    shares = np.array([b[2] for b in bands], dtype=np.float64)
    counts = np.floor(shares / shares.sum() * n_lines).astype(int)
    counts[0] += n_lines - counts.sum()
    nu, S = [], []
    for (centre, half, _), k in zip(bands, counts):
        x = rng.uniform(-1.0, 1.0, k)
        nu.append(centre + half * x)
        S.append(10.0 ** rng.uniform(*logS, k) * np.exp(-2.0 * x * x))
    nu = np.concatenate(nu)
    S = np.concatenate(S)
    iso = rng.choice(np.array(list(isos)), size=n_lines, p=iso_p)
    par = {
        "M": np.full(n_lines, molecule, dtype=np.int16),
        "I": iso.astype("U1"),
        "nu": nu,
        "S": S,
        "A": 10.0 ** rng.uniform(-3.0, 2.0, n_lines),
        "ga": rng.uniform(*ga, n_lines),
        "gs": rng.uniform(*gs, n_lines),
        "Epp": rng.uniform(*Epp, n_lines),
        "na": rng.uniform(*na, n_lines),
        "delta": rng.uniform(-0.005, 0.0, n_lines),
    }
    idx = np.argsort(par["nu"], kind="stable")
    return {k: v[idx] for k, v in par.items()}


def molparam() -> dict:
    """Molar masses, abundances and TIPS Q(T)/Qref Chebyshev coefficients of
    the isotopologues the catalogs use, by molecule and isotopologue label."""
    return json.loads(_MOLPARAM.read_text())["molecules"]


def line_table(par: dict, conc: float) -> dict:
    """Float64 per-line arrays of one gas for the plain reference: position,
    reference intensity, broadening, lower-state energy, temperature
    exponent, molar mass, the TIPS coefficients [n_lines, ncheb] and the
    gas's molar concentration on every line."""
    mol = molparam()[str(int(par["M"][0]))]["isotopologues"]
    ncheb = max(len(v["cheb"]) for v in mol.values())
    cheb = {k: np.pad(np.asarray(v["cheb"]), (0, ncheb - len(v["cheb"]))) for k, v in mol.items()}
    order = np.argsort(par["nu"], kind="stable")
    iso = np.asarray(par["I"])[order]
    return {
        "nu": np.asarray(par["nu"], np.float64)[order],
        "S": np.asarray(par["S"], np.float64)[order],
        "ga": np.asarray(par["ga"], np.float64)[order],
        "gs": np.asarray(par["gs"], np.float64)[order],
        "Epp": np.asarray(par["Epp"], np.float64)[order],
        "na": np.asarray(par["na"], np.float64)[order],
        "mu": np.array([mol[i]["mu"] for i in iso]),
        "cheb": np.stack([cheb[i] for i in iso]),
        "conc": np.full(len(iso), float(conc)),
    }


def merge_tables(tables: list[dict]) -> dict:
    """One table of several gases' lines, sorted by position (a mixture's
    line sum runs over the merged catalog, each line at its gas's
    concentration)."""
    ncheb = max(t["cheb"].shape[1] for t in tables)
    cat = {k: np.concatenate([t[k] for t in tables]) for k in tables[0] if k != "cheb"}
    cat["cheb"] = np.concatenate([np.pad(t["cheb"], ((0, 0), (0, ncheb - t["cheb"].shape[1])))
                                  for t in tables])
    order = np.argsort(cat["nu"], kind="stable")
    return {k: v[order] for k, v in cat.items()}

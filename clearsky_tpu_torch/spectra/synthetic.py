"""Synthetic HITRAN data: line lists and a CIA table made from a seed.

The repository carries no HITRAN file, so the tests and ``chip_smoke.py``
build their catalogs here with numpy only: a ``read_par``-style dict feeds
``SpectralLines.from_par_dict`` of both packages, and :func:`write_par` /
:func:`write_cia` write the same data in HITRAN's fixed-width formats, so
that the readers (``spectra.par.read_par``, ``absorption.cia.read_cia``)
are exercised on real file layouts. These writers are test data, not a
part of the package's interface.
"""

from __future__ import annotations

import numpy as np

__all__ = ["CO2_BANDS", "H2O_BANDS", "synthetic_co2_par", "synthetic_h2o_par",
           "synthetic_co2_cia", "write_par", "write_cia"]

# (centre, half-width [cm^-1], share of the lines): the 15 um bending band,
# the 10.4/9.4 um laser bands and the 4.3 um asymmetric-stretch band
CO2_BANDS = ((667.4, 90.0, 0.50), (961.0, 40.0, 0.08), (1063.7, 40.0, 0.08),
             (2349.1, 70.0, 0.34))
# water: the pure-rotation band below 600 cm^-1, the 6.3 um bending band and
# the 2.7 um stretching bands
H2O_BANDS = ((300.0, 290.0, 0.45), (1595.0, 150.0, 0.30), (3700.0, 180.0, 0.25))


def _synthetic_par(M, n_lines, seed, bands, isos, iso_p, logS, ga, gs, Epp, na):
    rng = np.random.default_rng(seed)
    shares = np.array([b[2] for b in bands], dtype=np.float64)
    counts = np.floor(shares / shares.sum() * n_lines).astype(int)
    counts[0] += n_lines - counts.sum()
    nu, S = [], []
    for (centre, half, _), k in zip(bands, counts):
        x = rng.uniform(-1.0, 1.0, k)
        nu.append(centre + half * x)
        # log-uniform strengths, tapered toward the band wings
        S.append(10.0 ** rng.uniform(*logS, k) * np.exp(-2.0 * x * x))
    nu = np.concatenate(nu)
    S = np.concatenate(S)
    iso = rng.choice(np.array(list(isos)), size=n_lines, p=iso_p)
    par = {
        "M": np.full(n_lines, M, dtype=np.int16),
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


def synthetic_co2_par(n_lines: int, seed: int = 0, bands=CO2_BANDS) -> dict:
    """A ``read_par``-style dict of ``n_lines`` CO2 (HITRAN molecule 2) lines.

    Positions are uniform within each band; intensities are log-uniform over
    1e-28..1e-18 cm/molecule and strongest near the band centres; broadening
    and lower-state energies lie in HITRAN's CO2 ranges; isotopologues are
    mostly '1' with some '2' and '3'. Sorted ascending in wavenumber.
    """
    return _synthetic_par(2, n_lines, seed, bands, "123", [0.9, 0.07, 0.03], (-28.0, -18.0),
                          (0.055, 0.085), (0.075, 0.105), (0.0, 3000.0), (0.65, 0.78))


def synthetic_h2o_par(n_lines: int, seed: int = 0, bands=H2O_BANDS) -> dict:
    """A ``read_par``-style dict of ``n_lines`` H2O (HITRAN molecule 1) lines
    in ``bands``, isotopologues '1'-'4', intensities log-uniform over
    1e-27..1e-19, HITRAN's water ranges of broadening (self-broadening
    several times the air value) and lower-state energy."""
    return _synthetic_par(1, n_lines, seed, bands, "1234", [0.85, 0.07, 0.05, 0.03],
                          (-27.0, -19.0), (0.06, 0.10), (0.20, 0.50), (0.0, 4000.0),
                          (0.50, 0.80))


def _fixed(x: float, width: int, decimals: int) -> str:
    """Fortran Fw.d: the leading zero goes where the field needs the room."""
    s = f"{x:.{decimals}f}"
    if len(s) > width:
        s = s.replace("0.", ".", 1)
    if len(s) > width:
        raise ValueError(f"{x} does not fit F{width}.{decimals}")
    return s.rjust(width)


def write_par(path: str, par: dict) -> None:
    """Write a ``read_par``-style dict as HITRAN 2004 160-character records
    (``da`` from the key ``da`` or ``delta``; quantum numbers and references
    are placeholders)."""
    da = par.get("da", par.get("delta"))
    recs = []
    for i in range(len(par["nu"])):
        r = (f"{int(par['M'][i]):2d}{par['I'][i]}{par['nu'][i]:12.6f}{par['S'][i]:10.3E}"
             f"{par['A'][i]:10.3E}{_fixed(par['ga'][i], 5, 4)}{_fixed(par['gs'][i], 5, 3)}"
             f"{par['Epp'][i]:10.4f}{_fixed(par['na'][i], 4, 2)}{_fixed(da[i], 8, 6)}"
             + "0 0 0 01".rjust(15) * 2 + "R 12e".rjust(15) * 2
             + "465554" + "     1     1" + " " + f"{1.0:7.1f}{1.0:7.1f}")
        if len(r) != 160:
            raise ValueError(f"record {i} has {len(r)} characters, not 160")
        recs.append(r)
    with open(path, "w") as f:
        f.write("\n".join(recs) + "\n")


def synthetic_co2_cia(seed: int = 0) -> list[dict]:
    """CO2-CO2 collision-induced absorption in ``read_cia``'s records.

    One range over 1-750 cm^-1 at six temperatures 200-400 K, with k
    falling from ~1e-43 to ~1e-47 cm^5/molecule^2 (all below float32's
    normal range), and one single-temperature range over 1150-1450 cm^-1
    (296 K) whose first and last values are 0.
    """
    rng = np.random.default_rng(seed)
    out = []
    nu = np.linspace(1.0, 750.0, 750)
    for T in np.linspace(200.0, 400.0, 6):
        logk = -43.0 - 4.0 * ((nu - 1.0) / 749.0) ** 0.6 + 0.2 * (T - 300.0) / 100.0
        logk = np.clip(logk + rng.normal(0.0, 0.02, nu.shape), -47.0, -43.0)
        out.append(dict(symbol="CO2-CO2", numin=1.0, numax=750.0, npts=nu.size, T=float(T),
                        nu=nu, k=10.0 ** logk, res=0.5, comments="synthetic", reference=1))
    nu = np.linspace(1150.0, 1450.0, 301)
    k = 1e-45 * np.exp(-(((nu - 1300.0) / 60.0) ** 2)) * 10.0 ** rng.normal(0.0, 0.02, nu.shape)
    k[0] = k[-1] = 0.0
    out.append(dict(symbol="CO2-CO2", numin=1150.0, numax=1450.0, npts=nu.size, T=296.0,
                    nu=nu, k=k, res=1.0, comments="synthetic single", reference=2))
    for r in out:
        r["maxcia"] = float(r["k"].max())
    return out


def write_cia(path: str, records: list[dict]) -> None:
    """Write ``read_cia``-style records as a HITRAN .cia file: a
    100-character header per (range, temperature), then (nu, k) lines."""
    rows = []
    for r in records:
        head = (f"{r['symbol']:>20}{r['numin']:10.3f}{r['numax']:10.3f}{len(r['nu']):7d}"
                f"{r['T']:7.1f}{r['maxcia']:10.3E}{r['res']:6.3f}{r['comments']:<27}"
                f"{r['reference']:3d}")
        if len(head) != 100:
            raise ValueError(f"header has {len(head)} characters, not 100")
        rows.append(head)
        rows += [f"{a:10.4f} {b:10.3E}" for a, b in zip(r["nu"], r["k"])]
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")

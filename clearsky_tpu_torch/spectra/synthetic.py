"""A synthetic CO2-like line list in the layout ``read_par`` returns.

The repository carries no HITRAN file, so the tests and ``chip_smoke.py``
build their catalogs here, from a seed, with numpy only: the same dict feeds
``SpectralLines.from_par_dict`` of both packages.
"""

from __future__ import annotations

import numpy as np

__all__ = ["CO2_BANDS", "synthetic_co2_par"]

# (centre, half-width [cm^-1], share of the lines): the 15 um bending band,
# the 10.4/9.4 um laser bands and the 4.3 um asymmetric-stretch band
CO2_BANDS = ((667.4, 90.0, 0.50), (961.0, 40.0, 0.08), (1063.7, 40.0, 0.08),
             (2349.1, 70.0, 0.34))


def synthetic_co2_par(n_lines: int, seed: int = 0, bands=CO2_BANDS) -> dict:
    """A ``read_par``-style dict of ``n_lines`` CO2 (HITRAN molecule 2) lines.

    Positions are uniform within each band; intensities are log-uniform over
    1e-28..1e-18 cm/molecule and strongest near the band centres; broadening
    and lower-state energies lie in HITRAN's CO2 ranges; isotopologues are
    mostly '1' with some '2' and '3'. Sorted ascending in wavenumber.
    """
    rng = np.random.default_rng(seed)
    shares = np.array([b[2] for b in bands], dtype=np.float64)
    counts = np.floor(shares / shares.sum() * n_lines).astype(int)
    counts[0] += n_lines - counts.sum()
    nu, S = [], []
    for (centre, half, _), k in zip(bands, counts):
        x = rng.uniform(-1.0, 1.0, k)
        nu.append(centre + half * x)
        # log-uniform strengths, tapered toward the band wings
        S.append(10.0 ** rng.uniform(-28.0, -18.0, k) * np.exp(-2.0 * x * x))
    nu = np.concatenate(nu)
    S = np.concatenate(S)
    iso = rng.choice(np.array(["1", "2", "3"]), size=n_lines, p=[0.9, 0.07, 0.03])
    par = {
        "M": np.full(n_lines, 2, dtype=np.int16),
        "I": iso.astype("U1"),
        "nu": nu,
        "S": S,
        "A": 10.0 ** rng.uniform(-3.0, 2.0, n_lines),
        "ga": rng.uniform(0.055, 0.085, n_lines),
        "gs": rng.uniform(0.075, 0.105, n_lines),
        "Epp": rng.uniform(0.0, 3000.0, n_lines),
        "na": rng.uniform(0.65, 0.78, n_lines),
        "delta": rng.uniform(-0.005, 0.0, n_lines),
    }
    idx = np.argsort(par["nu"], kind="stable")
    return {k: v[idx] for k, v in par.items()}

"""Orbital forcing: Keplerian mechanics and insolation factors.

Counterpart of ``clearsky_tpu.orbital``.
"""

from .orbits import (
    periapsis,
    apoapsis,
    semimajoraxis,
    eccentricity,
    meananomaly,
    trueanomaly,
    eccentricanomaly,
    orbitalperiod,
    orbitaldistance,
    orbit,
)
from .insolation import (
    substellarlatitude,
    hourangle,
    diurnalfluxfactor,
    diurnalfluxfactors,
    annualfluxfactor,
    annualfluxfactors,
)

__all__ = [
    "periapsis",
    "apoapsis",
    "semimajoraxis",
    "eccentricity",
    "meananomaly",
    "trueanomaly",
    "eccentricanomaly",
    "orbitalperiod",
    "orbitaldistance",
    "orbit",
    "substellarlatitude",
    "hourangle",
    "diurnalfluxfactor",
    "diurnalfluxfactors",
    "annualfluxfactor",
    "annualfluxfactors",
]

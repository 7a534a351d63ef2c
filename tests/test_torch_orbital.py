"""The port's orbital module against the JAX package.

Every function of ``orbital`` on seeded numpy inputs, float64 on the CPU,
arrays of eccentricity (0 and near 1 included), obliquity and precession:
rtol 1e-12 (the same fixed-count Newton solve of Kepler's equation, the
same composite Gauss-Legendre rule). Also the float32 annual factors
against float64 (1e-6 at the Earth's eccentricity), the defining equation
M = E - e sin E and the grids' placement.
"""

import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from clearsky_tpu import orbital as jo
import clearsky_tpu_torch as ct
from clearsky_tpu_torch import orbital as to

torch.set_num_threads(2)

AU = 1.495978707e11
M_SUN = 1.98892e30
YEAR = 365.25 * 86400.0
CPU64 = dict(dtype=torch.float64, device="cpu")
ECC = np.array([0.0, 0.0167, 0.3, 0.7, 0.96])


def _t(x):
    return torch.tensor(np.asarray(x, np.float64))


def _close(b, a, rtol=1e-12, atol_of_peak=1e-12):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert b.shape == a.shape
    np.testing.assert_allclose(b, a, rtol=rtol, atol=atol_of_peak * max(np.abs(a).max(), 1e-300))


def _inputs():
    rng = np.random.default_rng(21)
    n = 64
    return dict(a=rng.uniform(0.5, 5.0, n) * AU, e=rng.choice(ECC, n), m=M_SUN,
                t=rng.uniform(0.0, 3.0 * YEAR, n), E=rng.uniform(0.0, 2 * np.pi, n),
                f=rng.uniform(0.0, 2 * np.pi, n), T=rng.uniform(0.1, 30.0, n) * YEAR,
                theta=rng.uniform(-np.pi / 2, np.pi / 2, n),
                gamma=rng.uniform(0.0, np.pi / 2, n), p=rng.uniform(0.0, 2 * np.pi, n))


CASES = {
    "periapsis": ("periapsis", "a", "e"), "apoapsis": ("apoapsis", "a", "e"),
    "semimajoraxis": ("semimajoraxis", "T", "m"),
    "eccentricity": ("eccentricity", "rp", "ra"), "meananomaly": ("meananomaly", "E", "e"),
    "orbitalperiod": ("orbitalperiod", "a", "m"),
    "eccentricanomaly": ("eccentricanomaly", "t", "a", "m", "e"),
    "trueanomaly(E, e)": ("trueanomaly", "E", "e"),
    "trueanomaly(t, a, m, e)": ("trueanomaly", "t", "a", "m", "e"),
    "orbitaldistance(a, f, e)": ("orbitaldistance", "a", "f", "e"),
    "orbitaldistance(t, a, m, e)": ("orbitaldistance", "t", "a", "m", "e"),
    "substellarlatitude": ("substellarlatitude", "f", "gamma"),
    "hourangle": ("hourangle", "theta", "theta_s"),
    "diurnalfluxfactor(theta, theta_s)": ("diurnalfluxfactor", "theta", "theta_s"),
    "diurnalfluxfactor(theta, f, gamma)": ("diurnalfluxfactor", "theta", "f", "gamma"),
    "diurnalfluxfactor(t, a, m, e, theta, gamma, p)": (
        "diurnalfluxfactor", "t", "a", "m", "e", "theta", "gamma", "p"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_orbital_function_matches(case):
    x = _inputs()
    x["rp"], x["ra"] = x["a"] * (1 - x["e"]), x["a"] * (1 + x["e"])
    x["theta_s"] = np.arcsin(np.cos(x["f"]) * np.sin(x["gamma"]))
    name, *keys = CASES[case]
    args = [x[k] for k in keys]
    b = getattr(to, name)(*(_t(v) if isinstance(v, np.ndarray) else v for v in args))
    a = getattr(jo, name)(*(jnp.asarray(v) if isinstance(v, np.ndarray) else v for v in args))
    _close(b, a)


def test_orbit_matches():
    for e in ECC:
        b = to.orbit(AU, M_SUN, float(e), N=200, **CPU64)
        a = jo.orbit(AU, M_SUN, float(e), N=200)
        for x, y in zip(b, a):
            _close(x, y, atol_of_peak=1e-12)
    t, r, f = to.orbit(AU, M_SUN, 0.4, N=500, **CPU64)
    assert bool(((f >= 0) & (f < 2 * math.pi)).all())
    assert abs(float(r.min()) - AU * 0.6) / AU < 1e-6


@pytest.mark.parametrize("form", ["circular", "elliptical"])
def test_diurnal_grids_match(form):
    args = (0.41,) if form == "circular" else (AU, M_SUN, 0.3, 0.41, 1.2)
    b = to.diurnalfluxfactors(*args, nf=31, nt=31, ntheta=19, **CPU64)
    a = jo.diurnalfluxfactors(*args, nf=31, nt=31, ntheta=19)
    for x, y in zip(b, a):
        _close(x, y)


@pytest.mark.parametrize("e", list(ECC))
def test_annual_factors_match(e):
    for gamma, p in ((0.0, 0.0), (0.41, 1.3), (1.2, 4.0)):
        th, F = to.annualfluxfactors(float(e), gamma, p, ntheta=37, **CPU64)
        thj, Fj = jo.annualfluxfactors(float(e), gamma, p, ntheta=37)
        _close(th, thj)
        _close(F, Fj)
    theta = np.array([[-0.3, 0.2], [0.9, 1.5]])
    _close(to.annualfluxfactor(float(e), _t(theta), 0.41, 1.0),
           jo.annualfluxfactor(float(e), jnp.asarray(theta), 0.41, 1.0))


def test_kepler_solve_and_float32():
    t = _t(np.linspace(0.0, YEAR, 37))
    T = float(to.orbitalperiod(AU, M_SUN))
    for e in (0.0, 0.5, 0.96):
        E = to.eccentricanomaly(t, AU, M_SUN, e)
        M = 2 * math.pi * torch.remainder(t, T) / T
        assert float((to.meananomaly(E, e) - M).abs().max()) < 1e-10
    # float32 in, float32 out (numbers as float64 CPU scalars do not widen)
    th32, F32 = to.annualfluxfactors(0.0167, 0.41, 1.0, dtype=torch.float32, device="cpu")
    assert F32.dtype == torch.float32
    th64, F64 = to.annualfluxfactors(0.0167, 0.41, 1.0, **CPU64)
    assert float((F32.double() - F64).abs().max()) < 1e-6
    assert ct.annualfluxfactors is to.annualfluxfactors and ct.orbital is to

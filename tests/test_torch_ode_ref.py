"""The port's scipy validation oracle against the JAX package's, and the
port's discretized core converging to it.

Gray and semi-gray columns on a dry adiabat with a 150 K floor, float64 on
the CPU: ``ode_outgoing``, ``ode_optical_depth`` and ``ode_monoflux`` of
both packages integrate the same right-hand sides with the same adaptive
Radau settings (rtol 1e-9 between them), and the port's ``outgoing`` and
``optical_depth`` approach the port's oracle as the grid refines, at the
bars of ``tests/test_ode_ref.py``. No process pool runs here.
"""

import numpy as np
import pytest
import torch

from clearsky_tpu.absorption.absorbers import unify_absorbers as junify
from clearsky_tpu.absorption.gas import GrayGas as JGrayGas, SemiGrayGas as JSemiGray
from clearsky_tpu.rt import ode_ref as jode
import clearsky_tpu_torch as ct
from clearsky_tpu_torch.constants import R_GAS
from clearsky_tpu_torch.rt import ode_ref as tode

torch.set_num_threads(2)

G, MU, CP, PS, TS = 9.8, 0.029, 1e3, 1e5, 290.0
CPU64 = dict(dtype=torch.float64, device="cpu")
K = R_GAS / (MU * CP)


def _profiles(pkg):
    if pkg == "jax":
        return (lambda P: np.maximum(TS * (np.asarray(P) / PS) ** K, 150.0),
                lambda T, P: MU)
    return lambda P: torch.clamp(TS * (P / PS) ** K, min=150.0), lambda T, P: MU


def _gas(kind, nu):
    if kind == "gray":
        return JGrayGas.create(2e-26, nu), ct.GrayGas.create(2e-26, nu, **CPU64)
    return (JSemiGray.create(4e-26, nu, nucut=1200.0),
            ct.SemiGrayGas.create(4e-26, nu, 1200.0, **CPU64))


@pytest.mark.parametrize("kind", ["gray", "semigray"])
def test_ode_outgoing_matches_jax(kind):
    jg, tg = _gas(kind, np.linspace(10.0, 3000.0, 24))
    a = jode.ode_outgoing(PS, G, *_profiles("jax"), junify((jg,)), Ptop=1.0)
    b = tode.ode_outgoing(PS, G, *_profiles("torch"), ct.unify_absorbers((tg,)), Ptop=1.0)
    assert isinstance(b, np.ndarray) and b.dtype == np.float64
    np.testing.assert_allclose(b, a, rtol=1e-9)


@pytest.mark.parametrize("kind", ["gray", "semigray"])
def test_ode_optical_depth_matches_jax(kind):
    jg, tg = _gas(kind, np.linspace(10.0, 3000.0, 16))
    a = jode.ode_optical_depth(PS, 1.0, G, *_profiles("jax"), junify((jg,)), theta=0.5)
    b = tode.ode_optical_depth(PS, 1.0, G, *_profiles("torch"), ct.unify_absorbers((tg,)),
                               theta=0.5)
    np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-300)


@pytest.mark.parametrize("kind", ["gray", "semigray"])
def test_ode_monoflux_matches_jax(kind):
    nu = np.linspace(10.0, 3000.0, 16)
    jg, tg = _gas(kind, nu)
    P = np.geomspace(10.0, PS, 8)
    S = np.full(16, 0.1)
    kw = dict(S_nu=S, albedo_nu=0.3, nstream=4)
    a = jode.ode_monoflux(P, G, *_profiles("jax"), junify((jg,)), **kw)
    b = tode.ode_monoflux(P, G, *_profiles("torch"), ct.unify_absorbers((tg,)), **kw)
    for x, y in zip(b, a):
        np.testing.assert_allclose(x, y, rtol=1e-9, atol=1e-9 * np.abs(y).max())


def test_outgoing_converges_to_the_port_oracle():
    nu = np.linspace(10.0, 3000.0, 40)
    gas = ct.SemiGrayGas.create(4e-26, nu, 1200.0, **CPU64)
    fT, fmu = _profiles("torch")
    ref = tode.ode_outgoing(PS, G, fT, fmu, ct.unify_absorbers((gas,)), Ptop=1.0, nstream=5)
    errs = []
    for nlevels, tol in [(64, 0.04), (256, 0.01)]:
        ours = ct.outgoing(PS, G, fT, fmu, gas, Ptop=1.0, nstream=5, nlevels=nlevels).numpy()
        rel = np.abs(ours - ref) / np.abs(ref)
        assert rel.max() < tol, (nlevels, rel.max())
        errs.append(rel.max())
    assert errs[1] < errs[0]
    # the grid-refined core on the coarse grid closes in on it as well
    coarse = ct.outgoing(PS, G, fT, fmu, gas, Ptop=1.0, nlevels=16).numpy()
    refined = ct.outgoing(PS, G, fT, fmu, gas, Ptop=1.0, nlevels=16,
                          core=ct.RadauEq(refine=8)).numpy()
    assert np.abs(refined - ref).max() < 0.5 * np.abs(coarse - ref).max()


def test_optical_depth_converges_to_the_port_oracle():
    nu = np.linspace(10.0, 3000.0, 16)
    gas = ct.GrayGas.create(2e-26, nu, **CPU64)
    fT, fmu = _profiles("torch")
    ref = tode.ode_optical_depth(PS, 1.0, G, fT, fmu, ct.unify_absorbers((gas,)), theta=0.5)
    ours = ct.optical_depth((PS, 1.0), G, fT, fmu, 0.5, gas, nlevels=256).numpy()
    np.testing.assert_allclose(ours, ref, rtol=2e-3)


def test_ode_heating_matches_jax():
    """The oracle's heating on an RCM of each package (serial legs)."""
    from clearsky_tpu.models import rcm as jr

    nu = np.linspace(10.0, 2500.0, 12)
    Pe = ct.pressuregrid(100.0, PS, 6)
    Te = np.maximum(TS * (Pe / PS) ** K, 150.0)
    args = (Pe, Te, G, lambda T, P: MU, 0.05, 0.2, lambda T, P: CP, 1e7)
    jg, tg = _gas("semigray", nu)
    rj = jr.RCM.create(*args, jg, radmul=1)
    rt = ct.RCM.create(*args, tg, radmul=1)
    kw = dict(nstream=4, rtol=1e-7, atol=1e-9)
    a = jode.ode_heating(rj, **kw)
    b = tode.ode_heating(rt, **kw)
    np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-9 * np.abs(a).max())

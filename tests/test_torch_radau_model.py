"""The model API on the adaptive Radau core against the JAX package, in
float64 on the CPU: the RCM's heating (tol 1e-7, within 1e-8 of peak; the
discretized core within the JAX suite's 3%), ``convert.rcm`` of a JAX RCM on
``Radau``, ``models.sweep.batched_heating`` of a Radau RCM against JAX's
``vmap`` at 2 columns (each column also against the single column's
heating), and ``jacobian``: by differences against JAX's, and forward mode
(``torch.func.jacfwd`` through the plain engine, the kernel's derivative
twin) against the port's differences. The column is
tests/test_torch_radau.py's synthetic 60-line CO2 one at Earth's 4e-4.
"""

import dataclasses

import numpy as np
import torch
import jax.numpy as jnp

import clearsky_tpu as jpkg
from clearsky_tpu.absorption.gas import DirectGas as JDirectGas
from clearsky_tpu.models import rcm as jrcm, sweep as jsweep
from clearsky_tpu.spectra.lines import SpectralLines as JLines
import clearsky_tpu_torch as ct
from clearsky_tpu_torch import convert
from clearsky_tpu_torch.models import rcm as trcm, sweep as tsweep

import pytest

torch.set_num_threads(2)

G = 10.0
CO2 = 4e-4


def _t(x):
    return torch.tensor(np.asarray(x, np.float64))


def _of_peak(b, a) -> float:
    a = np.asarray(a, np.float64)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape
    return float(np.nanmax(np.abs(b - a)) / np.nanmax(np.abs(a)))


def _fmu(T, P):
    return 0.044


@pytest.fixture(scope="module")
def co2():
    par = ct.synthetic_co2_par(60, seed=3)
    tl = ct.SpectralLines.from_par_dict(par, dtype=torch.float64, device="cpu")
    p64 = tl.positions64()
    nu = np.linspace(max(p64.min() - 25.0, 1.0), p64.max() + 25.0, 96)
    return dict(jg=JDirectGas.from_lines(JLines.from_par_dict(par), CO2, nu),
                tg=ct.DirectGas.from_lines(tl, CO2, nu), nu=nu)


def _rcms(co2, tol=1e-7, levels=10):
    Pe = np.exp(np.linspace(np.log(10.0), np.log(1e5), levels))
    Te = 190.0 + 12.0 * np.log(Pe / 10.0)
    fcp = lambda T, P: 850.0
    rj = jpkg.RCM.create(Pe, Te, G, _fmu, 0.0, 0.0, fcp, 1e7, co2["jg"], core=jpkg.Radau(tol=tol))
    rt = ct.RCM.create(Pe, Te, G, _fmu, 0.0, 0.0, fcp, 1e7, co2["tg"], core=ct.Radau(tol=tol))
    return rj, rt


def test_radau_rcm_heating_matches_jax(co2):
    rj, rt = _rcms(co2)
    a = np.asarray(jrcm.heating(rj))
    b = trcm.heating(rt)
    assert _of_peak(b, a) <= 1e-8
    # the discretized core agrees within the JAX suite's 3% of peak
    r_d = ct.RCM.create(rt.Pe.numpy(), np.asarray(rj.A.T), G, _fmu, 0.0, 0.0,
                        lambda T, P: 850.0, 1e7, co2["tg"])
    assert _of_peak(b, trcm.heating(r_d)) <= 0.03
    # convert.rcm carries the JAX model's Radau core across
    rc = convert.rcm(rj, co2["tg"], fmu=_fmu, fcp=lambda T, P: 850.0)
    assert isinstance(rc.core, ct.Radau) and rc.core == rt.core
    assert _of_peak(trcm.heating(rc), a) <= 1e-8


def test_radau_batched_heating_matches_jax_vmap(co2):
    rj, rt = _rcms(co2, tol=1e-5, levels=6)
    rng = np.random.default_rng(5)
    T_b = np.asarray(rj.T)[None] + rng.uniform(-5.0, 5.0, (2, rj.T.shape[0]))
    f = np.array([0.7, 1.3])
    rj = dataclasses.replace(rj, S_nu=jnp.full_like(rj.S_nu, 3.0))
    rt = dataclasses.replace(rt, S_nu=torch.full_like(rt.S_nu, 3.0))
    a = np.asarray(jsweep.batched_heating(rj, jnp.asarray(T_b), jnp.asarray(f)))
    b = tsweep.batched_heating(rt, _t(T_b), f)
    assert b.shape == (2, rt.T.shape[0])
    assert _of_peak(b, a) <= 1e-6
    # each column of the batch is the single column's heating
    for i in range(2):
        one = trcm.heating(tsweep._with_insolation(rt, float(f[i])), _t(T_b[i]))
        assert _of_peak(b[i], one.numpy()) <= 1e-6


def test_radau_jacobian(co2):
    rj, rt = _rcms(co2, tol=1e-4, levels=3)
    a = np.asarray(jrcm.jacobian(rj, mode="fd"))
    fd = trcm.jacobian(rt, mode="fd")
    assert _of_peak(fd, a) <= 1e-4
    fwd = trcm.jacobian(rt, mode="fwd")
    assert fwd.shape == fd.shape
    assert _of_peak(fwd, fd.numpy()) <= 0.05



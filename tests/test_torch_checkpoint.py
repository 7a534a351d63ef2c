"""Checkpoints across the two packages: a file written by either loads in
the other.

A baked Gas (full and split precision) from a synthetic 150-line CO2
catalog on 256 points, and an RCM's state after a step, saved by
``clearsky_tpu.utils.checkpoint`` and loaded by the port's, and the other
way round, float64 on the CPU: the cross-sections within rtol 1e-12, the
state arrays equal. A mismatched grid and a file of another format raise
``ValueError``, as in the JAX package.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from clearsky_tpu.absorption.domain import AtmosphericDomain as JDomain
from clearsky_tpu.absorption.gas import Gas as JGas, GrayGas as JGrayGas
from clearsky_tpu.models import rcm as jr
from clearsky_tpu.spectra.lines import SpectralLines as JLines
from clearsky_tpu.utils import checkpoint as jck
import clearsky_tpu_torch as ct
from clearsky_tpu_torch import convert
from clearsky_tpu_torch.constants import R_GAS
from clearsky_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(2)

CPU64 = dict(dtype=torch.float64, device="cpu")
DOMAIN = ((150.0, 350.0), 6, (10.0, 1e5), 8)
T = np.array([180.0, 230.0, 300.0])
P = np.array([30.0, 2e3, 8e4])


@pytest.fixture(scope="module")
def gases():
    par = ct.synthetic_co2_par(150, seed=9)
    jl = JLines.from_par_dict(par)
    nu = np.linspace(600.0, 740.0, 256)
    jg = JGas.from_lines(jl, 0.5, nu, JDomain.create(*DOMAIN))
    return {"full": jg, "split": jg.split_precision(8)}


def _sigma_t(gas):
    return gas(torch.tensor(T), torch.tensor(P)).numpy()


def _sigma_j(gas):
    return np.asarray(gas(jnp.asarray(T), jnp.asarray(P)))


@pytest.mark.parametrize("kind", ["full", "split"])
def test_jax_saved_gas_loads_in_the_port(gases, kind, tmp_path):
    jg = gases[kind]
    path = str(tmp_path / "gas.npz")
    jck.save_gas(path, jg)
    tg = tck.load_gas(path, fC=0.5, **CPU64)
    assert (tg.name, tg.formula, tg.mu) == (jg.name, jg.formula, jg.mu)
    assert (tg.lead_idx, tg.tail_idx) == (jg.lead_idx, jg.tail_idx)
    ref = _sigma_j(jg)
    np.testing.assert_allclose(_sigma_t(tg), ref, rtol=1e-12, atol=1e-300)
    assert tg.domain.nT == 6 and tg.domain.Pmax == 1e5


@pytest.mark.parametrize("kind", ["full", "split"])
def test_port_saved_gas_loads_in_jax(gases, kind, tmp_path):
    tg = convert.gas(gases[kind], 0.5, **CPU64)
    path = str(tmp_path / "gas.npz")
    tck.save_gas(path, tg)
    jg = jck.load_gas(path, fC=0.5)
    np.testing.assert_allclose(_sigma_j(jg), _sigma_t(tg), rtol=1e-12, atol=1e-300)
    # and back into the port, bit for bit
    back = tck.load_gas(path, fC=0.5, **CPU64)
    assert torch.equal(back.coeffs, tg.coeffs) and torch.equal(back.nu, tg.nu)
    if tg.coeffs_tail is not None:
        assert back.coeffs_tail.dtype == torch.bfloat16
        assert torch.equal(back.coeffs_tail.view(torch.int16), tg.coeffs_tail.view(torch.int16))


def test_load_gas_keeps_float32_bits(gases, tmp_path):
    tg = convert.gas(gases["split"], 0.5, dtype=torch.float32, device="cpu")
    path = str(tmp_path / "gas32.npz")
    tck.save_gas(path, tg)
    back = tck.load_gas(path, fC=0.5, dtype=torch.float32, device="cpu")
    assert back.coeffs.dtype == torch.float32 and torch.equal(back.coeffs, tg.coeffs)
    assert torch.equal(back(torch.tensor(T, dtype=torch.float32),
                            torch.tensor(P, dtype=torch.float32)),
                       tg(torch.tensor(T, dtype=torch.float32),
                          torch.tensor(P, dtype=torch.float32)))


def test_load_gas_rejects_other_npz(tmp_path):
    path = str(tmp_path / "junk.npz")
    np.savez(path, manifest=np.frombuffer(b'{"format":"x"}', dtype=np.uint8))
    with pytest.raises(ValueError, match="not a clearsky-tpu gas checkpoint"):
        tck.load_gas(path, **CPU64)


def _rcms(n_levels=12):
    nu = np.linspace(1.0, 2000.0, 128)
    Pe = ct.pressuregrid(10.0, 1e5, n_levels)
    Te = np.maximum(280.0 * (Pe / 1e5) ** (R_GAS / (0.029 * 1e3)), 150.0)
    args = (Pe, Te, 9.8, lambda T_, P_: 0.029, 0.0, 0.0, lambda T_, P_: 1e3, 1e7)
    rj = jr.RCM.create(*args, JGrayGas.create(5e-27, nu))
    rt = ct.RCM.create(*args, ct.GrayGas.create(5e-27, nu, **CPU64))
    return rj, rt


FIELDS = ("T", "Pe", "P", "Pr")


def test_rcm_state_crosses_both_ways(tmp_path):
    rj, rt = _rcms()
    rj2 = jr.step(rj, 600.0)
    rt2 = dataclasses.replace(ct.step(rt, 600.0), T=rt.T * 1.01)
    pj, pt = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jck.save_rcm_state(pj, rj2)
    tck.save_rcm_state(pt, rt2)
    into_port = tck.load_rcm_state(pj, rt)
    into_jax = jck.load_rcm_state(pt, rj)
    np.testing.assert_array_equal(into_port.T.numpy(), np.asarray(rj2.T))
    np.testing.assert_array_equal(into_port.A.ln_sigma.numpy(), np.asarray(rj2.A.ln_sigma))
    np.testing.assert_array_equal(into_port.A.T.numpy(), np.asarray(rj2.A.T))
    np.testing.assert_array_equal(np.asarray(into_jax.T), rt2.T.numpy())
    np.testing.assert_array_equal(np.asarray(into_jax.A.ln_sigma), rt2.A.ln_sigma.numpy())
    assert into_port.T.dtype == torch.float64 and into_port.core == rt.core
    # the restored state radiates as the saved one does
    np.testing.assert_allclose(ct.heating(into_port).numpy(), np.asarray(jr.heating(rj2)),
                               rtol=1e-10, atol=1e-10 * float(np.abs(jr.heating(rj2)).max()))


def test_rcm_state_rejects_another_grid(tmp_path):
    rj, rt = _rcms()
    path = str(tmp_path / "rce.npz")
    tck.save_rcm_state(path, rt)
    _, other = _rcms(13)
    with pytest.raises(ValueError, match="does not match"):
        tck.load_rcm_state(path, other)
    with pytest.raises(ValueError, match="does not match"):
        tck.load_rcm_state(path, ct.RCM.create(
            np.asarray(rj.Pe), np.asarray(rj.Pe) * 0 + 250.0, 9.8, lambda T_, P_: 0.029, 0.0,
            0.0, lambda T_, P_: 1e3, 1e7, rt.A.stack, radmul=3))

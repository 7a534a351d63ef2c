"""The port's flux marches (the module of kernels K2 and K3) against the JAX package.

The adversarial column of tests/test_march_pallas.py (transparent, 1e-9,
1e-4 and opaque 1e4 layers; widths that are no multiple of any block) goes
through the port's plain marches and through ``clearsky_tpu``'s scan oracle
and its Pallas kernels in interpret mode, all in float64: the arithmetic is
the same, so the bar is 1e-12. In float32 the port's plain march is held to
the JAX float32 scan at 3e-6 of peak. The CUDA kernels run only on a card
(tests/test_torch_kernels.py, chip_smoke.py).
"""

import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from clearsky_tpu.rt import discretized as jd
from clearsky_tpu.rt.march_pallas import monoflux_pallas, olr_pallas
from clearsky_tpu.utils.quadrature import stream_nodes
from clearsky_tpu_torch.rt import discretized as td
from clearsky_tpu_torch.rt.march_cuda import olr_march, monoflux_march

# the suite runs in several worker processes: a torch thread pool of every
# core in each of them oversubscribes the machine
torch.set_num_threads(2)

CTHETA = math.cos(0.841)


def _column(L=19, N=1500, seed=0):
    rng = np.random.default_rng(seed)
    tau = rng.exponential(0.5, (L, N))
    tau[0] = 0.0
    tau[1] = 1e-9
    tau[2] = 1e-4
    tau[-1, : N // 3] = 1e4
    B = 0.5 + rng.random((L + 1, N))
    S = rng.random(N)
    a = rng.random(N) * 0.5
    return tau, B, S, a


def _t(xs, dtype=torch.float64, device="cpu"):
    return [torch.tensor(x, dtype=dtype, device=device) for x in xs]


def _j(xs, dtype=np.float64):
    return [jnp.asarray(x, dtype) for x in xs]


@pytest.mark.parametrize("nstream", [1, 4, 5, 8])
def test_monoflux_matches_scan_and_pallas(nstream):
    col = _column(L=9, N=1100)
    up, dn = td._monoflux_scan(*_t(col), CTHETA, nstream)
    ct = jnp.cos(jnp.asarray(0.841))
    up_s, dn_s = jd._monoflux_scan(*_j(col), ct, nstream)
    m, W = stream_nodes(nstream)
    up_k, dn_k = monoflux_pallas(*_j(col), ct, m, W, interpret=True)
    for ref_up, ref_dn in ((up_s, dn_s), (up_k, dn_k)):
        np.testing.assert_allclose(up.numpy(), np.asarray(ref_up), rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(dn.numpy(), np.asarray(ref_dn), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("nstream", [1, 5, 8])
def test_olr_matches_scan_and_pallas(nstream):
    tau, B, _, _ = _column(L=9, N=1300, seed=1)
    olr = td._olr_scan(*_t((tau, B)), nstream).numpy()
    m, W = stream_nodes(nstream)
    for ref in (jd._olr_scan(*_j((tau, B)), nstream),
                olr_pallas(*_j((tau, B)), m, W, interpret=True)):
        np.testing.assert_allclose(olr, np.asarray(ref), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("vertical", [False, True])
def test_outgoing_flux_matches(vertical):
    tau, B, _, _ = _column(L=7, N=700, seed=2)
    out = td.outgoing_flux(*_t((tau, B)), 5, vertical=vertical).numpy()
    ref = np.asarray(jd.outgoing_flux(*_j((tau, B)), 5, vertical=vertical))
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-14)


def test_monoflux_entry_matches():
    col = _column(L=5, N=700, seed=3)
    tau, B, S, a = _t(col)
    nu = torch.linspace(1.0, 100.0, 700, dtype=torch.float64)
    up, dn = td.monoflux(tau, B, nu, S, a, 0.6, 4)
    up_j, dn_j = jd.monoflux(*_j(col[:2]), jnp.asarray(nu.numpy()), *_j(col[2:]), 0.6, 4)
    np.testing.assert_allclose(up.numpy(), np.asarray(up_j), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(dn.numpy(), np.asarray(dn_j), rtol=1e-12, atol=1e-14)


def test_f32_plain_march_matches_f32_scan():
    col = _column()
    up, dn = td._monoflux_scan(*_t(col, torch.float32), CTHETA, 5)
    up_s, dn_s = jd._monoflux_scan(*_j(col, np.float32),
                                   jnp.cos(jnp.asarray(0.841, jnp.float32)), 5)
    up_s, dn_s = np.asarray(up_s), np.asarray(dn_s)
    assert np.abs(up.numpy() - up_s).max() < 3e-6 * np.abs(up_s).max()
    assert np.abs(dn.numpy() - dn_s).max() < 3e-6 * np.abs(dn_s).max()


def test_layer_quadrature_matches():
    rng = np.random.default_rng(4)
    P = np.geomspace(10.0, 1e5, 9)
    k = 3
    sig = 10 ** rng.uniform(-30, -20, (8 * k, 64))
    muf = 0.02 + 0.03 * rng.random(8 * k)
    Pn = td.lobatto_pressures(torch.tensor(P), k)
    np.testing.assert_allclose(Pn.numpy(), np.asarray(jd.lobatto_pressures(jnp.asarray(P), k)),
                               rtol=1e-15)
    tau = td.layer_tau_flat(torch.tensor(P), torch.tensor(muf), torch.tensor(sig), 9.8, k)
    ref = jd.layer_tau_flat(jnp.asarray(P), jnp.asarray(muf), jnp.asarray(sig), 9.8, k)
    np.testing.assert_allclose(tau.numpy(), np.asarray(ref), rtol=1e-13)


def test_wrappers_on_cpu_take_the_plain_version():
    tau, B, S, a = _t(_column(L=6, N=300, seed=5))
    m, W = stream_nodes(5)
    n_olr, n_mono = olr_march.launches, monoflux_march.launches
    np.testing.assert_array_equal(olr_march(tau, B, m, W).numpy(),
                                  td._olr_march(tau, B, m, W).numpy())
    up, dn = monoflux_march(tau, B, S, a, CTHETA, m, W)
    up_p, dn_p = td._monoflux_march(tau, B, S, a, CTHETA, m, W)
    np.testing.assert_array_equal(up.numpy(), up_p.numpy())
    np.testing.assert_array_equal(dn.numpy(), dn_p.numpy())
    assert (olr_march.launches, monoflux_march.launches) == (n_olr, n_mono)

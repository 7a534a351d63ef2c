"""The batched RCE sweeps (``clearsky_tpu_torch.models.sweep``) against the
JAX package's ``clearsky_tpu.models.sweep``, float64 on the CPU.

The same numpy inputs go to both packages: the JAX sweep tests' gray column
(tests/test_sweep.py), a synthetic CO2 ``DirectGas`` and a synthetic CO2 +
H2O ``MultiGas`` built in memory through both packages'
``SpectralLines.from_par_dict``. Bars: the batched heating rtol 1e-9 (the
JAX package's own vmap-against-loop class; the port's batch against its
own single-column loop, the same arithmetic, 1e-12), ``run_sweep``'s
temperatures and cached ln sigma rtol 1e-10, the sharded sweep over gloo
ranks 1e-9 (the all-reduce reassociates the spectral integral), the batched
convective adjustment bit for bit against the per-column one and 1e-13
against ``vmap(lapse)``. The route decision of a batched refresh is host
logic: every route the RCM can take, with the kernels' launches replaced
by recorders.
"""

import dataclasses
import math
import os
import pathlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from clearsky_tpu import parallel as jpar
from clearsky_tpu.absorption.gas import (DirectGas as JDirectGas, GrayGas as JGray,
                                         MultiGas as JMultiGas)
from clearsky_tpu.atmosphere import adiabats as ja
from clearsky_tpu.models import rcm as jr
from clearsky_tpu.models import sweep as jsw
from clearsky_tpu.spectra.lines import SpectralLines as JLines
from clearsky_tpu.utils.grids import logrange, pressuregrid
import clearsky_tpu_torch as ct
from clearsky_tpu_torch import convert
from clearsky_tpu_torch import parallel as tpar
from clearsky_tpu_torch.constants import R_GAS
from clearsky_tpu_torch.models import sweep as tsw
from clearsky_tpu_torch.ops import linesum_cuda
from clearsky_tpu_torch.ops import linesum_strategies as ls
from clearsky_tpu_torch.spectra.synthetic import synthetic_co2_par, synthetic_h2o_par
from clearsky_tpu_torch.utils import twin

from test_torch_parallel import _spawn

torch.set_num_threads(2)

G, MU, CP, PS = 9.8, 0.029, 1e3, 1e5
CPU64 = dict(dtype=torch.float64, device="cpu")
S0 = 340.0 / np.cos(0.841)
FACTORS = np.array([0.5, 1.0, 2.0])
N_LBL = 128


def _close(got, want, rtol, err_msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, err_msg
    np.testing.assert_allclose(got, want, rtol=rtol, err_msg=err_msg)


def _gray_pair(nnu=256):
    """Both packages' RCM on tests/test_sweep.py's gray column."""
    nu = np.concatenate([logrange(1e-6, 1e4, nnu - 1, 3), [1e5]])
    Pe = pressuregrid(10.0, PS, 16)
    Te = np.maximum(250.0 * (Pe / PS) ** (R_GAS / (MU * CP)), 150.0)
    f = S0 / (1e5 - 1e-6)
    jm = jr.RCM.create(Pe, Te, G, lambda T, P: MU, lambda v: jnp.full(jnp.shape(v), f), 0.1,
                       lambda T, P: CP, 1e6, JGray.create(3e-27, nu))
    tm = ct.RCM.create(Pe, Te, G, lambda T, P: MU, lambda v: torch.full_like(v, f), 0.1,
                       lambda T, P: CP, 1e6, ct.GrayGas.create(3e-27, nu, **CPU64))
    return jm, tm


def _lbl_column(nu):
    Pe = pressuregrid(10.0, PS, 10)
    Te = np.maximum(260.0 * (Pe / PS) ** (R_GAS / (MU * CP)), 150.0)
    return Pe, Te, S0 / float(nu[-1] - nu[0])


def _port_lbl_rcm(kind="direct"):
    """The port's line-by-line column, from the seed alone (the spawned
    ranks build it so)."""
    co2 = ct.SpectralLines.from_par_dict(synthetic_co2_par(150, seed=11), **CPU64)
    pos = co2.positions64()
    nu = np.linspace(max(pos.min() - 25.0, 1.0), pos.max() + 25.0, N_LBL)
    if kind == "direct":
        gas = ct.DirectGas.from_lines(co2, 0.9, nu)
    else:
        h2o = ct.SpectralLines.from_par_dict(synthetic_h2o_par(100, seed=12), **CPU64)
        gas = ct.MultiGas.from_lines([(co2, 0.9), (h2o, 0.005)], nu)
    Pe, Te, f = _lbl_column(nu)
    return ct.RCM.create(Pe, Te, G, lambda T, P: MU, lambda v: torch.full_like(v, f), 0.1,
                         lambda T, P: CP, 1e6, gas)


def _jax_lbl_rcm(kind="direct"):
    co2 = JLines.from_par_dict(synthetic_co2_par(150, seed=11))
    pos = np.asarray(co2.nu)
    nu = np.linspace(max(pos.min() - 25.0, 1.0), pos.max() + 25.0, N_LBL)
    if kind == "direct":
        gas = JDirectGas.from_lines(co2, 0.9, nu)
    else:
        h2o = JLines.from_par_dict(synthetic_h2o_par(100, seed=12))
        gas = JMultiGas.from_lines([(co2, 0.9), (h2o, 0.005)], nu)
    Pe, Te, f = _lbl_column(nu)
    return jr.RCM.create(Pe, Te, G, lambda T, P: MU, lambda v: jnp.full(jnp.shape(v), f), 0.1,
                         lambda T, P: CP, 1e6, gas)


PAIRS = {"gray": _gray_pair,
         "direct": lambda: (_jax_lbl_rcm("direct"), _port_lbl_rcm("direct")),
         "multigas": lambda: (_jax_lbl_rcm("multi"), _port_lbl_rcm("multi"))}


def _temperatures(T):
    return np.stack([np.asarray(T) * s for s in (1.0, 1.02, 0.98)])


@pytest.mark.parametrize("kind", list(PAIRS))
def test_batched_heating_matches_jax_and_the_loop(kind):
    jm, tm = PAIRS[kind]()
    Tb = _temperatures(jm.T)
    want = np.asarray(jsw.batched_heating(jm, jnp.asarray(Tb), jnp.asarray(FACTORS)))
    got = ct.batched_heating(tm, torch.tensor(Tb), FACTORS)
    _close(got, want, 1e-9)
    for i, f in enumerate(FACTORS):
        one = ct.heating(tsw._with_insolation(tm, f), torch.tensor(Tb[i]))
        _close(got[i], one.numpy(), 1e-12, f"column {i}")


@pytest.mark.parametrize("kind", ["direct", "multigas"])
def test_run_sweep_matches_jax(kind):
    """Refresh every 2 steps, adjustment every 3, on a line-by-line column:
    the final temperatures and every column's cached ln sigma (and the
    cache's other fields, JAX's stacked copies)."""
    jm, tm = PAIRS[kind]()
    kw = dict(update_every=2, adjust_every=3, cp=CP, mu=MU)
    jT, jA = jsw.run_sweep(jm, jnp.asarray(FACTORS), 2e4, 6, **kw)
    T, A = ct.run_sweep(tm, FACTORS, 2e4, 6, **kw)
    _close(T, jT, 1e-10)
    _close(A.ln_sigma, jA.ln_sigma, 1e-10)
    _close(A.T, jA.T, 1e-10)
    _close(torch.broadcast_to(A.lnP, jA.lnP.shape), jA.lnP, 1e-15)
    _close(torch.broadcast_to(A.nu, jA.nu.shape), jA.nu, 1e-15)
    assert A.batch_shape == (3,)


def test_run_sweep_continues_a_jax_sweep():
    """A JAX sweep's (T_b, A_b) carried over (``convert.accelerated_absorber``)
    and run on in the port equals the JAX sweep run for all the steps."""
    jm, tm = PAIRS["direct"]()
    kw = dict(update_every=2, adjust_every=2, cp=CP, mu=MU)
    jT4, jA4 = jsw.run_sweep(jm, jnp.asarray(FACTORS), 2e4, 4, **kw)
    jT6, jA6 = jsw.run_sweep(jm, jnp.asarray(FACTORS), 2e4, 6, **kw)
    A4 = convert.accelerated_absorber(jA4, tm.A.stack)
    _close(A4.ln_sigma, jA4.ln_sigma, 0.0)
    T, A = ct.run_sweep(tm, FACTORS, 2e4, 2, T0_b=torch.tensor(np.asarray(jT4)), A0_b=A4, **kw)
    _close(T, jT6, 1e-10)
    _close(A.ln_sigma, jA6.ln_sigma, 1e-10)


def test_run_sweep_orders_by_insolation():
    """Hotter insolation equilibrates to a warmer surface (the JAX package's
    ``test_run_sweep_orders_by_insolation``)."""
    _, r = _gray_pair(nnu=150)
    T_b, A_b = ct.run_sweep(r, [0.25, 1.0, 2.0], dt=2e4, nsteps=250, update_every=0)
    T_b = T_b.numpy()
    assert np.all(np.isfinite(T_b)) and A_b.batch_shape == (3,)
    surf = T_b[:, -1]
    assert surf[0] < surf[1] < surf[2]


def test_sweep_error_paths():
    jm, tm = _gray_pair(nnu=64)
    Tb = torch.tensor(_temperatures(jm.T))
    with pytest.raises(ValueError, match="factors"):
        ct.batched_heating(tm, Tb, [0.5, 1.0])        # factors of the wrong length
    with pytest.raises(ValueError):
        jsw.batched_heating(jm, jnp.asarray(np.asarray(Tb)), jnp.asarray([0.5, 1.0]))
    with pytest.raises(ValueError, match="vector"):
        ct.batched_heating(tm, Tb, np.ones((3, 1)))
    with pytest.raises(ValueError, match="T0_b"):
        ct.run_sweep(tm, [0.5, 1.0], 2e4, 1, T0_b=Tb)
    for pkg, m in ((ct, tm), (jsw, jm)):
        with pytest.raises(ValueError, match="cp and mu"):
            pkg.run_sweep(m, [0.5, 1.0], 2e4, 2, adjust_every=1, cp=CP)
    tmesh = tpar.spectral_mesh(1, n_batch=1, devices="cpu")
    tmesh = dataclasses.replace(tmesh, n_batch=2)          # a 2-row mesh's shape
    with pytest.raises(ValueError, match="not divisible by batch-mesh size 2"):
        ct.shard_sweep(tmesh, tm, [0.5, 1.0, 1.5])
    jmesh = jpar.spectral_mesh(1, n_batch=2, devices=jax.devices()[:2])
    with pytest.raises(ValueError, match="not divisible by batch-mesh size 2"):
        jsw.shard_sweep(jmesh, jm, jnp.asarray([0.5, 1.0, 1.5]))
    with pytest.raises(ValueError, match="already a batch"):
        tm.A.stacked(2).stacked(2)


# --- the batched convective adjustment ----------------------------------------

def test_batched_lapse_matches_columns_and_jax_vmap():
    rng = np.random.default_rng(4)
    P = np.sort(rng.uniform(10.0, 1e5, 16))[rng.permutation(16)]     # unsorted
    T = 150.0 + 150.0 * rng.random((5, 16))       # superadiabatic in places
    got = ct.lapse(torch.tensor(T), torch.tensor(P), CP, MU)
    for b in range(5):
        one = ct.lapse(torch.tensor(T[b]), torch.tensor(P), CP, MU)
        assert torch.equal(got[b], one)
    want = jax.vmap(lambda t: ja.lapse(t, jnp.asarray(P), CP, MU))(jnp.asarray(T))
    _close(got, want, 1e-13)
    assert not np.allclose(got.numpy(), T)        # the adjustment acted
    # per-column pressures ([B, np]) too, and the graph is kept
    Tg = torch.tensor(T, requires_grad=True)
    Pb = torch.tensor(np.stack([P * (1.0 + 0.1 * b) for b in range(5)]))
    out = ct.lapse(Tg, Pb, CP, MU)
    for b in range(5):
        assert torch.equal(out[b].detach(), ct.lapse(torch.tensor(T[b]), Pb[b], CP, MU))
    out.sum().backward()
    assert Tg.grad is not None and torch.isfinite(Tg.grad).all()


# --- the route decision of a batched refresh -------------------------------------

# route: (points, strategy, budget in bytes) where one column's 10 edge
# states take the route and a batch's 50 states, routed by their own
# count, would take another
ROUTES = {"stencil": (4096, "auto", 300_000), "coarse": (65536, "coarse", 500_000),
          "grouped": (4096, "grouped", 500_000), "segmented": (4096, "grouped", 150_000),
          "nosplit": (4096, "nosplit", 500_000), "lane": (4096, "lane", 200_000)}
LAUNCHERS = {"coarse": "sigma_coarse", "stencil": "sigma_stencil", "grouped": "sigma_lines",
             "segmented": "sigma_segmented", "nosplit": "sigma_nosplit", "lane": "sigma_lane",
             "gathered": "sigma_gathered"}
ROUTE_COLUMNS, ROUTE_EDGES = 5, 10


@pytest.mark.parametrize("route", list(ROUTES))
def test_batched_refresh_routes_as_one_column(route, monkeypatch):
    """A refresh of 5 columns takes one column's route with one column's
    parameter (coarse split, segment length) and runs it once over all 50
    states, where the gates at 50 states would choose otherwise."""
    n_nu, strategy, budget = ROUTES[route]
    monkeypatch.setattr(ls, "H100_L2_BYTES", budget)
    lines = ct.SpectralLines.from_par_dict(synthetic_co2_par(400, seed=7), **CPU64)
    pos = lines.positions64()
    gas = ct.DirectGas.from_lines(lines, 0.9, np.linspace(pos.min() - 25.0, pos.max() + 25.0,
                                                          n_nu), strategy=strategy)
    one = ls._resolve(gas.plan, lines, "voigt", strategy, ROUTE_EDGES)
    assert one[0] == route
    assert ls._resolve(gas.plan, lines, "voigt", strategy, ROUTE_COLUMNS * ROUTE_EDGES) != one
    calls = []

    def recorder(name):
        def launch(plan, lines_, T, P, Pp, *args, **kw):
            param = args[0] if name in ("sigma_coarse", "sigma_segmented") else None
            calls.append((name, param, T.shape[0]))
            return torch.zeros((T.shape[0], plan.n_nu), dtype=T.dtype)
        return launch

    for name in LAUNCHERS.values():
        monkeypatch.setattr(linesum_cuda, name, recorder(name))
    monkeypatch.setattr(twin, "kernel_path", lambda x: True)
    Pe = pressuregrid(10.0, PS, ROUTE_EDGES)
    Te = np.maximum(260.0 * (Pe / PS) ** (R_GAS / (MU * CP)), 150.0)
    A = ct.AcceleratedAbsorber.create(Te, Pe, gas)
    Te_b = torch.tensor(np.stack([Te * (1.0 + 0.01 * b) for b in range(ROUTE_COLUMNS)]))
    A_b = A.stacked(ROUTE_COLUMNS).update(Te_b)
    assert A_b.ln_sigma.shape == (ROUTE_COLUMNS, ROUTE_EDGES, n_nu)
    want = (LAUNCHERS[route], one[1])
    assert calls == [want + (ROUTE_EDGES,), want + (ROUTE_COLUMNS * ROUTE_EDGES,)]
    # outside a batch the count is the call's own
    with ls._column_batch(5):
        assert ls.routing_states(50) == 10
        with pytest.raises(RuntimeError, match="already"):
            with ls._column_batch(2):
                pass
        assert ls.routing_states(50) == 10
    assert ls.routing_states(50) == 50


# --- shard_sweep over gloo ranks ------------------------------------------------

SHARD_FACTORS = np.array([0.5, 1.0, 1.5, 2.0])
SHARD_STEPS = 4


def _sweep_T0(r):
    return torch.stack([r.T * (1.0 + 0.01 * b) for b in range(len(SHARD_FACTORS))])


def _rank_sweep(rank, world, url, out_dir, n_shards, n_batch):
    """One rank: shard_sweep, then the batched heating and a short run_sweep
    (refresh every 2) of its batch row on its spectral slab."""
    torch.set_num_threads(1)
    tpar.init_multihost(url, world, rank, backend="gloo", device="cpu", timeout=30.0)
    try:
        mesh = tpar.spectral_mesh(n_shards, n_batch=n_batch, devices="cpu")
        r = _port_lbl_rcm()
        r_s, f_s, T_s = ct.shard_sweep(mesh, r, SHARD_FACTORS, _sweep_T0(r))
        H = ct.batched_heating(r_s, T_s, f_s)
        T, A = ct.run_sweep(r_s, f_s, 2e4, SHARD_STEPS, T0_b=T_s, update_every=2)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), H=H.numpy(), T=T.numpy(),
                 f=f_s.numpy(), batch=mesh.batch_index, n_nu=r_s.nu.shape[0],
                 slab=A.ln_sigma.shape[-1])
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("world,n_shards,n_batch", [(2, 1, 2), (4, 2, 2)])
def test_shard_sweep_over_gloo_ranks(tmp_path, world, n_shards, n_batch):
    """Each rank's rows against the one-process batched heating and sweep,
    and against JAX's shard_sweep + batched_heating on the host devices."""
    res = _spawn(world, n_shards, n_batch, tmp_path, target=_rank_sweep)
    r = _port_lbl_rcm()
    T0 = _sweep_T0(r)
    H = ct.batched_heating(r, T0, SHARD_FACTORS).numpy()
    T, _ = ct.run_sweep(r, SHARD_FACTORS, 2e4, SHARD_STEPS, T0_b=T0, update_every=2)
    jm = _jax_lbl_rcm()
    jmesh = jpar.spectral_mesh(n_shards, n_batch=n_batch, devices=jax.devices()[:world])
    r_s, f_s, T_s = jsw.shard_sweep(jmesh, jm, jnp.asarray(SHARD_FACTORS), jnp.asarray(T0.numpy()))
    jH = np.asarray(jax.jit(jsw.batched_heating)(r_s, T_s, f_s))
    _close(H, jH, 1e-9)
    rows = len(SHARD_FACTORS) // n_batch
    for d in res:
        b = int(d["batch"])
        sl = slice(b * rows, (b + 1) * rows)
        assert int(d["slab"]) == N_LBL // n_shards and int(d["n_nu"]) == N_LBL // n_shards
        _close(d["f"], SHARD_FACTORS[sl], 0.0)
        _close(d["H"], H[sl], 1e-9)
        _close(d["H"], jH[sl], 1e-9)
        _close(d["T"], T.numpy()[sl], 1e-9)
    assert sorted(int(d["batch"]) for d in res) == sorted(
        [b for b in range(n_batch) for _ in range(world // n_batch)])

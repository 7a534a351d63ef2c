"""The port's sharded programs (``clearsky_tpu_torch.parallel``) against the
JAX package's, and across processes over ``torch.distributed``'s gloo.

The JAX side runs on 4 of the 8 virtual CPU devices of tests/conftest.py;
the port's side in one process holds all 4 shards, or spreads them over
spawned ranks (gloo on the CPU, every group and every join with a timeout).
Bars, the JAX package's own (tests/test_parallel.py,
tests/test_parallel_lbl.py): ``trapz_weights`` rtol 1e-14 (the same sum);
``sharded_radiate`` ``F_net`` and ``M_up`` rtol 1e-12; the sharded heating
and the step trajectory rtol 1e-9 (the all-reduce and the weighted sum
reassociate the spectral integral: float64 reduction-order noise). The
collective count is 1 per heating, step and radiate.
"""

import dataclasses
import os
import pathlib
import socket
import time
import multiprocessing as mp

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from clearsky_tpu import parallel as jpar
from clearsky_tpu.absorption.cia import CIATables as JCIA
from clearsky_tpu.absorption.domain import AtmosphericDomain as JDomain
from clearsky_tpu.absorption.gas import (
    DirectGas as JDirectGas,
    Gas as JGas,
    GrayGas as JGray,
    MultiGas as JMultiGas,
)
from clearsky_tpu.models import rcm as jr
from clearsky_tpu.spectra.lines import SpectralLines as JLines
from clearsky_tpu.utils import grids as jgrids
import clearsky_tpu_torch as ct
from clearsky_tpu_torch import convert
from clearsky_tpu_torch import parallel as tpar
from clearsky_tpu_torch.absorption.sharded import ShardedLineGas
from clearsky_tpu_torch.constants import R_GAS
from clearsky_tpu_torch.parallel import mesh as tmesh
from clearsky_tpu_torch.spectra.synthetic import (
    synthetic_co2_cia,
    synthetic_co2_par,
    synthetic_h2o_par,
    write_cia,
)

torch.set_num_threads(2)

CPU64 = dict(dtype=torch.float64, device="cpu")
G, MU, CP, PS, PT = 9.8, 0.044, 850.0, 1e5, 10.0
N_NU = 512
SPAWN_TIMEOUT_S = 60.0


def _jmesh():
    return jpar.spectral_mesh(4, devices=jax.devices()[:4])


def _tmesh():
    return tpar.spectral_mesh(4, devices="cpu")


def _close(a, b, rtol):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=rtol, atol=rtol * np.abs(b).max())


def _column(n_levels, mu=MU, cp=CP):
    Pe = jgrids.pressuregrid(PT, PS, n_levels)
    return Pe, np.maximum(280.0 * (Pe / PS) ** (R_GAS / (mu * cp)), 150.0)


def _rcm_pair(jabs, tabs, n_levels=12, mu=MU, cp=CP):
    """Both packages' RCM on one column (no sunlight, black surface, the
    JAX sharding tests' column)."""
    Pe, Te = _column(n_levels, mu, cp)
    jm = jr.RCM.create(Pe, Te, G, lambda T, P: mu, 0.0, 0.0, lambda T, P: cp, 1e7, *jabs)
    tm = ct.RCM.create(Pe, Te, G, lambda T, P: mu, 0.0, 0.0, lambda T, P: cp, 1e7, *tabs)
    return jm, tm


def _co2_par():
    return synthetic_co2_par(300, seed=5)


def _grid(pos, n=N_NU):
    return np.linspace(pos.min() - 25.0, pos.max() + 25.0, n)


def _port_rcm():
    """The port's line-by-line column, built from the seed alone (the
    spawned ranks build it so, without the JAX package)."""
    lines = ct.SpectralLines.from_par_dict(_co2_par(), **CPU64)
    gas = ct.DirectGas.from_lines(lines, 0.9, _grid(lines.positions64()))
    Pe, Te = _column(12)
    return ct.RCM.create(Pe, Te, G, lambda T, P: MU, 0.0, 0.0, lambda T, P: CP, 1e7, gas)


@pytest.fixture(scope="module")
def cats():
    co2, h2o = _co2_par(), synthetic_h2o_par(200, seed=6)
    return {"co2": (JLines.from_par_dict(co2), ct.SpectralLines.from_par_dict(co2, **CPU64)),
            "h2o": (JLines.from_par_dict(h2o), ct.SpectralLines.from_par_dict(h2o, **CPU64))}


@pytest.fixture(scope="module")
def cia_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("cia") / "CO2-CO2.cia"
    write_cia(str(path), synthetic_co2_cia(seed=33))
    return str(path)


@pytest.fixture(scope="module")
def direct(cats):
    jl, tl = cats["co2"]
    nu = _grid(np.asarray(jl.nu))
    return _rcm_pair([JDirectGas.from_lines(jl, 0.9, nu)], [ct.DirectGas.from_lines(tl, 0.9, nu)])


@pytest.fixture(scope="module")
def gray():
    nu = np.linspace(1.0, 3000.0, N_NU)
    return _rcm_pair([JGray.create(5e-27, nu)], [ct.GrayGas.create(5e-27, nu, **CPU64)],
                     n_levels=16, mu=0.029, cp=1e3)


# --- the mesh, the weights, the process group --------------------------------

def test_trapz_weights_exact():
    nu = np.sort(np.random.default_rng(0).uniform(1.0, 100.0, 33))
    y = np.random.default_rng(1).normal(size=(4, 33))
    w = tpar.trapz_weights(torch.tensor(nu))
    np.testing.assert_allclose(w.numpy(), np.asarray(jpar.trapz_weights(nu)), rtol=1e-14)
    ref = np.asarray(jgrids.trapz(jnp.asarray(nu), jnp.asarray(y)))
    np.testing.assert_allclose((torch.tensor(y) * w).sum(-1).numpy(), ref, rtol=1e-14)
    np.testing.assert_allclose((torch.tensor(y) * w).sum(-1).numpy(),
                               ct.trapz(torch.tensor(nu), torch.tensor(y)).numpy(), rtol=1e-14)


def test_mesh_construction():
    m = tpar.spectral_mesh()
    assert (m.world, m.rank, m.n_shards, m.k_local) == (1, 0, 1, 1)
    assert m.device == torch.device("cuda", 0)      # the card unless asked
    m4 = tpar.spectral_mesh(4, devices="cpu")
    assert m4.shape == {"batch": 1, "nu": 4} and m4.k_local == 4
    assert m4.device == torch.device("cpu")
    assert m4.slab(512) == (0, 512)
    with pytest.raises(ValueError, match="not divisible"):
        m4.slab(510)
    with pytest.raises(ValueError):
        tpar.spectral_mesh(n_nu_shards=3, n_batch=2)
    assert tpar.pad_nu(510, 8) == jpar.pad_nu(510, 8) == 512
    x = tpar.replicate(np.arange(3.0), m4)
    assert isinstance(x, torch.Tensor) and x.device == torch.device("cpu")


_LAUNCH_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "SLURM_NTASKS",
                "OMPI_COMM_WORLD_SIZE", "PMI_SIZE")


def test_init_multihost_single_process_noop(monkeypatch):
    for v in _LAUNCH_VARS:
        monkeypatch.delenv(v, raising=False)
    assert tpar.init_multihost() == (0, 1)
    assert not torch.distributed.is_initialized()
    assert tpar.spectral_mesh(4, devices="cpu").k_local == 4


@pytest.mark.parametrize("var,value", [("WORLD_SIZE", "4"), ("SLURM_NTASKS", "2"),
                                       ("OMPI_COMM_WORLD_SIZE", "8"), ("PMI_SIZE", "x")])
def test_init_multihost_refuses_to_degrade(monkeypatch, var, value):
    for v in _LAUNCH_VARS:
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setenv(var, value)
    with pytest.raises(RuntimeError, match="refusing"):
        tpar.init_multihost(device="cpu")
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="together"):
        tpar.init_multihost(num_processes=2, device="cpu")


# --- one process, every shard ------------------------------------------------

@pytest.mark.parametrize("case", ["gray", "direct"])
def test_sharded_radiate_matches_jax(case, gray, direct):
    jm, tm = {"gray": gray, "direct": direct}[case]
    F_j = jpar.sharded_radiate(_jmesh(), jm)
    calls = tmesh.spectral_all_reduce.calls
    F_t = tpar.sharded_radiate(_tmesh(), tm)
    assert tmesh.spectral_all_reduce.calls == calls + 1
    _close(F_t.F_net.numpy(), F_j.F_net, 1e-12)
    _close(F_t.M_up.numpy(), F_j.M_up, 1e-12)
    F_u = ct.radiate_state(tm)
    _close(F_t.F_net.numpy(), F_u.F_net.numpy(), 1e-12)


def test_sharded_heating_with_cia_matches_jax(cats, cia_file):
    jl, tl = cats["co2"]
    nu = _grid(np.asarray(jl.nu))
    jm, tm = _rcm_pair([JDirectGas.from_lines(jl, 0.9, nu), JCIA.from_file(cia_file)],
                       [ct.DirectGas.from_lines(tl, 0.9, nu), ct.CIATables.from_file(cia_file)])
    H_j = np.asarray(jpar.make_sharded_heating(_jmesh(), jm)(jm.T))
    hfn = tpar.make_sharded_heating(_tmesh(), tm)
    calls = tmesh.spectral_all_reduce.calls
    H_t = hfn(tm.T)
    assert tmesh.spectral_all_reduce.calls == calls + 1
    _close(H_t.numpy(), H_j, 1e-9)
    _close(H_t.numpy(), ct.heating(tm).numpy(), 1e-9)
    assert isinstance(hfn.rcm_sharded.A.stack.gases[0], ShardedLineGas)
    assert len(hfn.rcm_sharded.A.stack.cias) == 1


def test_sharded_baked_gas_matches_jax(cats, cia_file):
    """A baked table Gas (and CIA) under the sharded heating and step: the
    table's coefficients split along the grid, nothing converts."""
    jl, _ = cats["co2"]
    nu = _grid(np.asarray(jl.nu), 256)
    dom = JDomain.create((150.0, 350.0), 8, (PT, PS), 12)
    jg = JGas.from_lines(jl, 0.9, nu, dom)
    jm, tm = _rcm_pair([jg, JCIA.from_file(cia_file)],
                       [convert.gas(jg, 0.9, **CPU64), ct.CIATables.from_file(cia_file)])
    _close(tpar.make_sharded_heating(_tmesh(), tm)(tm.T).numpy(),
           jpar.make_sharded_heating(_jmesh(), jm)(jm.T), 1e-9)
    T_t, T_j = _trajectories(jm, tm)
    _close(T_t, T_j, 1e-9)


def _trajectories(jm, tm, steps=4, dt=300.0, update_every=2):
    jfn = jpar.make_sharded_step(_jmesh(), jm, dt=dt, update_every=update_every)
    T, A = jm.T, jfn.rcm_sharded.A
    for i in range(steps):
        T, A = jfn(T, A, i)
    tfn = tpar.make_sharded_step(_tmesh(), tm, dt=dt, update_every=update_every)
    Tt, At = tm.T, None
    calls = tmesh.spectral_all_reduce.calls
    for i in range(steps):
        Tt, At = tfn(Tt, At, i)
    assert tmesh.spectral_all_reduce.calls == calls + steps
    # and the port's own unsharded run
    out, _ = ct.run(tm, dt, steps, update_every=update_every)
    _close(Tt.numpy(), out.T.numpy(), 1e-9)
    return Tt.numpy(), np.asarray(T)


@pytest.mark.parametrize("kind", ["direct", "multigas"])
def test_sharded_step_trajectory_matches_jax(cats, direct, kind):
    if kind == "direct":
        jm, tm = direct
    else:
        (jc, tc), (jh, th) = cats["co2"], cats["h2o"]
        nu = _grid(np.asarray(jc.nu))
        jm, tm = _rcm_pair([JMultiGas.from_lines([(jc, 0.9), (jh, 0.005)], nu)],
                           [ct.MultiGas.from_lines([(tc, 0.9), (th, 0.005)], nu)])
    T_t, T_j = _trajectories(jm, tm)
    _close(T_t, T_j, 1e-9)


def test_absorber_refresh_on_a_slab_matches_jax(direct):
    """The refresh evaluates the line sum: the rank's slab of the cache
    refreshed through the sharded gas is the slab of the whole refresh."""
    jm, tm = direct
    mesh = tpar.spectral_mesh(4, devices="cpu")
    Te2 = np.linspace(160.0, 290.0, len(jm.Pe))
    A_j = jm.A.update(jnp.asarray(Te2))
    rcm_s = tpar.shard_spectral(tpar.shard_lbl(tm, 4), mesh, N_NU)
    A_t = rcm_s.A.update(torch.tensor(Te2))
    np.testing.assert_allclose(A_t.ln_sigma.numpy(), np.asarray(A_j.ln_sigma), rtol=1e-10,
                               atol=1e-12)


def test_spectral_slabs_of_every_absorber(cats, cia_file):
    jl, tl = cats["co2"]
    nu = _grid(np.asarray(jl.nu), 256)
    dom = JDomain.create((150.0, 350.0), 8, (PT, PS), 12)
    gas = convert.gas(JGas.from_lines(jl, 0.9, nu, dom), 0.9, **CPU64)
    gray = ct.GrayGas.create(1e-27, nu, **CPU64)
    stack = ct.AbsorberStack.create(gas, gray, ct.CIATables.from_file(cia_file),
                                    lambda v, T, P: 1e-30 * v / (v + T))
    T = torch.tensor([200.0, 280.0], dtype=torch.float64)
    P = torch.tensor([1e3, 9e4], dtype=torch.float64)
    lo, hi = 64, 192
    for obj in (gas, gray, stack.cias[0]):
        full = obj.sigma(T, P) if hasattr(obj, "tables") else obj(T, P)
        part = obj.spectral_slab(lo, hi)
        got = part.sigma(T, P) if hasattr(obj, "tables") else part(T, P)
        np.testing.assert_array_equal(got.numpy(), full[:, lo:hi].numpy())
    np.testing.assert_array_equal(stack.spectral_slab(lo, hi).sigma(T, P).numpy(),
                                  stack.sigma(T, P)[:, lo:hi].numpy())
    A = ct.AcceleratedAbsorber.create(np.array([250.0, 280.0]), np.array([1e3, 1e5]), stack)
    As = A.spectral_slab(lo, hi)
    np.testing.assert_array_equal(As.sigma(T, P).numpy(), A.sigma(T, P)[:, lo:hi].numpy())
    np.testing.assert_array_equal(As.update(T).ln_sigma.numpy(),
                                  A.update(T).ln_sigma[:, lo:hi].numpy())
    # a line-by-line gas must be sharded first
    direct = ct.DirectGas.from_lines(tl, 0.9, nu)
    with pytest.raises(ValueError, match="shard_lbl"):
        ct.AbsorberStack.create(direct).spectral_slab(lo, hi)


def test_shard_lbl_and_pspecs(direct, gray):
    _, tm = direct
    rs = tpar.shard_lbl(tm, 4)
    gas = rs.A.stack.gases[0]
    assert isinstance(gas, ShardedLineGas) and gas.n_shards == 4 and gas.k_local == 4
    assert tpar.shard_lbl(rs, 4).A.stack.gases[0] is gas
    assert tpar.shard_lbl(gray[1], 4).A.stack.gases[0] is gray[1].A.stack.gases[0]
    specs = tpar.spectral_pspecs(rs, N_NU)
    for k in ("S_nu", "a_nu", "A.nu", "A.stack.nu"):
        assert specs[k] == ("nu",), k
    assert specs["A.ln_sigma"] == (None, "nu")
    assert specs["A.stack.gases.0.lines.nu"] == ("nu", None)
    assert specs["A.stack.gases.0.plans.nu_blocks"] == ("nu", None, None)
    assert not any(k.startswith("T") or k.startswith("Pe") for k in specs)
    assert tpar.nu_spec(3) == (None, None, "nu") == tuple(jpar.nu_spec(3))


def test_mesh_device_is_the_local_rank_card(monkeypatch):
    """The mesh names the card of the local rank unless told otherwise."""
    assert tpar.spectral_mesh(2, devices=["cpu"]).device == torch.device("cpu")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert tmesh._local_device(None, 3).type == "cuda"
    assert tmesh._local_device(["cpu", "cuda:1"], 3) == torch.device("cuda", 1)


# --- spawned ranks over gloo -------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, url, out_dir, n_shards, n_batch):
    """One rank: the sharded heating, four steps and radiate of the port's
    column on its slab, its batch row's temperatures scaled by 1 + 0.01 b."""
    torch.set_num_threads(1)
    tpar.init_multihost(url, world, rank, backend="gloo", device="cpu", timeout=30.0)
    try:
        mesh = tpar.spectral_mesh(n_shards, n_batch=n_batch, devices="cpu")
        r = _port_rcm()
        T = r.T * (1.0 + 0.01 * mesh.batch_index)
        H = tpar.make_sharded_heating(mesh, r)(T)
        step = tpar.make_sharded_step(mesh, r, 300.0, update_every=2)
        Ts, A = T, None
        for i in range(4):
            Ts, A = step(Ts, A, i)
        F = tpar.sharded_radiate(mesh, r)
        lo, hi = mesh.slab(r.nu.shape[0])
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), H=H.numpy(), T=Ts.numpy(),
                 F_net=F.F_net.numpy(), M_up=F.M_up.numpy(), lo=lo, hi=hi,
                 batch=mesh.batch_index, k_local=mesh.k_local,
                 calls=tmesh.spectral_all_reduce.calls)
    finally:
        torch.distributed.destroy_process_group()


def _spawn(world, n_shards, n_batch, out_dir, target=None):
    """Run ``world`` ranks of ``target`` (by default :func:`_rank_main`,
    called with the same arguments); each one and the whole run within the
    timeout, a hung rank killed and the test failed."""
    ctx = mp.get_context("spawn")
    url = f"tcp://127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=target or _rank_main,
                         args=(r, world, url, str(out_dir), n_shards, n_batch))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(5.0)
    assert not hung, f"{len(hung)} of {world} ranks did not finish in {SPAWN_TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * world
    return [dict(np.load(pathlib.Path(out_dir) / f"rank{r}.npz")) for r in range(world)]


def _one_process(scale=1.0):
    r = _port_rcm()
    T = r.T * scale
    H = ct.heating(r, T)
    out, _ = ct.run(dataclasses.replace(r, T=T), 300.0, 4, update_every=2)
    return r, H.numpy(), out.T.numpy(), ct.radiate_state(r)


def test_two_gloo_ranks_match_one_process(tmp_path):
    """Two ranks of two shards each (gloo, CPU) against the one-process
    result: the heating, the four-step trajectory with refreshes every 2,
    and the fluxes (each rank's slab of M_up)."""
    res = _spawn(2, 4, 1, tmp_path)
    r, H, T4, F = _one_process()
    for d in res:
        assert int(d["k_local"]) == 2 and int(d["calls"]) == 6
        _close(d["H"], H, 1e-9)
        _close(d["T"], T4, 1e-9)
        _close(d["F_net"], F.F_net.numpy(), 1e-12)
        lo, hi = int(d["lo"]), int(d["hi"])
        _close(d["M_up"], F.M_up.numpy()[:, lo:hi], 1e-12)
    assert [(int(d["lo"]), int(d["hi"])) for d in res] == [(0, 256), (256, 512)]


def test_batch_rows_of_gloo_ranks(tmp_path):
    """The 2-D layout: four ranks as two batch rows of two, each row's
    heating summed over its own ranks only (one group a row)."""
    res = _spawn(4, 4, 2, tmp_path)
    for d in res:
        b = int(d["batch"])
        _, H, T4, _ = _one_process(1.0 + 0.01 * b)
        _close(d["H"], H, 1e-9)
        _close(d["T"], T4, 1e-9)
    assert [int(d["batch"]) for d in res] == [0, 0, 1, 1]

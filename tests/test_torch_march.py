"""The port's flux marches (the module of kernels K2 and K3) against the JAX package.

The adversarial column of tests/test_march_pallas.py (transparent, 1e-9,
1e-4 and opaque 1e4 layers; widths that are no multiple of any block) goes
through the port's plain marches and through ``clearsky_tpu``'s scan oracle
and its Pallas kernels in interpret mode, all in float64: the arithmetic is
the same, so the bar is 1e-12. In float32 the port's plain march is held to
the JAX float32 scan at 3e-6 of peak, and so is a float32 emulation of the
CUDA kernels' own arithmetic. The kernels' launch plan and the probe's
source cuts are checked on the host; the CUDA kernels run only on a card
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
from clearsky_tpu_torch.rt.march_cuda import olr_march, monoflux_march, _ratio_series
from clearsky_tpu_torch.utils import profiling

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
    n_olr = profiling.counters["launch.march.olr"]
    n_mono = profiling.counters["launch.march.monoflux"]
    np.testing.assert_array_equal(olr_march(tau, B, m, W).numpy(),
                                  td._olr_march(tau, B, m, W).numpy())
    up, dn = monoflux_march(tau, B, S, a, CTHETA, m, W)
    up_p, dn_p = td._monoflux_march(tau, B, S, a, CTHETA, m, W)
    np.testing.assert_array_equal(up.numpy(), up_p.numpy())
    np.testing.assert_array_equal(dn.numpy(), dn_p.numpy())
    assert (profiling.counters["launch.march.olr"],
            profiling.counters["launch.march.monoflux"]) == (n_olr, n_mono)


# -- the kernels' launch plan and float32 arithmetic (csrc/march.cu) --------

@pytest.mark.parametrize("kind", ["olr", "monoflux"])
@pytest.mark.parametrize("L,N", [(19, 2**19), (38, 16384), (160, 16384), (38, 16385),
                                 (1, 1), (7, 1000), (40, 140001), (300, 135167)])
@pytest.mark.parametrize("nst", [1, 5, 8])
def test_march_plan_fits_the_card(kind, L, N, nst):
    """Any L, N and 1-8 streams get a launch the card takes: whole warps,
    <= 1024 threads, every point in a block, shared bytes within 227 KB and
    the layout's budget, a chunk of 1..L layers where one is staged."""
    from clearsky_tpu_torch.rt import march_cuda as mc

    p = march_plan_of(kind, L, N, nst)
    assert p["threads"] % 32 == 0 and p["threads"] <= 1024
    assert p["blocks"] * p["block_points"] >= N > (p["blocks"] - 1) * p["block_points"]
    assert 0 <= p["shared"] <= 227 * 1024
    assert p["spread"] == (N < mc.SMS * mc.SPREAD_BELOW)
    if p["spread"]:
        assert p["slices"] == nst + (kind == "monoflux") and p["block_points"] == 32
        assert 1 <= p["chunk"] <= L and p["shared"] <= mc.SPREAD_SHARED
        # the tile's floats (csrc/march.cu ``tile_of``)
        c, P, s = p["chunk"], p["block_points"], p["slices"]
        floats = P * (3 * c + 1 + (c * s + 1 if kind == "monoflux" else s))
        assert p["shared"] == 4 * floats
        # the chunk is the largest within the budget
        assert c == L or 4 * floats + 4 * P * (3 + (s if kind == "monoflux" else 0)) > \
            mc.SPREAD_SHARED
    else:
        assert p["slices"] == 1 and p["threads"] == p["block_points"] == mc.POINT_THREADS
        want = min(L, mc.POINT_SHARED // (8 * p["block_points"])) if kind == "monoflux" else 0
        assert p["chunk"] == want and p["shared"] == 8 * p["block_points"] * want


def march_plan_of(kind, L, N, nst):
    from clearsky_tpu_torch.rt.march_cuda import march_plan

    return march_plan(kind, L, N, nst)


@pytest.mark.parametrize("nst", [1, 5, 8])
def test_march_plan_fills_the_card_at_the_rcm_shape(nst):
    """At the RCM's 16,384 points the spread layout puts blocks on all 132
    SMs (one thread a point would run 128 blocks of 128); at 2^19 points
    the card is full with a thread a point; the main shapes keep the
    whole column in one tile."""
    K2, K3 = (march_plan_of(k, 38, 16384, nst) for k in ("olr", "monoflux"))
    for p in (K2, K3):
        assert p["spread"] and p["blocks"] >= 132
        assert p["threads"] * p["blocks"] >= 16384 * nst
    assert K2["chunk"] == 38 and K3["chunk"] == (38 if nst <= 7 else 37)
    big = march_plan_of("monoflux", 19, 2**19, nst)
    assert not big["spread"] and big["chunk"] == 19 and big["blocks"] == 4096
    for kind, L in (("olr", 160), ("monoflux", 160)):   # chip_smoke's L beyond a tile
        assert march_plan_of(kind, L, 16384, 5)["chunk"] < L


def test_march_plan_rejects_what_no_kernel_takes():
    for args in (("olr", 0, 10, 5), ("olr", 3, 0, 5), ("monoflux", 3, 10, 9),
                 ("monoflux", 3, 10, 0), ("flux", 3, 10, 5)):
        with pytest.raises(ValueError):
            march_plan_of(*args)


def _kernel_march_f32(tau, B, m, W, I0, reverse, with_rows):
    """The kernels' float32 arithmetic (csrc/march.cu ``layer_step``): below
    tm = 0.25, t = 1 - tm r and ratio = r (the 7-term series); above, t = e
    = exp(-tm) and ratio = (1 - e) rcp(tau) (1/m); I <- b2 + t (I - b1) +
    (b1 - b2) ratio, the upper or lower level's B carried from the layer
    before; rows sum_k W_k I_k in stream order."""
    f = torch.float32
    m = torch.tensor(np.asarray(m), dtype=f)[:, None]
    inv_m = 1.0 / m
    W = torch.tensor(np.asarray(W), dtype=f)
    L = tau.shape[0]
    I = I0.clone()
    rows = [None] * L
    for l in (range(L - 1, -1, -1) if reverse else range(L)):
        tl = tau[l][None, :]
        b1, b2 = (B[l + 1], B[l]) if reverse else (B[l], B[l + 1])
        rtl = 1.0 / tl                       # one correctly rounded reciprocal a layer
        tm = tl * m
        e = torch.exp(-tm)
        q = rtl * inv_m
        r = _ratio_series(tm)
        small = tm < 0.25
        t = torch.where(small, 1.0 - tm * r, e)
        ratio = torch.where(small, r, q - e * q)
        I = b2 + t * (I - b1) + (b1 - b2) * ratio
        if with_rows:
            acc = torch.zeros_like(I[0])
            for k in range(I.shape[0]):
                acc = acc + W[k] * I[k]
            rows[l] = acc
    return I, rows


def _kernel_monoflux_f32(tau, B, S, a, ctheta, m, W):
    nst, N = len(m), tau.shape[1]
    zero = torch.zeros((nst, N), dtype=torch.float32)
    _, down = _kernel_march_f32(tau, B, m, W, zero, False, True)
    bm = ctheta * S
    M_down = [bm]
    for l in range(tau.shape[0]):
        bm = bm * torch.exp(-tau[l] * (1.0 / np.float32(ctheta)))
        M_down.append(down[l] + bm)
    I_surf = M_down[-1] * (a * np.float32(1.0 / math.pi)) + B[-1]
    _, up = _kernel_march_f32(tau, B, m, W, I_surf[None, :].expand(nst, -1), True, True)
    return torch.stack(up + [np.float32(math.pi) * I_surf]), torch.stack(M_down)


@pytest.mark.parametrize("nstream", [1, 5, 8])
def test_kernel_arithmetic_matches_f32_scan(nstream):
    """The kernels' float32 arithmetic, emulated in torch, against JAX's
    float32 scan on the adversarial column (tau = 0, 1e-9, 1e-4 and 1e4
    layers): 3e-6 of peak, the bar of the plain float32 march."""
    col = _column(L=38, N=1500, seed=6)
    tau, B, S, a = _t(col, torch.float32)
    m, W = stream_nodes(nstream)
    m32, W32 = np.float32(m), np.float32(W)
    up, dn = _kernel_monoflux_f32(tau, B, S, a, np.float32(CTHETA), m32, W32)
    I, _ = _kernel_march_f32(tau, B, m32, W32, B[-1][None, :].expand(nstream, -1), True, False)
    olr = sum(W32[k] * I[k] for k in range(nstream))
    ct32 = jnp.cos(jnp.asarray(0.841, jnp.float32))
    up_s, dn_s = (np.asarray(x) for x in jd._monoflux_scan(*_j(col, np.float32), ct32, nstream))
    olr_s = np.asarray(jd._olr_scan(*_j(col[:2], np.float32), nstream))
    for got, ref in ((up, up_s), (dn, dn_s), (olr, olr_s)):
        assert np.isfinite(got.numpy()).all()
        assert np.abs(got.numpy() - ref).max() < 3e-6 * np.abs(ref).max()


@pytest.mark.parametrize("cut", ["none", "loads", "arith", "no_vote"])
def test_march_probe_cuts_apply_to_the_kernel_source(cut):
    """tools/march_probe.py cuts csrc/march.cu by text edits: each edit of
    each cut finds its text exactly once in today's source."""
    from clearsky_tpu_torch.tools import march_probe
    from clearsky_tpu_torch.utils.cuda_build import CSRC

    src = (CSRC / "march.cu").read_text()
    assert march_probe.design_of(src) == "new"
    out = march_probe.cut_source(src, cut)
    assert (out == src) == (cut == "none")


def test_march_probe_counts_loop_bodies():
    """The probe's SASS reader: a loop is a branch back, its body the
    instructions from the target to the branch, per 5-stream kernel."""
    from clearsky_tpu_torch.tools.march_probe import loop_bodies

    sass = """
        Function : _ZN12_GLOBAL__N_110olr_kernelILi5ELb0EEEvPKfS2_
        /*01f0*/                   FFMA R0, R1, R2, R3 ;
        /*0200*/                   FFMA R0, R1, R2, R3 ;
        /*0210*/              @P0 BRA 0x1f0 ;
        /*0220*/                   BRA 0x220;
        Function : _ZN12_GLOBAL__N_115monoflux_kernelILi5ELb1EEEvPKfS2_
        /*0300*/              @!P1 BRA 0x100 ;
        Function : _ZN12_GLOBAL__N_115monoflux_kernelILi4ELb1EEEvPKfS2_
        /*0300*/              @!P1 BRA 0x100 ;
    """
    assert loop_bodies(sass) == {"olr": [3], "monoflux_spread": [33]}

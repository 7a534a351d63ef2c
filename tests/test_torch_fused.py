"""The tiling of the fused table kernels K6/K7 (``csrc/fused_table.cu``)
through a float64 stand-in, against the plain versions and the JAX Pallas
kernels in interpret mode.

The stand-in does what the kernels do, in float64: point tiles of 128
(zero past N), node passes of 64, tail chunks of 16 rows whose basis it
gathers from bt thread by thread into tensor-core A fragments
(``basis_piece``: zero past the nodes and T) and unpacks as mma.m16n8k16
reads them, then lead chunks of 8 rows whose node values it gathers from
bl the same way, added into the same accumulators; per-node weights times
exp, and each layer's tau summed in node order. It must equal the plain
``_fused_olr_plain``/``_fused_monoflux_plain`` in float64 at rtol 1e-12,
and JAX's ``_fused_call``/``_fused_mono_call`` with ``interpret=True``
(float32) at the bars of
tests/test_torch_table.py::test_fused_twins_match_pallas_interpret (OLR
rtol 2e-5 and 2e-5 of peak; tau rtol 3e-5, atol 1e-10; fluxes rtol 5e-5
and 5e-5 of peak).
"""

import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from clearsky_tpu.rt import fused_table as jft
from clearsky_tpu_torch.rt import fused_table as tft
from clearsky_tpu_torch.rt import fused_table_cuda as ftc
from clearsky_tpu_torch.rt.discretized import _monoflux_march, _olr_march
from clearsky_tpu_torch.utils.quadrature import stream_nodes

# the suite runs in several worker processes: a torch thread pool of every
# core in each of them oversubscribes the machine
torch.set_num_threads(2)

BP = 128          # csrc/fused_table.cu: points a tile
CTHETA = math.cos(0.841)


def _column(L, k, N, K=16, T=37, seed=0):
    """Split-table operands like a baked table's (ln sigma ~ -55 + small
    terms, tau ~ 1): float64 lead, basis and weights, a bfloat16 tail and
    tail basis, Planck rows, S and albedo. T = 37 is no multiple of the
    16-row chunk, K = 16 two lead chunks."""
    rng = np.random.default_rng(seed + 100 * L + k)
    lead = rng.normal(0.0, 0.3, (K, N))
    lead[0] = rng.uniform(-58.0, -52.0, N)
    bl = rng.uniform(-1.0, 1.0, (L * k, K))
    bl[:, 0] = 1.0
    tail = torch.tensor(rng.normal(0.0, 0.02, (T, N))).to(torch.bfloat16)
    bt = torch.tensor(rng.uniform(-1.0, 1.0, (L * k, T))).to(torch.bfloat16)
    wq = rng.uniform(0.5, 1.5, (L, k)) * math.exp(55.0) / (k * L)
    B = 0.5 + rng.random((L + 1, N))
    t = lambda x: torch.tensor(x, dtype=torch.float64)
    return (t(lead), tail, t(bl), bt, t(wq), t(B), t(rng.random(N)), t(0.5 * rng.random(N)))


NODE_TILE, K_STEP, LEAD_CHUNK = ftc.NODE_TILE, ftc.K_STEP, ftc.LEAD_CHUNK


def _gather(bl, bt, p, c, kt):
    """Chunk c of pass p's basis as basis_piece gathers it: 128 threads x 4
    values (bfloat16 pairs for a tail chunk, floats for a lead chunk), as
    float64 [128, 4] (pairs as [128, 4, 2])."""
    J, K = bl.shape
    T = bt.shape[1]
    if c < kt:
        out = torch.zeros((128, 4, 2), dtype=torch.float64)
        for tid in range(128):
            m, g, t = tid >> 5, (tid >> 2) & 7, tid & 3
            for i in range(4):
                node = p * NODE_TILE + 16 * m + g + 8 * (i & 1)
                col = c * K_STEP + 2 * t + 8 * (i >> 1)
                for e in range(2):
                    if node < J and col + e < T:
                        out[tid, i, e] = float(bt[node, col + e])
        return out
    out = torch.zeros((128, 4), dtype=torch.float64)
    for tid in range(128):
        r, g, col = tid >> 4, (tid >> 1) & 7, (c - kt) * LEAD_CHUNK + (tid >> 4)
        for i in range(4):
            mh = 4 * (tid & 1) + i
            node = p * NODE_TILE + 16 * (mh >> 1) + 8 * (mh & 1) + g
            if node < J and col < K:
                out[tid, i] = float(bl[node, col])
    return out


def _a_tile(frag):
    """[64 nodes, 16 rows] from a tail chunk's fragments: thread 32m + 4g + t
    holds a0..a3 = (node 16m + g + 8h, rows 2t + 8kh + e) with i = 2kh + h."""
    return frag.view(4, 8, 4, 2, 2, 2).permute(0, 4, 1, 3, 2, 5).reshape(64, 16)


def _lead_rows(vals):
    """[8 rows, 64 nodes] from a lead chunk: floats [r][g][2m + h]."""
    return vals.reshape(8, 8, 4, 2).permute(0, 2, 3, 1).reshape(8, 64)


def _stand_in_tau(lead, tail, bl, bt, wq):
    """tau [L, N] in float64 as csrc/fused_table.cu forms it."""
    K, N = lead.shape
    T = tail.shape[0]
    L, k = wq.shape
    J = L * k
    npass, kt, kl = -(-J // NODE_TILE), -(-T // K_STEP), -(-K // LEAD_CHUNK)
    Np = -(-N // BP) * BP
    tail_c = torch.zeros((kt * K_STEP, Np), dtype=torch.float64)
    tail_c[:T, :N] = tail.double()
    lead_c = torch.zeros((kl * LEAD_CHUNK, Np), dtype=torch.float64)
    lead_c[:K, :N] = lead
    w = wq.reshape(-1)
    tau = torch.zeros((L, Np), dtype=torch.float64)
    for p in range(npass):
        acc = torch.zeros((NODE_TILE, Np), dtype=torch.float64)
        for c in range(kt):
            acc += _a_tile(_gather(bl, bt, p, c, kt)) @ tail_c[K_STEP * c:K_STEP * (c + 1)]
        for lc in range(kl):
            rows = _lead_rows(_gather(bl, bt, p, kt + lc, kt))
            for r in range(LEAD_CHUNK):
                acc += rows[r][:, None] * lead_c[LEAD_CHUNK * lc + r][None, :]
        j0 = p * NODE_TILE
        for j in range(j0, min(J, j0 + NODE_TILE)):
            l, jj = divmod(j, k)
            s = w[j] * torch.exp(acc[j - j0])
            tau[l] = s if jj == 0 else tau[l] + s
    return tau[:, :N]


def _dense_quad(wq):
    L, k = wq.shape
    q = np.zeros((L, L * k), np.float32)
    for l in range(L):
        q[l, l * k:(l + 1) * k] = wq[l]
    return q


SHAPES = [(L, k) for L in (1, 19, 40, 128) for k in (2, 3, 5, 8)]


@pytest.mark.parametrize("L,k", SHAPES)
def test_stand_in_matches_plain(L, k):
    """Every (L, k) of the route gate's range: 1 to 16 node passes, layers
    across pass boundaries (64 is no multiple of 3 or 5); N = 300 is no
    multiple of the 128-point tile."""
    lead, tail, bl, bt, wq, B, S, a = _column(L, k, 300)
    tau = _stand_in_tau(lead, tail, bl, bt, wq)
    want = tft._unfused_tau(lead, tail, (bl, bt), wq)
    np.testing.assert_allclose(tau.numpy(), want.numpy(), rtol=1e-12, atol=0.0)
    m, W = stream_nodes(5)
    np.testing.assert_allclose(_olr_march(tau, B, m, W).numpy(),
                               tft._fused_olr_plain(lead, tail, bl, bt, wq, B, m, W).numpy(),
                               rtol=1e-12, atol=0.0)
    got = _monoflux_march(tau, B, S, a, CTHETA, m, W)
    up, dn, _ = tft._fused_monoflux_plain(lead, tail, bl, bt, wq, B, S, a, CTHETA, m, W)
    for x, y in zip(got, (up, dn)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-12, atol=0.0)


@pytest.mark.parametrize("K,T", [(1, 1), (8, 16), (9, 17), (16, 272), (3, 105)])
def test_gather_takes_every_basis_value_once(K, T):
    """Over a pass's chunks, the gathered basis holds every bl and bt value
    of the pass's nodes exactly once, where the MMA and the lead FMAs read
    it, and zero past the nodes (J = 57 of 64), T and K."""
    rng = np.random.default_rng(K + T)
    J = 19 * 3
    bl = torch.tensor(rng.normal(size=(J, K)), dtype=torch.float64)
    bt = torch.tensor(rng.normal(size=(J, T))).to(torch.bfloat16)
    kt, kl = -(-T // K_STEP), -(-K // LEAD_CHUNK)
    A = torch.cat([_a_tile(_gather(bl, bt, 0, c, kt)) for c in range(kt)], dim=1)
    assert torch.equal(A[:J, :T], bt.double()) and not A[J:].any() and not A[:, T:].any()
    Bl = torch.cat([_lead_rows(_gather(bl, bt, 0, kt + lc, kt)) for lc in range(kl)]).t()
    assert torch.equal(Bl[:J, :K], bl) and not Bl[J:].any() and not Bl[:, K:].any()


@pytest.mark.parametrize("kernel,L,k", [("K6", 1, 2), ("K6", 19, 3), ("K6", 40, 5),
                                         ("K6", 128, 8), ("K7", 1, 2), ("K7", 19, 3),
                                         ("K7", 40, 5)])
def test_stand_in_matches_pallas_interpret(L, k, kernel):
    """The stand-in (float64) against the JAX kernels in interpret mode
    (float32) on the same operands, N = 200 (two 128-point JAX blocks).
    K7 at 128 layers is left to the rtol-1e-12 test against the plain
    version: interpret mode takes ~400 s to trace its two 128-layer
    marches."""
    N = 200
    lead, tail, bl, bt, wq, B, S, a = _column(L, k, N, seed=1)
    f32 = lambda x: jnp.asarray(x.float().numpy())
    bt_j = jnp.asarray(bt.float().numpy()).astype(jnp.bfloat16)
    tail_j = jnp.asarray(tail.float().numpy()).astype(jnp.bfloat16)
    quad = jnp.asarray(_dense_quad(wq.float().numpy()))
    nst = 5
    m, W = stream_nodes(nst)
    # the JAX kernels take float32 operands: hold the stand-in to the same
    lead, bl, wq, B, S, a = (x.float().double() for x in (lead, bl, wq, B, S, a))
    tau = _stand_in_tau(lead, tail, bl, bt, wq)
    if kernel == "K6":
        want = np.asarray(jft._fused_call(f32(lead), tail_j, (f32(bl), bt_j), quad, f32(B), nst,
                                          True, 128))
        got = _olr_march(tau, B, m, W).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 * np.abs(want).max())
        return
    up_j, dn_j, tau_j = (np.asarray(x) for x in jft._fused_mono_call(
        f32(lead), tail_j, (f32(bl), bt_j), quad, f32(B), f32(S), f32(a),
        jnp.float32(CTHETA), nst, True, 128))
    up, dn = _monoflux_march(tau, B, S, a, CTHETA, m, W)
    np.testing.assert_allclose(tau.numpy(), tau_j, rtol=3e-5, atol=1e-10)
    pk = np.abs(up_j).max()
    np.testing.assert_allclose(up.numpy(), up_j, rtol=5e-5, atol=5e-5 * pk)
    np.testing.assert_allclose(dn.numpy(), dn_j, rtol=5e-5, atol=5e-5 * pk)


@pytest.mark.parametrize("cut", ["none", "stage", "contract", "march", "no_mma", "no_exp",
                                 "no_sync"])
def test_probe_cuts_apply_to_the_kernel_source(cut):
    """tools/fused_probe.py cuts csrc/fused_table.cu by text edits: each
    edit of each cut finds its text exactly once in today's source."""
    from clearsky_tpu_torch.tools import fused_probe
    from clearsky_tpu_torch.utils.cuda_build import CSRC

    src = (CSRC / "fused_table.cu").read_text()
    assert fused_probe.design_of(src) == "new"
    out = fused_probe.cut_source(src, cut)
    assert (out == src) == (cut == "none")

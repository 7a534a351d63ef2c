"""The port's CUDA kernels (K1 line sum, K2/K3 march, K6/K7 fused table)
and their wrappers.

This file imports no JAX, so that it also runs on a machine with a card and
no JAX (pytest then needs ``--noconftest``: tests/conftest.py imports jax):

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Tests marked ``gpu`` launch the kernels and skip without a CUDA card. Each
holds a float32 kernel to the plain PyTorch version in float64 on the same
inputs (line sum: rtol 2e-3 where |sigma| > 1e-35, the bar of
tests/test_linesum_pallas.py; march: 3.5e-6 of peak, the float32 class of
BASELINE.md; fused table: 1e-4 of peak for the fluxes and rtol 1e-4 for tau,
the bars of chip_smoke.py) and checks that the wrapper raises on inputs the
kernel does not take. The tests without the marker check the wrappers' CPU
path, the build flags and key, and the float32 precision pin.
"""

import math
import subprocess
import sys

import numpy as np
import pytest
import torch

import clearsky_tpu_torch as ct
from clearsky_tpu_torch.ops import linesum_cuda
from clearsky_tpu_torch.ops.linesum import build_line_window_plan, sigma_from_lines
from clearsky_tpu_torch.ops.linesum_cuda import sigma_lines
from clearsky_tpu_torch.rt import discretized as td
from clearsky_tpu_torch.rt import march_cuda
from clearsky_tpu_torch.rt.march_cuda import olr_march, monoflux_march
from clearsky_tpu_torch.rt import fused_table as tft
from clearsky_tpu_torch.rt.fused_table_cuda import fused_olr, fused_monoflux
from clearsky_tpu_torch.utils import cuda_build
from clearsky_tpu_torch.utils.quadrature import stream_nodes

# the suite runs in several worker processes: a torch thread pool of every
# core in each of them oversubscribes the machine
torch.set_num_threads(2)

CTHETA = math.cos(0.841)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def cat():
    lines = ct.SpectralLines.from_par_dict(ct.synthetic_co2_par(600, seed=21))
    nu = np.linspace(590.0, 760.0, 2000)   # no multiple of the 128-point block
    plan = build_line_window_plan(nu, lines.positions64(), 25.0)
    states = [np.linspace(170.0, 310.0, 11), np.geomspace(10.0, 1e5, 11)]
    states.append(0.95 * states[1])
    return lines, plan, states


def _column(L=19, N=3000, seed=0):
    rng = np.random.default_rng(seed)
    tau = rng.exponential(0.5, (L, N))
    tau[0], tau[1], tau[2] = 0.0, 1e-9, 1e-4
    tau[-1, : N // 3] = 1e4
    return tau, 0.5 + rng.random((L + 1, N)), rng.random(N), 0.5 * rng.random(N)


def _t(xs, dtype=torch.float64, device="cpu"):
    return [torch.tensor(x, dtype=dtype, device=device) for x in xs]


def test_build_flags_keep_ieee_float32():
    """No fast math (FTZ, approximate expf) and the Hopper target with its 'a'."""
    flags = " ".join(cuda_build.NVCC_FLAGS)
    assert "fast_math" not in flags and "ftz=true" not in flags
    assert "arch=compute_90a,code=sm_90a" in flags
    for name in ("linesum", "march", "fused_table"):
        src = (cuda_build.CSRC / f"{name}.cu").read_text()
        assert "clearsky_tpu/" in src and "__expf" not in src


def test_library_key_covers_the_headers(tmp_path, monkeypatch):
    """An edit to any csrc/*.cuh, or a new one, names a new library."""
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    first = cuda_build.library_path("k")
    assert cuda_build.library_path("k") == first
    (tmp_path / "common.cuh").write_text("// v2\n")
    second = cuda_build.library_path("k")
    (tmp_path / "other.cuh").write_text("\n")
    assert len({first, second, cuda_build.library_path("k")}) == 3


_PIN = """
import sys, torch
from clearsky_tpu_torch.utils.interp import full_float32
mm = torch.backends.cuda.matmul
if sys.argv[1] == "legacy":
    mm.allow_tf32 = True
    read = lambda: mm.allow_tf32
else:
    mm.fp32_precision = "tf32"
    read = lambda: mm.fp32_precision
before = read()
with full_float32():
    inside = mm.fp32_precision if sys.argv[1] == "new" else mm.allow_tf32
assert inside in (False, "ieee"), inside
assert read() == before, (read(), before)
print("ok")
"""


@pytest.mark.parametrize("api", ["legacy", "new"])
def test_full_float32_pins_and_restores_tf32(api):
    """The pin turns TF32 off inside and restores the caller's setting,
    through whichever of PyTorch's two interfaces the process used (a
    fresh process: the setting is global)."""
    proc = subprocess.run([sys.executable, "-c", _PIN, api], capture_output=True, text=True,
                          timeout=120, cwd=str(cuda_build.CSRC.parent.parent))
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_cpu_tensors_take_the_plain_versions(cat):
    lines, plan, states = cat
    counts = (sigma_lines.launches, olr_march.launches, monoflux_march.launches)
    T, P, Pp = _t(states)
    np.testing.assert_array_equal(sigma_lines(plan, lines, T, P, Pp).numpy(),
                                  sigma_from_lines(plan, lines, T, P, Pp).numpy())
    tau, B, S, a = _t(_column(L=5, N=300))
    m, W = stream_nodes(5)
    np.testing.assert_array_equal(olr_march(tau, B, m, W).numpy(),
                                  td._olr_march(tau, B, m, W).numpy())
    for k, p in zip(monoflux_march(tau, B, S, a, CTHETA, m, W),
                    td._monoflux_march(tau, B, S, a, CTHETA, m, W)):
        np.testing.assert_array_equal(k.numpy(), p.numpy())
    assert (sigma_lines.launches, olr_march.launches, monoflux_march.launches) == counts


@pytest.mark.parametrize("shape", ["phco2", "voigt_ref", "gauss"])
def test_line_sum_kernel_rejects_unported_shapes(shape):
    with pytest.raises(ValueError):
        linesum_cuda._mode(shape)


@pytest.mark.parametrize("n", [0, 9])
def test_march_kernels_take_one_to_eight_streams(n):
    with pytest.raises(ValueError):
        march_cuda._streams(np.ones(n), np.ones(n))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["voigt", "lorentz", "doppler"])
def test_line_sum_kernel_matches_plain(cat, cuda, shape):
    lines, plan, states = cat
    before = sigma_lines.launches
    out = sigma_lines(plan, lines.to(torch.float32, cuda), *_t(states, torch.float32, cuda),
                      shape=shape)
    torch.cuda.synchronize()
    assert sigma_lines.launches == before + 1
    ref = sigma_from_lines(plan, lines, *_t(states), shape=shape).numpy()
    out = out.double().cpu().numpy()
    m = np.abs(ref) > 1e-35
    np.testing.assert_allclose(out[m], ref[m], rtol=2e-3, atol=1e-32)
    assert np.all(np.abs(out[~m]) < 1e-30)


@pytest.mark.gpu
def test_line_sum_wrapper_rejects_bad_inputs(cat, cuda):
    lines, plan, states = cat
    l32 = lines.to(torch.float32, cuda)
    T, P, Pp = _t(states, torch.float32, cuda)
    with pytest.raises(TypeError):        # float64 states
        sigma_lines(plan, l32, T.double(), P, Pp)
    with pytest.raises(TypeError):        # float64 catalog
        sigma_lines(plan, lines.to(device=cuda), *_t(states, torch.float64, cuda))
    with pytest.raises(ValueError):       # not contiguous
        sigma_lines(plan, l32, torch.stack([T, T], 1)[:, 0], P, Pp)
    with pytest.raises(ValueError):       # wrong shape
        sigma_lines(plan, l32, T, P[:2], Pp)
    with pytest.raises(ValueError):       # another device
        sigma_lines(plan, l32, T, P.cpu(), Pp)


@pytest.mark.gpu
@pytest.mark.parametrize("nstream", [1, 5, 8])
def test_march_kernels_match_plain(cuda, nstream):
    m, W = stream_nodes(nstream)
    x32 = _t(_column(), torch.float32, cuda)
    x64 = [x.double().cpu() for x in x32]
    counts = (olr_march.launches, monoflux_march.launches)
    olr = olr_march(x32[0], x32[1], m, W)
    up, dn = monoflux_march(*x32, CTHETA, m, W)
    torch.cuda.synchronize()
    assert (olr_march.launches, monoflux_march.launches) == (counts[0] + 1, counts[1] + 1)
    olr_r = td._olr_march(x64[0], x64[1], m, W)
    up_r, dn_r = td._monoflux_march(*x64, CTHETA, m, W)
    for k, r in ((olr, olr_r), (up, up_r), (dn, dn_r)):
        assert float((k.double().cpu() - r).abs().max()) < 3.5e-6 * float(r.abs().max())


@pytest.mark.gpu
def test_march_wrappers_reject_bad_inputs(cuda):
    tau, B, S, a = _t(_column(L=4, N=256), torch.float32, cuda)
    m, W = stream_nodes(5)
    with pytest.raises(TypeError):
        olr_march(tau.double(), B.double(), m, W)
    with pytest.raises(ValueError):
        olr_march(tau, B[:-1], m, W)
    with pytest.raises(ValueError):
        olr_march(tau.t().contiguous().t(), B, m, W)
    with pytest.raises(ValueError):
        monoflux_march(tau, B, S[:-1], a, CTHETA, m, W)
    with pytest.raises(ValueError):
        monoflux_march(tau, B, S, a.cpu(), CTHETA, m, W)
    with pytest.raises(ValueError):
        olr_march(tau, B, *stream_nodes(9))


def _table_column(L, k, N, seed=0, K=16, T=272):
    """Split-table operands like a baked CO2 table's: ln sigma ~ -55 +- 2,
    with a tenth of the points transparent (-80: tau ~ 1e-11, the series
    branch) and a tenth opaque (-44: tau ~ 1e4)."""
    rng = np.random.default_rng(seed)
    lead = rng.normal(0.0, 0.3, (K, N))
    lead[0] = rng.uniform(-58.0, -52.0, N)
    lead[0, : N // 10] = -80.0
    lead[0, N // 10: N // 5] = -44.0
    tail = rng.normal(0.0, 0.02, (T, N))
    bl = rng.uniform(-1.0, 1.0, (L * k, K))
    bl[:, 0] = 1.0
    bt = rng.uniform(-1.0, 1.0, (L * k, T))
    wq = rng.uniform(0.5, 1.5, (L, k)) * math.exp(55.0) / (k * L)
    B = 0.5 + rng.random((L + 1, N))
    return dict(lead=lead, tail=tail, bl=bl, bt=bt, wq=wq, B=B, S=rng.random(N),
                a=0.5 * rng.random(N))


def _table_tensors(c, dtype=torch.float64, device="cpu"):
    """(lead, tail, bl, bt, wq, B, S, a): the tail and its basis in bfloat16."""
    t = lambda x, dt=dtype: torch.tensor(x, dtype=torch.float32, device=device).to(dt)
    return (t(c["lead"]), t(c["tail"], torch.bfloat16), t(c["bl"]), t(c["bt"], torch.bfloat16),
            t(c["wq"]), t(c["B"]), t(c["S"]), t(c["a"]))


def test_fused_wrappers_on_cpu_take_the_plain_versions():
    lead, tail, bl, bt, wq, B, S, a = _table_tensors(_table_column(L=4, k=3, N=200))
    m, W = stream_nodes(5)
    counts = (fused_olr.launches, fused_monoflux.launches)
    np.testing.assert_array_equal(fused_olr(lead, tail, bl, bt, wq, B, m, W).numpy(),
                                  tft._fused_olr_plain(lead, tail, bl, bt, wq, B, m, W).numpy())
    got = fused_monoflux(lead, tail, bl, bt, wq, B, S, a, CTHETA, m, W)
    for x, y in zip(got, tft._fused_monoflux_plain(lead, tail, bl, bt, wq, B, S, a, CTHETA,
                                                     m, W)):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert (fused_olr.launches, fused_monoflux.launches) == counts
    # the plain tau is the JAX package's dense block-diagonal quadrature
    L, k = wq.shape
    dense = torch.zeros((L, L * k), dtype=wq.dtype)
    for l in range(L):
        dense[l, l * k:(l + 1) * k] = wq[l]
    ln = bl @ lead + bt.double() @ tail.double()
    np.testing.assert_allclose(got[2].numpy(), (dense @ torch.exp(ln)).numpy(), rtol=1e-13)


@pytest.mark.parametrize("wrapper", ["fused_olr", "fused_monoflux"])
def test_fused_wrappers_refuse_gradients(wrapper):
    """Autograd through K6/K7 is not ported: the wrappers raise on any
    device (ROADMAP queue A item 5)."""
    lead, tail, bl, bt, wq, B, S, a = _table_tensors(_table_column(L=2, k=2, N=64))
    m, W = stream_nodes(5)
    lead.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="item 5"):
        if wrapper == "fused_olr":
            fused_olr(lead, tail, bl, bt, wq, B, m, W)
        else:
            fused_monoflux(lead, tail, bl, bt, wq, B, S, a, CTHETA, m, W)


@pytest.mark.gpu
@pytest.mark.parametrize("L,k,nstream,N", [(1, 3, 2, 333), (19, 3, 5, 4096), (40, 3, 8, 1000),
                                           (19, 2, 5, 2**16 + 37), (7, 5, 4, 515),
                                           (3, 8, 5, 130)])
def test_fused_kernels_match_plain(cuda, L, k, nstream, N):
    """K6 and K7 in float32 against their plain versions in float64 on the
    same split operands: N not a multiple of the 128-point block (but 4096),
    one to twenty node groups of 8 (L = 40, k = 3: two rounds of warps),
    k = 5 and 8 (groups of one layer)."""
    col = _table_column(L, k, N, seed=L + N)
    x32 = _table_tensors(col, torch.float32, cuda)
    lead, tail, bl, bt, wq, B, S, a = x32
    x64 = [x.cpu() if x.dtype == torch.bfloat16 else x.double().cpu() for x in x32]
    m, W = stream_nodes(nstream)
    counts = (fused_olr.launches, fused_monoflux.launches)
    olr = fused_olr(lead, tail, bl, bt, wq, B, m, W)
    up, dn, tau = fused_monoflux(*x32, CTHETA, m, W)
    torch.cuda.synchronize()
    assert (fused_olr.launches, fused_monoflux.launches) == (counts[0] + 1, counts[1] + 1)
    olr_r = tft._fused_olr_plain(*x64[:6], m, W)
    up_r, dn_r, tau_r = tft._fused_monoflux_plain(*x64, CTHETA, m, W)
    for kern, ref in ((olr, olr_r), (up, up_r), (dn, dn_r)):
        assert float((kern.double().cpu() - ref).abs().max()) < 1e-4 * float(ref.abs().max())
    np.testing.assert_allclose(tau.double().cpu().numpy(), tau_r.numpy(), rtol=1e-4, atol=0.0)


@pytest.mark.gpu
def test_fused_wrappers_reject_bad_inputs(cuda):
    lead, tail, bl, bt, wq, B, S, a = _table_tensors(_table_column(L=4, k=3, N=300),
                                                     torch.float32, cuda)
    m, W = stream_nodes(5)
    with pytest.raises(TypeError):         # a float32 tail
        fused_olr(lead, tail.float(), bl, bt, wq, B, m, W)
    with pytest.raises(TypeError):         # float64 coefficients
        fused_olr(lead.double(), tail, bl, bt, wq, B, m, W)
    with pytest.raises(ValueError):        # a Planck row short
        fused_olr(lead, tail, bl, bt, wq, B[:-1], m, W)
    with pytest.raises(ValueError):        # basis rows that are not L*k nodes
        fused_olr(lead, tail, bl[:-1], bt[:-1], wq, B, m, W)
    with pytest.raises(ValueError):        # not contiguous
        fused_olr(lead, tail, bl.t().contiguous().t(), bt, wq, B, m, W)
    with pytest.raises(ValueError):        # another device
        fused_monoflux(lead, tail, bl, bt, wq, B, S.cpu(), a, CTHETA, m, W)
    with pytest.raises(ValueError):        # nine streams
        fused_olr(lead, tail, bl, bt, wq, B, *stream_nodes(9))
    with pytest.raises(NotImplementedError):
        fused_monoflux(lead, tail, bl, bt, wq.requires_grad_(True), B, S, a, CTHETA, m, W)


@pytest.mark.gpu
def test_table_contractions_ignore_global_tf32(cuda):
    """With TF32 allowed process-wide, Gas.raw_sigma and cheb2d_coeffs keep
    full float32 (their bars fail under TF32's 10-bit mantissa: ~0.03 in an
    ln sigma of 55, 3% in sigma)."""
    from clearsky_tpu_torch.utils.interp import cheb2d_coeffs

    rng = np.random.default_rng(7)
    dom = ct.AtmosphericDomain.create((150.0, 350.0), 12, (9.0, 1.01e5), 24)
    coeffs = rng.normal(0.0, 0.3, (288, 4096)) / (1.0 + np.arange(288))[:, None]
    coeffs[0] = rng.uniform(-58.0, -52.0, 4096)
    nu = np.linspace(500.0, 900.0, 4096)
    T = rng.uniform(150.0, 350.0, 64)
    P = np.exp(rng.uniform(np.log(9.0), np.log(1.01e5), 64))
    V = rng.normal(-60.0, 5.0, (256, 12, 24))

    def gas(dtype, device):
        return ct.Gas(nu=torch.tensor(nu, dtype=dtype, device=device),
                      coeffs=torch.tensor(coeffs, dtype=dtype, device=device), domain=dom,
                      fC=lambda T_, P_: torch.ones_like(T_))

    g64 = gas(torch.float64, "cpu")
    ref_sig = {"full": g64, "split": g64.split_precision(16)}
    ref_sig = {k: g.raw_sigma(torch.tensor(T), torch.tensor(P)) for k, g in ref_sig.items()}
    ref_c = cheb2d_coeffs(torch.tensor(V))
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        g32 = gas(torch.float32, cuda)
        t32, p32 = (torch.tensor(x, dtype=torch.float32, device=cuda) for x in (T, P))
        got = {"full": g32.raw_sigma(t32, p32),
               "split": g32.split_precision(16).raw_sigma(t32, p32)}
        c32 = cheb2d_coeffs(torch.tensor(V, dtype=torch.float32, device=cuda))
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    for k in got:
        np.testing.assert_allclose(got[k].double().cpu().numpy(), ref_sig[k].numpy(),
                                   rtol=1e-4, err_msg=k)
    err = float((c32.double().cpu() - ref_c).abs().max())
    assert err < 1e-5 * float(ref_c.abs().max())

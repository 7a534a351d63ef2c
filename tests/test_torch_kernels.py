"""The port's CUDA kernels (K1 line sum, K2/K3 march) and their wrappers.

This file imports no JAX, so that it also runs on a machine with a card and
no JAX (pytest then needs ``--noconftest``: tests/conftest.py imports jax):

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Tests marked ``gpu`` launch the kernels and skip without a CUDA card. Each
holds a float32 kernel to the plain PyTorch version in float64 on the same
inputs (line sum: rtol 2e-3 where |sigma| > 1e-35, the bar of
tests/test_linesum_pallas.py; march: 3.5e-6 of peak, the float32 class of
BASELINE.md) and checks that the wrapper raises on inputs the kernel does not
take. The tests without the marker check the wrappers' CPU path and the
build flags.
"""

import math

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
    for name in ("linesum", "march"):
        src = (cuda_build.CSRC / f"{name}.cu").read_text()
        assert "clearsky_tpu/" in src and "__expf" not in src


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

"""The port's line sum (the module of kernel K1) against the JAX package.

A synthetic CO2 catalog built in memory from a seed feeds both packages. The
plain PyTorch line sum in float64 is held to ``clearsky_tpu``'s float64
oracle at 1e-9 (same arithmetic, other summation order), and to the float32
Pallas kernel in interpret mode at its own bar (2e-3 where |sigma| > 1e-35,
tests/test_linesum_pallas.py). The kernel's coefficient pack is checked by
evaluating the kernel's formulas on it in float64. The CUDA kernel itself
runs only on a card (tests/test_torch_kernels.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from clearsky_tpu.spectra.lines import SpectralLines as JLines
from clearsky_tpu.ops.linesum import build_line_window_plan as jplan, sigma_from_lines as jsigma
from clearsky_tpu.ops.linesum_pallas import sigma_from_lines_pallas
from clearsky_tpu_torch import convert
from clearsky_tpu_torch.spectra.synthetic import synthetic_co2_par
from clearsky_tpu_torch.ops.faddeeva import wofz_re
from clearsky_tpu_torch.ops.linesum import (
    build_line_window_plan,
    sigma_from_lines,
    sigma_from_lines_auto,
    _line_params,
)
from clearsky_tpu_torch.ops import linesum_cuda
from clearsky_tpu_torch.ops import linesum_strategies as ls
from clearsky_tpu_torch.ops.linesum_cuda import pack_coefficients, near_distance
from clearsky_tpu_torch.utils import profiling

# the suite runs in several worker processes: a torch thread pool of every
# core in each of them oversubscribes the machine
torch.set_num_threads(2)

SHAPES = ["voigt", "lorentz", "doppler"]
T = np.array([190.0, 250.0, 310.0])
P = np.array([20.0, 4e3, 9e4])     # low P: small y (the w4 repair); high P: wide lines
PP = 0.4 * P


@pytest.fixture(scope="module")
def cat():
    par = synthetic_co2_par(500, seed=11)
    jl = JLines.from_par_dict(par)
    tl = convert.spectral_lines(jl, dtype=torch.float64, device="cpu")
    nu = np.linspace(600.0, 740.0, 1024)
    return dict(jl=jl, tl=tl, nu=nu, jp=jplan(nu, np.asarray(jl.nu), 25.0),
                tp=build_line_window_plan(nu, tl.positions64(), 25.0))


def _states(dtype=torch.float64, device="cpu"):
    return [torch.tensor(x, dtype=dtype, device=device) for x in (T, P, PP)]


def _jax_oracle(cat, shape):
    return np.asarray(jsigma(cat["jp"], cat["jl"], jnp.asarray(T), jnp.asarray(P),
                             jnp.asarray(PP), shape))


def test_plan_matches(cat):
    a, b = cat["tp"], cat["jp"]
    assert (a.block, a.n_blocks, a.slab, a.cut) == (b.block, b.n_blocks, b.slab, b.cut)
    for f in ("nu", "nu_blocks", "start", "count"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_f64_oracle(cat, shape):
    out = sigma_from_lines(cat["tp"], cat["tl"], *_states(), shape=shape).numpy()
    ref = _jax_oracle(cat, shape)
    assert out.shape == ref.shape == (3, len(cat["nu"]))
    np.testing.assert_allclose(out, ref, rtol=1e-9, atol=1e-40)


@pytest.mark.parametrize("strategy", ["grouped", "nosplit"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_interpret(cat, shape, strategy):
    ker = np.asarray(sigma_from_lines_pallas(
        cat["jp"], cat["jl"], jnp.asarray(T), jnp.asarray(P), jnp.asarray(PP), shape,
        interpret=True, strategy=strategy))
    t32 = cat["tl"].to(torch.float32)
    for out in (sigma_from_lines(cat["tp"], cat["tl"], *_states(), shape=shape).numpy(),
                sigma_from_lines(cat["tp"], t32, *_states(torch.float32),
                                 shape=shape).double().numpy()):
        m = np.abs(out) > 1e-35
        np.testing.assert_allclose(ker[m], out[m], rtol=2e-3, atol=1e-32)
        assert np.all(np.abs(ker[~m]) < 1e-30)


def test_nosplit_plain_matches_pallas_interpret(cat):
    """The no-split sweep's plain version in float32 against JAX's
    interpret-mode kernel (strategy "nosplit") at the line-sum bar, and
    the split mode within rtol 1e-4 of it (tests/test_linesum_pallas.py:62)."""
    ker = np.asarray(sigma_from_lines_pallas(
        cat["jp"], cat["jl"], jnp.asarray(T), jnp.asarray(P), jnp.asarray(PP), "voigt",
        interpret=True, strategy="nosplit"))
    out = ls.sigma_nosplit_plain(cat["tp"], cat["tl"].to(torch.float32),
                                 *_states(torch.float32)).double().numpy()
    m = np.abs(ker) > 1e-35
    np.testing.assert_allclose(out[m], ker[m], rtol=2e-3, atol=1e-32)
    assert np.all(np.abs(out[~m]) < 1e-30)
    split = np.asarray(sigma_from_lines_pallas(
        cat["jp"], cat["jl"], jnp.asarray(T), jnp.asarray(P), jnp.asarray(PP), "voigt",
        interpret=True, strategy="grouped"))
    np.testing.assert_allclose(split[m], ker[m], rtol=1e-4, atol=0.0)
    # on the CPU the wrapper is the plain version
    np.testing.assert_array_equal(
        linesum_cuda.sigma_nosplit(cat["tp"], cat["tl"], *_states()).numpy(),
        ls.sigma_nosplit_plain(cat["tp"], cat["tl"], *_states()).numpy())


def test_f32_plain_carries_two_float_positions(cat):
    """float32 with the hi + lo split stays near float64 at low pressure."""
    t32 = cat["tl"].to(torch.float32)
    out = sigma_from_lines(cat["tp"], t32, *_states(torch.float32), shape="voigt").double()
    ref = sigma_from_lines(cat["tp"], cat["tl"], *_states(), shape="voigt")
    m = ref.abs() > 1e-8 * ref.abs().max()
    assert float(((out - ref).abs()[m] / ref.abs()[m]).max()) < 1e-4


def test_auto_dispatch_on_cpu_is_plain_and_launches_nothing(cat):
    before = profiling.counters["launch.linesum"]
    Tb = torch.tensor(T).reshape(3, 1).expand(3, 2)
    Pb = torch.tensor(P).reshape(3, 1).expand(3, 2)
    out = sigma_from_lines_auto(cat["tp"], cat["tl"], Tb, Pb, 0.4 * Pb, "voigt")
    assert out.shape == (3, 2, len(cat["nu"]))
    ref = sigma_from_lines(cat["tp"], cat["tl"], *_states(), shape="voigt")
    np.testing.assert_array_equal(out[:, 0].numpy(), ref.numpy())
    np.testing.assert_array_equal(out[:, 1].numpy(), ref.numpy())
    assert profiling.counters["launch.linesum"] == before


def _emulate_kernel(plan, lines, mode, coef, d_near, n_states):
    """The kernel's arithmetic (csrc/linesum.cu) in float64 on its coefficient
    pack [n_lines, n_states, n_coef]: the split mode's (Sia, ia, y0, 0, A, c1,
    c2, k2), the no-split sweep's (Sia, ia, y0, A), lorentz's and doppler's
    (S, alpha, gamma, 0)."""
    nu_b = torch.tensor(plan.nu_blocks)
    out = torch.zeros(n_states, plan.n_blocks, plan.block, dtype=torch.float64)
    for b in range(plan.n_blocks):
        s0, cnt = int(plan.start[b]), int(plan.count[b])
        if cnt == 0:
            continue
        dnu = nu_b[b][:, None] - lines.nu[s0:s0 + cnt][None, :]        # [B, cnt]
        adnu = dnu.abs()
        for st in range(n_states):
            c = coef[s0:s0 + cnt, st]
            if mode == linesum_cuda.NOSPLIT_MODES["voigt"]:
                f = c[:, 0] * wofz_re(dnu * c[:, 1], c[:, 2].expand_as(dnu))
            elif mode == linesum_cuda.MODES["voigt"]:
                near = c[:, 0] * wofz_re(dnu * c[:, 1], c[:, 2].expand_as(dnu))
                D = dnu * dnu
                m_ = D * c[:, 4]
                far = c[:, 7] * (c[:, 5] + m_) / ((c[:, 5] - m_) ** 2 + c[:, 6] * D)
                f = torch.where(adnu > d_near, far, near)
            elif mode == linesum_cuda.MODES["lorentz"]:
                f = c[:, 0] * (c[:, 2] / np.pi) / (dnu * dnu + c[:, 2] ** 2)
            else:
                ia = 1.0 / c[:, 1]
                f = (c[:, 0] / np.sqrt(np.pi) * ia) * torch.exp(-(dnu * ia) ** 2)
            out[st, b] = torch.where(adnu <= plan.cut, f, 0.0).sum(-1)
    return out.reshape(n_states, -1)[:, : plan.n_nu]


@pytest.mark.parametrize("shape", ["voigt", "lorentz", "doppler", "voigt_nosplit"])
def test_kernel_pack_reproduces_plain(cat, shape):
    """The coefficient pack and d_near, run through the kernel's formulas
    (the split mode, the single sweeps and the no-split sweep)."""
    # 11 states: K1's tiles of 8, 2 and 1 states
    Ts = torch.tensor(np.linspace(180.0, 320.0, 11))
    Ps = torch.tensor(np.geomspace(10.0, 1e5, 11))
    nosplit = shape.endswith("_nosplit")
    shape = shape.removesuffix("_nosplit")
    mode = linesum_cuda.nosplit_mode(shape) if nosplit else linesum_cuda._mode(shape)
    S, a, g = _line_params(cat["tl"], Ts, Ps, 0.4 * Ps)
    coef = pack_coefficients(mode, S, a, g)
    assert coef.shape == (cat["tl"].n_lines, 11, linesum_cuda._N_COEF[mode])
    d_near = float(near_distance(a, cat["tp"].cut))
    assert 0.0 < d_near <= cat["tp"].cut
    out = _emulate_kernel(cat["tp"], cat["tl"], mode, coef, d_near, 11)
    ref = sigma_from_lines(cat["tp"], cat["tl"], Ts, Ps, 0.4 * Ps, shape=shape)
    m = ref.abs() > 1e-35
    # region 1 against the w4 small-y repair in the far wing: <= 2e-5 relative
    rtol = 1e-4 if shape == "voigt" and not nosplit else 1e-12
    if nosplit:
        np.testing.assert_allclose(out.numpy(), ls.sigma_nosplit_plain(
            cat["tp"], cat["tl"], Ts, Ps, 0.4 * Ps).numpy(), rtol=1e-13, atol=1e-300)
    np.testing.assert_allclose(out[m].numpy(), ref[m].numpy(), rtol=rtol, atol=1e-40)

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
from clearsky_tpu_torch.ops.linesum_cuda import sigma_lines, pack_coefficients, near_distance

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


def test_f32_plain_carries_two_float_positions(cat):
    """float32 with the hi + lo split stays near float64 at low pressure."""
    t32 = cat["tl"].to(torch.float32)
    out = sigma_from_lines(cat["tp"], t32, *_states(torch.float32), shape="voigt").double()
    ref = sigma_from_lines(cat["tp"], cat["tl"], *_states(), shape="voigt")
    m = ref.abs() > 1e-8 * ref.abs().max()
    assert float(((out - ref).abs()[m] / ref.abs()[m]).max()) < 1e-4


def test_auto_dispatch_on_cpu_is_plain_and_launches_nothing(cat):
    before = sigma_lines.launches
    Tb = torch.tensor(T).reshape(3, 1).expand(3, 2)
    Pb = torch.tensor(P).reshape(3, 1).expand(3, 2)
    out = sigma_from_lines_auto(cat["tp"], cat["tl"], Tb, Pb, 0.4 * Pb, "voigt")
    assert out.shape == (3, 2, len(cat["nu"]))
    ref = sigma_from_lines(cat["tp"], cat["tl"], *_states(), shape="voigt")
    np.testing.assert_array_equal(out[:, 0].numpy(), ref.numpy())
    np.testing.assert_array_equal(out[:, 1].numpy(), ref.numpy())
    assert sigma_lines.launches == before


def _emulate_kernel(plan, lines, mode, coef, d_near, n_states):
    """The kernel's arithmetic (csrc/linesum.cu) in float64 on its coefficient pack."""
    nc = coef.shape[-1] // linesum_cuda.ST
    nu_b = torch.tensor(plan.nu_blocks)
    out = torch.zeros(n_states, plan.n_blocks, plan.block, dtype=torch.float64)
    for b in range(plan.n_blocks):
        s0, cnt = int(plan.start[b]), int(plan.count[b])
        if cnt == 0:
            continue
        dnu = nu_b[b][:, None] - lines.nu[s0:s0 + cnt][None, :]        # [B, cnt]
        adnu = dnu.abs()
        for st in range(n_states):
            c = coef[st // linesum_cuda.ST, s0:s0 + cnt].view(cnt, linesum_cuda.ST, nc)
            c = c[:, st % linesum_cuda.ST]
            if mode == linesum_cuda.MODES["voigt"]:
                near = c[:, 0] * wofz_re(dnu * c[:, 1], c[:, 2].expand_as(dnu))
                D = dnu * dnu
                m_ = D * c[:, 3]
                far = c[:, 6] * (c[:, 4] + m_) / ((c[:, 4] - m_) ** 2 + c[:, 5] * D)
                f = torch.where(adnu > d_near, far, near)
            elif mode == linesum_cuda.MODES["lorentz"]:
                f = c[:, 0] * (c[:, 2] / np.pi) / (dnu * dnu + c[:, 2] ** 2)
            else:
                ia = 1.0 / c[:, 1]
                f = (c[:, 0] / np.sqrt(np.pi) * ia) * torch.exp(-(dnu * ia) ** 2)
            out[st, b] = torch.where(adnu <= plan.cut, f, 0.0).sum(-1)
    return out.reshape(n_states, -1)[:, : plan.n_nu]


@pytest.mark.parametrize("shape", ["voigt", "lorentz", "doppler"])
def test_kernel_pack_reproduces_plain(cat, shape):
    """The coefficient pack and d_near, run through the kernel's formulas."""
    # 11 states: a full tile of 8 plus a padded one
    Ts = torch.tensor(np.linspace(180.0, 320.0, 11))
    Ps = torch.tensor(np.geomspace(10.0, 1e5, 11))
    mode = linesum_cuda._mode(shape)
    S, a, g = _line_params(cat["tl"], Ts, Ps, 0.4 * Ps)
    coef = pack_coefficients(mode, S, a, g)
    assert coef.shape == (2, cat["tl"].n_lines, 8 * linesum_cuda._N_COEF[mode])
    d_near = float(near_distance(a, cat["tp"].cut))
    assert 0.0 < d_near <= cat["tp"].cut
    out = _emulate_kernel(cat["tp"], cat["tl"], mode, coef, d_near, 11)
    ref = sigma_from_lines(cat["tp"], cat["tl"], Ts, Ps, 0.4 * Ps, shape=shape)
    m = ref.abs() > 1e-35
    # region 1 against the w4 small-y repair in the far wing: <= 2e-5 relative
    rtol = 1e-4 if shape == "voigt" else 1e-12
    np.testing.assert_allclose(out[m].numpy(), ref[m].numpy(), rtol=rtol, atol=1e-40)

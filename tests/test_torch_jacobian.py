"""Derivatives through the port's kernels, and the RCM's Jacobian, against
the JAX package.

The JAX package differentiates through its Pallas kernels with custom JVPs
whose tangents run on each kernel's plain twin; the port's kernel wrappers
are ``torch.autograd.Function``s that do the same (``utils/twin.py``). On
the CPU the kernels cannot run, so each Function is driven with its launch
replaced by a plain CPU stand-in, the way tests/test_march_pallas.py forces
the kernel path into interpret mode: the Function's forward-mode Jacobian
and its gradient must then equal the plain twin's. Bars and their reasons:

* the Faddeeva derivative against JAX's custom JVP: 1e-12 (the same
  formulas); against central differences of the w4 approximation, the JAX
  test's 7e-3 (the rule is the true function's derivative);
* each Function against its plain twin: rtol 1e-11 (the same arithmetic);
* ``jacobian`` against JAX's in float64: rtol 1e-8, atol 1e-8 max|J| (other
  summation orders in the line sum and the march; fd amplifies them by
  1/eps);
* forward mode against finite differences: the bars of tests/test_rcm.py
  :102 and :146.

Synthetic catalogs from a seed feed both packages (no HITRAN file is in the
repository).
"""

import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from clearsky_tpu.absorption.cia import CIATables as JCIATables
from clearsky_tpu.absorption.domain import AtmosphericDomain as JDomain
from clearsky_tpu.absorption.gas import (DirectGas as JDirectGas, Gas as JGas,
                                         GrayGas as JGrayGas, MultiGas as JMultiGas)
from clearsky_tpu.atmosphere import adiabats as ja
from clearsky_tpu.models import rcm as jr
from clearsky_tpu.ops.faddeeva import wofz_re_im as jwofz
from clearsky_tpu.spectra.lines import SpectralLines as JLines
from clearsky_tpu.utils import grids as jgrids
import clearsky_tpu_torch as ct
from clearsky_tpu_torch import convert
from clearsky_tpu_torch.constants import R_GAS
from clearsky_tpu_torch.ops.planck import planck
from clearsky_tpu_torch.atmosphere.profile import formprofile
from clearsky_tpu_torch.ops import linesum_cuda
from clearsky_tpu_torch.ops import linesum_strategies as ls
from clearsky_tpu_torch.ops.faddeeva import wofz_re_im
from clearsky_tpu_torch.ops.linesum import (build_line_window_plan, sigma_from_lines,
                                            sigma_from_lines_auto)
from clearsky_tpu_torch.rt import fused_table as tft
from clearsky_tpu_torch.rt import fused_table_cuda, march_cuda
from clearsky_tpu_torch.rt.discretized import _monoflux_march, _olr_march
from clearsky_tpu_torch.spectra.synthetic import (synthetic_co2_cia, synthetic_co2_par,
                                                  synthetic_h2o_par, write_cia, write_par)
from clearsky_tpu_torch.utils import twin
from clearsky_tpu_torch.utils.quadrature import stream_nodes

torch.set_num_threads(2)

G, MU, CP, PS, PT = 9.8, 0.044, 850.0, 1e5, 10.0
CPU64 = dict(dtype=torch.float64, device="cpu")
CTHETA = math.cos(0.841)


def _t(x, dtype=torch.float64):
    return torch.tensor(np.asarray(x), dtype=dtype)


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


# --- the Faddeeva function's derivative -------------------------------------------

X = np.array([0.3, 2.0, 4.0, 7.0, 20.0, 300.0, 1e5, -3e4])
Y = np.array([0.2, 0.005, 0.05, 2.0, 8.0, 0.5, 1e-3, 3.0])


@pytest.mark.parametrize("wrt", ["x", "y"])
def test_wofz_jvp_matches_jax(wrt):
    """The JVP of w(x + iy) in every w4 region and the far wings (the
    asymptotic form where |x| + y >= 6), as JAX's custom JVP gives it, and
    against central differences (tests/test_lineshapes.py:162)."""
    t = (np.ones_like(X), np.zeros_like(Y)) if wrt == "x" else (np.zeros_like(X), np.ones_like(Y))
    (wr, wi), (dwr, dwi) = torch.func.jvp(wofz_re_im, (_t(X), _t(Y)), tuple(map(_t, t)))
    (jwr, jwi), (jdr, jdi) = jax.jvp(jwofz, (jnp.asarray(X), jnp.asarray(Y)),
                                      tuple(map(jnp.asarray, t)))
    np.testing.assert_allclose(wr.numpy(), np.asarray(jwr), rtol=1e-14)
    np.testing.assert_allclose(dwr.numpy(), np.asarray(jdr), rtol=1e-12)
    np.testing.assert_allclose(dwi.numpy(), np.asarray(jdi), rtol=1e-12)
    h = 1e-6
    core = np.abs(X) < 1e3
    dx, dy = (h, 0.0) if wrt == "x" else (0.0, h)
    up = wofz_re_im(_t(X + dx), _t(Y + dy))
    dn = wofz_re_im(_t(X - dx), _t(Y - dy))
    for d, a, b in ((dwr, up[0], dn[0]), (dwi, up[1], dn[1])):
        np.testing.assert_allclose(d.numpy()[core], ((a - b) / (2 * h)).numpy()[core],
                                   rtol=7e-3, atol=1e-9)


def test_wofz_float32_tangents_stay_finite():
    """At |x| = 1e7 the quotient rule on the w4 rationals overflows float32
    (region 1's denominator squared, ~|z|^8); the asymptotic rule does not."""
    x = torch.tensor([1e7, -1e7, 3e7, -4e6, 1e5], dtype=torch.float32)
    y = torch.tensor([1e-3, 0.5, 1e-3, 5.0, 0.3], dtype=torch.float32)
    _, (dwr, dwi) = torch.func.jvp(wofz_re_im, (x, y), (torch.ones_like(x), torch.ones_like(y)))
    assert bool(torch.isfinite(dwr).all() and torch.isfinite(dwi).all())
    xg, yg = x.clone().requires_grad_(), y.clone().requires_grad_()
    wofz_re_im(xg, yg)[0].sum().backward()
    assert bool(torch.isfinite(xg.grad).all() and torch.isfinite(yg.grad).all())


def test_wofz_backward_and_vmap_match_jax():
    """Reverse mode (JAX transposes its JVP) and a batched primal under
    vmap (the primal then runs once over the batch)."""
    x, y = _t(X).requires_grad_(), _t(Y).requires_grad_()
    wr, wi = wofz_re_im(x, y)
    (wr + 2.0 * wi).sum().backward()
    gj = jax.grad(lambda a, b: (lambda w: (w[0] + 2.0 * w[1]).sum())(jwofz(a, b)),
                  argnums=(0, 1))(jnp.asarray(X), jnp.asarray(Y))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gj[0]), rtol=1e-12)
    np.testing.assert_allclose(y.grad.numpy(), np.asarray(gj[1]), rtol=1e-12)
    xb = _t(np.stack([X, 0.5 * X, X + 1.0]))
    got = torch.func.vmap(lambda a: wofz_re_im(a, _t(Y))[0])(xb)
    np.testing.assert_array_equal(got.numpy(), wofz_re_im(xb, _t(Y))[0].numpy())
    J = torch.func.jacfwd(lambda a: wofz_re_im(a, _t(Y))[1])(_t(X))
    Jj = jax.jacfwd(lambda a: jwofz(a, jnp.asarray(Y))[1])(jnp.asarray(X))
    np.testing.assert_allclose(J.numpy(), np.asarray(Jj), rtol=1e-12, atol=0.0)


def test_planck_float32_jvp_stays_finite():
    """Counterpart of tests/test_foundation.py:165: the exponent folds C2,
    so no (kT)^2 intermediate underflows in float32."""
    nu = torch.linspace(1.0, 3000.0, 301, dtype=torch.float32)
    T = torch.tensor([150.0, 288.0, 400.0], dtype=torch.float32)
    _, dB = torch.func.jvp(lambda t: planck(nu[None, :], t[:, None]), (T,),
                           (torch.ones_like(T),))
    assert bool(torch.isfinite(dB).all()) and bool((dB[:, 10:] > 0).all())


# --- each kernel's Function through a plain stand-in launch -----------------------

class _StandIn:
    """A launch replaced by a plain CPU function, counting its calls."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **k):
        self.calls += 1
        return self.fn(*a, **k)


@pytest.fixture
def on_card(monkeypatch):
    """Every wrapper takes its kernel path for CPU tensors; the launches the
    test replaces run there."""
    monkeypatch.setattr(twin, "kernel_path", lambda x: True)

    def patch(module, name, fn):
        s = _StandIn(fn)
        monkeypatch.setattr(module, name, s)
        return s
    return patch


def _grad_and_jac(f, x, w):
    """(jacfwd of f at x, gradient of sum(w f) at x by backward)."""
    J = torch.func.jacfwd(f)(x)
    xg = x.clone().requires_grad_()
    (w * f(xg)).sum().backward()
    return J, xg.grad


def _column(L=6, N=96, seed=0):
    rng = np.random.default_rng(seed)
    tau = _t(rng.exponential(0.5, (L, N)))
    tau[0, :3] = torch.tensor([0.0, 1e-9, 1e-4], dtype=torch.float64)
    return tau, _t(0.5 + rng.random((L + 1, N))), _t(rng.random(N)), _t(0.5 * rng.random(N))


def test_olr_march_function_matches_its_twin(on_card):
    tau, B, _, _ = _column()
    m, W = stream_nodes(5)
    launch = on_card(march_cuda, "_olr_launch", _olr_march)
    L = tau.shape[0]
    v = _t(np.concatenate([np.linspace(-0.3, 0.3, L), np.linspace(0.0, 0.2, L + 1)]))

    def f(v):
        return march_cuda.olr_march(tau * torch.exp(v[:L, None]), B + v[L:, None], m, W)

    def f_plain(v):
        return _olr_march(tau * torch.exp(v[:L, None]), B + v[L:, None], m, W)

    w = torch.linspace(0.5, 1.5, tau.shape[1], dtype=torch.float64)
    J, g = _grad_and_jac(f, v, w)
    assert launch.calls == 2                      # one primal for jacfwd, one for backward
    Jp, gp = _grad_and_jac(f_plain, v, w)
    np.testing.assert_allclose(J.numpy(), Jp.numpy(), rtol=1e-11, atol=0.0)
    np.testing.assert_allclose(g.numpy(), gp.numpy(), rtol=1e-11, atol=0.0)


def test_monoflux_march_function_matches_its_twin(on_card):
    tau, B, S, a = _column(seed=1)
    m, W = stream_nodes(4)
    launch = on_card(march_cuda, "_monoflux_launch", _monoflux_march)
    L = tau.shape[0]
    v = _t(np.concatenate([np.linspace(-0.3, 0.3, L), [0.1, -0.2]]))

    def cols(v):
        return (tau * torch.exp(v[:L, None]), B, S * (1.0 + v[L]), a * (1.0 + v[L + 1]))

    def f(v):
        up, dn = march_cuda.monoflux_march(*cols(v), CTHETA, m, W)
        return torch.cat([up, 0.7 * dn])

    def f_plain(v):
        up, dn = _monoflux_march(*cols(v), CTHETA, m, W)
        return torch.cat([up, 0.7 * dn])

    w = torch.rand(2 * (L + 1), tau.shape[1], dtype=torch.float64,
                   generator=torch.Generator().manual_seed(2))
    J, g = _grad_and_jac(f, v, w)
    assert launch.calls == 2
    Jp, gp = _grad_and_jac(f_plain, v, w)
    np.testing.assert_allclose(J.numpy(), Jp.numpy(), rtol=1e-11, atol=0.0)
    np.testing.assert_allclose(g.numpy(), gp.numpy(), rtol=1e-11, atol=0.0)


@pytest.fixture(scope="module")
def routed():
    """A 120-line catalog on a 2,048-point grid where the stencil route
    applies (its plain version is not the exact sum: the Function's
    derivatives must still be the exact sum's)."""
    lines = ct.SpectralLines.from_par_dict(synthetic_co2_par(120, seed=3), **CPU64)
    pos = lines.positions64()
    nu = np.linspace(pos.min() - 25.0, pos.max() + 25.0, 2048)
    plan = build_line_window_plan(nu, pos, 25.0)
    return lines, plan


@pytest.mark.parametrize("strategy", ["stencil", "grouped", "nosplit"])
def test_routed_line_sum_function_matches_the_exact_sum(routed, on_card, strategy):
    """sigma_from_lines_auto on the kernel path: the primal is the route's
    (its plain version here), the derivatives are those of the exact plain
    sum, in T and in P, as JAX's _pallas_jvp_rule takes them."""
    lines, plan = routed
    assert ls.route(plan, lines, "voigt", strategy, 3) == strategy
    launch = on_card(linesum_cuda, "_routed_launch", linesum_cuda._routed_launch)
    P = _t([30.0, 3e3, 8e4])
    x = _t([190.0, 250.0, 300.0, 0.0, 0.0, 0.0])

    def f(x):
        Ps = P * torch.exp(x[3:])
        return sigma_from_lines_auto(plan, lines, x[:3], Ps, 0.95 * Ps, strategy=strategy)

    def f_exact(x):
        Ps = P * torch.exp(x[3:])
        return sigma_from_lines(plan, lines, x[:3], Ps, 0.95 * Ps)

    w = 1e21 * torch.rand(3, plan.n_nu, dtype=torch.float64,
                          generator=torch.Generator().manual_seed(4))
    J, g = _grad_and_jac(f, x, w)
    assert launch.calls == 2
    Jp, gp = _grad_and_jac(f_exact, x, w)
    np.testing.assert_allclose(J.numpy(), Jp.numpy(), rtol=1e-11, atol=0.0)
    np.testing.assert_allclose(g.numpy(), gp.numpy(), rtol=1e-11, atol=0.0)
    prim = f(x)
    assert launch.calls == 3
    if strategy == "stencil":
        np.testing.assert_array_equal(prim.numpy(), ls.sigma_stencil_plain(
            plan, lines, x[:3], P, 0.95 * P).numpy())


def test_routed_line_sum_carries_concentrations(routed, on_card):
    """MultiGas's per-line concentrations: a differentiable operand too."""
    lines, plan = routed
    on_card(linesum_cuda, "_routed_launch", linesum_cuda._routed_launch)
    T, P = _t([200.0, 280.0]), _t([1e3, 5e4])
    conc = _t(np.linspace(0.1, 1.0, lines.n_lines))

    def f(c):
        return sigma_from_lines_auto(plan, lines, T, P, None, conc=c)

    J = torch.func.jacfwd(lambda s: f(conc * (1.0 + s)).sum(-1))(_t(0.0))
    Jp = torch.func.jacfwd(lambda s: sigma_from_lines(plan, lines, T, P, P, conc=conc * (
        1.0 + s)).sum(-1))(_t(0.0))
    np.testing.assert_allclose(J.numpy(), Jp.numpy(), rtol=1e-11, atol=0.0)


@pytest.fixture(scope="module")
def split_gas():
    lines = ct.SpectralLines.from_par_dict(synthetic_co2_par(80, seed=9), **CPU64)
    pos = lines.positions64()
    nu = np.linspace(pos.min() - 25.0, pos.max() + 25.0, 400)
    dom = ct.AtmosphericDomain.create((150.0, 350.0), 8, (0.9 * PT, 1.01 * PS), 12)
    return ct.Gas.from_lines(lines, 0.95, nu, dom).split_precision(8)


@pytest.mark.parametrize("kernel", ["fused_olr", "fused_monoflux"])
def test_fused_functions_match_the_unfused_pipeline(split_gas, on_card, kernel):
    """K6/K7 on the kernel path: the column's temperatures reach the
    coefficients' basis (lead float64, tail bfloat16), the quadrature and
    the Planck rows; jacfwd and the gradient in the edge temperatures are
    those of the unfused plain pipeline."""
    plain = {"fused_olr": tft._fused_olr_plain, "fused_monoflux": tft._fused_monoflux_plain}
    launch = on_card(fused_table_cuda, f"_{kernel}_launch", plain[kernel])
    Pe = ct.pressuregrid(PT, PS, 7)
    P = _t(Pe)
    Te = _t(np.maximum(285.0 * (Pe / PS) ** (R_GAS / (MU * CP)), 170.0))
    S = torch.full_like(split_gas.nu, 1.0)

    def f(Te):
        fT = formprofile(P, Te)
        if kernel == "fused_olr":
            return tft.table_olr_fused(split_gas, P, G, fT, lambda T, P: MU)
        up, dn, tau = tft.table_monoflux_fused(split_gas, P, G, fT, lambda T, P: MU, S,
                                               0.1 * S, 0.841)
        return torch.cat([up, dn, tau])

    w = torch.rand(f(Te).shape, dtype=torch.float64, generator=torch.Generator().manual_seed(5))
    assert launch.calls == 1
    J, g = _grad_and_jac(f, Te, w)
    assert launch.calls == 3
    on_card(twin, "kernel_path", lambda x: False)
    Jp, gp = _grad_and_jac(f, Te, w)
    assert launch.calls == 3
    np.testing.assert_allclose(J.numpy(), Jp.numpy(), rtol=1e-11, atol=0.0)
    np.testing.assert_allclose(g.numpy(), gp.numpy(), rtol=1e-11, atol=0.0)


def test_kernels_refuse_tensors_that_carry_derivatives():
    """A derivative never reaches a raw pointer: a tensor that requires grad
    (in grad mode), a forward-mode dual and a torch.func-transformed tensor
    are refused before a launch; inside a Function's forward none is."""
    x = torch.ones(3, dtype=torch.float64)
    twin.refuse_derivatives("x", x)
    with pytest.raises(RuntimeError, match="requires grad"):
        twin.refuse_derivatives("x", x.clone().requires_grad_())
    with torch.no_grad():
        twin.refuse_derivatives("x", x.clone().requires_grad_())
    import torch.autograd.forward_ad as fwAD
    with fwAD.dual_level():
        with pytest.raises(RuntimeError, match="dual"):
            twin.refuse_derivatives("x", fwAD.make_dual(x, torch.ones_like(x)))
    with pytest.raises(RuntimeError, match="torch.func"):
        torch.func.vmap(lambda r: twin.refuse_derivatives("x", r))(torch.ones(2, 3))
    seen = []

    def kernel(a):
        twin.refuse_derivatives("a", a)
        seen.append(a.shape)
        return 2.0 * a

    f = lambda a: twin.with_twin(kernel, lambda b: 2.0 * b, a)
    torch.func.jacfwd(f)(x)
    torch.func.grad(lambda a: f(a).sum())(x)
    f(x.clone().requires_grad_()).sum().backward()
    assert seen == [(3,)] * 3


def test_with_twin_under_vmap_and_tuple_outputs():
    """A batched primal runs the kernel once per slice; an unbatched one
    (jacfwd's) once; tuple outputs keep their structure under both."""
    calls = []

    def kernel(a, b):
        calls.append(a.shape)
        return a * b, a + b

    f = lambda a, b: twin.with_twin(kernel, lambda a, b: (a * b, a + b), a, b)
    A, b = _t(np.arange(6.0).reshape(3, 2)), _t([1.5, -2.0])
    got = torch.func.vmap(f, in_dims=(0, None))(A, b)
    np.testing.assert_array_equal(got[0].numpy(), (A * b).numpy())
    np.testing.assert_array_equal(got[1].numpy(), (A + b).numpy())
    assert calls == [(2,)] * 3
    J = torch.func.jacfwd(lambda a: torch.cat(f(a, b)))(A[0])
    assert len(calls) == 4
    np.testing.assert_array_equal(J.numpy(), torch.cat([torch.diag(b), torch.eye(2)]).numpy())


# --- the RCM's Jacobian against the JAX package -----------------------------------

def _pair(jgas, tgas, nu, n_levels=8, Ts=285.0, extra=((), ())):
    """Both packages' RCM on the same column: a dry adiabat from Ts with a
    170 K floor on ``n_levels`` edges, radmul 2, sunlight and albedo 0.1."""
    Pe = jgrids.pressuregrid(PT, PS, n_levels)
    Te = np.maximum(Ts * (Pe / PS) ** (R_GAS / (MU * CP)), 170.0)
    span = float(nu[-1] - nu[0])
    fS = 340.0 / math.cos(0.841) / span
    jm = jr.RCM.create(Pe, Te, G, lambda T, P: MU, lambda v: jnp.full(jnp.shape(v), fS), 0.1,
                       lambda T, P: CP, 1e7, jgas, *extra[0], radmul=2)
    tm = ct.RCM.create(Pe, Te, G, lambda T, P: MU, lambda v: torch.full_like(v, fS), 0.1,
                       lambda T, P: CP, 1e7, tgas, *extra[1], radmul=2)
    return jm, tm


@pytest.fixture(scope="module")
def gray():
    nu = np.concatenate([jgrids.logrange(1e-6, 1e4, 59, 3), [1e5]])
    return _pair(JGrayGas.create(5e-27, nu), ct.GrayGas.create(5e-27, nu, **CPU64), nu)


@pytest.fixture(scope="module")
def direct():
    jl = JLines.from_par_dict(synthetic_co2_par(60, seed=12))
    pos = np.asarray(jl.nu)
    nu = np.linspace(pos.min() - 25.0, pos.max() + 25.0, 160)
    jg = JDirectGas.from_lines(jl, 0.95, nu)
    return _pair(jg, convert.direct_gas(jg, 0.95, **CPU64), nu)


@pytest.fixture(scope="module")
def mixture(tmp_path_factory):
    d = tmp_path_factory.mktemp("hitran")
    paths = [str(d / n) for n in ("co2.par", "h2o.par", "CO2-CO2.cia")]
    write_par(paths[0], synthetic_co2_par(80, seed=41))
    write_par(paths[1], synthetic_h2o_par(60, seed=42))
    write_cia(paths[2], synthetic_co2_cia(seed=43))
    kw = dict(numin=515.0, numax=675.0)       # H2O's rotation band meets CO2's bending band
    nu = np.linspace(540.0, 650.0, 140)
    fh2o = lambda T, P: 1e-3 * (T / 250.0) ** 2 * (P / 1e5) + 1e-6
    jm = JMultiGas.from_lines([(JLines.from_par(paths[0], **kw), 0.9),
                               (JLines.from_par(paths[1], **kw), fh2o)], nu)
    tm = ct.MultiGas.from_lines([(ct.SpectralLines.from_par(paths[0], **CPU64, **kw), 0.9),
                                 (ct.SpectralLines.from_par(paths[1], **CPU64, **kw), fh2o)], nu)
    extra = ((JCIATables.from_file(paths[2]),), (ct.CIATables.from_file(paths[2]),))
    return _pair(jm, tm, nu, extra=extra)


@pytest.fixture(scope="module")
def baked():
    jl = JLines.from_par_dict(synthetic_co2_par(60, seed=13))
    pos = np.asarray(jl.nu)
    nu = np.linspace(pos.min() - 25.0, pos.max() + 25.0, 150)
    jg = JGas.from_lines(jl, 0.95, nu, JDomain.create((150.0, 350.0), 8, (0.9 * PT, 1.01 * PS),
                                                      12))
    return _pair(jg, convert.gas(jg, 0.95, **CPU64), nu)


def _jacobians_match(pair, mode, update_sigma, eps=1.0):
    jm, tm = pair
    got = ct.jacobian(tm, mode=mode, eps=eps, update_sigma=update_sigma)
    want = np.asarray(jr.jacobian(jm, mode=mode, eps=eps, update_sigma=update_sigma))
    assert got.shape == want.shape == (tm.T.shape[0],) * 2
    assert bool(torch.isfinite(got).all())
    _close(got.numpy(), want, rtol=1e-8)
    return got


@pytest.mark.parametrize("mode", ["fwd", "fd"])
def test_gray_jacobian_matches_jax(gray, mode):
    J = _jacobians_match(gray, mode, False)
    assert bool((torch.diagonal(J) < 0).all())


@pytest.mark.parametrize("mode,update_sigma", [("fwd", False), ("fwd", True), ("fd", True)])
def test_direct_gas_jacobian_matches_jax(direct, mode, update_sigma):
    _jacobians_match(direct, mode, update_sigma)


@pytest.mark.parametrize("mode", ["fwd", "fd"])
def test_mixture_with_cia_jacobian_matches_jax(mixture, mode):
    _jacobians_match(mixture, mode, True)


@pytest.mark.parametrize("update_sigma", [False, True])
def test_baked_gas_jacobian_matches_jax(baked, update_sigma):
    _jacobians_match(baked, "fwd", update_sigma)


def test_jacobian_refuses_unknown_modes(gray):
    with pytest.raises(ValueError, match="mode"):
        ct.jacobian(gray[1], mode="rev")


def test_fwd_matches_finite_differences(gray, direct):
    """Forward mode against one-sided differences at eps 1e-3 K, at the bars
    of tests/test_rcm.py: the gray column (:102, rtol 2e-3) and the
    DirectGas through its refresh (:146; fd differentiates the w4
    approximation, fwd the true Voigt function, 5e-5 of max|J|)."""
    tm = gray[1]
    J, Jd = ct.jacobian(tm, "fwd"), ct.jacobian(tm, "fd", eps=1e-3)
    np.testing.assert_allclose(J.numpy(), Jd.numpy(), rtol=2e-3, atol=1e-11)
    tm = direct[1]
    J = ct.jacobian(tm, "fwd", update_sigma=True)
    Jd = ct.jacobian(tm, "fd", eps=1e-3, update_sigma=True)
    scale = float(Jd.abs().max())
    np.testing.assert_allclose(J.numpy(), Jd.numpy(), rtol=5e-3, atol=5e-5 * scale)
    assert bool((torch.diagonal(ct.jacobian(tm, "fwd")) < 0).all())


@pytest.mark.parametrize("superadiabatic", [False, True])
def test_lapse_derivative_matches_jax(superadiabatic):
    """The convective adjustment keeps T's graph (JAX's scan is
    differentiable): its forward-mode Jacobian equals JAX's jacfwd, and
    reverse mode gives its transpose."""
    P = np.geomspace(100.0, 1e5, 9)[::-1].copy()
    T = 285.0 * (P / 1e5) ** 0.1                 # stable: below the dry lapse rate
    if superadiabatic:
        T[2] -= 30.0                              # the third level is warmed
    J = torch.func.jacfwd(lambda t: ct.lapse(t, _t(P), CP, MU))(_t(T))
    Jj = jax.jacfwd(lambda t: ja.lapse(t, jnp.asarray(P), CP, MU))(jnp.asarray(T))
    np.testing.assert_allclose(J.numpy(), np.asarray(Jj), rtol=1e-12, atol=1e-15)
    Tg = _t(T).requires_grad_()
    w = _t(np.linspace(1.0, 2.0, 9))
    (w * ct.lapse(Tg, _t(P), CP, MU)).sum().backward()
    np.testing.assert_allclose(Tg.grad.numpy(), (w @ J).numpy(), rtol=1e-13)
    assert superadiabatic == bool((J - torch.eye(9, dtype=torch.float64)).abs().max() > 0)

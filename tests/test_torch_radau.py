"""The adaptive Radau core of the port against the JAX package.

The plain engine (``utils/radau.py``: ``radau_scalar``, ``radau_dense``)
against JAX's on the cases of tests/test_radau.py, in float64 on the CPU:
the same accepted steps on every lane (the stiff oscillatory lane of ~6,100
steps within 0.1%: its count moves by 2 in JAX alone under a 1e-14 relative
change of rtol, and the two packages' cos and pow differ in the last bit)
and y within 1e-10 of each case's peak. The flux core (``rt/radau.py``)
through the entry points with ``core=Radau``: ``optical_depth``,
``outgoing`` (vertical and 5 streams), ``monochromatic_fluxes`` and the RCM's
heating on a synthetic 60-line CO2 column, against JAX within 1e-8 of peak
(monochromatic_fluxes within its tol, 1e-7), with the JAX suite's own bars (Lobatto depth,
the scipy oracle, the refined discretized core, the boundary conventions,
the gray analytic OLR). The model API on the Radau core is in
tests/test_torch_radau_model.py. The column's
CO2 is at Earth's 4e-4: the plain engine's loop runs until the stiffest lane
ends, and at the JAX suite's 0.95 that lane takes ~9,000 steps at tol 1e-7.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from scipy.integrate import solve_ivp

import clearsky_tpu as jpkg
from clearsky_tpu.absorption.gas import DirectGas as JDirectGas
from clearsky_tpu.spectra.lines import SpectralLines as JLines
from clearsky_tpu.utils.radau import radau_scalar as j_scalar, radau_dense as j_dense
import clearsky_tpu_torch as ct
from clearsky_tpu_torch.absorption.absorbers import unify_absorbers
from clearsky_tpu_torch.constants import R_GAS
from clearsky_tpu_torch.rt import ode_ref, radau as trad, radau_cuda
from clearsky_tpu_torch.utils import profiling
from clearsky_tpu_torch.utils.radau import radau_scalar as t_scalar, radau_dense as t_dense

torch.set_num_threads(2)

G, MU, CP, PS, TS = 10.0, 0.01, 1e3, 1e5, 300.0
CO2 = 4e-4
CPU64 = dict(dtype=torch.float64, device="cpu")


def _t(x):
    return torch.tensor(np.asarray(x, np.float64))


def _of_peak(b, a) -> float:
    a = np.asarray(a, np.float64)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape
    return float(np.nanmax(np.abs(b - a)) / np.nanmax(np.abs(a)))


# --- the plain engine against JAX's ------------------------------------------------
# (f in each package, y0, x0, x1, args, keywords): tests/test_radau.py's cases
def _cases():
    k5 = [1e-2, 1.0, 10.0, 1e3, 1e6]
    return {
        "linear_decay": (lambda x, y, a: -a * y, lambda x, y, a: -a * y, np.ones(5), 0.0, 2.0,
                         k5, dict(rtol=1e-8, atol=1e-12)),
        "stiff_lane": (lambda x, y, a: jnp.cos(a * x) * a, lambda x, y, a: torch.cos(a * x) * a,
                       np.zeros(2), 0.0, 1.0, [0.1, 200.0], dict(rtol=1e-8, atol=1e-10)),
        "schwarzschild": (lambda x, y, a: a * (x - y), lambda x, y, a: a * (x - y), np.zeros(3),
                          0.0, 3.0, [0.1, 1.0, 1e4], dict(rtol=1e-9, atol=1e-12)),
        "nonlinear": (lambda x, y, a: y * y, lambda x, y, a: y * y, np.ones(1), 0.0, 0.5, None,
                      dict(rtol=1e-10, atol=1e-12)),
        "nonlinear_forced": (lambda x, y, a: jnp.sin(x) * y + jnp.cos(a * x),
                             lambda x, y, a: torch.sin(x) * y + torch.cos(a * x), np.ones(3),
                             0.0, 4.0, [0.5, 2.0, 5.0], dict(rtol=1e-9, atol=1e-12)),
        "backward": (lambda x, y, a: -y, lambda x, y, a: -y, np.ones(2), 1.0, 0.0, None,
                     dict(rtol=1e-9, atol=1e-12)),
        "per_lane_bounds": (lambda x, y, a: -y, lambda x, y, a: -y, np.ones(3), 0.0,
                            np.array([0.5, 1.0, 2.0]), None, dict(rtol=1e-9, atol=1e-12)),
        "zero_span": (lambda x, y, a: -y, lambda x, y, a: -y, np.array([3.0]), 1.0, 1.0, None,
                      {}),
        "nan_lane": (lambda x, y, a: -a * y, lambda x, y, a: -a * y, np.array([1.0, np.nan]),
                     0.0, 2.0, [1.0, 1.0], dict(rtol=1e-8, atol=1e-12)),
        "nan_rhs": (lambda x, y, a: jnp.where(a > 0, jnp.nan, -y),
                    lambda x, y, a: torch.where(a > 0, torch.nan, -y), np.ones(2), 0.0, 2.0,
                    [1.0, -1.0], dict(rtol=1e-8, atol=1e-12)),
    }


@pytest.mark.parametrize("case", list(_cases()))
def test_engine_matches_jax(case):
    fj, ft, y0, x0, x1, args, kw = _cases()[case]
    a = j_scalar(fj, jnp.asarray(y0), x0, jnp.asarray(x1) if np.ndim(x1) else x1,
                 args=None if args is None else jnp.asarray(args), **kw)
    b = t_scalar(ft, _t(y0), x0, _t(x1) if np.ndim(x1) else x1,
                 args=None if args is None else _t(args), **kw)
    np.testing.assert_array_equal(b.ok.numpy(), np.asarray(a.ok))
    np.testing.assert_array_equal(np.isnan(b.y.numpy()), np.isnan(np.asarray(a.y)))
    sa, sb = np.asarray(a.steps), b.steps.numpy()
    if case == "stiff_lane":
        assert sb[0] == sa[0] and abs(int(sb[1]) - int(sa[1])) <= 1e-3 * sa[1]
        assert sb[1] > 4 * sb[0]
    else:
        np.testing.assert_array_equal(sb, sa)
    if np.isfinite(np.asarray(a.y)).any():
        assert _of_peak(b.y, a.y) <= 1e-10


def test_engine_closed_forms():
    """The closed forms of tests/test_radau.py on the port's engine alone."""
    r = t_scalar(lambda x, y, a: -a * y, torch.ones(5, dtype=torch.float64), 0.0, 2.0,
                 args=_t([1e-2, 1.0, 10.0, 1e3, 1e6]), rtol=1e-8, atol=1e-12)
    assert bool(r.ok.all())
    np.testing.assert_allclose(r.y.numpy(), np.exp(-np.array([1e-2, 1.0, 10.0, 1e3, 1e6]) * 2),
                               rtol=1e-6, atol=1e-12)
    k = np.array([0.1, 1.0, 1e4])
    r = t_scalar(lambda x, y, a: a * (x - y), torch.zeros(3, dtype=torch.float64), 0.0, 3.0,
                 args=_t(k), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(r.y.numpy(), 3.0 - 1.0 / k + np.exp(-k * 3.0) / k, rtol=1e-7)
    assert int(r.steps[2]) < 500   # L-stability: the stiff lane skips its transient
    a = np.array([0.5, 2.0, 5.0])
    r = t_scalar(lambda x, y, a: torch.sin(x) * y + torch.cos(a * x),
                 torch.ones(3, dtype=torch.float64), 0.0, 4.0, args=_t(a), rtol=1e-9, atol=1e-12)
    for i, ai in enumerate(a):
        sol = solve_ivp(lambda t, y: np.sin(t) * y + np.cos(ai * t), (0.0, 4.0), [1.0],
                        method="Radau", rtol=1e-10, atol=1e-13)
        np.testing.assert_allclose(float(r.y[i]), sol.y[0, -1], rtol=1e-6)


def test_dense_matches_jax():
    xs = np.linspace(0.0, 3.0, 7)
    a = j_dense(lambda x, y, a: -2.0 * y, jnp.asarray([1.0, 4.0]), xs, rtol=1e-9, atol=1e-12)
    b, steps = t_dense(lambda x, y, a: -2.0 * y, _t([1.0, 4.0]), xs, rtol=1e-9, atol=1e-12,
                       with_steps=True)
    assert b.shape == (7, 2) and steps.shape == (2,)
    assert _of_peak(b, a) <= 1e-10
    np.testing.assert_allclose(b.numpy(), np.exp(-2.0 * xs)[:, None] * np.array([1.0, 4.0]),
                               rtol=1e-6)
    # a NaN lane stays NaN through the later segments without stalling them
    k = _t([1.0, 1.0])
    ys = t_dense(lambda x, y, a: -a * y, _t([1.0, np.nan]), np.linspace(0.0, 2.0, 5), args=k,
                 rtol=1e-8)
    yj = j_dense(lambda x, y, a: -a * y, jnp.asarray([1.0, np.nan]), jnp.linspace(0.0, 2.0, 5),
                 args=jnp.asarray([1.0, 1.0]), rtol=1e-8)
    assert np.all(np.isnan(ys.numpy()[1:, 1]))
    assert _of_peak(ys[:, 0], np.asarray(yj)[:, 0]) <= 1e-10


def test_engine_guards_and_max_steps():
    with pytest.raises(ValueError, match="newton_iters"):
        t_scalar(lambda x, y, a: -y, torch.ones(1), 0.0, 1.0, newton_iters=1)
    # a lane out of attempts is not ok; in dense output it is NaN from there on
    r = t_scalar(lambda x, y, a: torch.cos(a * x) * a, torch.zeros(2, dtype=torch.float64), 0.0,
                 1.0, args=_t([0.1, 200.0]), rtol=1e-8, atol=1e-10, max_steps=50)
    a = j_scalar(lambda x, y, a: jnp.cos(a * x) * a, jnp.zeros(2), 0.0, 1.0,
                 args=jnp.asarray([0.1, 200.0]), rtol=1e-8, atol=1e-10, max_steps=50)
    assert r.ok.tolist() == [True, False] == np.asarray(a.ok).tolist()
    ys = t_dense(lambda x, y, a: torch.cos(a * x) * a, torch.zeros(2, dtype=torch.float64),
                 np.linspace(0.0, 1.0, 3), args=_t([0.1, 200.0]), rtol=1e-8, atol=1e-10,
                 max_steps=50)
    assert np.isfinite(ys[:, 0].numpy()).all() and np.isnan(ys[1:, 1].numpy()).all()


def test_float32_engine_matches_jax():
    """float32 lanes (the card's dtype): the same steps and y within 1e-6 of peak."""
    k = [1e-2, 1.0, 10.0, 1e3]
    a = j_scalar(lambda x, y, a: -a * y, jnp.ones(4, jnp.float32), 0.0, 2.0,
                 args=jnp.asarray(k, jnp.float32), rtol=1e-5, atol=1e-9)
    b = t_scalar(lambda x, y, a: -a * y, torch.ones(4), 0.0, 2.0, args=torch.tensor(k),
                 rtol=1e-5, atol=1e-9)
    assert b.y.dtype == torch.float32
    np.testing.assert_array_equal(b.steps.numpy(), np.asarray(a.steps))
    assert _of_peak(b.y.double(), np.asarray(a.y, np.float64)) <= 1e-6


# --- the flux core through the entry points -----------------------------------------
@pytest.fixture(scope="module")
def co2():
    par = ct.synthetic_co2_par(60, seed=3)
    jl = JLines.from_par_dict(par)
    tl = ct.SpectralLines.from_par_dict(par, **CPU64)
    p64 = tl.positions64()
    nu = np.linspace(max(p64.min() - 25.0, 1.0), p64.max() + 25.0, 96)
    P = np.exp(np.linspace(np.log(10.0), np.log(1e5), 12))
    return dict(jg=JDirectGas.from_lines(jl, CO2, nu), tg=ct.DirectGas.from_lines(tl, CO2, nu),
                nu=nu, P=P, jl=jl, tl=tl)


def _fT(pkg):
    # linear in ln P: the cache's interpolation of T is exact
    if pkg == "jax":
        return lambda P: 190.0 + 12.0 * jnp.log(jnp.asarray(P) / 10.0)
    return lambda P: 190.0 + 12.0 * torch.log(P / 10.0)


def _fmu(T, P):
    return 0.044


@pytest.mark.parametrize("vertical", [True, False])
def test_radau_outgoing_matches_jax(co2, vertical):
    core_j, core_t = jpkg.Radau(tol=1e-7), ct.Radau(tol=1e-7)
    a = jpkg.outgoing(co2["P"], G, _fT("jax"), _fmu, co2["jg"], core=core_j, vertical=vertical)
    b = ct.outgoing(co2["P"], G, _fT("torch"), _fmu, co2["tg"], core=core_t, vertical=vertical)
    assert b.shape == (96,) and bool(torch.isfinite(b).all())
    assert _of_peak(b, a) <= 1e-8


def test_radau_optical_depth_matches_jax(co2):
    a = jpkg.optical_depth((1e5, 10.0), G, _fT("jax"), _fmu, 0.4, co2["jg"],
                           core=jpkg.Radau(tol=1e-8))
    b = ct.optical_depth((1e5, 10.0), G, _fT("torch"), _fmu, 0.4, co2["tg"],
                         core=ct.Radau(tol=1e-8))
    assert _of_peak(b, a) <= 1e-8
    # against the Lobatto quadrature on a gray column (the JAX suite's bar)
    nu = np.linspace(1.0, 100.0, 16)
    gas = ct.GrayGas.create(3e-26, nu, **CPU64)
    fT = lambda P: 250.0 + 20.0 * torch.log(P / 1e4)
    t_ad = ct.optical_depth((1e5, 10.0), G, fT, _fmu, 0.4, gas, core=ct.Radau(tol=1e-8))
    t_lo = ct.optical_depth((1e5, 10.0), G, fT, _fmu, 0.4, gas)
    np.testing.assert_allclose(t_ad.numpy(), t_lo.numpy(), rtol=1e-5)
    with pytest.raises(ValueError, match="core"):
        ct.optical_depth((1e5, 10.0), G, fT, _fmu, 0.4, gas, core=ct.Discretized())


def test_radau_monoflux_matches_jax(co2):
    core_j, core_t = jpkg.Radau(tol=1e-7), ct.Radau(tol=1e-7)
    a = jpkg.monochromatic_fluxes(co2["P"], G, _fT("jax"), _fmu, 5.0, 0.25, co2["jg"], core=core_j)
    b = ct.monochromatic_fluxes(co2["P"], G, _fT("torch"), _fmu, 5.0, 0.25, co2["tg"],
                                core=core_t)
    # 1e-7 (tol) of peak: M_down's downward leg differs by 1.9e-8 (a lane
    # whose accept decisions the two packages' last bits move)
    for x, y in zip(b, a):
        assert _of_peak(x, y) <= 1e-7
    M_up, M_down, tau = (x.numpy() for x in b)
    assert tau.shape == (11, 96) and np.all(tau >= 0)
    # the boundary conventions: the top's M_down is the beam, the surface's
    # M_up pi (reflection + Planck)
    c = np.cos(0.841)
    np.testing.assert_allclose(M_down[0], c * 5.0, rtol=1e-6)
    B_s = ct.planck(_t(co2["nu"]), _fT("torch")(_t(co2["P"][-1]))).numpy()
    np.testing.assert_allclose(M_up[-1], np.pi * (M_down[-1] * 0.25 / np.pi + B_s), rtol=1e-6)
    # the refined discretized core agrees (the JAX suite's 3e-3 of peak)
    d = ct.monochromatic_fluxes(co2["P"], G, _fT("torch"), _fmu, 5.0, 0.25, co2["tg"],
                                core=ct.RadauEq(refine=16, nlobatto=4))
    for x, y in zip(b[:2], d[:2]):
        assert _of_peak(x, y) <= 3e-3


def test_radau_monoflux_vs_scipy_oracle(co2):
    """The adaptive fluxes on an AcceleratedAbsorber's cache against the scipy
    oracle on the same cache (2e-5 of peak, the JAX suite's bar)."""
    P = co2["P"]
    T = _fT("torch")(_t(P))
    A = ct.AcceleratedAbsorber.create(T, _t(P), co2["tg"])
    M_up, M_down, _ = ct.monochromatic_fluxes(P, G, _fT("torch"), _fmu, 0.0, 0.0, A,
                                              core=ct.Radau(tol=1e-7))
    Mu_ref, Md_ref = ode_ref.ode_monoflux(P, G, _fT("torch"), _fmu, A, S_nu=np.zeros(96),
                                          albedo_nu=0.0, rtol=1e-9, atol=1e-12,
                                          sigma_of_P=ode_ref._np_sigma_accel(A))
    scale = np.abs(Mu_ref).max()
    np.testing.assert_allclose(M_up.numpy(), Mu_ref, atol=2e-5 * scale)
    np.testing.assert_allclose(M_down.numpy(), Md_ref, atol=2e-5 * scale)


@pytest.mark.parametrize("sigma", [1e-26])
def test_radau_gray_olr_vs_analytic(sigma):
    from conftest import gray_analytic_olr

    nu = np.concatenate([ct.logrange(1e-6, 1e5, 3000, 4), [1e6]])
    fT = lambda P: TS * (P / PS) ** (R_GAS / (MU * CP))
    gas = ct.GrayGas.create(sigma, nu, **CPU64)
    olr_nu = ct.outgoing(PS, G, fT, lambda T, P: MU, gas, Ptop=1e-6, nlevels=128, vertical=True,
                         core=ct.Radau(tol=1e-6))
    olr = float(ct.trapz(gas.nu, olr_nu))
    ref = gray_analytic_olr(sigma, G, MU, CP, PS, TS)
    assert abs(olr - ref) / ref < 0.01


# --- the wrapper's CPU path ----------------------------------------------------------
def test_radau_leg_takes_the_plain_engine_on_the_cpu(co2):
    """On CPU tensors the wrapper runs the plain engine and launches nothing."""
    cache = trad.build_column_cache(co2["P"], _fT("torch"), _fmu,
                                    unify_absorbers((co2["tg"],)))
    before = profiling.counts("launch.radau.")
    olr = trad.radau_outgoing(cache, co2["P"][-1], co2["P"][0], G, tol=1e-5)
    assert profiling.counts("launch.radau.") == before
    assert olr.shape == (96,) and bool(torch.isfinite(olr).all())
    c, nodes = radau_cuda.method_constants(1e-5, G)
    assert c.dtype == np.float32 and c.shape == (36,) and nodes.dtype == np.float64
    assert nodes[2] == 1.0   # the last node: an accepted step reuses its stage


def test_radau_kernel_constants_are_the_plain_engines():
    """What the wrapper hands the kernel beyond the method's 29 numbers are
    the plain engine's float32 values: the nodes C (the stage abscissae's
    offsets), 1 / mu_r, the controller's safety 0.9 (2 ni + 1) / (2 ni +
    nit) at nit = 1 and 2 as radau_scalar divides it (0.9 and 0.75 at the
    flux core's two Newton iterations), and max(err, 1e-12)^(-1/4) at an
    error under the floor (1000)."""
    from clearsky_tpu_torch.utils import radau as eng

    c, _ = radau_cuda.method_constants(1e-5, G)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    assert np.array_equal(c[29:32], eng._C.astype(np.float32))
    assert c[32] == float(1.0 / f32(eng._MU_REAL))
    ni = trad.NEWTON_ITERS
    for k, nit in enumerate((1, 2)):
        assert c[33 + k] == float(eng._rdiv(0.9 * (2.0 * ni + 1.0), 2.0 * ni + f32(nit)))
    assert (c[33], c[34]) == (np.float32(0.9), np.float32(0.75))
    assert c[35] == float(torch.clamp(f32(1e-20), min=1e-12) ** -0.25) == 1000.0


def test_chip_smoke_band_integrals_are_the_fluxes(co2, monkeypatch):
    """chip_smoke's band integral of a Radau launch (its float64 check of the
    dense legs and the OLR) is the trapezoid integral of the flux the call
    builds from that leg: outgoing's OLR, radiate's M_down (no beam) per
    level, and the depth of optical_depth."""
    import chip_smoke as cs

    seen = []
    orig = radau_cuda.radau_leg

    def record(rhs, lnP, Tg, mug, lnsig, nu, m, g, atol, y0, xs, *, rtol, max_steps, dense):
        y = orig(rhs, lnP, Tg, mug, lnsig, nu, m, g, atol, y0, xs, rtol=rtol,
                 max_steps=max_steps, dense=dense)
        seen.append(((rhs, lnP, Tg, mug, lnsig, nu, m, g, atol, y0, xs, rtol, max_steps, dense), y))
        return y

    monkeypatch.setattr(radau_cuda, "radau_leg", record)
    nu = _t(co2["nu"])
    core = ct.Radau(tol=1e-5)
    olr = ct.outgoing(co2["P"], G, _fT("torch"), _fmu, co2["tg"], core=core)
    tau = ct.optical_depth(co2["P"], G, _fT("torch"), _fmu, 0.4, co2["tg"], core=core)
    F = ct.monochromatic_fluxes(co2["P"], G, _fT("torch"), _fmu, 0.0, 0.25, co2["tg"], core=core)
    assert [a[0] for a, _ in seen] == ["emission", "depth", "emission", "depth", "emission"]
    trap = lambda v: torch.trapz(v, nu, dim=-1)
    (a_olr, y_olr), (a_tau, y_tau), (a_dn, y_dn) = seen[0], seen[1], seen[2]
    b = cs._band(y_olr, a_olr, 1)
    assert b.shape == (1, 1)
    np.testing.assert_allclose(float(b[0, 0]), float(trap(olr)), rtol=1e-12)
    b = cs._band(y_dn, a_dn, 1)
    assert b.shape == (12, 1)
    np.testing.assert_allclose(b[:, 0].numpy(), trap(F[1]).numpy(), rtol=1e-12, atol=1e-300)
    b = cs._band(y_tau, a_tau, 1)
    assert b.shape == (1, 1)
    np.testing.assert_allclose(float(b[0, 0]), float(trap(tau)), rtol=1e-12)

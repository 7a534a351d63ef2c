"""The validation oracle: adaptive per-wavenumber Schwarzschild integration.

Counterpart of ``clearsky_tpu.rt.ode_ref``: scipy's Radau integrator on the
same Schwarzschild problem as the discretized core, on the host in float64
numpy, per stream, in sqrt-P coordinates. The tests use it to show that the
port's discretized core converges to the adaptive solution as the grid
refines. Not a production path: slow, host-only.

It takes the port's absorbers: each evaluates where it lives, in its dtype,
and the cross-sections come back as float64 numpy (a validation run passes
absorbers in float64 on the CPU). Profile callables fT(P), fmu(T, P) and a
model's fcp are called on float64 CPU tensors, as the port's entry points
call them.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.integrate import solve_ivp
from scipy.sparse import diags as _spdiags

from ..constants import N_AVOGADRO, C2_RADIATION, H_PLANCK, C_LIGHT
from ..utils.quadrature import stream_nodes


def _np_planck(nu, T):
    """numpy twin of :func:`..ops.planck.planck` (the same underflow-safe
    form): the scipy right-hand sides run thousands of times an integration."""
    nu_m = 100.0 * nu
    x = C2_RADIATION * nu / T
    p = 2.0 * H_PLANCK * C_LIGHT**2 * nu_m**3
    em = np.exp(-x)
    return 100.0 * p * em / (-np.expm1(-x))

__all__ = [
    "ode_outgoing",
    "ode_optical_depth",
    "ode_monoflux",
    "ode_heating",
    "ode_run",
    "make_oracle_pool",
]


def _t64(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _host(x) -> np.ndarray:
    return x.detach().cpu().double().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, dtype=np.float64)


def _scalar(fn, *args) -> float:
    """A profile callable's value at scalar arguments, as a float."""
    return float(_host(fn(*(_t64(a) for a in args))))


def _sigma_at(A, T, P):
    """Dense sigma row [n_nu] (float64 numpy) from an absorber stack at scalar (T, P)."""
    t = lambda x: torch.as_tensor(float(x), dtype=A.nu.dtype, device=A.nu.device)
    return _host(A.sigma(t(T), t(P)))


def _np_interp_extrap(x, xp, fp):
    """numpy linear interpolation with edge-cell extrapolation — the semantics
    of ``utils.interp.interp_linear`` (np.interp clamps, which would bias the
    TOA cell where the refined grid reaches above the top cell center)."""
    x = np.asarray(x)
    i = np.clip(np.searchsorted(xp, x, side="right") - 1, 0, len(xp) - 2)
    t = (x - xp[i]) / (xp[i + 1] - xp[i])
    return fp[i] + t * (fp[i + 1] - fp[i])


def _np_sigma_accel(A):
    """Pure-numpy sigma(P) evaluator for an AcceleratedAbsorber.

    Reproduces ``AcceleratedAbsorber.sigma`` (linear in lnP on cached log
    cross-sections, edge-cell extrapolation) in numpy, so the scipy
    right-hand sides run at numpy speed.
    """
    lnP = _host(A.lnP)
    ln_sigma = _host(A.ln_sigma)  # [np_col, n_nu]
    n = len(lnP)

    def sigma(P):
        x = np.log(P)
        i = int(np.clip(np.searchsorted(lnP, x, side="right") - 1, 0, n - 2))
        t = (x - lnP[i]) / (lnP[i + 1] - lnP[i])
        return np.exp(ln_sigma[i] + t * (ln_sigma[i + 1] - ln_sigma[i]))

    return sigma


def ode_outgoing(
    Ps: float,
    g: float,
    fT,
    fmu,
    A,
    Ptop: float = 1.0,
    nstream: int = 5,
    rtol: float = 1e-8,
    atol: float = 1e-10,
    vertical: bool = False,
):
    """OLR spectrum [n_nu] by adaptive integration of dI/d(omega) per stream.

    The problem of ``outgoing``: upward Schwarzschild integration from the
    surface's Planck emission in omega = -sqrt(P) coordinates.
    """
    nu = _host(A.nu)
    if vertical:
        m, W = np.array([1.0]), np.array([np.pi])
    else:
        m, W = stream_nodes(nstream)
    Ts = _scalar(fT, Ps)
    B_surf = _np_planck(nu, Ts)
    w1, w2 = -np.sqrt(Ps), -np.sqrt(Ptop)

    def rhs_factory(mk):
        def rhs(w, I):
            P = w * w
            T = _scalar(fT, P)
            mu = _scalar(fmu, T, P)
            sig = _sigma_at(A, T, P)
            dtau_dP = 1e-4 * sig * N_AVOGADRO / (mu * g)
            B = _np_planck(nu, T)
            # dI/domega = dI/dP * dP/domega; dP/domega = 2w (negative upward)
            return mk * dtau_dP * (2.0 * w) * (I - B)

        def jac(w, I):
            # the RHS is diagonal in I (per-wavenumber independence); the
            # analytic sparse Jacobian keeps scipy Radau O(n_nu) instead of
            # O(n_nu^2) FD evaluations + dense LU at production sizes
            P = w * w
            T = _scalar(fT, P)
            mu = _scalar(fmu, T, P)
            sig = _sigma_at(A, T, P)
            dtau_dP = 1e-4 * sig * N_AVOGADRO / (mu * g)
            return _spdiags(mk * dtau_dP * (2.0 * w))

        return rhs, jac

    out = np.zeros_like(nu, dtype=np.float64)
    for k in range(len(m)):
        rhs_k, jac_k = rhs_factory(float(m[k]))
        sol = solve_ivp(
            rhs_k,
            (w1, w2),
            B_surf.astype(np.float64),
            method="Radau",
            rtol=rtol,
            atol=atol,
            jac=jac_k,
        )
        if not sol.success:
            raise RuntimeError(f"reference ODE integration failed: {sol.message}")
        out += W[k] * sol.y[:, -1]
    return out


def ode_monoflux(
    P_grid,
    g,
    fT,
    fmu,
    A,
    S_nu=None,
    albedo_nu=0.0,
    theta_s: float = 0.841,
    nstream: int = 5,
    rtol: float = 1e-8,
    atol: float = 1e-10,
    sigma_of_P=None,
):
    """Monochromatic up/down fluxes [n_levels, n_nu] by adaptive integration.

    The validation counterpart of ``rt.discretized.monoflux``: per-stream Schwarzschild ODEs integrated adaptively in sqrt-P coordinates
    with dense output at ``P_grid`` — downward atmospheric emission, direct
    stellar beam attenuated by exp(-tau/cos theta_s), Lambertian surface
    reflection + surface Planck, upward streams.

    ``sigma_of_P`` optionally supplies a numpy sigma(P) -> [n_nu] evaluator
    (e.g. :func:`_np_sigma_accel` for cached absorbers); otherwise the stack
    is evaluated at every right-hand side (slow).
    """
    nu = _host(A.nu)
    n_nu = len(nu)
    P_grid = np.asarray(P_grid, dtype=np.float64)
    m, W = stream_nodes(nstream)
    sig = sigma_of_P if sigma_of_P is not None else (
        lambda P: _sigma_at(A, _scalar(fT, P), P))

    def beta_of(P):
        T = _scalar(fT, P)
        mu = _scalar(fmu, T, P)
        return 1e-4 * sig(P) * N_AVOGADRO / (mu * g), T

    # --- downward streams in iota = +sqrt(P), integrated top -> surface ---
    iota = np.sqrt(P_grid)
    w_top, w_surf = iota[0], iota[-1]

    def rhs_down_factory(mk):
        def rhs(w, I):
            P = w * w
            beta, T = beta_of(P)
            B = _np_planck(nu, T)
            return mk * beta * (2.0 * w) * (B - I)

        def jac(w, I):
            beta, _ = beta_of(w * w)
            return _spdiags(-mk * beta * (2.0 * w))

        return rhs, jac

    M_down = np.zeros((len(P_grid), n_nu))
    for k in range(len(m)):
        rhs_k, jac_k = rhs_down_factory(float(m[k]))
        sol = solve_ivp(
            rhs_k,
            (w_top, w_surf),
            np.zeros(n_nu),
            method="Radau",
            t_eval=iota,
            rtol=rtol,
            atol=atol,
            jac=jac_k,
        )
        if not sol.success:  # pragma: no cover - diagnostics
            raise RuntimeError(f"down-stream integration failed: {sol.message}")
        M_down += W[k] * sol.y.T

    # --- direct stellar beam: tau(P) by adaptive integration, then exp decay ---
    if S_nu is not None and np.any(np.asarray(S_nu) != 0.0):
        c = np.cos(theta_s)

        def rhs_tau(w, tau):
            P = w * w
            beta, _ = beta_of(P)
            return beta * (2.0 * w)

        sol = solve_ivp(
            rhs_tau, (w_top, w_surf), np.zeros(n_nu),
            method="Radau", t_eval=iota, rtol=rtol, atol=atol,
            jac=lambda w, tau: _spdiags(np.zeros(n_nu)),
        )
        if not sol.success:  # pragma: no cover
            raise RuntimeError(f"beam tau integration failed: {sol.message}")
        M_down += (c * np.asarray(S_nu))[None, :] * np.exp(-sol.y.T / c)

    # --- upward streams in omega = -sqrt(P), from the Lambertian surface ---
    Ts = _scalar(fT, P_grid[-1])
    B_surf = _np_planck(nu, Ts)
    I_surf = M_down[-1] * np.asarray(albedo_nu) / np.pi + B_surf
    omega = -np.sqrt(P_grid)[::-1]  # ascending: -sqrt(Ps) ... -sqrt(Ptop)

    def rhs_up_factory(mk):
        def rhs(w, I):
            P = w * w
            beta, T = beta_of(P)
            B = _np_planck(nu, T)
            return mk * beta * (2.0 * w) * (I - B)

        def jac(w, I):
            beta, _ = beta_of(w * w)
            return _spdiags(mk * beta * (2.0 * w))

        return rhs, jac

    M_up = np.zeros((len(P_grid), n_nu))
    for k in range(len(m)):
        rhs_k, jac_k = rhs_up_factory(float(m[k]))
        sol = solve_ivp(
            rhs_k,
            (omega[0], omega[-1]),
            I_surf.copy(),
            method="Radau",
            t_eval=omega,
            rtol=rtol,
            atol=atol,
            jac=jac_k,
        )
        if not sol.success:  # pragma: no cover
            raise RuntimeError(f"up-stream integration failed: {sol.message}")
        M_up += W[k] * sol.y.T[::-1]
    # the surface level emits pi*I_surf (hemispherically integrated), matching
    # the production march's boundary value
    M_up[-1] = np.pi * I_surf
    return M_up, M_down



# --------------------------------------------------------------------------
# Pooled oracle: the 2*nstream+1 stream legs of one monoflux solve are
# independent adaptive integrations, parallelized over OS processes. Workers
# are spawned (a fork inherits the parent's thread pools in whatever state
# they are), so every leg spec is a tuple of plain numpy arrays/floats and
# the worker rebuilds its interpolants from them. Profiles are therefore array-based: T, mu and
# ln(sigma) linear in lnP on the caller's grids (exact for the constant-mu
# RCE configurations the oracle drives; the serial path keeps arbitrary
# callables).

def _oracle_leg(spec):
    """One adaptive stream-leg integration from an array-only spec."""
    (kind, mk, nu, P_grid, lnP_sig, ln_sigma, lnP_T, T_vals,
     lnP_mu, mu_vals, g, rtol, atol, y0) = spec
    nsig = len(lnP_sig)

    def sig(P):
        x = np.log(P)
        i = int(np.clip(np.searchsorted(lnP_sig, x, side="right") - 1, 0, nsig - 2))
        t = (x - lnP_sig[i]) / (lnP_sig[i + 1] - lnP_sig[i])
        return np.exp(ln_sigma[i] + t * (ln_sigma[i + 1] - ln_sigma[i]))

    def beta_of(P):
        T = float(_np_interp_extrap(np.log(P), lnP_T, T_vals))
        mu = float(_np_interp_extrap(np.log(P), lnP_mu, mu_vals))
        return 1e-4 * sig(P) * N_AVOGADRO / (mu * g), T

    iota = np.sqrt(P_grid)
    if kind == "down":
        def rhs(w, I):
            beta, T = beta_of(w * w)
            return mk * beta * (2.0 * w) * (_np_planck(nu, T) - I)

        def jac(w, I):
            beta, _ = beta_of(w * w)
            return _spdiags(-mk * beta * (2.0 * w))

        sol = solve_ivp(rhs, (iota[0], iota[-1]), np.zeros(len(nu)),
                        method="Radau", t_eval=iota, rtol=rtol, atol=atol,
                        jac=jac)
    elif kind == "tau":
        def rhs(w, tau):
            beta, _ = beta_of(w * w)
            return beta * (2.0 * w)

        sol = solve_ivp(rhs, (iota[0], iota[-1]), np.zeros(len(nu)),
                        method="Radau", t_eval=iota, rtol=rtol, atol=atol,
                        jac=lambda w, tau: _spdiags(np.zeros(len(nu))))
    elif kind == "up":
        omega = -iota[::-1]

        def rhs(w, I):
            beta, T = beta_of(w * w)
            return mk * beta * (2.0 * w) * (I - _np_planck(nu, T))

        def jac(w, I):
            beta, _ = beta_of(w * w)
            return _spdiags(mk * beta * (2.0 * w))

        sol = solve_ivp(rhs, (omega[0], omega[-1]), y0.copy(),
                        method="Radau", t_eval=omega, rtol=rtol, atol=atol,
                        jac=jac)
    else:  # pragma: no cover - defensive
        raise ValueError(kind)
    if not sol.success:  # pragma: no cover - diagnostics
        raise RuntimeError(f"{kind} leg failed: {sol.message}")
    return sol.y.T


def make_oracle_pool(processes: int):
    """Spawned worker pool for :func:`ode_heating`'s ``pool=`` argument.

    Create once and reuse across steps (spawned workers import the package,
    which costs seconds); close() when done.
    """
    import multiprocessing as mp

    return mp.get_context("spawn").Pool(processes)


def _pooled_monoflux(Pr, g, nu, specs_common, S_nu, albedo_nu, theta_s,
                     nstream, rtol, atol, pool):
    m, W = stream_nodes(nstream)
    mk_list = [float(x) for x in m]
    down_specs = [("down", mk) + specs_common + (rtol, atol, None)
                  for mk in mk_list]
    need_beam = S_nu is not None and np.any(np.asarray(S_nu) != 0.0)
    if need_beam:
        down_specs.append(("tau", 1.0) + specs_common + (rtol, atol, None))
    res = pool.map(_oracle_leg, down_specs)
    M_down = np.zeros((len(Pr), len(nu)))
    for k in range(len(mk_list)):
        M_down += W[k] * res[k]
    if need_beam:
        c = np.cos(theta_s)
        M_down += (c * np.asarray(S_nu))[None, :] * np.exp(-res[-1] / c)
    # Lambertian surface + Planck, then the upward legs
    (_nu, _Pr, _lnP_sig, _ln_sigma, lnP_T, T_vals, *_rest) = specs_common
    Ts = float(_np_interp_extrap(np.log(Pr[-1]), lnP_T, T_vals))
    B_surf = _np_planck(nu, Ts)
    I_surf = M_down[-1] * np.asarray(albedo_nu) / np.pi + B_surf
    up_specs = [("up", mk) + specs_common + (rtol, atol, I_surf)
                for mk in mk_list]
    res_up = pool.map(_oracle_leg, up_specs)
    M_up = np.zeros_like(M_down)
    for k in range(len(mk_list)):
        M_up += W[k] * res_up[k][::-1]
    M_up[-1] = np.pi * I_surf
    return M_up, M_down


def ode_heating(rcm, T=None, A=None, pool=None, nstream: int = 5,
                rtol: float = 1e-8, atol: float = 1e-10, **kwargs):
    """Heating rates H [np] for an RCM state via the adaptive flux oracle.

    Mirrors ``models.rcm.heating`` with the scipy fluxes of
    :func:`ode_monoflux` in place of the discretized core: radiate on the
    refined grid, interpolate the net flux to the edges with the sign flip,
    convert the flux divergence to heating.
    """
    T = _host(rcm.T if T is None else T)
    A = rcm.A if A is None else A
    nu = _host(rcm.nu)
    lnP = np.log(_host(rcm.P))

    def fT(P):
        return torch.as_tensor(_np_interp_extrap(np.log(_host(P)), lnP, T))

    Pr = _host(rcm.Pr)
    if pool is not None:
        # array-based leg specs (see the pooled-oracle note above); mu is
        # evaluated on the sigma cache's own pressure grid
        lnP_sig = _host(A.lnP)
        ln_sigma = _host(A.ln_sigma)
        Pg = np.exp(lnP_sig)
        Tg = _np_interp_extrap(lnP_sig, lnP, T)
        mu_vals = np.broadcast_to(_host(rcm.fmu(_t64(Tg), _t64(Pg))),
                                  Pg.shape).astype(np.float64)
        specs_common = (nu, Pr, lnP_sig, ln_sigma, lnP, T, lnP_sig, mu_vals,
                        rcm.g)
        M_up, M_down = _pooled_monoflux(
            Pr, rcm.g, nu, specs_common, _host(rcm.S_nu),
            _host(rcm.a_nu), rcm.theta_s, nstream, rtol, atol, pool,
        )
    else:
        M_up, M_down = ode_monoflux(
            Pr, rcm.g, fT, rcm.fmu, A,
            S_nu=_host(rcm.S_nu), albedo_nu=_host(rcm.a_nu),
            theta_s=rcm.theta_s, sigma_of_P=_np_sigma_accel(A),
            nstream=nstream, rtol=rtol, atol=atol, **kwargs,
        )
    F_net = np.trapezoid(M_up - M_down, nu, axis=-1)
    Pe = _host(rcm.Pe)
    R = -_np_interp_extrap(np.log(Pe), np.log(Pr), F_net)
    cp = np.broadcast_to(_host(rcm.fcp(_t64(T[:-1]), _t64(_host(rcm.P)[:-1]))), T[:-1].shape)
    dP = Pe[1:] - Pe[:-1]
    H_cells = (rcm.g / cp) * (R[:-1] - R[1:]) / dP
    return np.concatenate([H_cells, [R[-1] / rcm.cs]])


def ode_run(rcm, dt, nsteps: int, update_every: int = 0,
            adjust_every: int = 0, cp: float | None = None,
            mu: float | None = None, processes: int = 0, **kwargs):
    """RCE trajectory by explicit Euler on the adaptive-flux heating oracle.

    An independent adaptive integrator drives the same composed loop as
    ``models.rcm.run``: a step, the convective adjustment every
    ``adjust_every`` steps, then the cached cross-sections refreshed every
    ``update_every`` steps; ``processes`` > 0 integrates a step's stream legs
    in a spawned pool of that many processes. Returns the temperature
    trajectory [nsteps, np] (float64 numpy).
    """
    if adjust_every and (cp is None or mu is None):
        raise ValueError("convective adjustment requires scalar cp and mu")
    T = _host(rcm.T)
    A = rcm.A
    lnPe = np.log(_host(rcm.Pe))
    lnP = np.log(_host(rcm.P))
    traj = np.zeros((nsteps, len(T)))
    pool = make_oracle_pool(processes) if processes else None
    try:
        return _ode_run_loop(rcm, dt, nsteps, update_every, adjust_every,
                             cp, mu, T, A, lnPe, lnP, traj, pool, kwargs)
    finally:
        if pool is not None:
            pool.close()


def _ode_run_loop(rcm, dt, nsteps, update_every, adjust_every, cp, mu,
                  T, A, lnPe, lnP, traj, pool, kwargs):
    if adjust_every:
        from ..atmosphere.adiabats import lapse
    for i in range(nsteps):
        H = ode_heating(rcm, T, A, pool=pool, **kwargs)
        T = T + dt * H
        if adjust_every and (i + 1) % adjust_every == 0:
            # the same adjustment operator as the production loop (the
            # oracle's independence is in the flux solve, not the adjustment)
            T = _host(lapse(_t64(T), _t64(_host(rcm.P)), cp, mu))
        if update_every and (i + 1) % update_every == 0:
            Te = _np_interp_extrap(lnPe, lnP, T)
            A = A.update(torch.as_tensor(Te, dtype=A.nu.dtype, device=A.nu.device))
        traj[i] = T
    return traj


def ode_optical_depth(
    P1: float,
    P2: float,
    g: float,
    fT,
    fmu,
    A,
    theta: float = 0.0,
    rtol: float = 1e-9,
    atol: float = 1e-12,
):
    """Slant-path optical depth [n_nu] by adaptive integration."""
    nu = _host(A.nu)
    hi, lo = max(P1, P2), min(P1, P2)
    w1, w2 = -np.sqrt(hi), -np.sqrt(lo)
    msec = 1.0 / np.cos(theta)

    def rhs(w, tau):
        P = w * w
        T = _scalar(fT, P)
        mu = _scalar(fmu, T, P)
        sig = _sigma_at(A, T, P)
        return -msec * 1e-4 * sig * N_AVOGADRO / (mu * g) * (2.0 * w)

    sol = solve_ivp(
        rhs, (w1, w2), np.zeros_like(nu, dtype=np.float64),
        method="Radau", rtol=rtol, atol=atol,
    )
    if not sol.success:
        raise RuntimeError(f"reference ODE integration failed: {sol.message}")
    return sol.y[:, -1]

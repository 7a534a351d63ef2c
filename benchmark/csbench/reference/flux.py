"""Plain column radiative transfer at chosen wavenumbers.

Three cores on one column, each a straightforward implementation of the
flux pack ``radiate`` returns (the monochromatic fluxes M_up, M_down
[levels, points] from a line table, a temperature profile on the levels, a
constant molar mass, a stellar spectrum and a surface albedo):

* :func:`refined_fluxes`: the grid-refined discretized core (``RadauEq``):
  every caller layer split into ``refine`` sub-layers spaced in sqrt P,
  layer optical depths by Gauss-Lobatto quadrature of the cross-sections,
  hemispheric streams marched with an emission linear in optical depth, a
  direct beam and a Lambertian surface; fluxes at the caller's levels.
* :func:`radau_fluxes`: the adaptive core's problem (``Radau``): ln sigma,
  T and mu on a column cache of 256 levels spaced in sqrt P, linear in ln P
  between them; the Schwarzschild and depth equations in x = +-sqrt(P)
  solved on every (stream, wavenumber) lane, here by the Radau IIA(5)
  collocation on fixed sub-steps (``n_sub`` to each cache interval, exact
  stage solves), far finer than the tolerance the program works to.
* :func:`radau_steps`: the accepted steps an error-controlled Radau IIA(5)
  integration of those lanes needs at the program's tolerance (the work
  count of the roofline), segment by segment from the reference's own
  values at the levels.

Everything runs in ``dtype`` (float64 for the reference, bfloat16 for the
control) on ``device``; pressures and positions are formed in float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .linesum import C2, C_LIGHT, H_PLANCK

__all__ = ["N_AVOGADRO", "planck", "stream_nodes", "lobatto", "interp", "march",
           "refined_levels", "refined_fluxes", "radau_cache", "radau_fluxes", "radau_steps",
           "RADAU_C", "RADAU_A"]

N_AVOGADRO = 6.02214076e23
_S6 = math.sqrt(6.0)
RADAU_C = np.array([(4.0 - _S6) / 10.0, (4.0 + _S6) / 10.0, 1.0])
RADAU_A = np.array([
    [(88.0 - 7.0 * _S6) / 360.0, (296.0 - 169.0 * _S6) / 1800.0, (-2.0 + 3.0 * _S6) / 225.0],
    [(296.0 + 169.0 * _S6) / 1800.0, (88.0 + 7.0 * _S6) / 360.0, (-2.0 - 3.0 * _S6) / 225.0],
    [(16.0 - _S6) / 36.0, (16.0 + _S6) / 36.0, 1.0 / 9.0],
])
_E = np.array([-13.0 - 7.0 * _S6, -13.0 + 7.0 * _S6, -1.0]) / 3.0
_MU_REAL = 3.0 + 3.0 ** (2.0 / 3.0) - 3.0 ** (1.0 / 3.0)


def planck(nu, T):
    """Blackbody intensity [W/m^2/cm^-1/sr] at wavenumber nu [cm^-1] and T [K]."""
    x = C2 * nu / T
    return 100.0 * 2.0 * H_PLANCK * C_LIGHT ** 2 * (100.0 * nu) ** 3 * torch.exp(-x) \
        / -torch.expm1(-x)


def stream_nodes(n: int):
    """Secants m and weights W of ``n`` hemispheric streams (Gauss-Legendre
    in the zenith angle over [0, pi/2]; sum W I approximates the flux)."""
    x, w = np.polynomial.legendre.leggauss(n)
    theta = (np.pi / 2.0) * (x + 1.0) / 2.0
    return 1.0 / np.cos(theta), 2.0 * np.pi * (np.pi / 4.0) * w * np.cos(theta) * np.sin(theta)


def lobatto(n: int):
    """Gauss-Lobatto nodes and weights on [0, 1]."""
    if n == 2:
        return np.array([0.0, 1.0]), np.array([0.5, 0.5])
    c = np.zeros(n)
    c[-1] = 1.0
    inner = np.sort(np.polynomial.legendre.legroots(np.polynomial.legendre.legder(c)))
    x = np.concatenate([[-1.0], inner, [1.0]])
    w = 2.0 / (n * (n - 1) * np.polynomial.legendre.legval(x, c) ** 2)
    return (x + 1.0) / 2.0, w / 2.0


def interp(x, xp, fp):
    """Linear interpolation of fp(xp) at x along the last axis of fp,
    extrapolating with the edge slopes; xp ascending."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x, right=True) - 1, 0, n - 2)
    t = (x - xp[i]) / (xp[i + 1] - xp[i])
    return fp[..., i] + t * (fp[..., i + 1] - fp[..., i])


def _emit(tm):
    """(e^-tm, 1 - e^-tm, (1 - e^-tm)/tm), the ratio by its series at small tm."""
    omt = -torch.expm1(-tm)
    small = tm < 1e-3
    ratio = torch.where(small, 1.0 - tm * 0.5 + tm * tm / 6.0,
                        omt / torch.where(small, torch.ones_like(tm), tm))
    return torch.exp(-tm), omt, ratio


def march(tau, B, S_nu, albedo, ctheta: float, nstream: int):
    """Whole-column fluxes (M_up, M_down) [..., L+1, K] from layer depths tau
    [..., L, K] and level Planck B [..., L+1, K] (level 0 the top): the
    streams marched down from a dark top, the direct beam, then the
    Lambertian surface's reflection and emission marched up; the surface's
    upward flux is pi I_surf."""
    m, W = stream_nodes(nstream)
    dt, dev = tau.dtype, tau.device
    m = torch.as_tensor(m, dtype=dt, device=dev)[:, None]
    W = torch.as_tensor(W, dtype=dt, device=dev)[:, None]
    L = tau.shape[-2]

    def layer(I, l, B_in, B_out):
        t, omt, ratio = _emit(tau[..., l, None, :] * m)
        dB = (B_in - B_out)[..., None, :]
        return I * t + B_out[..., None, :] * omt - dB * t + ratio * dB

    I = torch.zeros(tau.shape[:-2] + (m.shape[0], tau.shape[-1]), dtype=dt, device=dev)
    down = [torch.zeros_like(tau[..., 0, :])]
    for l in range(L):
        I = layer(I, l, B[..., l, :], B[..., l + 1, :])
        down.append((W * I).sum(dim=-2))
    M_down = torch.stack(down, dim=-2)
    beam = ctheta * S_nu[..., None, :] * torch.exp(
        -torch.cat([torch.zeros_like(tau[..., :1, :]), torch.cumsum(tau, dim=-2)], dim=-2)
        / ctheta)
    M_down = M_down + beam
    I_surf = M_down[..., -1, :] * albedo / math.pi + B[..., -1, :]
    I = I_surf[..., None, :].expand(I.shape)
    up = [math.pi * I_surf]
    for l in range(L - 1, -1, -1):
        I = layer(I, l, B[..., l + 1, :], B[..., l, :])
        up.append((W * I).sum(dim=-2))
    return torch.stack(up[::-1], dim=-2), M_down


def refined_levels(P: np.ndarray, refine: int) -> np.ndarray:
    """``refine - 1`` levels spaced in sqrt P inserted into each layer of the
    ascending levels P."""
    parts = [np.linspace(np.sqrt(P[i]), np.sqrt(P[i + 1]), refine + 1)[:-1] ** 2
             for i in range(len(P) - 1)]
    return np.concatenate(parts + [P[-1:]])


def refined_fluxes(sigma, P, T, points, *, g, mu, S_nu, albedo, theta_s, nstream, nlobatto,
                   refine, dtype=torch.float64, device="cpu"):
    """(M_up, M_down) [C, levels, K] of the grid-refined discretized core for
    columns T [C, levels] on the ascending levels P (numpy float64) at the
    wavenumbers ``points``; ``S_nu`` [K] or [C, K]. ``sigma(points, T, P,
    dtype, device)`` gives the cross-sections [states, points] at states T,
    P (as ``linesum.line_sum`` does)."""
    dev = torch.device(device)
    f64 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float64, device=dev)
    Pr = refined_levels(np.asarray(P, np.float64), refine)
    x, w = lobatto(nlobatto)
    dP = np.diff(Pr)
    Pn = (Pr[:-1, None] + dP[:, None] * x[None, :]).reshape(-1)
    lnP = torch.log(f64(P))
    T = torch.as_tensor(T, dtype=torch.float64, device=dev)
    C = T.shape[0]
    Tn = interp(torch.log(f64(Pn)), lnP, T)                        # [C, L k]
    sig = sigma(points, Tn.reshape(-1), f64(Pn).repeat(C), dtype, dev).reshape(
        C, len(dP), nlobatto, -1)
    c = torch.as_tensor(dP[:, None] * w[None, :] * (1e-4 * N_AVOGADRO / g / mu), dtype=dtype,
                        device=dev)
    tau = (c[None, :, :, None] * sig).sum(dim=2)                    # [C, L, K]
    nu = torch.as_tensor(np.asarray(points), dtype=dtype, device=dev)
    Tr = interp(torch.log(f64(Pr)), lnP, T).to(dtype)
    B = planck(nu, Tr[..., None])
    S = torch.as_tensor(S_nu, dtype=dtype, device=dev)
    up, down = march(tau, B, S, albedo, math.cos(theta_s), nstream)
    return up[:, ::refine], down[:, ::refine]


def radau_cache(sigma, P, T, points, *, mu, nlevels=256, dtype=torch.float64, device="cpu"):
    """The adaptive core's column cache for columns T [C, levels] on the
    ascending levels P: pressures ``nlevels`` apart in sqrt P over [P[0],
    P[-1]], T interpolated there in ln P, and ln sigma [C, nlevels, K] at
    ``points`` (log(float64 tiny) where sigma is not positive); ``sigma`` as
    in ``refined_fluxes``."""
    dev = torch.device(device)
    P = np.asarray(P, np.float64)
    wg = np.linspace(np.sqrt(P[0]), np.sqrt(P[-1]), nlevels)
    Pg = wg * wg
    Pg[0], Pg[-1] = P[0], P[-1]
    Pg_t = torch.as_tensor(Pg, dtype=torch.float64, device=dev)
    T = torch.as_tensor(T, dtype=torch.float64, device=dev)
    C = T.shape[0]
    Tg = interp(torch.log(Pg_t), torch.log(torch.as_tensor(P, dtype=torch.float64, device=dev)), T)
    sig = sigma(points, Tg.reshape(-1), Pg_t.repeat(C), torch.float64, dev).reshape(
        C, nlevels, -1)
    tiny = float(np.log(np.finfo(np.float64).tiny))
    ln = torch.where(sig > 0, torch.log(torch.clamp(sig, min=1e-300)), torch.full_like(sig, tiny))
    return dict(Pg=Pg, lnPg=torch.log(Pg_t), lnPg_host=np.log(Pg), Tg=Tg, mu=float(mu), ln_sigma=ln.to(dtype),
                nu=torch.as_tensor(np.asarray(points), dtype=torch.float64, device=dev),
                dtype=dtype)


def _state(cache, x: float, g: float):
    """Per-wavenumber rate/m [C, K] and Planck [C, K] at the shared abscissa x."""
    dt = cache["dtype"]
    lnPg = cache["lnPg_host"]
    lnp = 2.0 * math.log(abs(x))
    i = int(np.clip(np.searchsorted(lnPg, lnp, side="right") - 1, 0, len(lnPg) - 2))
    t = (lnp - lnPg[i]) / (lnPg[i + 1] - lnPg[i])
    lns = cache["ln_sigma"][:, i] + t * (cache["ln_sigma"][:, i + 1] - cache["ln_sigma"][:, i])
    T = cache["Tg"][:, i] + t * (cache["Tg"][:, i + 1] - cache["Tg"][:, i])
    k = 1e-4 * N_AVOGADRO / g / cache["mu"] * 2.0 * abs(x)
    rate = torch.exp(lns) * k
    B = planck(cache["nu"].to(dt), T.to(dt)[:, None])
    return rate, B


def _solve3(M, b):
    """Solve M y = b for [..., 3, 3] M and [..., 3] b by elimination without
    pivoting (the systems here are A^-1 / h + diag(r) with r >= 0)."""
    a = [[M[..., i, j] for j in range(3)] for i in range(3)]
    v = [b[..., i] for i in range(3)]
    for k in range(3):
        for i in range(k + 1, 3):
            f = a[i][k] / a[k][k]
            for j in range(k, 3):
                a[i][j] = a[i][j] - f * a[k][j]
            v[i] = v[i] - f * v[k]
    y = [None] * 3
    for i in (2, 1, 0):
        s = v[i]
        for j in range(i + 1, 3):
            s = s - a[i][j] * y[j]
        y[i] = s / a[i][i]
    return torch.stack(y, dim=-1)


def _path(cache, x0: float, x1: float, xs_out, n_sub: int, grade: int = 48):
    """Step boundaries from x0 to x1: every cache level, ``n_sub`` sub-steps
    between two, the output abscissae, and ``grade`` more halving toward x0
    (the leg's start, where an intensity far from the local Planck function
    relaxes to it in a layer as thin as the most opaque lane makes it)."""
    xg = np.sqrt(cache["Pg"]) * (1.0 if x0 + x1 > 0 else -1.0)   # the leg's side of 0
    xg = np.sort(xg)
    fine = np.concatenate([np.linspace(a, b, n_sub + 1)[:-1] for a, b in zip(xg[:-1], xg[1:])]
                          + [xg[-1:]])
    first = abs(x1 - x0) / (len(xg) - 1) / n_sub
    graded = x0 + np.sign(x1 - x0) * first * 0.5 ** np.arange(1, grade + 1)
    lo, hi = min(x0, x1), max(x0, x1)
    pts = np.concatenate([fine[(fine > lo) & (fine < hi)], [x0, x1], xs_out, graded])
    pts = np.unique(pts[(pts >= lo) & (pts <= hi)])
    return pts if x1 > x0 else pts[::-1]


def _integrate(cache, kind: str, m, y0, x0, x1, xs_out, g, n_sub):
    """Fixed-step Radau IIA(5) from x0 to x1 of every lane [C, S, K]
    (``kind`` "emission": dy/dx = m rate (B - y); "depth": dy/dx = m rate),
    y at each abscissa of ``xs_out`` (in path order)."""
    dt = cache["dtype"]
    dev = y0.device
    Ainv = torch.as_tensor(np.linalg.inv(RADAU_A), dtype=dt, device=dev)
    A = torch.as_tensor(RADAU_A, dtype=dt, device=dev)
    mm = torch.as_tensor(np.asarray(m, np.float64), dtype=dt, device=dev)[None, :, None]
    want = {float(x): k for k, x in enumerate(xs_out)}
    out = [None] * len(xs_out)
    pts = _path(cache, x0, x1, xs_out, n_sub)
    y = y0
    if float(pts[0]) in want:
        out[want[float(pts[0])]] = y
    for a, b in zip(pts[:-1], pts[1:]):
        h = float(b - a)
        st = [_state(cache, a + c * h, g) for c in RADAU_C]
        r = torch.stack([s[0][:, None, :] for s in st], dim=-1) * mm[..., None]   # [C, S, K, 3]
        if kind == "depth":
            y = y + h * (r * A[2]).sum(dim=-1)
        else:
            Bs = torch.stack([s[1][:, None, :].expand_as(y) for s in st], dim=-1)
            M = Ainv / h + torch.diag_embed(r)
            rhs = (Ainv.sum(dim=-1) / h) * y[..., None] + r * Bs
            y = _solve3(M, rhs)[..., 2]
        if float(b) in want:
            out[want[float(b)]] = y
    return torch.stack(out)


def radau_fluxes(cache, P, *, g, S_nu, albedo, theta_s, nstream, n_sub=8):
    """(M_up, M_down) [C, levels, K] of the adaptive core's problem on the
    cache, solved on fixed sub-steps (see the module note); ``S_nu`` [K]."""
    dt = cache["dtype"]
    dev = cache["lnPg"].device
    P = np.asarray(P, np.float64)
    m, W = stream_nodes(nstream)
    Wt = torch.as_tensor(W, dtype=dt, device=dev)[:, None]
    C, K = cache["Tg"].shape[0], cache["nu"].shape[0]
    xd = np.sqrt(P)
    T_lev = interp(torch.log(torch.as_tensor(P, dtype=torch.float64, device=dev)), cache["lnPg"],
                   cache["Tg"])
    B_lev = planck(cache["nu"].to(dt), T_lev.to(dt)[..., None])             # [C, levels, K]
    zeros = torch.zeros((C, len(m), K), dtype=dt, device=dev)
    I_dn = _integrate(cache, "emission", m, zeros, xd[0], xd[-1], xd, g, n_sub)
    M_down = (Wt * I_dn).sum(dim=2).transpose(0, 1)
    ctheta = math.cos(theta_s)
    tau_v = _integrate(cache, "depth", [1.0], zeros[:, :1], xd[0], xd[-1], xd, g, n_sub)
    tau_v = tau_v[:, :, 0].transpose(0, 1)
    S = torch.as_tensor(S_nu, dtype=dt, device=dev)
    M_down = M_down + ctheta * S * torch.exp(-tau_v / ctheta)
    I_surf = M_down[:, -1] * albedo / math.pi + B_lev[:, -1]
    I_up = _integrate(cache, "emission", m, I_surf[:, None].expand(C, len(m), K).contiguous(),
                      -xd[-1], -xd[0], -xd[::-1], g, n_sub)
    M_up = torch.flip((Wt * I_up).sum(dim=2), (0,)).transpose(0, 1)
    M_up = torch.cat([M_up[:, :-1], (math.pi * I_surf)[:, None]], dim=1)
    return M_up, M_down, dict(I_dn=I_dn, I_up=I_up, tau_v=tau_v, B_lev=B_lev)


def radau_steps(cache, P, lanes, *, g, nstream, tol, B_peak, max_attempts=20000):
    """Accepted steps of an error-controlled Radau IIA(5) integration of each
    leg's lanes at relative tolerance ``tol`` (absolute tol 1e-3 B_peak for
    the emission, B_peak [C] each column's largest Planck intensity over its
    levels and the whole grid; tol 1e-6 for the depth: the program's),
    segment by segment between the levels, each segment from the
    reference's own value at its start (``lanes`` from :func:`radau_fluxes`).
    Returns {"emission": steps, "depth": steps}, each summed over the lanes."""
    dev = cache["lnPg"].device
    f64 = torch.float64
    P = np.asarray(P, np.float64)
    xd = np.sqrt(P)
    m, _ = stream_nodes(nstream)
    C, K = cache["Tg"].shape[0], cache["nu"].shape[0]
    legs = []
    # (kind, slants, y at the levels in path order [nx, C, S, K], path abscissae)
    legs.append(("emission", m, lanes["I_dn"].to(f64), xd))
    legs.append(("depth", [1.0], lanes["tau_v"].transpose(0, 1)[..., None, :].to(f64), xd))
    legs.append(("emission", m, lanes["I_up"].to(f64), -xd[::-1]))
    out = {"emission": 0, "depth": 0}
    for kind, mk, ys, xs in legs:
        nseg = len(xs) - 1
        S = len(mk)
        shape = (nseg, C, S, K)
        y0 = ys[:-1].reshape(-1)
        xa = torch.as_tensor(xs[:-1], dtype=f64, device=dev)[:, None, None, None].expand(shape)
        xb = torch.as_tensor(xs[1:], dtype=f64, device=dev)[:, None, None, None].expand(shape)
        col = torch.arange(C, device=dev)[None, :, None, None].expand(shape).reshape(-1)
        j = torch.arange(K, device=dev)[None, None, None, :].expand(shape).reshape(-1)
        ms = torch.as_tensor(np.asarray(mk, np.float64), dtype=f64, device=dev)
        ms = ms[None, None, :, None].expand(shape).reshape(-1)
        atol = (torch.full_like(y0, tol * 1e-6) if kind == "depth"
                else tol * 1e-3 * torch.as_tensor(B_peak, dtype=f64, device=dev)[col])
        steps = _adaptive(cache, kind, ms, col, j, y0, xa.reshape(-1), xb.reshape(-1), g, tol,
                          atol, max_attempts)
        out[kind] += int(steps.sum())
    return out


def _rhs_parts(cache, kind, x, ms, col, j, g):
    """(rate, B) per lane at per-lane abscissae x (float64)."""
    lnPg = cache["lnPg"]
    lnp = 2.0 * torch.log(x.abs())
    i = torch.clamp(torch.searchsorted(lnPg, lnp, right=True) - 1, 0, lnPg.shape[0] - 2)
    t = (lnp - lnPg[i]) / (lnPg[i + 1] - lnPg[i])
    ln = cache["ln_sigma"].to(torch.float64)
    lns = ln[col, i, j] + t * (ln[col, i + 1, j] - ln[col, i, j])
    rate = ms * (1e-4 * N_AVOGADRO / g / cache["mu"]) * torch.exp(lns) * 2.0 * x.abs()
    if kind == "depth":
        return rate, None
    T = cache["Tg"][col, i] + t * (cache["Tg"][col, i + 1] - cache["Tg"][col, i])
    return rate, planck(cache["nu"][j], T)


def _f(kind, rate, B, y):
    return rate if kind == "depth" else rate * (B - y)


def _adaptive(cache, kind, ms, col, j, y0, x0, x1, g, rtol, atol, max_attempts):
    """Accepted steps per lane of Radau IIA(5) with the embedded third-order
    error estimate and the predictive step-size controller (Hairer & Wanner,
    IV.8, as scipy's Radau), stage systems solved exactly (the equations are
    linear in y)."""
    f64 = torch.float64
    dev = y0.device
    A = torch.as_tensor(RADAU_A, dtype=f64, device=dev)
    Ainv = torch.linalg.inv(A)
    E = torch.as_tensor(_E, dtype=f64, device=dev)
    cs = torch.as_tensor(RADAU_C, dtype=f64, device=dev)
    d = torch.sign(x1 - x0)
    span = (x1 - x0).abs()
    x, y = x0.clone(), y0.clone()
    rate0, B0 = _rhs_parts(cache, kind, x, ms, col, j, g)
    f0 = _f(kind, rate0, B0, y)
    scale = atol + y.abs() * rtol
    d0, d1 = y.abs() / scale, f0.abs() / scale
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), torch.full_like(d0, 1e-6),
                     0.01 * d0 / torch.clamp(d1, min=1e-300))
    h0 = torch.minimum(h0, span)
    r1, B1 = _rhs_parts(cache, kind, x + d * h0, ms, col, j, g)
    f1 = _f(kind, r1, B1, y + d * h0 * f0)
    d2 = (f1 - f0).abs() / scale / torch.clamp(h0, min=1e-300)
    dm = torch.maximum(d1, d2)
    h1 = torch.where(dm <= 1e-15, torch.clamp(h0 * 1e-3, min=1e-6),
                     (0.01 / torch.clamp(dm, min=1e-300)) ** 0.25)
    h = torch.minimum(torch.minimum(100.0 * h0, h1), span)
    done = span <= 0
    h_old = torch.zeros_like(h)
    err_old = torch.full_like(h, -1.0)
    rejected = torch.zeros_like(done)
    steps = torch.zeros(x.shape, dtype=torch.int64, device=dev)
    safety = 0.9 * 5.0 / 6.0
    for _ in range(max_attempts):
        if bool(done.all()):
            break
        active = ~done
        h_abs = torch.minimum(h, (x1 - x).abs())
        hs = d * h_abs
        parts = [_rhs_parts(cache, kind, x + c * hs, ms, col, j, g) for c in cs]
        r = torch.stack([p[0] for p in parts], dim=-1)
        if kind == "depth":
            Z = hs[:, None] * (r[:, None, :] * A).sum(dim=-1)
        else:
            Bs = torch.stack([p[1] for p in parts], dim=-1)
            M = Ainv / hs[:, None, None] + torch.diag_embed(r)
            Y = torch.linalg.solve(M, (Ainv.sum(dim=-1) / hs[:, None]) * y[:, None] + r * Bs)
            Z = Y - y[:, None]
        y_new = y + Z[:, 2]
        J = torch.zeros_like(y) if kind == "depth" else -rate0
        den = _MU_REAL / hs - J
        ZE = (Z * E).sum(dim=-1) / hs
        e_raw = (f0 + ZE) / den
        sc = atol + torch.maximum(y.abs(), y_new.abs()) * rtol
        err = e_raw.abs() / sc
        fd = _f(kind, rate0, B0, y + e_raw)
        err2 = ((fd + ZE) / den).abs() / sc
        err = torch.where(rejected & (err > 1.0), err2, err)
        mult = torch.where((err_old > 0) & (h_old > 0) & (err > 0),
                           h_abs / torch.clamp(h_old, min=1e-300)
                           * (err_old / torch.clamp(err, min=1e-300)) ** 0.25, torch.ones_like(err))
        factor = torch.clamp(mult, max=1.0) * torch.clamp(err, min=1e-12) ** -0.25
        accept = active & (err <= 1.0)
        x_next = x + hs
        reached = (x1 - x_next).abs() <= 1e-12 * torch.clamp(x1.abs(), min=1.0)
        rn, Bn = parts[2]
        f_next = _f(kind, rn, Bn, y_new)
        h_acc = h_abs * torch.clamp(safety * factor, 0.2, 10.0)
        h_rej = h_abs * torch.clamp(safety * factor, min=0.2)
        x = torch.where(accept, x_next, x)
        y = torch.where(accept, y_new, y)
        f0 = torch.where(accept, f_next, f0)
        rate0 = torch.where(accept, rn, rate0)
        if B0 is not None:
            B0 = torch.where(accept, Bn, B0)
        h = torch.where(active, torch.where(accept, h_acc, h_rej), h)
        done = done | (accept & reached)
        h_old = torch.where(accept, h_abs, h_old)
        err_old = torch.where(accept, err, err_old)
        rejected = torch.where(active, ~accept, rejected)
        steps = steps + accept.to(torch.int64)
    return steps

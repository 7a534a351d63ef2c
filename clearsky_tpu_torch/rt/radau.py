"""Adaptive Radau flux core: per-lane error-controlled Schwarzschild marches.

Counterpart of ``clearsky_tpu.rt.radau``: optical depth and intensity ODEs
in the sqrt-pressure coordinates (omega = -sqrt(P) upward, iota = +sqrt(P)
downward), one scalar ODE per (stream x wavenumber) lane, integrated by the
adaptive Radau IIA(5) method with each lane's own step control. The core
consumes a **column cache**: ln sigma on a pressure grid with the
temperature and mean-molar-mass profiles on the same grid, all linear in
ln P at the integrator's abscissae. An ``AcceleratedAbsorber`` is consumed
as it is; any other absorber stack is evaluated once on a 256-level grid
spaced in sqrt P (one line sum of every state).

Each leg (an outgoing march, the downward emission, the beam's depth, the
upward emission) is one launch of ``csrc/radau.cu`` on CUDA tensors
(``rt.radau_cuda``): ``outgoing`` and ``optical_depth`` make one,
``monochromatic_fluxes`` three. CPU tensors take the plain engine
(``utils.radau``), which is also the kernel's derivative twin. A cache of a
batch of columns (T and mu [B, npc], ln sigma [npc, n_nu] shared or [B,
npc, n_nu]) integrates every column's lanes in the same launch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..constants import N_AVOGADRO
from ..ops.planck import planck
from ..utils import profiling
from ..utils.quadrature import stream_nodes
from ..utils.radau import radau_scalar, radau_dense
from ..absorption.absorbers import AcceleratedAbsorber, _LOG_TINY

__all__ = [
    "ColumnCache",
    "build_column_cache",
    "radau_path_tau",
    "radau_outgoing",
    "radau_monoflux",
]

DENSE_LEVELS = 256  # the cache's levels for a stack that is not an AcceleratedAbsorber
NEWTON_ITERS = 2    # the Schwarzschild right-hand sides are linear in y


class ColumnCache(NamedTuple):
    """Opacity and state column for the adaptive core (ascending pressures):
    ``lnP`` [npc], ``T`` and ``mu`` [..., npc], ``ln_sigma`` [npc, n_nu] (or
    [..., npc, n_nu] for a batch of columns), ``nu`` [n_nu]."""

    lnP: torch.Tensor
    T: torch.Tensor
    mu: torch.Tensor
    ln_sigma: torch.Tensor
    nu: torch.Tensor


def _profiles(Pg, fT, fmu):
    T = torch.as_tensor(fT(Pg), dtype=Pg.dtype, device=Pg.device)
    T = torch.broadcast_to(T, torch.broadcast_shapes(T.shape, Pg.shape))
    mu = torch.as_tensor(fmu(T, Pg), dtype=Pg.dtype, device=Pg.device)
    return T, torch.broadcast_to(mu, T.shape)


def build_column_cache(P, fT, fmu, A, nlevels: int = 0) -> ColumnCache:
    """Evaluate the absorber and profiles onto a column cache.

    ``A`` an :class:`AcceleratedAbsorber` with ``nlevels`` 0: its own grid
    and cross-sections (P unused; ``fT`` may return a batch [B, npc]). Any
    other absorber stack: one evaluation of sigma on ``nlevels`` (default
    256) levels spaced in sqrt P over [P.min, P.max], ln sigma floored at
    log(float64 tiny) where sigma is not positive.
    """
    with profiling.span("cs.radau.cache", A.nu):
        if isinstance(A, AcceleratedAbsorber) and nlevels == 0:
            Pg = torch.exp(A.lnP)
            T, mu = _profiles(Pg, fT, fmu)
            return ColumnCache(lnP=A.lnP, T=T, mu=mu, ln_sigma=A.ln_sigma, nu=A.nu)
        P = np.asarray(P.detach().cpu() if isinstance(P, torch.Tensor) else P, dtype=np.float64)
        n = nlevels or DENSE_LEVELS
        w = np.linspace(np.sqrt(P.min()), np.sqrt(P.max()), n)
        Pg = w * w
        Pg[0], Pg[-1] = P.min(), P.max()
        Pg = torch.as_tensor(Pg, dtype=A.nu.dtype, device=A.nu.device)
        T, mu = _profiles(Pg, fT, fmu)
        sig = A.sigma(T, Pg)  # [n, n_nu]: one evaluation of every state
        tiny = torch.finfo(sig.dtype).tiny
        ln = torch.where(sig > 0, torch.log(torch.clamp(sig, min=tiny)),
                         torch.full_like(sig, _LOG_TINY))
        return ColumnCache(lnP=torch.log(Pg), T=T, mu=mu, ln_sigma=ln, nu=A.nu)


def _bracket(lnp, lnPg):
    """Edge-extrapolating linear-interpolation bracket (as utils.interp)."""
    npc = lnPg.shape[0]
    i = torch.clamp(torch.searchsorted(lnPg, lnp, right=True) - 1, 0, npc - 2)
    t = (lnp - lnPg[i]) / (lnPg[i + 1] - lnPg[i])
    return i, t


# The right-hand sides on a lane layout (see _lane_args): x is the signed
# sqrt-P coordinate, the path element |dP| = 2 sqrt(P) |dx| in both
# directions; T, mu and ln sigma linear in ln P between the cache's levels.

def _rate(x, args):
    trow, sbase, _, m, lnPg, Tg, mug, lnsig, const, n_nu = args
    sp = x.abs()
    lnp = 2.0 * torch.log(sp)
    i, t = _bracket(lnp, lnPg)
    ti = trow + i
    mu = mug[ti] + t * (mug[ti + 1] - mug[ti])
    base = sbase + i * n_nu
    lns = lnsig[base] + t * (lnsig[base + n_nu] - lnsig[base])
    return m * const * (torch.exp(lns) / mu) * (2.0 * sp), ti, t


class _Emission:
    """Schwarzschild along the propagation path: dI/dx = rate (B - I). Its
    x-stage is (rate, B) (the engine's two-stage interface, utils.radau)."""

    def at(self, x, args):
        rate, ti, t = _rate(x, args)
        Tg, nu_val = args[5], args[2]
        T = Tg[ti] + t * (Tg[ti + 1] - Tg[ti])
        return rate, planck(nu_val, T)

    def apply(self, q, y):
        return q[0] * (q[1] - y)

    def dfdy(self, q, y):
        return -q[0]

    def __call__(self, x, y, args):
        return self.apply(self.at(x, args), y)


class _Depth(_Emission):
    """Optical depth: dtau/dx = rate (independent of y); x-stage (rate,)."""

    def at(self, x, args):
        return (_rate(x, args)[0],)

    def apply(self, q, y):
        return q[0] * torch.ones_like(y)

    def dfdy(self, q, y):
        return torch.zeros_like(y)


_rhs_emission, _rhs_depth = _Emission(), _Depth()
RHS = {"emission": _rhs_emission, "depth": _rhs_depth}


def _konst(g: float) -> float:
    return 1e-4 * N_AVOGADRO / g   # dtau/dP = const sigma / mu


def _lane_args(lnPg, Tg, mug, lnsig, nu, m, g, n_streams: int):
    """The plain right-hand sides' arguments for C columns x ``n_streams``
    streams x n_nu lanes, lane = (c n_streams + s) n_nu + j: T, mu [C, npc],
    ln sigma [C or 1, npc, n_nu], ``m`` the streams' slants [n_streams]."""
    C, npc = Tg.shape
    n_nu = nu.shape[0]
    dev, dtype = Tg.device, Tg.dtype
    lane = torch.arange(C * n_streams * n_nu, device=dev)
    c = lane // (n_streams * n_nu)
    j = lane % n_nu
    s = (lane // n_nu) % n_streams
    shared = lnsig.shape[0] == 1
    sbase = (0 if shared else c * (npc * n_nu)) + j
    m_t = torch.as_tensor(np.asarray(m, np.float64), dtype=dtype, device=dev)
    return (c * npc, sbase, nu[j].to(dtype), m_t[s], lnPg, Tg.reshape(-1), mug.reshape(-1),
            lnsig.reshape(-1), torch.tensor(_konst(g), dtype=dtype, device=dev), n_nu), c


def _plain_leg(rhs: str, lnPg, Tg, mug, lnsig, nu, m, g, atol, y0, xs, rtol: float,
               max_steps: int, dense: bool, with_steps: bool = False):
    """One leg in the plain engine: y0 [C n_streams n_nu] from xs[0] through
    the nodes ``xs`` (dense: [nx, lanes]; else the end, NaN where a lane did
    not reach it). ``atol`` [C], one a column."""
    args, c = _lane_args(lnPg, Tg, mug, lnsig, nu, m, g, len(m))
    f = RHS[rhs]
    if dense:
        ys, steps = radau_dense(f, y0, xs, args=args, rtol=rtol, atol=atol[c],
                                newton_iters=NEWTON_ITERS, max_steps=max_steps, with_steps=True)
    else:
        r = radau_scalar(f, y0, xs[0], xs[-1], args=args, rtol=rtol, atol=atol[c],
                         newton_iters=NEWTON_ITERS, max_steps=max_steps)
        ys, steps = torch.where(r.ok, r.y, torch.nan), r.steps
    return (ys, steps) if with_steps else ys


def _leg(rhs: str, cache: ColumnCache, g: float, m, atol, y0, xs, tol: float,
         max_steps: int, dense: bool):
    """One leg of the core on the cache's columns: the kernel on CUDA
    tensors, the plain engine on the CPU. y0 [C, n_streams, n_nu]; the
    result [nx, C, n_streams, n_nu] (dense) or [C, n_streams, n_nu]."""
    from .radau_cuda import radau_leg

    npc = cache.lnP.shape[0]
    Tg = cache.T.reshape(-1, npc).contiguous()
    mug = torch.broadcast_to(cache.mu, cache.T.shape).reshape(-1, npc).contiguous()
    lnsig = cache.ln_sigma.reshape(-1, npc, cache.nu.shape[0]).contiguous()
    atol = torch.broadcast_to(torch.as_tensor(atol, dtype=Tg.dtype, device=Tg.device),
                              (Tg.shape[0],))
    with profiling.span("cs.radau." + rhs, Tg):
        out = radau_leg(rhs, cache.lnP.contiguous(), Tg, mug, lnsig, cache.nu,
                        np.asarray(m, np.float64), g, atol.contiguous(),
                        y0.reshape(-1).contiguous(), xs.contiguous(), rtol=tol,
                        max_steps=max_steps, dense=dense)
    return out.reshape(((xs.shape[0],) if dense else ()) + tuple(y0.shape))


def _eff_tol(tol, dtype) -> float:
    """Clamp rtol above float resolution: below ~8 eps the embedded error
    estimate is rounding, every step rejects and lanes burn to max_steps."""
    return max(float(tol), 8.0 * float(torch.finfo(dtype).eps))


def _default_atol(tol, B_peak):
    return tol * 1e-3 * B_peak


def _columns(cache: ColumnCache):
    """(C, batched): the cache's columns, and whether it carries a batch."""
    return cache.T.reshape(-1, cache.lnP.shape[0]).shape[0], cache.T.dim() > 1


def _nodes(xs, like):
    """Abscissae [nx] on ``like``'s device without a host-to-device copy."""
    return torch.stack([torch.full((), float(x), dtype=like.dtype, device=like.device)
                        for x in xs])


def radau_path_tau(cache: ColumnCache, P1: float, P2: float, g: float, m: float = 1.0,
                   tol: float = 1e-5, max_steps: int = 10_000):
    """Adaptive slant-path optical depth [n_nu] between two pressures: one
    error-controlled integration a wavenumber lane, NaN where a lane did not
    reach the end."""
    dtype = cache.T.dtype
    C, batched = _columns(cache)
    n_nu = cache.nu.shape[0]
    tol = _eff_tol(tol, dtype)
    hi, lo = max(P1, P2), min(P1, P2)
    y0 = torch.zeros((C, 1, n_nu), dtype=dtype, device=cache.T.device)
    tau = _leg("depth", cache, g, [m], tol * 1e-6, y0, _nodes([np.sqrt(lo), np.sqrt(hi)], y0),
               tol, max_steps, dense=False)[:, 0]
    return tau if batched else tau[0]


def radau_outgoing(cache: ColumnCache, Ps: float, Ptop: float, g: float, nstream: int = 5,
                   tol: float = 1e-5, vertical: bool = False, max_steps: int = 10_000):
    """OLR spectrum [n_nu] by adaptive upward marches: surface Planck
    emission, ``nstream`` hemispheric streams (one vertical beam with
    ``vertical``), each (stream x wavenumber) lane with its own step control."""
    if vertical:
        m, W = np.array([1.0]), np.array([np.pi])
    else:
        m, W = stream_nodes(nstream)
    dtype, dev = cache.T.dtype, cache.T.device
    C, batched = _columns(cache)
    # the surface temperature from the cache's own profile at Ps
    i, t = _bracket(torch.log(torch.tensor(Ps, dtype=dtype, device=dev)), cache.lnP)
    Ts = cache.T[..., i] + t * (cache.T[..., i + 1] - cache.T[..., i])
    B_s = planck(cache.nu.to(dtype), Ts[..., None]).reshape(C, 1, -1)   # [C, 1, n_nu]
    tol = _eff_tol(tol, dtype)
    atol = _default_atol(tol, B_s.amax(dim=(1, 2)))
    I0 = B_s.expand(C, len(m), -1)
    I_top = _leg("emission", cache, g, m, atol, I0, _nodes([-np.sqrt(Ps), -np.sqrt(Ptop)], B_s),
                 tol, max_steps, dense=False)
    olr = (torch.as_tensor(W, dtype=dtype, device=dev)[:, None] * I_top).sum(dim=1)
    return olr if batched else olr[0]


def radau_monoflux(cache: ColumnCache, P, g: float, S_nu, albedo_nu, theta_s: float,
                   nstream: int = 5, tol: float = 1e-5, max_steps: int = 10_000):
    """Whole-column monochromatic fluxes (M_up, M_down, tau): the fluxes
    [np, n_nu], tau [np-1, n_nu] the layers' vertical depth from the beam's
    leg (a batch of columns: [B, ...] of each, ``S_nu`` [n_nu] or [B, n_nu]).

    Three adaptive dense-output legs over the levels P: the downward
    emission streams, the stellar beam's vertical depth, and the upward
    streams from the Lambertian surface (reflection plus Planck). The
    surface's upward flux is pinned to pi I_surf, as the discretized march
    does.
    """
    with profiling.span("cs.radau.monoflux", cache.T):
        dtype, dev = cache.T.dtype, cache.T.device
        C, batched = _columns(cache)
        P = torch.as_tensor(P, dtype=dtype, device=dev)
        n_lev = P.shape[0]
        m, W = stream_nodes(nstream)
        ns = len(m)
        Wt = torch.as_tensor(W, dtype=dtype, device=dev)[:, None]
        tol = _eff_tol(tol, dtype)

        i_lev, t_lev = _bracket(torch.log(P), cache.lnP)
        Tc = cache.T.reshape(C, -1)
        Tlev = Tc[:, i_lev] + t_lev * (Tc[:, i_lev + 1] - Tc[:, i_lev])          # [C, np]
        B_lev = planck(cache.nu[None, None, :].to(dtype), Tlev[..., None])      # [C, np, n_nu]
        atol = _default_atol(tol, B_lev.amax(dim=(1, 2)))

        # downward emission: iota = +sqrt(P), top to surface
        xs_down = torch.sqrt(P)
        zeros = torch.zeros((C, ns, cache.nu.shape[0]), dtype=dtype, device=dev)
        I_dn = _leg("emission", cache, g, m, atol, zeros, xs_down, tol, max_steps, dense=True)
        M_down = (Wt * I_dn).sum(dim=2).transpose(0, 1)                          # [C, np, n_nu]

        # the direct stellar beam: adaptive vertical depth, attenuated at cos(theta_s)
        c = float(torch.cos(torch.tensor(theta_s, dtype=dtype)))   # cos in the column's dtype
        tau_v = _leg("depth", cache, g, [1.0], tol * 1e-6, zeros[:, :1], xs_down, tol, max_steps,
                     dense=True)[:, :, 0].transpose(0, 1)                        # [C, np, n_nu]
        S_nu = torch.as_tensor(S_nu, dtype=dtype, device=dev).reshape(-1, 1, cache.nu.shape[0])
        M_down = M_down + (c * S_nu) * torch.exp(-tau_v / c)

        # Lambertian reflection plus surface Planck, upward
        albedo_nu = torch.as_tensor(albedo_nu, dtype=dtype, device=dev)
        I_surf = M_down[:, -1] * albedo_nu / np.pi + B_lev[:, -1]                # [C, n_nu]
        xs_up = -torch.flip(xs_down, (0,))                                   # -sqrt(Ps) -> -sqrt(Ptop)
        I_up = _leg("emission", cache, g, m, atol, I_surf[:, None].expand(C, ns, -1), xs_up, tol,
                    max_steps, dense=True)
        M_up = torch.flip((Wt * I_up).sum(dim=2), (0,)).transpose(0, 1)
        # the surface's upward flux of an isotropic boundary is pi I_surf exactly
        # (the streams' sum of W only approximates pi), as in the discretized march
        M_up = torch.cat([M_up[:, :-1], (np.pi * I_surf)[:, None]], dim=1)
        tau = tau_v[:, 1:] - tau_v[:, :-1]
        if batched:
            return M_up, M_down, tau
        return M_up[0], M_down[0], tau[0]

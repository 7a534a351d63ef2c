"""Plain radiative-convective column model, for a few columns of a sweep.

The model is ClearSky's RCM with the discretized core: cell temperatures
(the last cell the surface), edges Pe, cell centres midway between edges, a
radiative grid with each edge layer split ``radmul`` times evenly in P, and
cross-sections cached as ln sigma at the edges (evaluated at edge
temperatures, interpolated in ln P between them). A step radiates on the
radiative grid (Lobatto nodes at the layers' ends, hemispheric streams, a
beam scaled by the column's insolation factor, a Lambertian surface), turns
the net flux per wavenumber into heating (interpolated in ln P to the
edges, differenced over each cell, times g/cp over its pressure thickness;
the surface by its heat capacity), integrates over the spectrum by the
trapezoid rule, takes an explicit Euler step and adjusts dry convection
from the surface up. Every ``period`` steps the cache is refreshed at the
cell temperatures interpolated in ln P to the edges.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .flux import N_AVOGADRO, interp, lobatto, march, planck
from .linesum import R_GAS

__all__ = ["Model", "edge_ln_sigma", "heating", "lapse", "run_steps", "cells"]


def cells(Pe: np.ndarray, Te: np.ndarray):
    """(P, T): cell centres midway between edges, the last cell the surface."""
    return (np.concatenate([0.5 * (Pe[:-1] + Pe[1:]), Pe[-1:]]),
            np.concatenate([0.5 * (Te[:-1] + Te[1:]), Te[-1:]]))


class Model:
    """The sweep's shared structure: grids, constants and the absorber's
    cross-sections ``sigma(points, T, P, dtype, device)``."""

    def __init__(self, sigma, nu, Pe, *, g, mu, cp, cs, S_nu, albedo, theta_s, radmul, nstream,
                 nlobatto, dtype=torch.float64, device="cpu"):
        self.sigma, self.dtype = sigma, dtype
        self.dev = torch.device(device)
        self.nu64 = np.asarray(nu, np.float64)
        self.Pe = np.asarray(Pe, np.float64)
        self.P = cells(self.Pe, self.Pe)[0]
        sub = np.linspace(self.Pe[:-1], self.Pe[1:], radmul, endpoint=False, axis=1).ravel()
        self.Pr = np.concatenate([sub, self.Pe[-1:]])
        self.g, self.mu, self.cp, self.cs = g, mu, cp, cs
        self.S_nu, self.albedo, self.theta_s = S_nu, albedo, theta_s
        self.nstream, self.nlobatto = nstream, nlobatto

    def t64(self, x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float64, device=self.dev)


def edge_ln_sigma(model: Model, Te) -> torch.Tensor:
    """ln sigma [C, edges, n_nu] at edge temperatures Te [C, edges] (float64
    tiny's log where sigma is not positive), in the model's dtype."""
    Te = torch.as_tensor(Te, dtype=torch.float64, device=model.dev)
    C, n = Te.shape
    sig = model.sigma(model.nu64, Te.reshape(-1), model.t64(model.Pe).repeat(C), torch.float64,
                      model.dev).reshape(C, n, -1)
    tiny = float(np.log(np.finfo(np.float64).tiny))
    ln = torch.where(sig > 0, torch.log(torch.clamp(sig, min=1e-300)), torch.full_like(sig, tiny))
    return ln.to(model.dtype)


def _operator(model: Model) -> torch.Tensor:
    """The map from net flux on the radiative levels to cell heating rows
    [cells, radiative levels] (before the spectral integral)."""
    lnPe, lnPr = np.log(model.Pe), np.log(model.Pr)
    nr = len(lnPr)
    i = np.clip(np.searchsorted(lnPr, lnPe, side="right") - 1, 0, nr - 2)
    t = (lnPe - lnPr[i]) / (lnPr[i + 1] - lnPr[i])
    W = np.zeros((len(lnPe), nr))
    W[np.arange(len(lnPe)), i] -= 1.0 - t
    W[np.arange(len(lnPe)), i + 1] -= t
    dP = np.diff(model.Pe)
    G = np.concatenate([(W[:-1] - W[1:]) * (model.g / model.cp / dP)[:, None],
                        W[-1:] / model.cs])
    return torch.as_tensor(G, dtype=model.dtype, device=model.dev)


def heating(model: Model, T, ln_sigma, factors) -> torch.Tensor:
    """Heating rates [C, cells] [K/s] of columns T [C, cells] on caches
    ln_sigma [C, edges, n_nu] with insolation factors [C]."""
    dt, dev = model.dtype, model.dev
    T = torch.as_tensor(T, dtype=torch.float64, device=dev)
    lnPc = torch.log(model.t64(model.P))
    x, w = lobatto(model.nlobatto)
    Pr = model.Pr
    dP = np.diff(Pr)
    Pn = (Pr[:-1, None] + dP[:, None] * x[None, :]).reshape(-1)
    lnPe = torch.log(model.t64(model.Pe))
    # the cache interpolated in ln P to the nodes: [C, nodes, n_nu]
    ls = ln_sigma.to(torch.float64).transpose(1, 2)
    sig = torch.exp(interp(torch.log(model.t64(Pn)), lnPe, ls)).transpose(1, 2).to(dt)
    C, n_nu = T.shape[0], ln_sigma.shape[-1]
    sig = sig.reshape(C, len(dP), model.nlobatto, n_nu)
    c = torch.as_tensor(dP[:, None] * w[None, :] * (1e-4 * N_AVOGADRO / model.g / model.mu),
                        dtype=dt, device=dev)
    tau = (c[None, :, :, None] * sig).sum(dim=2)
    nu = model.t64(model.nu64).to(dt)
    Tr = interp(torch.log(model.t64(Pr)), lnPc, T).to(dt)
    B = planck(nu, Tr[..., None])
    f = torch.as_tensor(factors, dtype=dt, device=dev)
    S = torch.as_tensor(model.S_nu, dtype=dt, device=dev) * f[:, None]
    up, down = march(tau, B, S, model.albedo, math.cos(model.theta_s), model.nstream)
    dH = torch.einsum("kr,crn->ckn", _operator(model), up - down)
    return torch.trapezoid(dH, nu, dim=-1)


def lapse(T, P: np.ndarray, cp: float, mu: float):
    """Dry convective adjustment of T [C, cells]: from the highest pressure
    up, each point warmed to the dry adiabat from the point below where the
    profile is steeper than it."""
    order = np.argsort(-P, kind="stable")
    Ts = T[:, order]
    out = [Ts[:, 0]]
    Ps = P[order]
    for k in range(1, len(P)):
        Ti = out[-1]
        gamma_e = (Ti / Ps[k - 1]) * (R_GAS / (mu * cp))
        gamma_p = (Ts[:, k] - Ti) / (Ps[k] - Ps[k - 1])
        out.append(torch.where(gamma_p > gamma_e, Ti + gamma_e * (Ps[k] - Ps[k - 1]), Ts[:, k]))
    adj = torch.stack(out, dim=1)
    return adj[:, np.argsort(order)]


def run_steps(model: Model, T, ln_sigma, factors, dt_s: float, nsteps: int, adjust_every: int):
    """Temperatures [C, cells] after ``nsteps`` Euler steps on a fixed cache,
    with the adjustment after every ``adjust_every``-th."""
    T = torch.as_tensor(T, dtype=model.dtype, device=model.dev)
    for i in range(nsteps):
        T = T + dt_s * heating(model, T, ln_sigma, factors).to(model.dtype)
        if adjust_every and (i + 1) % adjust_every == 0:
            T = lapse(T, model.P, model.cp, model.mu)
    return T


def edge_temperatures(model: Model, T) -> torch.Tensor:
    """Cell temperatures [C, cells] interpolated in ln P to the edges."""
    T = torch.as_tensor(T, dtype=torch.float64, device=model.dev)
    return interp(torch.log(model.t64(model.Pe)), torch.log(model.t64(model.P)), T)

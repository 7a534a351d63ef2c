"""The discretized radiative-transfer core: layer optical depth and flux marches.

Counterpart of ``clearsky_tpu.rt.discretized``: per-layer optical depth by
Gauss-Lobatto quadrature, the linear-in-tau layer emission, and the up/down
hemispheric-stream marches with a direct stellar beam and a Lambertian
surface.

The marches run through the kernel wrappers of :mod:`.march_cuda` (K2 for
the top-of-atmosphere flux, K3 for whole-column fluxes), which take the plain
versions here (:func:`_olr_march`, :func:`_monoflux_march`) for CPU tensors.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..constants import N_AVOGADRO
from ..utils.quadrature import stream_nodes, lobatto_unit_nodes
from ..utils.grids import trapz
from ..utils.interp import full_float32
from .march_cuda import trans_emit, olr_march, monoflux_march

__all__ = [
    "FluxPack",
    "lobatto_pressures",
    "layer_tau_flat",
    "monoflux",
    "outgoing_flux",
    "integrate_flux",
]


class FluxPack(NamedTuple):
    """Whole-atmosphere radiation bundle.

    tau [np-1, n_nu]; M_up, M_down [np, n_nu] monochromatic fluxes
    [W/m^2/cm^-1]; F_up, F_down, F_net [np] integrated fluxes [W/m^2].
    """

    tau: torch.Tensor
    M_up: torch.Tensor
    M_down: torch.Tensor
    F_up: torch.Tensor
    F_down: torch.Tensor
    F_net: torch.Tensor


def lobatto_pressures(P, nlobatto: int):
    """Intra-layer Gauss-Lobatto node pressures [np-1, nlobatto]."""
    x, _ = lobatto_unit_nodes(nlobatto)
    x = torch.as_tensor(x, dtype=P.dtype, device=P.device)
    dP = P[1:] - P[:-1]
    return P[:-1, None] + dP[:, None] * x[None, :]


def layer_tau_flat(P, muf, sig_flat, g, nlobatto: int):
    """Per-layer tau[np-1, n_nu] from flat node cross-sections [np-1 * nlobatto, n_nu].

    The Lobatto reduction (dP, node weight, 1e-4 Na/g, 1/mu) is one
    block-diagonal matrix product; ``muf`` is the flat per-node molar mass.
    Floorless: the march's series branch handles tau -> 0 exactly. The
    product runs in full float32 (:func:`..utils.interp.full_float32`), as
    the JAX package pins it at ``Precision.HIGHEST``: TF32 would round sigma
    to a 10-bit mantissa.
    """
    L = P.shape[0] - 1
    k = nlobatto
    _, w = lobatto_unit_nodes(k)
    mask = np.zeros((L, L * k))
    for j in range(k):
        mask[np.arange(L), np.arange(L) * k + j] = w[j]
    dt, dev = sig_flat.dtype, sig_flat.device
    dP = (P[1:] - P[:-1]).to(dt)
    Wm = torch.as_tensor(mask, dtype=dt, device=dev) * dP[:, None]
    Wm = Wm * ((1e-4 * N_AVOGADRO / g) / muf)[None, :].to(dt)
    with full_float32():
        return torch.matmul(Wm, sig_flat)


def _march(tau, m, B_lo, B_hi, I0, W=None, reverse=False):
    """March through the layers, I <- I t + Be, for all streams at once.

    tau [L, n_nu] vertical optical depth; m [nstream] slants applied per
    layer; B_lo/B_hi [L, n_nu] Planck at each layer's entry/exit level; I0
    [nstream, n_nu]. With ``W`` each step's weighted flux [n_nu] is stacked
    in level order (also when ``reverse`` marches from the last layer up).
    Returns (I_final, fluxes [L, n_nu] or None).
    """
    L = tau.shape[0]
    I = I0
    rows = [None] * L
    for l in (range(L - 1, -1, -1) if reverse else range(L)):
        tm = tau[l][None, :] * m[:, None]
        t, omt, ratio = trans_emit(tm)
        dB = B_lo[l][None, :] - B_hi[l][None, :]
        I = I * t + (B_hi[l][None, :] * omt - dB * t + ratio * dB)
        if W is not None:
            rows[l] = W @ I
    return I, (None if W is None else torch.stack(rows))


def _nodes(m, W, like):
    return (torch.as_tensor(np.asarray(m), dtype=like.dtype, device=like.device),
            torch.as_tensor(np.asarray(W), dtype=like.dtype, device=like.device))


def _olr_march(tau, B, m, W):
    """Plain version of K2: the top-of-atmosphere flux for stream nodes (m, W)."""
    m, W = _nodes(m, W, tau)
    I_surf = B[-1][None, :].expand(len(m), -1)
    I_toa, _ = _march(tau, m, B[1:], B[:-1], I_surf, reverse=True)
    return W @ I_toa


def _olr_scan(tau, B, nstream: int):
    """Plain OLR with ``nstream`` hemispheric streams (``clearsky_tpu``'s name)."""
    return _olr_march(tau, B, *stream_nodes(nstream))


def _monoflux_march(tau, B, S_nu, albedo_nu, ctheta, m, W):
    """Plain version of K3: (M_up, M_down) [L+1, n_nu] for stream nodes (m, W)."""
    m, W = _nodes(m, W, tau)
    n_nu = tau.shape[1]
    # downward atmospheric emission
    I0 = torch.zeros((len(m), n_nu), dtype=tau.dtype, device=tau.device)
    _, M_down_body = _march(tau, m, B[:-1], B[1:], I0, W=W)
    M_down = torch.cat([torch.zeros_like(M_down_body[:1]), M_down_body])
    # direct stellar beam, attenuated by exp(-tau / cos(theta_s))
    beam_top = ctheta * S_nu
    beam = beam_top[None, :] * torch.exp(-torch.cumsum(tau, dim=0) / ctheta)
    M_down = M_down + torch.cat([beam_top[None, :], beam])
    # Lambertian reflection plus surface emission, marched upward
    I_surf = M_down[-1] * albedo_nu / math.pi + B[-1]
    _, M_up_body = _march(tau, m, B[1:], B[:-1], I_surf[None, :].expand(len(m), -1),
                          W=W, reverse=True)
    M_up = torch.cat([M_up_body, (math.pi * I_surf)[None, :]])
    return M_up, M_down


def _monoflux_scan(tau, B, S_nu, albedo_nu, ctheta, nstream: int):
    """Plain whole-column fluxes with ``nstream`` streams (``clearsky_tpu``'s name)."""
    return _monoflux_march(tau, B, S_nu, albedo_nu, ctheta, *stream_nodes(nstream))


def monoflux(tau, B, nu, S_nu, albedo_nu, theta_s: float, nstream: int):
    """Whole-column monochromatic up/down fluxes (M_up, M_down) [np, n_nu].

    tau [L, n_nu] floorless layer optical depth; B [np, n_nu] level Planck
    (index 0 = top, -1 = surface); S_nu [n_nu] stellar flux at the top;
    albedo_nu [n_nu] surface albedo; theta_s stellar zenith angle [rad].
    """
    m, W = stream_nodes(nstream)
    return monoflux_march(tau, B, S_nu, albedo_nu, math.cos(theta_s), m, W)


def outgoing_flux(tau, B, nstream: int, vertical: bool = False):
    """Outgoing monochromatic flux at the top [n_nu]: surface emission marched up.

    ``vertical=True`` uses one vertical beam scaled by pi (m = 1, W = pi),
    the convention of the analytic gray-atmosphere solution.
    """
    m, W = (np.array([1.0]), np.array([np.pi])) if vertical else stream_nodes(nstream)
    return olr_march(tau, B, m, W)


def integrate_flux(M_up, M_down, nu):
    """Spectral integration of monochromatic fluxes (row-wise trapezoid rule)."""
    return trapz(nu, M_up, axis=-1), trapz(nu, M_down, axis=-1)

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

import contextlib
import contextvars
import math
from typing import NamedTuple

import numpy as np
import torch

from ..constants import N_AVOGADRO
from ..utils.quadrature import stream_nodes, lobatto_unit_nodes
from ..utils.grids import trapz
from ..utils.interp import full_float32
from ..utils import profiling
from .march_cuda import trans_emit, olr_march, monoflux_march

__all__ = [
    "FluxPack",
    "TAU_MIN",
    "layer_planck",
    "lobatto_pressures",
    "layer_tau",
    "layer_tau_flat",
    "path_tau",
    "march_kernel_mode",
    "monoflux",
    "outgoing_flux",
    "integrate_flux",
]


# The floor of the reference's per-layer optical depth, an opt-in here
# (``floor=True``) for comparisons with it: the marches take tau -> 0 by
# series, so the default is floorless.
TAU_MIN = 1e-6


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


def layer_planck(B1, B2, tau, t, omt=None):
    """Linear-in-tau layer emission Be = B2 (1 - t) - (B1 - B2) t + (1 - t)(B1 - B2) / tau.

    ``omt`` is 1 - t formed accurately (by default -expm1(-tau)); the ratio
    (1 - t) / tau is its series 1 - tau/2 + tau^2/6 below tau = 1e-3, so a
    transparent layer needs no floor.
    """
    dB = B1 - B2
    if omt is None:
        omt = -torch.expm1(-tau)
    small = tau < 1e-3
    safe_tau = torch.where(small, torch.ones_like(tau), tau)
    ratio = torch.where(small, 1.0 - tau * 0.5 + tau * tau * (1.0 / 6.0), omt / safe_tau)
    return B2 * omt - dB * t + ratio * dB


def lobatto_pressures(P, nlobatto: int):
    """Intra-layer Gauss-Lobatto node pressures [np-1, nlobatto]."""
    x, _ = lobatto_unit_nodes(nlobatto)
    x = torch.as_tensor(x, dtype=P.dtype, device=P.device)
    dP = P[1:] - P[:-1]
    return P[:-1, None] + dP[:, None] * x[None, :]


def layer_tau(P, Tn, mun, sigman, g, nlobatto: int, floor: bool = False):
    """Per-layer vertical optical depth tau[np-1, n_nu] by Lobatto quadrature.

    ``P`` [np] ascending; ``Tn``, ``mun`` [np-1, nlobatto] at the layers'
    nodes; ``sigman`` [np-1, nlobatto, n_nu] the cross-sections there;
    beta = 1e-4 Na sigma / (g mu). ``floor=True`` floors each layer at
    :data:`TAU_MIN`.
    """
    _, w = lobatto_unit_nodes(nlobatto)
    w = torch.as_tensor(w, dtype=sigman.dtype, device=sigman.device)
    P = torch.as_tensor(P, dtype=sigman.dtype, device=sigman.device)
    dP = (P[1:] - P[:-1])[:, None, None]
    beta = (1e-4 * N_AVOGADRO / g) * sigman / mun[:, :, None]
    tau = torch.sum(dP * w[None, :, None] * beta, dim=1)
    return torch.clamp(tau, min=TAU_MIN) if floor else tau


def path_tau(P, Tn, mun, sigman, g, m, nlobatto: int):
    """Slant-path optical depth [n_nu] between P[0] and P[-1] for the angle
    factor ``m``: the floorless :func:`layer_tau` summed over the layers."""
    return m * torch.sum(layer_tau(P, Tn, mun, sigman, g, nlobatto), dim=0)


def layer_tau_flat(P, muf, sig_flat, g, nlobatto: int, floor: bool = False):
    """Per-layer tau[..., np-1, n_nu] from flat node cross-sections
    [..., np-1 * nlobatto, n_nu].

    The Lobatto reduction (dP, node weight, 1e-4 Na/g, 1/mu) as one batched
    product over the layers, [L, 1, k] x [L, k, n_nu], linear in the layer
    count (the JAX package's block-diagonal product grows with its square:
    ``tools/tau_probe.py`` times both); ``muf`` is the flat per-node molar
    mass [..., np-1 * nlobatto]. Leading dimensions of either (a batch of
    columns on the same levels ``P``) fold into the product's batch: one
    product for every column's layers. The product runs in full float32
    (:func:`..utils.interp.full_float32`), as the JAX package pins it at
    ``Precision.HIGHEST``: TF32 would round sigma to a 10-bit mantissa.
    Floorless unless ``floor`` (then at :data:`TAU_MIN`): the march's series
    branch handles tau -> 0 exactly.
    """
    L = P.shape[0] - 1
    k = nlobatto
    _, w = lobatto_unit_nodes(k)
    dt, dev = sig_flat.dtype, sig_flat.device
    muf = torch.as_tensor(muf)
    batch = torch.broadcast_shapes(sig_flat.shape[:-2], muf.shape[:-1])
    n_nu = sig_flat.shape[-1]
    dP = (P[1:] - P[:-1]).to(dt)
    c = dP[:, None] * torch.as_tensor(w, dtype=dt, device=dev)[None, :]
    c = torch.broadcast_to(
        c * ((1e-4 * N_AVOGADRO / g) / muf).to(dt).reshape(muf.shape[:-1] + (L, k)),
        batch + (L, k))
    sig = torch.broadcast_to(sig_flat, batch + sig_flat.shape[-2:])
    with full_float32():
        tau = torch.bmm(c.reshape(-1, 1, k), sig.reshape(-1, k, n_nu))[:, 0]
    tau = tau.reshape(batch + (L, n_nu))
    return torch.clamp(tau, min=TAU_MIN) if floor else tau


_MARCH_MODE = contextvars.ContextVar("march_kernel_mode", default="auto")


@contextlib.contextmanager
def march_kernel_mode(mode: str):
    """Scoped choice of the flux route.

    "auto" (the default): the fused table kernels K6/K7 where their route
    applies. "off": no fused table route, as the JAX package's "off" turns
    off its ``_fused_table_ok``; the line sum and the marches then run
    separately. Either way the marches are K2/K3 for CUDA tensors and the
    plain versions for CPU tensors: the port has no plain march on the card.
    The JAX package's "interpret" runs its Pallas kernels in interpret mode
    and has no counterpart here.
    """
    if mode == "interpret":
        raise ValueError("march_kernel_mode('interpret') runs the JAX package's Pallas "
                         "kernels in interpret mode; the port has no interpret mode")
    if mode not in ("auto", "off"):
        raise ValueError(f"march_kernel_mode must be auto/off, not {mode!r}")
    tok = _MARCH_MODE.set(mode)
    try:
        yield
    finally:
        _MARCH_MODE.reset(tok)


def fused_route_on() -> bool:
    """False inside ``march_kernel_mode("off")``."""
    return _MARCH_MODE.get() != "off"


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

    A batch of columns, tau [..., L, n_nu] and B [..., np, n_nu] with S_nu
    and albedo_nu [n_nu] or per column [..., n_nu], is folded into the
    wavenumber axis, as the JAX package's lane-fold rule does under ``vmap``
    (the march is per point): one march over [L, columns x n_nu], unfolded
    to [..., np, n_nu].
    """
    with profiling.span("cs.march", tau):
        m, W = stream_nodes(nstream)
        ctheta = math.cos(theta_s)
        if tau.dim() == 2:
            return monoflux_march(tau, B, S_nu, albedo_nu, ctheta, m, W)
        batch, (L, N) = tau.shape[:-2], tau.shape[-2:]
        nb = math.prod(batch)

        def fold(x, rows):
            x = torch.broadcast_to(x, batch + (rows, N)).reshape(nb, rows, N)
            return x.transpose(0, 1).reshape(rows, nb * N)

        spectral = lambda x: torch.broadcast_to(x, batch + (N,)).reshape(nb * N)
        M_up, M_down = monoflux_march(fold(tau, L), fold(B, L + 1), spectral(S_nu),
                                      spectral(albedo_nu), ctheta, m, W)
        unfold = lambda x: x.view(L + 1, nb, N).transpose(0, 1).reshape(batch + (L + 1, N))
        return unfold(M_up), unfold(M_down)


def outgoing_flux(tau, B, nstream: int, vertical: bool = False):
    """Outgoing monochromatic flux at the top [n_nu]: surface emission marched up.

    ``vertical=True`` uses one vertical beam scaled by pi (m = 1, W = pi),
    the convention of the analytic gray-atmosphere solution.
    """
    m, W = (np.array([1.0]), np.array([np.pi])) if vertical else stream_nodes(nstream)
    with profiling.span("cs.march", tau):
        return olr_march(tau, B, m, W)


def integrate_flux(M_up, M_down, nu):
    """Spectral integration of monochromatic fluxes (row-wise trapezoid rule)."""
    return trapz(nu, M_up, axis=-1), trapz(nu, M_down, axis=-1)

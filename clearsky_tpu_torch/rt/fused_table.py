"""The baked-table fast path: split-precision coefficients to fluxes in one kernel.

Counterpart of ``clearsky_tpu.rt.fused_table``. For a column whose only
absorber is a split-precision :class:`~..absorption.gas.Gas`, the Chebyshev
basis at the Lobatto nodes, the per-layer quadrature weights and the level
Planck rows are formed here in plain torch; the contraction with the
coefficients, exp, the layer quadrature and the march run in one kernel per
call (``rt/fused_table_cuda.py``: K6 for the OLR, K7 for whole-column fluxes),
so the [nodes, n_nu] ln sigma never reaches device memory.

The plain versions of K6 and K7 (:func:`_fused_olr_plain`,
:func:`_fused_monoflux_plain`) are :func:`_unfused_tau` followed by the plain
marches; the wrappers take them for CPU tensors. :func:`table_olr_fused_ref`
is the unfused pipeline (``raw_sigma`` -> ``layer_tau_flat`` -> march).
"""

from __future__ import annotations

import math

import torch

from ..constants import N_AVOGADRO
from ..ops.planck import planck
from ..utils.interp import full_float32
from ..utils.quadrature import stream_nodes, lobatto_unit_nodes
from .discretized import (
    lobatto_pressures,
    layer_tau_flat,
    _olr_march,
    _olr_scan,
    _monoflux_march,
)
from .fused_table_cuda import fused_olr, fused_monoflux

__all__ = ["table_olr_fused", "table_monoflux_fused", "fused_table_applicable",
           "table_olr_fused_ref", "MAX_LAYERS"]

# the layer bound of the fused route (clearsky_tpu/rt/march_pallas.py
# MAX_LAYERS); K6/K7 keep each point's layer tau in shared memory
MAX_LAYERS = 128
# the JAX package's lane block of its fused kernels; K6/K7 tile their own
# points (csrc/fused_table.cu), so the argument changes nothing here
BLOCK_N = 1024


def _no_interpret(interpret: bool):
    if interpret:
        raise ValueError("interpret=True runs the JAX package's Pallas kernels in interpret "
                         "mode; the port has no interpret mode")


def fused_table_applicable(A) -> bool:
    """True when the absorber is exactly one split-precision Gas (alone or
    as the only member of a stack, with no CIA and no function)."""
    from ..absorption.gas import Gas
    from ..absorption.absorbers import AbsorberStack

    if isinstance(A, AbsorberStack):
        if len(A.gases) != 1 or A.funs or A.cias:
            return False
        A = A.gases[0]
    return isinstance(A, Gas) and A.coeffs_tail is not None


def _state_basis(gas, Tq, Pq):
    """The table's Chebyshev basis at states (Tq, Pq), split like its
    coefficients: lead columns in the coefficients' dtype, tail columns
    rounded to bfloat16 (as ``Gas.raw_sigma`` and the JAX kernels round them)."""
    from ..absorption.gas import table_basis

    basis = table_basis(gas.domain, Tq, Pq)
    bl = basis[:, gas._rows(gas.lead_idx)].to(gas.coeffs.dtype).contiguous()
    bt = basis[:, gas._rows(gas.tail_idx)].to(torch.bfloat16).contiguous()
    return bl, bt


def _quad_matrix(P, g, mun, Cn, nlobatto, dtype):
    """The nonzero [L, k] blocks of the Lobatto quadrature matrix.

    The JAX package forms the block-diagonal [L, L*k] matrix of
    ``layer_tau_flat`` (layer l uses only its own k nodes); row l of the
    result holds its diagonal block, with dP, the node weights,
    1e-4 Na/g and the node concentration over molar mass folded in
    (sigma in the kernels is the raw cross-section).
    """
    L = P.shape[0] - 1
    _, w = lobatto_unit_nodes(nlobatto)
    w = torch.as_tensor(w, dtype=dtype, device=P.device)
    dP = (P[1:] - P[:-1]).to(dtype)
    fac = ((1e-4 * N_AVOGADRO / g) * Cn / mun).to(dtype).reshape(L, nlobatto)
    return (w[None, :] * dP[:, None]) * fac


def _unfused_tau(lead, tail, basis_pair, wq):
    """Plain version of the kernels' tau [L, N], in ``lead``'s dtype.

    ln = bl lead + bt tail with both bfloat16 operands widened first (exact
    products), sigma = exp(ln), tau_l = sum_j wq[l, j] sigma[l k + j].
    """
    bl, bt = basis_pair
    acc = lead.dtype
    with full_float32():
        ln = torch.matmul(bl.to(acc), lead) + torch.matmul(bt.to(acc), tail.to(acc))
    sigma = torch.exp(ln)
    L, k = wq.shape
    return (wq.to(acc)[:, :, None] * sigma.view(L, k, -1)).sum(dim=1)


def _fused_olr_plain(lead, tail, bl, bt, wq, B, m, W):
    """Plain version of K6: the top-of-atmosphere flux [N]."""
    return _olr_march(_unfused_tau(lead, tail, (bl, bt), wq), B, m, W)


def _fused_monoflux_plain(lead, tail, bl, bt, wq, B, S_nu, albedo_nu, ctheta, m, W):
    """Plain version of K7: (M_up, M_down, tau)."""
    tau = _unfused_tau(lead, tail, (bl, bt), wq)
    M_up, M_down = _monoflux_march(tau, B, S_nu, albedo_nu, ctheta, m, W)
    return M_up, M_down, tau


def _like(x, P):
    return torch.broadcast_to(torch.as_tensor(x, dtype=P.dtype, device=P.device), P.shape)


def _column_operands(gas, P, g, fT, fmu, nlobatto):
    """(bl, bt, wq, B) of a column on the ascending pressure levels P."""
    if gas.coeffs_tail is None:
        raise ValueError("the fused table path needs a split-precision Gas "
                         "(gas.split_precision(k))")
    L = P.shape[0] - 1
    if not (1 <= L <= MAX_LAYERS):
        raise ValueError(f"the fused table path needs 1 <= L <= {MAX_LAYERS} layers, not {L}")
    Pn = lobatto_pressures(P, nlobatto).reshape(-1)
    Tn = _like(fT(Pn), Pn)
    mun = _like(fmu(Tn, Pn), Pn)
    Cn = _like(gas.fC(Tn, Pn), Pn)
    bl, bt = _state_basis(gas, Tn, Pn)
    wq = _quad_matrix(P, g, mun, Cn, nlobatto, gas.coeffs.dtype)
    B = planck(gas.nu[None, :], _like(fT(P), P)[:, None])
    return bl, bt, wq, B


def table_olr_fused(gas, P, g, fT, fmu, nlobatto: int = 3, nstream: int = 5,
                    interpret: bool = False, block_n: int = BLOCK_N):
    """Outgoing flux [n_nu] of a split-precision table gas through K6.

    Same contract as ``outgoing`` for a single-gas absorber: P [np] the
    ascending level pressures (a tensor on the gas's device), fT(P) and
    fmu(T, P) the profiles. ``interpret=True`` raises (no interpret mode);
    ``block_n`` is accepted and changes nothing (:data:`BLOCK_N`).
    """
    _no_interpret(interpret)
    bl, bt, wq, B = _column_operands(gas, P, g, fT, fmu, nlobatto)
    return fused_olr(gas.coeffs, gas.coeffs_tail, bl, bt, wq, B, *stream_nodes(nstream))


def table_monoflux_fused(gas, P, g, fT, fmu, S_nu, albedo_nu, theta_s,
                         nlobatto: int = 3, nstream: int = 5, interpret: bool = False,
                         block_n: int = BLOCK_N):
    """(M_up, M_down, tau) of a split-precision table gas through K7
    (``monochromatic_fluxes`` semantics); ``interpret`` and ``block_n`` as
    :func:`table_olr_fused`'s."""
    _no_interpret(interpret)
    bl, bt, wq, B = _column_operands(gas, P, g, fT, fmu, nlobatto)
    return fused_monoflux(gas.coeffs, gas.coeffs_tail, bl, bt, wq, B, S_nu, albedo_nu,
                          math.cos(theta_s), *stream_nodes(nstream))


def table_olr_fused_ref(gas, P, g, fT, fmu, nlobatto: int, nstream: int, B=None):
    """The unfused pipeline on the same column: split ``raw_sigma`` ->
    ``layer_tau_flat`` -> plain OLR march."""
    Pn = lobatto_pressures(P, nlobatto).reshape(-1)
    Tn = _like(fT(Pn), Pn)
    mun = _like(fmu(Tn, Pn), Pn)
    Cn = _like(gas.fC(Tn, Pn), Pn)
    tau = layer_tau_flat(P, mun / Cn, gas.raw_sigma(Tn, Pn), g, nlobatto)
    if B is None:
        B = planck(gas.nu[None, :], _like(fT(P), P)[:, None])
    return _olr_scan(tau, B, nstream)

"""Wrappers of the fused table kernels (K6 and K7, ``csrc/fused_table.cu``).

K6 replaces ``clearsky_tpu/rt/fused_table.py::_fused_kernel`` (split table
coefficients -> sigma -> Lobatto tau -> top-of-atmosphere march) and K7
``::_fused_mono_kernel`` (the same tau, written out, then both marches with
the stellar beam and the Lambertian surface). One thread runs one
wavenumber point from its coefficients to its fluxes.

:func:`fused_olr` and :func:`fused_monoflux` launch their kernel for CUDA
tensors and take the plain versions in :mod:`.fused_table` for CPU tensors.
On CUDA they check device, dtype (float32 lead, basis, weights and Planck
rows; bfloat16 tail and tail basis), shape and contiguity and raise on
anything the kernels do not take; there is no fallback. Their derivatives
are those of the unfused plain pipeline (``_unfused_tau`` and the plain
marches, :func:`..utils.twin.with_twin`), as the JAX package's custom JVPs
route tangents through its unfused XLA pipeline.

Operands (K lead rows, T tail rows, N points, L layers of k Lobatto nodes):
``lead`` [K, N], ``tail`` [T, N], ``bl`` [L*k, K] and ``bt`` [L*k, T] the
Chebyshev basis at the nodes split like the coefficients, ``wq`` [L, k] the
nonzero blocks of the block-diagonal quadrature matrix, ``B`` [L+1, N].
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.cuda_build import check_operand, load_library
from ..utils import twin
from .march_cuda import MAX_STREAMS, _streams

__all__ = ["fused_olr", "fused_monoflux", "MAX_SMEM_BYTES", "MAX_NODES_PER_LAYER"]

MAX_SMEM_BYTES = 232448  # a block's shared-memory limit on sm_90
MAX_NODES_PER_LAYER = 8  # csrc/fused_table.cu ``NG``: a layer's nodes fit one group

_P = ctypes.c_void_p
_I = ctypes.c_int


def _library(symbol: str, argtypes):
    lib = load_library("fused_table")
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        if (lib.fused_max_streams(), lib.fused_nodes_per_group()) != (
                MAX_STREAMS, MAX_NODES_PER_LAYER):
            raise RuntimeError("csrc/fused_table.cu and this wrapper disagree on the stream "
                               "or node-group count")
        lib.fused_smem_bytes.argtypes = [_I, _I, _I]
        lib.fused_smem_bytes.restype = ctypes.c_longlong
        fn.argtypes = argtypes
        fn.restype = _I
    return fn, lib


def _operands(lead, tail, bl, bt, wq, B, lib):
    """Check the operands on the card; return (K, T, L, k, lpg, ngroups, N, basis).

    ``basis`` [K + T, ngroups, NG] float32 holds bl and the widened bt
    (exact) transposed, one row per coefficient, its nodes in groups of
    lpg = NG // k whole layers, zero past them (the kernel's layout).
    """
    dev = lead.device
    if dev.type != "cuda":
        raise ValueError(f"no fused table kernel for device {dev}")
    if lead.dim() != 2 or tail.dim() != 2 or wq.dim() != 2:
        raise ValueError("lead, tail and wq must be 2-D")
    (K, N), T, (L, k) = lead.shape, tail.shape[0], wq.shape
    ng = MAX_NODES_PER_LAYER
    if not (1 <= N < 2**31 and K >= 1 and T >= 1 and L >= 1 and 1 <= k <= ng):
        raise ValueError(f"fused table kernels need K, T, L, N >= 1 and 1 <= k <= {ng}, "
                         f"not {K, T, L, k, N}")
    nnode = L * k
    check_operand("lead", lead, (K, N), dev)
    check_operand("tail", tail, (T, N), dev, torch.bfloat16)
    check_operand("bl", bl, (nnode, K), dev)
    check_operand("bt", bt, (nnode, T), dev, torch.bfloat16)
    check_operand("wq", wq, (L, k), dev)
    check_operand("B", B, (L + 1, N), dev)
    smem = lib.fused_smem_bytes(K, T, L)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{K} lead + {T} tail rows and {L} layers need {smem} bytes of "
                         f"shared memory per block; the card has {MAX_SMEM_BYTES}")
    lpg = ng // k
    ngroups = -(-L // lpg)
    nodes = torch.zeros((K + T, ngroups * lpg * k), dtype=torch.float32, device=dev)
    nodes[:K, :nnode] = bl.t()
    nodes[K:, :nnode] = bt.t().float()
    basis = torch.zeros((K + T, ngroups, ng), dtype=torch.float32, device=dev)
    basis[:, :, :lpg * k] = nodes.view(K + T, ngroups, lpg * k)
    return K, T, L, k, lpg, ngroups, N, basis


def fused_olr(lead, tail, bl, bt, wq, B, m, W):
    """Outgoing flux at the top [N] of a split table column (K6).

    ``m``/``W`` the stream slants and weights. CPU tensors take the plain
    ``fused_table._fused_olr_plain``, whose derivatives CUDA tensors carry.
    """
    from .fused_table import _fused_olr_plain

    if not twin.kernel_path(lead):
        return _fused_olr_plain(lead, tail, bl, bt, wq, B, m, W)
    return twin.with_twin(lambda *x: _fused_olr_launch(*x, m, W),
                          lambda *x: _fused_olr_plain(*x, m, W), lead, tail, bl, bt, wq, B)


def _fused_olr_launch(lead, tail, bl, bt, wq, B, m, W):
    """K6 on the card into a new [N]."""
    m, W = _streams(m, W)
    fn, lib = _library("fused_olr_launch",
                       [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P])
    K, T, L, k, lpg, ngroups, N, basis = _operands(lead, tail, bl, bt, wq, B, lib)
    out = torch.empty(N, dtype=torch.float32, device=lead.device)
    err = fn(lead.data_ptr(), tail.data_ptr(), basis.data_ptr(), wq.data_ptr(),
             B.data_ptr(), m.ctypes.data, W.ctypes.data, len(m), K, T, L, k, lpg, ngroups,
             N, out.data_ptr(), torch.cuda.current_stream(lead.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused table OLR kernel launch failed: CUDA error {err}")
    fused_olr.launches += 1
    return out


fused_olr.launches = 0


def fused_monoflux(lead, tail, bl, bt, wq, B, S_nu, albedo_nu, ctheta: float, m, W):
    """(M_up, M_down, tau) of a split table column (K7): M_up and M_down
    [L+1, N] as ``march_cuda.monoflux_march`` gives them, tau [L, N].

    ``ctheta`` is cos(stellar zenith angle). CPU tensors take the plain
    ``fused_table._fused_monoflux_plain``, whose derivatives CUDA tensors
    carry.
    """
    from .fused_table import _fused_monoflux_plain

    if not twin.kernel_path(lead):
        return _fused_monoflux_plain(lead, tail, bl, bt, wq, B, S_nu, albedo_nu, ctheta, m, W)
    return twin.with_twin(lambda *x: _fused_monoflux_launch(*x, ctheta, m, W),
                          lambda *x: _fused_monoflux_plain(*x, ctheta, m, W),
                          lead, tail, bl, bt, wq, B, S_nu, albedo_nu)


def _fused_monoflux_launch(lead, tail, bl, bt, wq, B, S_nu, albedo_nu, ctheta, m, W):
    """K7 on the card into new (M_up, M_down, tau)."""
    m, W = _streams(m, W)
    fn, lib = _library("fused_monoflux_launch",
                       [_P, _P, _P, _P, _P, _P, _P, ctypes.c_float, _P, _P, _I, _I, _I, _I,
                        _I, _I, _I, _I, _P, _P, _P, _P])
    K, T, L, k, lpg, ngroups, N, basis = _operands(lead, tail, bl, bt, wq, B, lib)
    dev = lead.device
    check_operand("S_nu", S_nu, (N,), dev)
    check_operand("albedo_nu", albedo_nu, (N,), dev)
    ctheta = float(ctheta)
    if not 0.0 < ctheta <= 1.0:  # NaN fails too
        raise ValueError(f"cos(stellar zenith angle) must be in (0, 1], not {ctheta}")
    tau = torch.empty((L, N), dtype=torch.float32, device=dev)
    M_up = torch.empty((L + 1, N), dtype=torch.float32, device=dev)
    M_down = torch.empty((L + 1, N), dtype=torch.float32, device=dev)
    err = fn(lead.data_ptr(), tail.data_ptr(), basis.data_ptr(), wq.data_ptr(),
             B.data_ptr(), S_nu.data_ptr(), albedo_nu.data_ptr(), ctheta,
             m.ctypes.data, W.ctypes.data, len(m), K, T, L, k, lpg, ngroups, N,
             tau.data_ptr(), M_up.data_ptr(), M_down.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused table flux kernel launch failed: CUDA error {err}")
    fused_monoflux.launches += 1
    return M_up, M_down, tau


fused_monoflux.launches = 0

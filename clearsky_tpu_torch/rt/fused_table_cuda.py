"""Wrappers of the fused table kernels (K6 and K7, ``csrc/fused_table.cu``).

K6 replaces ``clearsky_tpu/rt/fused_table.py::_fused_kernel`` (split table
coefficients -> sigma -> Lobatto tau -> top-of-atmosphere march) and K7
``::_fused_mono_kernel`` (the same tau, written out, then both marches with
the stellar beam and the Lambertian surface). The bfloat16 tail runs on the
tensor cores, the float32 lead in FP32 FMAs; the coefficients stream
through a ring of shared-memory chunks.

:func:`fused_olr` and :func:`fused_monoflux` launch their kernel for CUDA
tensors and take the plain versions in :mod:`.fused_table` for CPU tensors.
On CUDA they check device, dtype (float32 lead, basis, weights and Planck
rows; bfloat16 tail and tail basis), shape and contiguity and raise on
anything the kernels do not take; there is no fallback. Their derivatives
are those of the unfused plain pipeline (``_unfused_tau`` and the plain
marches, :func:`..utils.twin.with_twin`), as the JAX package's custom JVPs
route tangents through its unfused XLA pipeline. Their launches count in
``utils.profiling.counters`` as ``launch.fused.olr`` and
``launch.fused.monoflux``.

Operands (K lead rows, T tail rows, N points, L layers of k Lobatto nodes):
``lead`` [K, N], ``tail`` [T, N], ``bl`` [L*k, K] and ``bt`` [L*k, T] the
Chebyshev basis at the nodes split like the coefficients, ``wq`` [L, k] the
nonzero blocks of the block-diagonal quadrature matrix, ``B`` [L+1, N].
Each launch first gathers bl and bt into a scratch pack laid out as the
kernels stage it (``csrc/fused_table.cu``, ``fused_basis_kernel``): one
small launch, where PR 2's wrapper built its basis with six PyTorch ops.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.cuda_build import check_operand, load_library
from ..utils import profiling, twin
from .march_cuda import MAX_STREAMS, _streams

__all__ = ["fused_olr", "fused_monoflux", "kernel_info", "MAX_SMEM_BYTES",
           "MAX_NODES_PER_LAYER", "NODE_TILE", "K_STEP", "LEAD_CHUNK"]

MAX_SMEM_BYTES = 232448  # a block's shared-memory limit on sm_90
MAX_NODES_PER_LAYER = 8  # the Lobatto nodes a layer the fused route takes
# csrc/fused_table.cu's tiling: nodes a pass (4 m16 tiles of the
# tensor-core product), tail rows a chunk (the product's depth), lead rows a
# chunk
NODE_TILE, K_STEP, LEAD_CHUNK = 64, 16, 8

_P = ctypes.c_void_p
_I = ctypes.c_int
_OLR_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P]
_MONO_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_float, _P, _P, _I, _I, _I, _I, _I,
              _I, _P, _P, _P, _P]


def _library(symbol: str, argtypes):
    lib = load_library("fused_table")
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        layout = (_I * 4)()
        lib.fused_layout(layout)
        if (lib.fused_max_streams(), tuple(layout)) != (
                MAX_STREAMS, (NODE_TILE, K_STEP, LEAD_CHUNK, MAX_NODES_PER_LAYER)):
            raise RuntimeError("csrc/fused_table.cu and this wrapper disagree on the stream "
                               "count or the tiling")
        lib.fused_smem_bytes.argtypes = [_I, _I]
        lib.fused_smem_bytes.restype = ctypes.c_longlong
        lib.fused_pack_bytes.argtypes = [_I, _I, _I, _I]
        lib.fused_pack_bytes.restype = ctypes.c_longlong
        lib.fused_kernel_info.argtypes = [_I, _I, _I, _I, ctypes.POINTER(_I)]
        lib.fused_kernel_info.restype = _I
        fn.argtypes = argtypes
        fn.restype = _I
    return fn, lib


def kernel_info(kind: str, L: int, N: int, nstream: int = 5) -> dict:
    """K6 (``kind`` "olr") or K7 ("monoflux") on the card at L layers and N
    points: registers and local (spill) bytes a thread, static and dynamic
    shared bytes a block, resident blocks an SM with the share of the SM's
    64 warps they hold, and the persistent blocks a launch starts (ctas)."""
    _, lib = _library("fused_olr_launch", _OLR_ARGS)
    out = (_I * 6)()
    err = lib.fused_kernel_info(int(kind == "monoflux"), nstream, L, N, out)
    if err != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed: CUDA error {err}")
    return {"registers": out[0], "shared_bytes": out[1] + out[4], "static_shared_bytes": out[1],
            "local_bytes": out[2], "blocks_per_sm": out[3],
            "resident_warps": out[3] * 4 / 64.0, "ctas": out[5]}


def _operands(lead, tail, bl, bt, wq, B, lib, mono):
    """Check the operands on the card; return (K, T, L, k, N, pack): pack
    the uninitialized scratch the launch fills with the basis as the
    kernels read it."""
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
    smem = lib.fused_smem_bytes(L, int(mono))
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{L} layers need {smem} bytes of shared memory per block; the card "
                         f"has {MAX_SMEM_BYTES}")
    pack = torch.empty(lib.fused_pack_bytes(K, T, L, k), dtype=torch.uint8, device=dev)
    return K, T, L, k, N, pack


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
    fn, lib = _library("fused_olr_launch", _OLR_ARGS)
    K, T, L, k, N, pack = _operands(lead, tail, bl, bt, wq, B, lib, False)
    out = torch.empty(N, dtype=torch.float32, device=lead.device)
    err = fn(lead.data_ptr(), tail.data_ptr(), bl.data_ptr(), bt.data_ptr(), pack.data_ptr(),
             wq.data_ptr(), B.data_ptr(), m.ctypes.data, W.ctypes.data, len(m), K, T, L, k, N,
             out.data_ptr(), torch.cuda.current_stream(lead.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused table OLR kernel launch failed: CUDA error {err}")
    profiling.counters["launch.fused.olr"] += 1
    return out


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
    fn, lib = _library("fused_monoflux_launch", _MONO_ARGS)
    K, T, L, k, N, pack = _operands(lead, tail, bl, bt, wq, B, lib, True)
    dev = lead.device
    check_operand("S_nu", S_nu, (N,), dev)
    check_operand("albedo_nu", albedo_nu, (N,), dev)
    ctheta = float(ctheta)
    if not 0.0 < ctheta <= 1.0:  # NaN fails too
        raise ValueError(f"cos(stellar zenith angle) must be in (0, 1], not {ctheta}")
    tau = torch.empty((L, N), dtype=torch.float32, device=dev)
    M_up = torch.empty((L + 1, N), dtype=torch.float32, device=dev)
    M_down = torch.empty((L + 1, N), dtype=torch.float32, device=dev)
    err = fn(lead.data_ptr(), tail.data_ptr(), bl.data_ptr(), bt.data_ptr(), pack.data_ptr(),
             wq.data_ptr(), B.data_ptr(), S_nu.data_ptr(), albedo_nu.data_ptr(), ctheta,
             m.ctypes.data, W.ctypes.data, len(m), K, T, L, k, N,
             tau.data_ptr(), M_up.data_ptr(), M_down.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused table flux kernel launch failed: CUDA error {err}")
    profiling.counters["launch.fused.monoflux"] += 1
    return M_up, M_down, tau

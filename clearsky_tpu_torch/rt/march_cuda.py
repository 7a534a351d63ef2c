"""Wrappers of the CUDA flux-march kernels (K2 and K3, ``csrc/march.cu``).

K2 replaces ``clearsky_tpu/rt/march_pallas.py::_olr_kernel`` (the TOA-only
upward march of ``outgoing``) and K3 replaces ``::_march_kernel`` (down march,
stellar beam, Lambertian surface and up march of ``monoflux``).
:func:`march_plan` chooses their layout from the shape: where the card is
full, one thread a wavenumber point with the stream intensities in
registers; where the points are few, a warp a stream over a block of 32
points whose column tile is staged in shared memory (the source note of
``csrc/march.cu``). The kernels receive the plan's numbers.

:func:`olr_march` and :func:`monoflux_march` launch their kernel for CUDA
tensors and take the plain versions in :mod:`.discretized` for CPU tensors.
On CUDA they check device, dtype (float32), shape and contiguity and raise on
anything the kernels do not take; there is no fallback. Their derivatives
are the plain versions' (:func:`..utils.twin.with_twin`), as the JAX
package's custom JVPs route tangents through its scan marches. Their
launches count in ``utils.profiling.counters`` as ``launch.march.olr`` and
``launch.march.monoflux``.

:func:`trans_emit` is the shared transmittance/emission helper of the plain
march; the kernels' float32 step rearranges it (``csrc/march.cu``
``layer_step``: no division, the series/exp split at 0.25 kept).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils.cuda_build import check_operand, load_library
from ..utils import profiling, twin

__all__ = ["trans_emit", "olr_march", "monoflux_march", "march_plan", "kernel_info",
           "MAX_STREAMS"]

MAX_STREAMS = 8  # csrc/march.cu ``MAX_STREAMS``

SMS = 132                       # the H100's streaming multiprocessors
SPREAD_BELOW = 1024             # points an SM under which a warp marches one stream
POINT_THREADS = 128             # block of the one-thread-a-point layout
SPREAD_POINTS = 32              # points a block of the spread layout (a warp a stream)
SM_SHARED = 232448              # shared bytes an SM's blocks may hold (227 KB)
SPREAD_SHARED = SM_SHARED // 4  # a spread block's budget: 4 blocks an SM
POINT_SHARED = SM_SHARED // 8   # K3's kept column, a block of the point layout

_P = ctypes.c_void_p
_I = ctypes.c_int


def _ratio_series(tm):
    """(1 - e^-tm)/tm = sum_k (-tm)^k/(k+1)!, used below the 0.25 switch.

    float32 keeps 7 terms (truncation ~1.5e-9 relative at the switch, below
    f32 roundoff); float64 keeps 11 (< 2.4e-14)."""
    if tm.dtype == torch.float32:
        return 1.0 - tm * (0.5 - tm * ((1.0 / 6.0) - tm * (
            (1.0 / 24.0) - tm * ((1.0 / 120.0) - tm * ((1.0 / 720.0)
                                                       - tm * (1.0 / 5040.0))))))
    return 1.0 - tm * (0.5 - tm * ((1.0 / 6.0) - tm * (
        (1.0 / 24.0) - tm * ((1.0 / 120.0) - tm * ((1.0 / 720.0) - tm * (
            (1.0 / 5040.0) - tm * ((1.0 / 40320.0) - tm * (
                (1.0 / 362880.0) - tm * (1.0 / 3628800.0)))))))))


def trans_emit(tm):
    """(t, omt, ratio): e^-tm, 1 - e^-tm and (1 - e^-tm)/tm from one exp.

    Below tm = 0.25, omt = tm * series (1 - exp(-tm) formed directly cancels
    catastrophically in float32 for transparent layers); above it omt = 1 - e.
    t is formed as 1 - omt, as the TPU kernels do.
    """
    e = torch.exp(-tm)
    r = _ratio_series(tm)
    small = tm < 0.25
    omt_l = 1.0 - e
    ratio = torch.where(small, r, omt_l / torch.where(small, torch.ones_like(tm), tm))
    omt = torch.where(small, tm * r, omt_l)
    return 1.0 - omt, omt, ratio


def march_plan(kind: str, L: int, N: int, nst: int) -> dict:
    """The launch of K2 (``kind`` "olr") or K3 ("monoflux") at L layers, N
    points and nst streams, as ``csrc/march.cu`` takes it.

    ``spread`` where N < SMS x SPREAD_BELOW (one thread a point would fill
    under half the card's thread slots): blocks of ``block_points`` = 32 points
    and ``slices`` warps (a warp a stream; K3 one more for the beam), each
    staging ``chunk`` layers of tau, 1/tau and B with the weighted
    intensities of every level in ``shared`` bytes, within a quarter of an
    SM's 227 KB. Otherwise blocks of 128 points, a thread a point; K3 keeps
    its first ``chunk`` layers (tau and B) in shared memory for the up
    march, within an eighth. ``blocks`` = ceil(N / block_points)."""
    if kind not in ("olr", "monoflux"):
        raise ValueError(f"no march kernel {kind!r}")
    if L < 1 or N < 1 or not 1 <= nst <= MAX_STREAMS:
        raise ValueError(f"no march plan for L={L}, N={N}, {nst} streams")
    mono = kind == "monoflux"
    spread = N < SMS * SPREAD_BELOW
    if spread:
        P, slices = SPREAD_POINTS, nst + mono
        # floats a block: tau, 1/tau and B rows (3 chunk + 1) and the
        # weighted intensities (K3: chunk x slices, with I_surf; K2: slices)
        per_layer, fixed = (3 + slices, 2) if mono else (3, 1 + slices)
        chunk = min(L, (SPREAD_SHARED // (4 * P) - fixed) // per_layer)
        shared = 4 * P * (per_layer * chunk + fixed)
    else:
        P, slices = POINT_THREADS, 1
        chunk = min(L, POINT_SHARED // (8 * P)) if mono else 0
        shared = 8 * P * chunk
    return dict(spread=spread, block_points=P, slices=slices, threads=P * slices, chunk=chunk,
                shared=shared, blocks=-(-N // P))


def kernel_info(kind: str, L: int, N: int, nst: int, lib=None) -> dict:
    """The plan of a launch at (L, N, nst) with the build's registers and
    local (spill) bytes a thread and its resident blocks and warps an SM (of
    64), from ``lib`` (default: the port's library)."""
    plan = march_plan(kind, L, N, nst)
    lib = lib or load_library("march")
    fn = lib.march_kernel_info
    fn.argtypes = [_I, _I, _I, _I, ctypes.c_longlong, _P]
    fn.restype = _I
    out = (_I * 3)()
    err = fn(int(kind == "monoflux"), int(plan["spread"]), nst, plan["threads"],
             plan["shared"], ctypes.cast(out, _P))
    if err != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed: CUDA error {err}")
    return dict(plan, registers=out[0], local_bytes=out[1], blocks_per_sm=out[2],
                resident_warps=out[2] * plan["threads"] // 32)


def _plan_args(kind, L, N, nst):
    p = march_plan(kind, L, N, nst)
    return [int(p["spread"]), p["block_points"], p["chunk"], p["shared"]]


def _library(symbol: str, argtypes):
    lib = load_library("march")
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        if lib.march_max_streams() != MAX_STREAMS:
            raise RuntimeError("csrc/march.cu and this wrapper disagree on the stream count")
        fn.argtypes = argtypes
        fn.restype = _I
    return fn


def _streams(m, W):
    m = np.ascontiguousarray(m, dtype=np.float32)
    W = np.ascontiguousarray(W, dtype=np.float32)
    if m.ndim != 1 or m.shape != W.shape or not 1 <= len(m) <= MAX_STREAMS:
        raise ValueError(f"the march kernels take 1..{MAX_STREAMS} streams (m, W)")
    return m, W


def _column_shape(tau, B):
    if tau.dim() != 2 or tau.shape[0] < 1 or not 1 <= tau.shape[1] < 2**31:
        raise ValueError("tau must be [L, n_nu] with at least one layer and one point")
    return tau.shape


def olr_march(tau, B, m, W):
    """Outgoing flux at the top [n_nu]: surface Planck marched up, sum_k W_k I_k.

    ``tau`` [L, n_nu] per-layer vertical optical depth, ``B`` [L+1, n_nu]
    level Planck (row 0 = top), ``m``/``W`` the stream slants and weights.
    CUDA tensors run K2, differentiable as the plain ``discretized._olr_march``
    is; CPU tensors take that plain version.
    """
    from .discretized import _olr_march

    if not twin.kernel_path(tau):
        return _olr_march(tau, B, m, W)
    return twin.with_twin(lambda t, b: _olr_launch(t, b, m, W),
                          lambda t, b: _olr_march(t, b, m, W), tau, B)


def _olr_launch(tau, B, m, W):
    """K2 on the card into a new [n_nu]."""
    if tau.device.type != "cuda":
        raise ValueError(f"no march kernel for device {tau.device}")
    m, W = _streams(m, W)
    L, N = _column_shape(tau, B)
    dev = tau.device
    check_operand("tau", tau, (L, N), dev)
    check_operand("B", B, (L + 1, N), dev)
    out = torch.empty(N, dtype=torch.float32, device=dev)
    fn = _library("olr_launch", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_longlong,
                                 _P, _P])
    err = fn(tau.data_ptr(), B.data_ptr(), m.ctypes.data, W.ctypes.data, len(m),
             L, N, *_plan_args("olr", L, N, len(m)), out.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"OLR march kernel launch failed: CUDA error {err}")
    profiling.counters["launch.march.olr"] += 1
    return out


def monoflux_march(tau, B, S_nu, albedo_nu, ctheta: float, m, W):
    """(M_up, M_down) [L+1, n_nu]: the whole-column march with the stellar beam.

    Same contract as ``clearsky_tpu.rt.march_pallas.monoflux_pallas``;
    ``ctheta`` is cos(stellar zenith angle). CUDA tensors run K3,
    differentiable (in tau, B, S_nu and albedo_nu) as the plain
    ``discretized._monoflux_march`` is; CPU tensors take that plain version.
    """
    from .discretized import _monoflux_march

    if not twin.kernel_path(tau):
        return _monoflux_march(tau, B, S_nu, albedo_nu, ctheta, m, W)
    return twin.with_twin(lambda *x: _monoflux_launch(*x, ctheta, m, W),
                          lambda *x: _monoflux_march(*x, ctheta, m, W), tau, B, S_nu, albedo_nu)


def _monoflux_launch(tau, B, S_nu, albedo_nu, ctheta, m, W):
    """K3 on the card into new (M_up, M_down)."""
    if tau.device.type != "cuda":
        raise ValueError(f"no march kernel for device {tau.device}")
    m, W = _streams(m, W)
    L, N = _column_shape(tau, B)
    dev = tau.device
    check_operand("tau", tau, (L, N), dev)
    check_operand("B", B, (L + 1, N), dev)
    check_operand("S_nu", S_nu, (N,), dev)
    check_operand("albedo_nu", albedo_nu, (N,), dev)
    ctheta = float(ctheta)
    if not 0.0 < ctheta <= 1.0:  # NaN fails too
        raise ValueError(f"cos(stellar zenith angle) must be in (0, 1], not {ctheta}")
    M_up = torch.empty((L + 1, N), dtype=torch.float32, device=dev)
    M_down = torch.empty((L + 1, N), dtype=torch.float32, device=dev)
    fn = _library("monoflux_launch",
                  [_P, _P, _P, _P, ctypes.c_float, _P, _P, _I, _I, _I, _I, _I, _I,
                   ctypes.c_longlong, _P, _P, _P])
    err = fn(tau.data_ptr(), B.data_ptr(), S_nu.data_ptr(), albedo_nu.data_ptr(),
             ctheta, m.ctypes.data, W.ctypes.data, len(m), L, N,
             *_plan_args("monoflux", L, N, len(m)), M_up.data_ptr(), M_down.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flux march kernel launch failed: CUDA error {err}")
    profiling.counters["launch.march.monoflux"] += 1
    return M_up, M_down

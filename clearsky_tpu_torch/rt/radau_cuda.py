"""Wrapper of the adaptive Radau kernel (``csrc/radau.cu``).

The kernel counterparts no ``pallas_call``: it is the adaptive engine that
the JAX package runs as an XLA ``lax.while_loop`` over every lane
(``clearsky_tpu/utils/radau.py::radau_scalar`` :104 and ``radau_dense``
:305, on ``clearsky_tpu/rt/radau.py``'s right-hand sides). One CUDA thread
integrates one (column, stream, wavenumber) lane; a leg of the flux core is
one launch (the source note of ``csrc/radau.cu``).

:func:`radau_leg` launches it for CUDA tensors and takes the plain engine
(``rt.radau._plain_leg``, masked tensor arithmetic over every lane) for CPU
tensors. On CUDA it checks device, dtype (float32), shape and contiguity and
raises on anything the kernel does not take; there is no fallback. Its
derivatives are the plain engine's (:func:`..utils.twin.with_twin`), as JAX
differentiates its ``while_loop``. The launches count in
``utils.profiling.counters`` by right-hand side (``launch.radau.emission``,
``launch.radau.depth``); the last launch's accepted steps and attempts per
lane are ``radau_leg.last``. While a ``torch.profiler`` records, the kernel
also adds its lanes' steps and attempts, a warp's at a time, to the
registry's device counters ``radau.steps`` and ``radau.attempts``
(:func:`..utils.profiling.device_counters`): no device operation of its
own.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils.cuda_build import check_operand, load_library
from ..utils import profiling, twin
from ..utils import radau as _engine

__all__ = ["radau_leg", "kernel_info", "method_constants", "MAX_STREAMS", "BLOCK"]

MAX_STREAMS = 8   # csrc/radau.cu ``MAX_STREAMS``
BLOCK = 128       # threads a block, one lane each
_RHS = {"emission": 0, "depth": 1}
WORK_COUNTERS = ("radau.steps", "radau.attempts")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def method_constants(rtol: float, g: float) -> tuple[np.ndarray, np.ndarray]:
    """What the kernel takes: 36 float32 numbers and the three collocation
    nodes in float64 (the positions'). The numbers: E, T, TI, the
    eigenvalues, rtol and the Newton tolerance, 1e-4 N_A / g and the Planck
    constants (the 29 the first design read), then the nodes C, 1 / mu_r, the
    safety factor 0.9 (2 ni + 1) / (2 ni + nit) at nit = 1 and 2 (ni =
    ``NEWTON_ITERS``) and the controller's factor of an error at its floor,
    (1e-12)^(-1/4); each the plain engine's float32 value
    (``utils.radau``)."""
    from ..constants import C2_RADIATION, C_LIGHT, H_PLANCK
    from .radau import NEWTON_ITERS, _konst

    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    r = f32(rtol)
    eps = torch.finfo(torch.float32).eps
    newton_tol = torch.maximum(_engine._rdiv(10.0 * eps, r), torch.clamp(torch.sqrt(r), max=0.03))
    vals = np.concatenate([_engine._E, _engine._T.ravel(), _engine._TI.ravel(),
                           [_engine._MU_REAL, _engine._MU_C_RE, _engine._MU_C_IM]])
    ni = NEWTON_ITERS
    safety = [_engine._rdiv(0.9 * (2.0 * ni + 1.0), f32(2.0 * ni + nit)) for nit in (1, 2)]
    derived = [*_engine._C, float(1.0 / f32(_engine._MU_REAL)), *map(float, safety),
               float(torch.clamp(f32(0.0), min=1e-12) ** -0.25)]
    out = np.concatenate([vals.astype(np.float32),
                          np.array([float(r), float(newton_tol)], np.float32),
                          np.array([_konst(g), 2.0 * H_PLANCK * C_LIGHT**2, C2_RADIATION],
                                   np.float32),
                          np.array(derived, np.float32)])
    return np.ascontiguousarray(out), np.ascontiguousarray(_engine._C, dtype=np.float64)


def _library():
    """(``radau_launch``, whether it takes the work counters' pointer): a
    library built from an earlier tree's source (``tools/radau_probe.py
    --against``) exports no ``radau_counts_work`` and takes none."""
    lib = load_library("radau")
    fn = lib.radau_launch
    counts = hasattr(lib, "radau_counts_work")
    if fn.argtypes is None:
        if lib.radau_max_streams() != MAX_STREAMS:
            raise RuntimeError("csrc/radau.cu and this wrapper disagree on its constants")
        fn.argtypes = [_I, _I, _LL, _I, _I, _I, _I, _I, _P, _P, _P, _I, _I, _P, _P, _P, _P,
                       _LL, _P, _P, _P, _P, _P, _P, _P] + [_P] * counts + [_P]
        fn.restype = _I
    return fn, counts


def kernel_info(rhs: str, lib=None) -> dict:
    """Registers and local (spill) bytes a thread of the ``rhs`` instance,
    and its resident blocks and warps an SM, from ``lib`` (default: the
    port's library; another build's threads a block are its own)."""
    lib = lib or load_library("radau")
    fn = lib.radau_kernel_info
    fn.argtypes = [_I, _P]
    fn.restype = _I
    out = (_I * 3)()
    err = fn(_RHS[rhs], ctypes.cast(out, _P))
    if err != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed: CUDA error {err}")
    block = lib.radau_block()
    return dict(registers=out[0], local_bytes=out[1], blocks_per_sm=out[2],
                resident_warps=out[2] * block // 32, block=block)


def radau_leg(rhs: str, lnP, Tg, mug, lnsig, nu, m, g: float, atol, y0, xs, *, rtol: float,
              max_steps: int, dense: bool):
    """One leg of the adaptive core over C columns x len(m) streams x n_nu
    lanes (lane = (c len(m) + s) n_nu + j).

    ``lnP`` [npc] ascending; ``Tg``, ``mug`` [C, npc]; ``lnsig`` [1 or C,
    npc, n_nu] (one cache for every column, or one each); ``nu`` [n_nu];
    ``m`` the streams' slants (host); ``atol`` [C]; ``y0`` [C len(m) n_nu];
    ``xs`` [nx] the nodes. Returns y at every node [nx, lanes] (``dense``)
    or at the last [lanes], NaN on a lane that did not reach it within
    ``max_steps`` attempts a segment. CUDA tensors launch the kernel,
    differentiable (in every tensor but ``nu``) as the plain engine is; CPU
    tensors take the plain engine.
    """
    from .radau import _plain_leg

    def plain(lnP, Tg, mug, lnsig, atol, y0, xs):
        return _plain_leg(rhs, lnP, Tg, mug, lnsig, nu, m, g, atol, y0, xs, rtol, max_steps,
                          dense)

    if not twin.kernel_path(y0):
        return plain(lnP, Tg, mug, lnsig, atol, y0, xs)
    return twin.with_twin(
        lambda *a: _launch(rhs, *a[:4], nu, m, g, *a[4:], rtol, max_steps, dense),
        plain, lnP, Tg, mug, lnsig, atol, y0, xs)


radau_leg.last = {}


def _launch(rhs, lnP, Tg, mug, lnsig, nu, m, g, atol, y0, xs, rtol, max_steps, dense):
    """The kernel on the card into new (y, steps, attempts); returns y."""
    from .radau import NEWTON_ITERS

    if y0.device.type != "cuda":
        raise ValueError(f"no Radau kernel for device {y0.device}")
    if rhs not in _RHS:
        raise ValueError(f"no Radau right-hand side {rhs!r}")
    m = np.ascontiguousarray(m, dtype=np.float32)
    ns = len(m)
    if m.ndim != 1 or not 1 <= ns <= MAX_STREAMS:
        raise ValueError(f"the Radau kernel takes 1..{MAX_STREAMS} streams")
    if Tg.dim() != 2 or lnsig.dim() != 3:
        raise ValueError("Tg must be [C, npc] and lnsig [1 or C, npc, n_nu]")
    C, npc = Tg.shape
    n_nu = nu.shape[0]
    L = C * ns * n_nu
    nx = xs.shape[0]
    if npc < 2 or nx < 2 or lnsig.shape[0] not in (1, C) or L >= 2**31:
        raise ValueError(f"no Radau launch for {C} columns of {npc} levels, {nx} nodes, "
                         f"{L} lanes, ln sigma {tuple(lnsig.shape)}")
    dev = y0.device
    check_operand("lnP", lnP, (npc,), dev)
    check_operand("Tg", Tg, (C, npc), dev)
    check_operand("mug", mug, (C, npc), dev)
    check_operand("lnsig", lnsig, (lnsig.shape[0], npc, n_nu), dev)
    check_operand("nu", nu, (n_nu,), dev)
    check_operand("atol", atol, (C,), dev)
    check_operand("y0", y0, (L,), dev)
    check_operand("xs", xs, (nx,), dev)
    consts, nodes = method_constants(rtol, g)
    y = torch.empty((nx, L) if dense else (L,), dtype=torch.float32, device=dev)
    steps = torch.empty(L, dtype=torch.int32, device=dev)
    attempts = torch.empty(L, dtype=torch.int32, device=dev)
    sig_stride = 0 if lnsig.shape[0] == 1 else npc * n_nu
    fn, counts = _library()
    work = ()
    if counts:
        # made (zeroed) at the first launch, outside a profile as a rule, so a
        # traced launch adds no device operation; passed only while traced
        buf = profiling.device_counters(WORK_COUNTERS, dev)
        work = (buf.data_ptr() if profiling.recording() else None,)
    err = fn(_RHS[rhs], int(dense), L, C, ns, n_nu, npc, nx, consts.ctypes.data,
             nodes.ctypes.data, m.ctypes.data, NEWTON_ITERS, int(max_steps),
             lnP.data_ptr(), Tg.data_ptr(), mug.data_ptr(), lnsig.data_ptr(),
             sig_stride, nu.data_ptr(),
             atol.data_ptr(), y0.data_ptr(), xs.data_ptr(), y.data_ptr(),
             steps.data_ptr(), attempts.data_ptr(), *work,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"Radau kernel launch failed: CUDA error {err}")
    profiling.counters["launch.radau." + rhs] += 1
    radau_leg.last = {"rhs": rhs, "steps": steps, "attempts": attempts, "lanes": L,
                      "columns": C, "streams": ns, "nodes": nx}
    return y

"""Wrapper of the CUDA line-sum kernel (K1, ``csrc/linesum.cu``).

The kernel replaces ``clearsky_tpu/ops/linesum_pallas.py::
_kernel_resident_grouped`` (split and single-sweep modes). Before the launch
the per-(state, line) profile coefficients are computed here in plain torch
on the device, as ``_grouped_pack`` does in XLA, and packed per tile of
``ST`` states so that each block streams one contiguous run of them through
shared memory.

:func:`sigma_lines` launches the kernel for CUDA tensors and takes the plain
version, :func:`..linesum.sigma_from_lines`, for CPU tensors. On CUDA it
checks device, dtype (float32), shape and contiguity and raises on anything
the kernel does not take; there is no fallback.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..utils.cuda_build import check_operand, load_library
from .linesum import LineWindowPlan, _line_params, sigma_from_lines

__all__ = ["sigma_lines", "pack_coefficients", "near_distance", "MODES"]

# kernel modes (csrc/linesum.cu ``Mode``) and coefficients per state: voigt
# runs the split mode, lorentz and doppler the single sweep
MODES = {"voigt": 0, "lorentz": 1, "doppler": 2}
_N_COEF = {0: 7, 1: 3, 2: 3}
ST = 8  # states per tile; csrc/linesum.cu ``ST``

_INV_SQRT_PI = 1.0 / math.sqrt(math.pi)
_P = ctypes.c_void_p
_I = ctypes.c_int


def _mode(shape: str) -> int:
    if shape not in MODES:
        raise ValueError(f"the line-sum kernel has no shape {shape!r}")
    return MODES[shape]


def pack_coefficients(mode: int, S, alpha, gamma):
    """Per-(state, line) coefficients [n_tiles, n_lines, ST * n_coef].

    Voigt packs (Sia, ia, y0) = (S ia / sqrt(pi), 1/alpha, gamma/alpha) and
    the far-wing (A, c1, c2, k2) = (ia^2, 0.5 + y0^2, 4 y0^2 A,
    S gamma A / pi), with which Humlicek region 1 in D = dnu^2 is
    k2 (c1 + m) / ((c1 - m)^2 + c2 D), m = D A (``_grouped_pack``). Lorentz
    and Doppler pack (S, alpha, gamma). States past the last are padded with
    coefficients whose contribution is exactly zero.
    """
    n_states, n_lines = S.shape
    if mode == MODES["voigt"]:
        ia = 1.0 / alpha
        y0 = gamma * ia
        A = ia * ia
        y2 = y0 * y0
        rows = [(S * ia * _INV_SQRT_PI, 0.0), (ia, 1.0), (y0, 1.0), (A, 1.0),
                (0.5 + y2, 1.5), (4.0 * y2 * A, 4.0), (S * gamma * A * (1.0 / math.pi), 0.0)]
    else:
        rows = [(S, 0.0), (alpha, 1.0), (gamma, 1.0)]
    n_tiles = -(-n_states // ST)
    pad = n_tiles * ST - n_states
    cols = []
    for vals, fill in rows:
        if pad:
            vals = torch.cat([vals, vals.new_full((pad, n_lines), fill)])
        cols.append(vals)
    pack = torch.stack(cols, dim=-1)                       # [n_st_pad, n_lines, nc]
    pack = pack.view(n_tiles, ST, n_lines, len(rows)).permute(0, 2, 1, 3)
    return pack.reshape(n_tiles, n_lines, ST * len(rows)).contiguous()


def near_distance(alpha, cut: float):
    """d_near = min(15 max(alpha), cut) as a one-element tensor.

    At |dnu| > d_near every line's |x| = |dnu|/alpha >= 15, where Humlicek
    region 1 is the w4 value. The catalog holds only real lines (no padding
    sentinel), so the maximum runs over all of them.
    """
    return torch.clamp(15.0 * alpha.max(), max=cut).reshape(1).contiguous()


def _library():
    lib = load_library("linesum")
    fn = lib.linesum_launch
    if fn.argtypes is None:
        # the coefficient layout is shared with the C side: hold it to it
        layout = (lib.linesum_states_per_tile(),
                  {m: lib.linesum_coef_per_state(m) for m in _N_COEF})
        if layout != (ST, _N_COEF):
            raise RuntimeError(f"csrc/linesum.cu packs {layout}, this wrapper {(ST, _N_COEF)}")
        fn.argtypes = [_I, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_float,
                       _I, _I, _I, _I, _I, _P, _P]
        fn.restype = _I
    return fn


def _prepare(plan: LineWindowPlan, lines, T, P, Pp, shape: str):
    """Check K1's operands on the card and build its coefficient pack.

    Returns the launch: a function of no arguments that runs the kernel into
    a new sigma[n_states, n_nu] and returns it, so that a caller can time
    the launch apart from the pack. Raises on anything the kernel does not
    take (device, float32, shape, contiguity).
    """
    if T.device.type != "cuda":
        raise ValueError(f"no line-sum kernel for device {T.device}")
    mode = _mode(shape)
    dev = T.device
    if T.dim() != 1:
        raise ValueError("the kernel wrapper takes flat state batches [n_states]")
    n_states = T.shape[0]
    n_lines = lines.n_lines
    for name, x in (("T", T), ("P", P), ("Pp", Pp)):
        check_operand(name, x, (n_states,), dev)
    for name in ("nu", "nu_lo", "S", "ga", "gs", "Epp", "na", "mu"):
        check_operand(f"lines.{name}", getattr(lines, name), (n_lines,), dev)
    if plan.block > 1024:
        raise ValueError(f"plan block {plan.block} exceeds 1024 threads")
    if int((plan.start + plan.count).max(initial=0)) > n_lines:
        raise ValueError("the plan's line windows exceed the catalog: plan and lines differ")
    arrs = plan.device_arrays(dev)
    S, alpha, gamma = _line_params(lines, T, P, Pp)
    coef = pack_coefficients(mode, S, alpha, gamma)
    d_near = near_distance(alpha, plan.cut) if mode == MODES["voigt"] else None

    def launch():
        out = torch.empty((n_states, plan.n_nu), dtype=torch.float32, device=dev)
        if n_states == 0 or n_lines == 0:
            return out.zero_()
        err = _library()(
            mode, arrs["nu_hi"].data_ptr(), arrs["nu_lo"].data_ptr(),
            lines.nu.data_ptr(), lines.nu_lo.data_ptr(), coef.data_ptr(),
            arrs["start"].data_ptr(), arrs["count"].data_ptr(),
            None if d_near is None else d_near.data_ptr(), float(plan.cut),
            plan.n_blocks, plan.block, n_lines, n_states, plan.n_nu,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"line-sum kernel launch failed: CUDA error {err}")
        sigma_lines.launches += 1
        return out

    return launch


def sigma_lines(plan: LineWindowPlan, lines, T, P, Pp, shape: str = "voigt"):
    """sigma[n_states, n_nu] for flat state batches T, P, Pp [n_states].

    CUDA tensors: the K1 kernel, in its split mode for voigt and its single
    sweep for lorentz and doppler. CPU tensors: the plain
    :func:`sigma_from_lines`.
    """
    if T.device.type == "cpu":
        return sigma_from_lines(plan, lines, T, P, Pp, shape)
    return _prepare(plan, lines, T, P, Pp, shape)()


sigma_lines.launches = 0

"""Wrappers of the CUDA line-sum kernels (K1 and the near-core correction,
``csrc/linesum.cu``).

K1 replaces ``clearsky_tpu/ops/linesum_pallas.py::_kernel_resident_grouped``
in every mode: split (voigt) and single sweep (lorentz, doppler) over the
plan's windows, and the windowed modes of the voigt routes, FARALL
(stencil-near) and FINE, FINE_STENCIL and COARSE (coarse-far split).
``stencil_correction`` replaces the XLA-side ``_stencil_apply``. Before a
launch the per-(state, line) profile coefficients are computed here in
plain torch on the device, as ``_grouped_pack`` does in XLA, and packed per
tile of ``ST`` states so that each block streams one contiguous run of them
through shared memory.

:func:`sigma_lines` (split mode), :func:`sigma_stencil` and
:func:`sigma_coarse` are the three routes; :func:`sigma_routed` takes the
one that :func:`.linesum_strategies.route` picks. Each launches the kernels
for CUDA tensors and takes its plain version for CPU tensors. On CUDA the
operands are checked for device, dtype (float32), shape and contiguity, and
anything the kernels do not take raises; there is no fallback to a plain
version or to another route.

Launch counts: ``sigma_lines.launches`` counts every K1 launch and
``sigma_lines.launches_by_mode`` each mode's; ``stencil_correction.launches``
the correction's.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.cuda_build import check_operand, load_library
from .linesum import LineWindowPlan, _line_params, sigma_from_lines, two_float, voigt_coefficients
from .linesum_strategies import (
    _resolve,
    coarse_geometry,
    far_from_coarse,
    sigma_coarse_plain,
    sigma_stencil_plain,
    stencil_correction_plain,
    stencil_geometry,
)

__all__ = ["sigma_lines", "sigma_stencil", "sigma_coarse", "sigma_routed",
           "stencil_correction", "launch_mode", "pack_coefficients", "near_distance",
           "MODES", "WINDOW_MODES"]

# kernel modes (csrc/linesum.cu ``Mode``): over the plan's windows, voigt
# runs the split mode and lorentz and doppler the single sweep; the routes
# run the windowed modes
MODES = {"voigt": 0, "lorentz": 1, "doppler": 2}
WINDOW_MODES = {"farall": 3, "fine": 4, "fine_stencil": 5, "coarse": 6}
_MODE_NAMES = {0: "voigt_split", 1: "lorentz", 2: "doppler", 3: "farall", 4: "fine",
               5: "fine_stencil", 6: "coarse"}
_N_COEF = {m: (3 if m in (1, 2) else 7) for m in _MODE_NAMES}
_N_WIN = {m: (3 if m in (4, 5) else 1) for m in _MODE_NAMES}
ST = 8  # states per tile; csrc/linesum.cu ``ST``

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _mode(shape: str) -> int:
    if shape not in MODES:
        raise ValueError(f"the line-sum kernel has no shape {shape!r}")
    return MODES[shape]


def pack_coefficients(mode: int, S, alpha, gamma):
    """Per-(state, line) coefficients [n_tiles, n_lines, ST * n_coef].

    Every voigt mode packs :func:`.linesum.voigt_coefficients`, (Sia, ia,
    y0, A, c1, c2, k2); lorentz and doppler pack (S, alpha, gamma). States
    past the last are padded with coefficients whose contribution is
    exactly zero.
    """
    n_states, n_lines = S.shape
    if _N_COEF[mode] == 7:
        rows = list(zip(voigt_coefficients(S, alpha, gamma),
                        (0.0, 1.0, 1.0, 1.0, 1.5, 4.0, 0.0)))
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


def near_distance(alpha, limit: float):
    """d_near = min(15 max(alpha), limit) as a one-element tensor.

    At |dnu| > d_near every line's |x| = |dnu|/alpha >= 15, where Humlicek
    region 1 is the w4 value. The limit is the cut (split mode) or the mid
    zone's 2 d_far (FINE). The catalog holds only real lines (no padding
    sentinel), so the maximum runs over all of them.
    """
    return torch.clamp(15.0 * alpha.max(), max=limit).reshape(1).contiguous()


def _library():
    lib = load_library("linesum")
    fn = lib.linesum_launch
    if fn.argtypes is None:
        # the coefficient and window layouts are shared with the C side:
        # hold them to it
        layout = (lib.linesum_states_per_tile(),
                  {m: lib.linesum_coef_per_state(m) for m in _N_COEF},
                  {m: lib.linesum_windows_per_block(m) for m in _N_WIN})
        if layout != (ST, _N_COEF, _N_WIN):
            raise RuntimeError(f"csrc/linesum.cu packs {layout}, this wrapper "
                               f"{(ST, _N_COEF, _N_WIN)}")
        fn.argtypes = [_I, _P, _P, _P, _P, _P, _P, _P, ctypes.POINTER(_F),
                       _I, _I, _I, _I, _I, _P, _P]
        fn.restype = _I
        cor = lib.stencil_correction_launch
        cor.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _F, _F, _P, _P]
        cor.restype = _I
    return lib


def _zones(cut, cut_f=0.0, d_lo=0.0, D1=0.0, D2=1.0, R1=0.0, R2=1.0):
    """The kernel's ``Zones`` as float[7]; the switch widths go as
    reciprocals computed in float64, as the TPU kernel folds them."""
    vals = (cut, cut_f, d_lo, D1, 1.0 / (D2 - D1), R1, 1.0 / (R2 - R1))
    return (_F * 7)(*vals)


def _checked(lines, T, P, Pp):
    """Check the states and the catalog for the kernels; (n_states, dev)."""
    dev = T.device
    if dev.type != "cuda":
        raise ValueError(f"no line-sum kernel for device {dev}")
    if T.dim() != 1:
        raise ValueError("the kernel wrappers take flat state batches [n_states]")
    n_states = T.shape[0]
    for name, x in (("T", T), ("P", P), ("Pp", Pp)):
        check_operand(name, x, (n_states,), dev)
    for name in ("nu", "nu_lo", "S", "ga", "gs", "Epp", "na", "mu"):
        check_operand(f"lines.{name}", getattr(lines, name), (lines.n_lines,), dev)
    return n_states, dev


def _check_windows(windows, n_lines: int):
    if int((windows[:, 0::2] + windows[:, 1::2]).max(initial=0)) > n_lines:
        raise ValueError("the line windows exceed the catalog: plan and lines differ")


def launch_mode(mode: int, grid: dict, lines, coef, n_states: int, n_out: int, zones,
                d_near=None):
    """One K1 launch into a new sigma[n_states, n_out].

    ``grid`` holds the block grid ``nu_hi``/``nu_lo`` (flat, float32,
    n_blocks * block) and the int32 window table ``win``
    [n_blocks, 2 * windows per block] on the device; ``coef`` is the pack of
    :func:`pack_coefficients` for ``mode``; ``zones`` from :func:`_zones`;
    ``d_near`` a one-element tensor for the split and FINE modes.
    """
    win = grid["win"]
    n_blocks, block = win.shape[0], grid["nu_hi"].shape[0] // win.shape[0]
    dev = coef.device
    if tuple(win.shape) != (n_blocks, 2 * _N_WIN[mode]) or win.dtype != torch.int32:
        raise ValueError(f"mode {_MODE_NAMES[mode]} takes an int32 window table "
                         f"[n_blocks, {2 * _N_WIN[mode]}]")
    if block > 1024 or n_blocks * block < n_out:
        raise ValueError(f"a grid of {n_blocks} blocks of {block} points cannot give "
                         f"{n_out} outputs (at most 1024 threads a block)")
    check_operand("coef", coef, (-(-n_states // ST), lines.n_lines, ST * _N_COEF[mode]), dev)
    if (mode in (0, 4)) != (d_near is not None):
        raise ValueError("d_near goes with the split and FINE modes, and only with them")
    if d_near is not None:
        check_operand("d_near", d_near, (1,), dev)
    out = torch.empty((n_states, n_out), dtype=torch.float32, device=dev)
    if n_states == 0 or lines.n_lines == 0:
        return out.zero_()
    err = _library().linesum_launch(
        mode, grid["nu_hi"].data_ptr(), grid["nu_lo"].data_ptr(), lines.nu.data_ptr(),
        lines.nu_lo.data_ptr(), coef.data_ptr(), win.data_ptr(),
        None if d_near is None else d_near.data_ptr(), zones, n_blocks, block,
        lines.n_lines, n_states, n_out, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"line-sum kernel launch failed: CUDA error {err}")
    sigma_lines.launches += 1
    sigma_lines.launches_by_mode[_MODE_NAMES[mode]] += 1
    return out


def _prepare(plan: LineWindowPlan, lines, T, P, Pp, shape: str):
    """Check K1's operands on the card and build its coefficient pack.

    Returns the launch: a function of no arguments that runs the kernel into
    a new sigma[n_states, n_nu] and returns it, so that a caller can time
    the launch apart from the pack. Raises on anything the kernel does not
    take (device, float32, shape, contiguity).
    """
    mode = _mode(shape)
    n_states, dev = _checked(lines, T, P, Pp)
    _check_windows(plan.windows(), lines.n_lines)
    grid = plan.device_arrays(dev)
    S, alpha, gamma = _line_params(lines, T, P, Pp)
    coef = pack_coefficients(mode, S, alpha, gamma)
    d_near = near_distance(alpha, plan.cut) if mode == MODES["voigt"] else None
    zones = _zones(plan.cut)
    return lambda: launch_mode(mode, grid, lines, coef, n_states, plan.n_nu, zones, d_near)


def sigma_lines(plan: LineWindowPlan, lines, T, P, Pp, shape: str = "voigt"):
    """sigma[n_states, n_nu] over the plan's windows, flat states [n_states].

    CUDA tensors: K1 in its split mode for voigt and its single sweep for
    lorentz and doppler. CPU tensors: the plain :func:`sigma_from_lines`.
    """
    if T.device.type == "cpu":
        return sigma_from_lines(plan, lines, T, P, Pp, shape)
    return _prepare(plan, lines, T, P, Pp, shape)()


sigma_lines.launches = 0
sigma_lines.launches_by_mode = dict.fromkeys(_MODE_NAMES.values(), 0)


def _stencil_arrays(geom, dev):
    got = geom._on_device.get(dev)
    if got is None:
        got = geom._on_device[dev] = {
            "dnu_hi": torch.as_tensor(geom.dnu_hi, device=dev),
            "dnu_lo": torch.as_tensor(geom.dnu_lo, device=dev),
            "q": torch.as_tensor(geom.q, dtype=torch.int32, device=dev),
        }
    return got


def stencil_correction(out, geom, co, cut: float, weight=None):
    """Add the near-core correction of the stencil geometry ``geom`` into
    ``out`` [n_states, n_nu] in place, and return ``out``.

    ``co`` are the :func:`.linesum.voigt_coefficients` [n_states, n_lines]
    (the kernel reads Sia, ia, y0); ``weight`` = (D1, D2) multiplies by the
    coarse split's 1 - W(dnu^2). CUDA tensors: the correction kernel, whose
    atomic adds change the summation order from run to run. CPU tensors:
    :func:`.linesum_strategies.stencil_correction_plain`.
    """
    n_states, n_nu = out.shape
    if out.device.type == "cpu":
        out += stencil_correction_plain(geom, co, cut, n_nu, weight)
        return out
    dev = out.device
    n_lines = geom.q.shape[0]
    check_operand("out", out, (n_states, n_nu), dev)
    for name, x in zip(("Sia", "ia", "y0"), co[:3]):
        check_operand(name, x, (n_states, n_lines), dev)
    arr = _stencil_arrays(geom, dev)
    D1, D2 = weight if weight is not None else (0.0, 1.0)
    err = _library().stencil_correction_launch(
        arr["dnu_hi"].data_ptr(), arr["dnu_lo"].data_ptr(), arr["q"].data_ptr(),
        co[0].data_ptr(), co[1].data_ptr(), co[2].data_ptr(), geom.K, n_lines, n_states,
        n_nu, float(cut), int(weight is not None), float(D1), 1.0 / (D2 - D1),
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"stencil correction launch failed: CUDA error {err}")
    stencil_correction.launches += 1
    return out


stencil_correction.launches = 0


def _route_operands(lines, T, P, Pp, n_windows_table):
    n_states, dev = _checked(lines, T, P, Pp)
    _check_windows(n_windows_table, lines.n_lines)
    S, alpha, gamma = _line_params(lines, T, P, Pp)
    co = tuple(c.contiguous() for c in voigt_coefficients(S, alpha, gamma))
    coef = pack_coefficients(WINDOW_MODES["farall"], S, alpha, gamma)
    return n_states, dev, alpha, co, coef


def sigma_stencil(plan: LineWindowPlan, lines, T, P, Pp):
    """The stencil-near route, flat states [n_states]: K1's FARALL mode over
    the plan's windows, then the near-core correction. CPU tensors: its
    plain version."""
    if T.device.type == "cpu":
        return sigma_stencil_plain(plan, lines, T, P, Pp)
    geom = stencil_geometry(plan, lines)
    if geom is None:
        raise ValueError("the stencil geometry rejects this grid and catalog")
    n_states, dev, _, co, coef = _route_operands(lines, T, P, Pp, plan.windows())
    out = launch_mode(WINDOW_MODES["farall"], plan.device_arrays(dev), lines, coef,
                      n_states, plan.n_nu, _zones(plan.cut))
    return stencil_correction(out, geom, co, plan.cut)


def _coarse_arrays(geom, dev):
    got = geom._on_device.get(dev)
    if got is None:
        def grid(blocks, windows):
            hi, lo = two_float(blocks)
            return {"nu_hi": torch.as_tensor(hi.reshape(-1), device=dev),
                    "nu_lo": torch.as_tensor(lo.reshape(-1), device=dev),
                    "win": torch.as_tensor(windows, dtype=torch.int32, device=dev)}
        got = geom._on_device[dev] = {"fine": grid(geom.fine_blocks, geom.fine_windows),
                                      "coarse": grid(geom.coarse_blocks, geom.coarse_windows)}
    return got


def sigma_coarse(plan: LineWindowPlan, lines, T, P, Pp, params):
    """The coarse-far route, flat states [n_states], for the split's
    ``params`` (d_far, h, n_cc, c_ratio): on the fine grid K1's FINE_STENCIL
    mode and the weighted correction where the stencil geometry accepts,
    else its FINE mode; K1's COARSE mode on the coarse grid; the far field
    interpolated back in plain torch. CPU tensors: its plain version."""
    if T.device.type == "cpu":
        return sigma_coarse_plain(plan, lines, T, P, Pp, params)
    geom = coarse_geometry(plan, lines, params)
    n_states, dev, alpha, co, coef = _route_operands(
        lines, T, P, Pp, geom.coarse_windows)
    _check_windows(geom.fine_windows, lines.n_lines)
    arrs = _coarse_arrays(geom, dev)
    z = geom.zones
    zones = _zones(**z)
    if geom.stencil is not None:
        fine = launch_mode(WINDOW_MODES["fine_stencil"], arrs["fine"], lines, coef, n_states,
                           plan.n_nu, zones)
        stencil_correction(fine, geom.stencil, co, z["cut"], weight=(z["D1"], z["D2"]))
    else:
        fine = launch_mode(WINDOW_MODES["fine"], arrs["fine"], lines, coef, n_states,
                           plan.n_nu, zones, near_distance(alpha, z["cut_f"]))
    far_c = launch_mode(WINDOW_MODES["coarse"], arrs["coarse"], lines, coef, n_states,
                        geom.params[2], zones)
    return fine + far_from_coarse(far_c, geom)


def sigma_routed(plan: LineWindowPlan, lines, T, P, Pp, shape: str = "voigt",
                 strategy: str = "auto"):
    """sigma[n_states, n_nu] through the route that ``strategy`` gives on
    this plan and catalog (:func:`.linesum_strategies.route`)."""
    name, params = _resolve(plan, lines, shape, strategy)
    if name == "coarse":
        return sigma_coarse(plan, lines, T, P, Pp, params)
    if name == "stencil":
        return sigma_stencil(plan, lines, T, P, Pp)
    return sigma_lines(plan, lines, T, P, Pp, shape)


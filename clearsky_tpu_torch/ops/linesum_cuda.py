"""Wrappers of the CUDA line-sum kernels (K1, K1-seg, K4, K5 and the
near-core correction, ``csrc/linesum.cu``).

K1 replaces ``clearsky_tpu/ops/linesum_pallas.py::_kernel_resident_grouped``
in every mode: split (the Voigt family) and single sweep (lorentz, doppler)
over the plan's windows, and the windowed modes of the routes, FARALL
(stencil-near) and FINE, FINE_STENCIL and COARSE (coarse-far split). Each
Voigt mode has two instances: voigt (and voigt_ref) and phco2 (and
phco2_ref), whose y carries chi(|dnu|, T) with the per-state rates of
:func:`chi_rates`; the *_ref shapes reach the kernels with alpha / sqrt(ln 2)
folded into their coefficients (:func:`.linesum.effective_alpha`).
``stencil_correction`` replaces the XLA-side ``_stencil_apply``. K1-seg
(:func:`sigma_segmented`) runs K1 once per catalog segment, adding in place
(``_pallas_sigma_segmented``); K4 (:func:`sigma_lane`) and K5
(:func:`sigma_gathered`) are the full-profile kernels of the lane and
gathered branches (``_kernel_resident``, ``_kernel``). Before a K1 launch
the per-(state, line) profile coefficients are computed here in plain torch
on the device, as ``_grouped_pack`` does in XLA, and packed per tile of
``ST`` states so that each block streams one contiguous run of them through
shared memory; K4 and K5 take unpacked per-state rows.

:func:`sigma_lines` (split mode), :func:`sigma_stencil`,
:func:`sigma_coarse`, :func:`sigma_segmented`, :func:`sigma_lane` and
:func:`sigma_gathered` are the routes; :func:`sigma_routed` takes the one
that :func:`.linesum_strategies.route` picks. Each launches the kernels
for CUDA tensors and takes its plain version for CPU tensors. On CUDA the
operands are checked for device, dtype (float32), shape and contiguity, and
anything the kernels do not take raises; there is no fallback to a plain
version or to another route.

Every wrapper takes per-line concentrations ``conc`` ([n_lines] or
[n_states, n_lines]), folded into S and gamma before the pack, so no kernel
sees them.

Launch counts: ``sigma_lines.launches`` counts every launch of K1, K4 and
K5 and ``sigma_lines.launches_by_mode`` each mode's (the phco2 instances
under "phco2_..."), K1-seg's launches (one per segment) under "segmented",
K4's under "lane" and K5's under "gathered" ("phco2_segmented",
"phco2_lane", "phco2_gathered" for the phco2 family);
``stencil_correction.launches`` the correction's voigt instance and
``stencil_correction.launches_phco2`` its phco2 one.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.cuda_build import check_operand, load_library
from .linesum import (
    PHCO2_FAMILY,
    LineWindowPlan,
    _line_params,
    effective_alpha,
    sigma_from_lines,
    two_float,
    voigt_coefficients,
)
from .linesum_strategies import (
    CHUNK,
    _resolve,
    chi_T,
    _slice_lines,
    coarse_geometry,
    far_from_coarse,
    gathered_slabs,
    lane_layout,
    segments,
    sigma_coarse_plain,
    sigma_gathered_plain,
    sigma_lane_plain,
    sigma_segmented_plain,
    sigma_stencil_plain,
    split_check,
    stencil_correction_plain,
    stencil_geometry,
)

__all__ = ["sigma_lines", "sigma_stencil", "sigma_coarse", "sigma_segmented", "sigma_lane",
           "sigma_gathered", "sigma_routed", "stencil_correction", "launch_mode",
           "launch_fullprofile", "pack_coefficients", "near_distance", "chi_rates",
           "window_mode", "gather_group", "MODES", "WINDOW_MODES", "GATHER_BYTES"]

# kernel modes (csrc/linesum.cu ``Mode``): over the plan's windows, voigt
# and phco2 run the split mode and lorentz and doppler the single sweep; the
# routes run the windowed modes, whose phco2 instances are
# PHCO2_WINDOW_OFFSET further on
MODES = {"voigt": 0, "lorentz": 1, "doppler": 2, "phco2": 7}
WINDOW_MODES = {"farall": 3, "fine": 4, "fine_stencil": 5, "coarse": 6}
PHCO2_WINDOW_OFFSET = 5
_SHAPE_MODES = dict(MODES, voigt_ref=0, phco2_ref=7)
_MODE_NAMES = {0: "voigt_split", 1: "lorentz", 2: "doppler", 3: "farall", 4: "fine",
               5: "fine_stencil", 6: "coarse", 7: "phco2_split", 8: "phco2_farall",
               9: "phco2_fine", 10: "phco2_fine_stencil", 11: "phco2_coarse"}
_PHCO2_MODES = (7, 8, 9, 10, 11)
_N_COEF = {m: (3 if m in (1, 2) + _PHCO2_MODES else 7) for m in _MODE_NAMES}
_N_WIN = {m: (3 if m in (4, 5, 9, 10) else 1) for m in _MODE_NAMES}
# the modes that take d_near: the split modes and FINE
_D_NEAR_MODES = (0, 4, 7, 9)
# the modes that may add into sigma (K1-seg): split and single sweep
_ACC_MODES = (0, 1, 2, 7)
# launch-count keys of the routes that run K1 per segment and K4/K5
_ROUTE_COUNTS = ("segmented", "lane", "gathered", "phco2_segmented", "phco2_lane",
                 "phco2_gathered")
ST = 8  # states per tile; csrc/linesum.cu ``ST``
# K5's gathered slabs (S, alpha, gamma: 12 bytes a state, block and slab
# line) are built for at most this many bytes of states at a time
GATHER_BYTES = 2**30

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _mode(shape: str) -> int:
    """The split (or single-sweep) mode of ``shape``."""
    if shape not in _SHAPE_MODES:
        raise ValueError(f"the line-sum kernel has no shape {shape!r}")
    return _SHAPE_MODES[shape]


def window_mode(name: str, shape: str) -> int:
    """The instance of the windowed mode ``name`` for the Voigt-family
    ``shape``."""
    return WINDOW_MODES[name] + (PHCO2_WINDOW_OFFSET if shape in PHCO2_FAMILY else 0)


def _family(shape: str) -> str:
    """The launch-count prefix of ``shape``'s family."""
    return "phco2_" if shape in PHCO2_FAMILY else ""


def pack_coefficients(mode: int, S, alpha, gamma):
    """Per-(state, line) coefficients [n_tiles, n_lines, ST * n_coef].

    Every voigt mode packs :func:`.linesum.voigt_coefficients`, (Sia, ia,
    y0, A, c1, c2, k2), every phco2 mode its first three (Sia, ia, y0), on
    the profile's Doppler width ``alpha`` (the *_ref shapes' already divided
    by sqrt(ln 2)); lorentz and doppler pack (S, alpha, gamma). States past
    the last are padded with coefficients whose contribution is exactly
    zero.
    """
    n_states, n_lines = S.shape
    if _N_COEF[mode] == 7:
        rows = list(zip(voigt_coefficients(S, alpha, gamma),
                        (0.0, 1.0, 1.0, 1.0, 1.5, 4.0, 0.0)))
    elif mode in _PHCO2_MODES:
        rows = list(zip(voigt_coefficients(S, alpha, gamma)[:3], (0.0, 1.0, 1.0)))
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


def chi_rates(T):
    """The phco2 family's rates of chi at each state, as the kernels read
    them: [n_tiles, 2, ST] float32, B1 = 0.0888 - 0.16 exp(-0.0041 T) then
    B2 = 0.0526 exp(-0.00152 T) for the tile's ST states (0 past the last
    state), computed in float64 and rounded once."""
    T64 = T.double()
    B = torch.stack([0.0888 - 0.16 * torch.exp(-0.0041 * T64),
                     0.0526 * torch.exp(-0.00152 * T64)])              # [2, n]
    n_tiles = -(-T.shape[0] // ST)
    B = torch.cat([B, B.new_zeros((2, n_tiles * ST - T.shape[0]))], dim=1)
    return B.view(2, n_tiles, ST).permute(1, 0, 2).contiguous().float()


def _check_rates(bcoef, n_states: int, dev):
    check_operand("bcoef", bcoef, (-(-n_states // ST), 2, ST), dev)


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
        fn.argtypes = [_I, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.POINTER(_F),
                       _I, _I, _I, _I, _I, _I, _I, _P, _P]
        fn.restype = _I
        full = lib.fullprofile_launch
        full.argtypes = [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I,
                         _I, _P, _P]
        full.restype = _I
        cor = lib.stencil_correction_launch
        cor.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _F, _F, _P, _P]
        cor.restype = _I
    return lib


def _zones(cut, cut_f=0.0, d_lo=0.0, D1=0.0, D2=1.0, R1=0.0, R2=1.0):
    """The kernel's ``Zones`` as float[7]; the switch widths go as
    reciprocals computed in float64, as the TPU kernel folds them."""
    vals = (cut, cut_f, d_lo, D1, 1.0 / (D2 - D1), R1, 1.0 / (R2 - R1))
    return (_F * 7)(*vals)


def _checked(lines, T, P, Pp, conc=None):
    """Check the states, the concentrations and the catalog for the kernels;
    (n_states, dev)."""
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
    if conc is not None:
        shape = (lines.n_lines,) if conc.dim() == 1 else (n_states, lines.n_lines)
        check_operand("conc", conc, shape, dev)
    return n_states, dev


def _check_windows(windows, n_lines: int):
    if int((windows[:, 0::2] + windows[:, 1::2]).max(initial=0)) > n_lines:
        raise ValueError("the line windows exceed the catalog: plan and lines differ")


def _count(name: str) -> None:
    sigma_lines.launches += 1
    sigma_lines.launches_by_mode[name] += 1


def launch_mode(mode: int, grid: dict, lines, coef, n_states: int, n_out: int, zones,
                d_near=None, out=None, count_as=None, bcoef=None):
    """One K1 launch into a new sigma[n_states, n_out], or added into the
    first n_out columns of ``out``.

    ``grid`` holds the block grid ``nu_hi``/``nu_lo`` (flat, float32,
    n_blocks * block) and the int32 window table ``win``
    [n_blocks, 2 * windows per block] on the device; ``coef`` is the pack of
    :func:`pack_coefficients` for ``mode``; ``zones`` from :func:`_zones`;
    ``d_near`` a one-element tensor for the split and FINE modes; ``bcoef``
    the :func:`chi_rates` of the phco2 modes, and only of them. ``out``
    (the split and single-sweep modes): a float32 [n_states, >= n_out] view
    with unit column stride, added to in place (K1-seg). The launch counts
    under ``count_as``, else under its mode.
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
    if (mode in _D_NEAR_MODES) != (d_near is not None):
        raise ValueError("d_near goes with the split and FINE modes, and only with them")
    if d_near is not None:
        check_operand("d_near", d_near, (1,), dev)
    if (mode in _PHCO2_MODES) != (bcoef is not None):
        raise ValueError("chi's rates go with the phco2 modes, and only with them")
    if bcoef is not None:
        _check_rates(bcoef, n_states, dev)
    accumulate = out is not None
    if accumulate:
        if mode not in _ACC_MODES:
            raise ValueError("only the split and single-sweep modes add into sigma")
        if (out.dtype != torch.float32 or out.device != dev or out.dim() != 2
                or out.shape[0] != n_states or out.shape[1] < n_out or out.stride(1) != 1):
            raise ValueError(f"out must be a float32 [{n_states}, >= {n_out}] view on {dev} "
                             "with unit column stride")
    else:
        out = torch.empty((n_states, n_out), dtype=torch.float32, device=dev)
    if n_states == 0 or lines.n_lines == 0:
        return out if accumulate else out.zero_()
    err = _library().linesum_launch(
        mode, grid["nu_hi"].data_ptr(), grid["nu_lo"].data_ptr(), lines.nu.data_ptr(),
        lines.nu_lo.data_ptr(), coef.data_ptr(), win.data_ptr(),
        None if d_near is None else d_near.data_ptr(),
        None if bcoef is None else bcoef.data_ptr(), zones, n_blocks, block,
        lines.n_lines, n_states, n_out, out.stride(0), int(accumulate), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"line-sum kernel launch failed: CUDA error {err}")
    _count(count_as or _MODE_NAMES[mode])
    return out


def _prepare(plan: LineWindowPlan, lines, T, P, Pp, shape: str, conc=None):
    """Check K1's operands on the card and build its coefficient pack.

    Returns the launch: a function of no arguments that runs the kernel into
    a new sigma[n_states, n_nu] and returns it, so that a caller can time
    the launch apart from the pack. Raises on anything the kernel does not
    take (device, float32, shape, contiguity).
    """
    mode = _mode(shape)
    n_states, dev = _checked(lines, T, P, Pp, conc)
    _check_windows(plan.windows(), lines.n_lines)
    grid = plan.device_arrays(dev)
    S, alpha, gamma = _line_params(lines, T, P, Pp, conc)
    alpha = effective_alpha(shape, alpha)
    coef = pack_coefficients(mode, S, alpha, gamma)
    d_near = near_distance(alpha, plan.cut) if mode in _D_NEAR_MODES else None
    bcoef = chi_rates(T) if mode in _PHCO2_MODES else None
    zones = _zones(plan.cut)
    return lambda: launch_mode(mode, grid, lines, coef, n_states, plan.n_nu, zones, d_near,
                               bcoef=bcoef)


def sigma_lines(plan: LineWindowPlan, lines, T, P, Pp, shape: str = "voigt", conc=None):
    """sigma[n_states, n_nu] over the plan's windows, flat states [n_states].

    CUDA tensors: K1 in its split mode for the Voigt family and its single
    sweep for lorentz and doppler. CPU tensors: the plain
    :func:`sigma_from_lines`.
    """
    if T.device.type == "cpu":
        return sigma_from_lines(plan, lines, T, P, Pp, shape, conc)
    return _prepare(plan, lines, T, P, Pp, shape, conc)()


sigma_lines.launches = 0
sigma_lines.launches_by_mode = dict.fromkeys(tuple(_MODE_NAMES.values()) + _ROUTE_COUNTS, 0)


def _stencil_arrays(geom, dev):
    got = geom._on_device.get(dev)
    if got is None:
        got = geom._on_device[dev] = {
            "dnu_hi": torch.as_tensor(geom.dnu_hi, device=dev),
            "dnu_lo": torch.as_tensor(geom.dnu_lo, device=dev),
            "q": torch.as_tensor(geom.q, dtype=torch.int32, device=dev),
        }
    return got


def stencil_correction(out, geom, co, cut: float, weight=None, T=None):
    """Add the near-core correction of the stencil geometry ``geom`` into
    ``out`` [n_states, n_nu] in place, and return ``out``.

    ``co`` are the :func:`.linesum.voigt_coefficients` [n_states, n_lines]
    (the kernel reads Sia, ia, y0); ``weight`` = (D1, D2) multiplies by the
    coarse split's 1 - W(dnu^2); the states' temperatures ``T`` [n_states]
    (the phco2 family) put chi on y. CUDA tensors: the correction kernel,
    whose atomic adds change the summation order from run to run. CPU
    tensors: :func:`.linesum_strategies.stencil_correction_plain`.
    """
    n_states, n_nu = out.shape
    if out.device.type == "cpu":
        out += stencil_correction_plain(geom, co, cut, n_nu, weight, T)
        return out
    dev = out.device
    n_lines = geom.q.shape[0]
    check_operand("out", out, (n_states, n_nu), dev)
    for name, x in zip(("Sia", "ia", "y0"), co[:3]):
        check_operand(name, x, (n_states, n_lines), dev)
    arr = _stencil_arrays(geom, dev)
    D1, D2 = weight if weight is not None else (0.0, 1.0)
    bcoef = None
    if T is not None:
        check_operand("T", T, (n_states,), dev)
        bcoef = chi_rates(T)
    err = _library().stencil_correction_launch(
        arr["dnu_hi"].data_ptr(), arr["dnu_lo"].data_ptr(), arr["q"].data_ptr(),
        co[0].data_ptr(), co[1].data_ptr(), co[2].data_ptr(),
        None if bcoef is None else bcoef.data_ptr(), geom.K, n_lines, n_states,
        n_nu, float(cut), int(weight is not None), float(D1), 1.0 / (D2 - D1),
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"stencil correction launch failed: CUDA error {err}")
    if T is None:
        stencil_correction.launches += 1
    else:
        stencil_correction.launches_phco2 += 1
    return out


stencil_correction.launches = 0
stencil_correction.launches_phco2 = 0


def _route_operands(lines, T, P, Pp, n_windows_table, conc, shape):
    """Checks and operands of the routes' windowed modes for the Voigt-family
    ``shape``: (n_states, dev, alpha, co, coef, bcoef), alpha the profile's
    Doppler widths, co their :func:`.linesum.voigt_coefficients`, coef the
    family's pack and bcoef its :func:`chi_rates` (phco2) or None."""
    split_check(shape)
    n_states, dev = _checked(lines, T, P, Pp, conc)
    _check_windows(n_windows_table, lines.n_lines)
    S, alpha, gamma = _line_params(lines, T, P, Pp, conc)
    alpha = effective_alpha(shape, alpha)
    co = tuple(c.contiguous() for c in voigt_coefficients(S, alpha, gamma))
    coef = pack_coefficients(window_mode("farall", shape), S, alpha, gamma)
    bcoef = chi_rates(T) if shape in PHCO2_FAMILY else None
    return n_states, dev, alpha, co, coef, bcoef


def sigma_stencil(plan: LineWindowPlan, lines, T, P, Pp, conc=None, shape: str = "voigt"):
    """The stencil-near route of a Voigt-family ``shape``, flat states
    [n_states]: K1's FARALL mode over the plan's windows, then the
    near-core correction. CPU tensors: its plain version."""
    if T.device.type == "cpu":
        return sigma_stencil_plain(plan, lines, T, P, Pp, conc, shape)
    geom = stencil_geometry(plan, lines)
    if geom is None:
        raise ValueError("the stencil geometry rejects this grid and catalog")
    n_states, dev, _, co, coef, bcoef = _route_operands(lines, T, P, Pp, plan.windows(), conc,
                                                        shape)
    out = launch_mode(window_mode("farall", shape), plan.device_arrays(dev), lines, coef,
                      n_states, plan.n_nu, _zones(plan.cut), bcoef=bcoef)
    return stencil_correction(out, geom, co, plan.cut, T=chi_T(shape, T))


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


def sigma_coarse(plan: LineWindowPlan, lines, T, P, Pp, params, conc=None,
                 shape: str = "voigt"):
    """The coarse-far route of a Voigt-family ``shape``, flat states
    [n_states], for the split's ``params`` (d_far, h, n_cc, c_ratio): on the
    fine grid K1's FINE_STENCIL mode and the weighted correction where the
    stencil geometry accepts, else its FINE mode; K1's COARSE mode on the
    coarse grid; the far field interpolated back in plain torch. CPU
    tensors: its plain version."""
    if T.device.type == "cpu":
        return sigma_coarse_plain(plan, lines, T, P, Pp, params, conc, shape)
    geom = coarse_geometry(plan, lines, params)
    n_states, dev, alpha, co, coef, bcoef = _route_operands(
        lines, T, P, Pp, geom.coarse_windows, conc, shape)
    _check_windows(geom.fine_windows, lines.n_lines)
    arrs = _coarse_arrays(geom, dev)
    z = geom.zones
    zones = _zones(**z)
    if geom.stencil is not None:
        fine = launch_mode(window_mode("fine_stencil", shape), arrs["fine"], lines, coef,
                           n_states, plan.n_nu, zones, bcoef=bcoef)
        stencil_correction(fine, geom.stencil, co, z["cut"], weight=(z["D1"], z["D2"]),
                           T=chi_T(shape, T))
    else:
        fine = launch_mode(window_mode("fine", shape), arrs["fine"], lines, coef, n_states,
                           plan.n_nu, zones, near_distance(alpha, z["cut_f"]), bcoef=bcoef)
    far_c = launch_mode(window_mode("coarse", shape), arrs["coarse"], lines, coef, n_states,
                        geom.params[2], zones, bcoef=bcoef)
    return fine + far_from_coarse(far_c, geom)


def _segment_windows(plan: LineWindowPlan, n_lines: int, L_seg: int, dev):
    """(segment, its block grid and int32 window table on ``dev``) for each
    of the catalog's segments (:func:`.linesum_strategies.segments`), cached
    on the plan under the segments' own key and the device."""
    key = (dev, "segments", int(n_lines), int(L_seg))
    got = plan._on_device.get(key)
    if got is None:
        full = plan.device_arrays(dev)
        B = plan.block
        got = plan._on_device[key] = [
            (g, {"nu_hi": full["nu_hi"][g.blo * B: g.bhi * B],
                 "nu_lo": full["nu_lo"][g.blo * B: g.bhi * B],
                 "win": torch.as_tensor(g.windows, dtype=torch.int32, device=dev)})
            for g in segments(plan, n_lines, L_seg)]
    return got


def sigma_segmented(plan: LineWindowPlan, lines, T, P, Pp, L_seg: int, shape: str = "voigt",
                    conc=None):
    """K1-seg, flat states [n_states]: the catalog cut into segments of
    ``L_seg`` lines (:func:`.linesum_strategies.segments`); for each, its own
    coefficient pack and (the Voigt family) its own d_near from its own
    largest Doppler width, and one K1 launch over the blocks its windows
    meet, added in place into one sigma [n_states, n_nu]. CPU tensors: its
    plain version."""
    if T.device.type == "cpu":
        return sigma_segmented_plain(plan, lines, T, P, Pp, L_seg, shape, conc)
    mode = _mode(shape)
    n_states, dev = _checked(lines, T, P, Pp, conc)
    _check_windows(plan.windows(), lines.n_lines)
    if L_seg < 1:
        raise ValueError(f"segments need at least one line, not {L_seg}")
    out = torch.zeros((n_states, plan.n_nu), dtype=torch.float32, device=dev)
    zones = _zones(plan.cut)
    bcoef = chi_rates(T) if mode in _PHCO2_MODES else None
    for seg, grid in _segment_windows(plan, lines.n_lines, L_seg, dev):
        sub = _slice_lines(lines, seg.a, seg.b)
        S, alpha, gamma = _line_params(sub, T, P, Pp,
                                       None if conc is None else conc[..., seg.a:seg.b])
        alpha = effective_alpha(shape, alpha)
        d_near = near_distance(alpha, plan.cut) if mode in _D_NEAR_MODES else None
        launch_mode(mode, grid, sub, pack_coefficients(mode, S, alpha, gamma), n_states,
                    seg.n_out, zones, d_near, out=out[:, seg.blo * plan.block:],
                    count_as=_family(shape) + "segmented", bcoef=bcoef)
    return out


def launch_fullprofile(shape: str, gathered: bool, grid: dict, nu, nu_lo, S, alpha, gamma,
                       start, count, row: int, cut: float, n_out: int, out=None, T=None):
    """One K4 (``gathered`` False) or K5 launch into sigma[n_states, n_out]
    (new, or the contiguous ``out``).

    ``grid``: the plan's ``nu_hi``/``nu_lo`` block grid; ``nu``/``nu_lo``
    the line positions ([row] padded catalog for K4, [n_blocks * row] slabs
    for K5), ``S``/``alpha``/``gamma`` the per-state rows
    ([n_states, len(nu)]; alpha the profile's width, a *_ref shape's
    already divided by sqrt(ln 2)), ``start``/``count`` int32 [n_blocks]
    (K4's aligned window starts; K5 reads only the counts); ``T``
    [n_states] the phco2 family's temperatures, and only theirs.
    """
    dev = S.device
    n_blocks = count.shape[0]
    block = grid["nu_hi"].shape[0] // max(n_blocks, 1)
    n_states = S.shape[0]
    n_pos = n_blocks * row if gathered else row
    if block > 1024 or n_blocks * block != grid["nu_hi"].shape[0] or n_blocks * block < n_out:
        raise ValueError(f"a grid of {n_blocks} blocks cannot give {n_out} outputs")
    for name, x in (("nu", nu), ("nu_lo", nu_lo)):
        check_operand(name, x, (n_pos,), dev)
    for name, x in (("S", S), ("alpha", alpha), ("gamma", gamma)):
        check_operand(name, x, (n_states, n_pos), dev)
    for name, x in (("start", start), ("count", count)):
        if x.dtype != torch.int32 or x.device != dev or tuple(x.shape) != (n_blocks,):
            raise ValueError(f"{name} must be int32 [{n_blocks}] on {dev}")
    if (shape in PHCO2_FAMILY) != (T is not None):
        raise ValueError("T goes with the phco2 family, and only with it")
    bcoef = None
    if T is not None:
        check_operand("T", T, (n_states,), dev)
        bcoef = chi_rates(T)
    if out is None:
        out = torch.empty((n_states, n_out), dtype=torch.float32, device=dev)
    else:
        check_operand("out", out, (n_states, n_out), dev)
    if n_states == 0:
        return out
    err = _library().fullprofile_launch(
        _mode(shape), int(gathered), grid["nu_hi"].data_ptr(), grid["nu_lo"].data_ptr(),
        nu.data_ptr(), nu_lo.data_ptr(), S.data_ptr(), alpha.data_ptr(), gamma.data_ptr(),
        start.data_ptr(), count.data_ptr(), None if bcoef is None else bcoef.data_ptr(), row,
        n_blocks, block, float(cut), n_states, n_out, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"full-profile kernel launch failed: CUDA error {err}")
    _count(_family(shape) + ("gathered" if gathered else "lane"))
    return out


def sigma_lane(plan: LineWindowPlan, lines, T, P, Pp, shape: str = "voigt", conc=None):
    """K4, flat states [n_states]: the full profile over each block's
    CHUNK-aligned window of unpacked per-state rows
    (:func:`.linesum_strategies.lane_layout`). CPU tensors: its plain
    version."""
    if T.device.type == "cpu":
        return sigma_lane_plain(plan, lines, T, P, Pp, shape, conc)
    n_states, dev = _checked(lines, T, P, Pp, conc)
    _check_windows(plan.windows(), lines.n_lines)
    S, alpha, gamma = _line_params(lines, T, P, Pp, conc)
    lay = lane_layout(plan, lines, S, effective_alpha(shape, alpha), gamma)
    win = torch.as_tensor(lay.windows, dtype=torch.int32, device=dev)
    return launch_fullprofile(shape, False, plan.device_arrays(dev), lay.nu, lay.nu_lo, lay.S,
                              lay.alpha, lay.gamma, win[:, 0].contiguous(),
                              win[:, 1].contiguous(), lay.nu.shape[0], plan.cut, plan.n_nu,
                              T=chi_T(shape, T))


def gather_group(plan: LineWindowPlan) -> int:
    """States per K5 launch: the gathered slabs of a group stay within
    :data:`GATHER_BYTES`, in whole tiles of ``ST`` states where that allows."""
    slab_pad = -(-max(1, plan.slab) // CHUNK) * CHUNK
    per_state = 12 * plan.n_blocks * slab_pad
    n = max(1, GATHER_BYTES // per_state)
    return n // ST * ST if n >= ST else n


def sigma_gathered(plan: LineWindowPlan, lines, T, P, Pp, shape: str = "voigt", conc=None):
    """K5, flat states [n_states]: each block's slab gathered by plain
    indexing (:func:`.linesum_strategies.gathered_slabs`), then the full
    profile over it; states in groups of :func:`gather_group`. CPU tensors:
    its plain version."""
    if T.device.type == "cpu":
        return sigma_gathered_plain(plan, lines, T, P, Pp, shape, conc)
    n_states, dev = _checked(lines, T, P, Pp, conc)
    _check_windows(plan.windows(), lines.n_lines)
    grid = plan.device_arrays(dev)
    count = grid["win"][:, 1].contiguous()
    out = torch.empty((n_states, plan.n_nu), dtype=torch.float32, device=dev)
    step = gather_group(plan)
    for a in range(0, n_states, step):
        b = min(a + step, n_states)
        c = None if conc is None or conc.dim() == 1 else conc[a:b]
        S, alpha, gamma = _line_params(lines, T[a:b], P[a:b], Pp[a:b], conc if c is None else c)
        g = gathered_slabs(plan, lines, S, effective_alpha(shape, alpha), gamma)
        launch_fullprofile(shape, True, grid, g.nu, g.nu_lo, g.S, g.alpha, g.gamma, count,
                           count, g.slab_pad, plan.cut, plan.n_nu, out=out[a:b],
                           T=chi_T(shape, T[a:b]))
    return out


def sigma_routed(plan: LineWindowPlan, lines, T, P, Pp, shape: str = "voigt",
                 strategy: str = "auto", conc=None, resident_limit=None):
    """sigma[n_states, n_nu] through the route that ``strategy`` gives for
    this plan, catalog and number of states
    (:func:`.linesum_strategies.route`), with the residency gates at
    ``resident_limit`` bytes (by default the card's L2 cache,
    :func:`.linesum_strategies.resident_budget`)."""
    name, param = _resolve(plan, lines, shape, strategy, T.shape[0], resident_limit)
    if name == "coarse":
        return sigma_coarse(plan, lines, T, P, Pp, param, conc, shape)
    if name == "stencil":
        return sigma_stencil(plan, lines, T, P, Pp, conc, shape)
    if name == "segmented":
        return sigma_segmented(plan, lines, T, P, Pp, param, shape, conc)
    if name == "lane":
        return sigma_lane(plan, lines, T, P, Pp, shape, conc)
    if name == "gathered":
        return sigma_gathered(plan, lines, T, P, Pp, shape, conc)
    return sigma_lines(plan, lines, T, P, Pp, shape, conc)

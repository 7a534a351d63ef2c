"""The port's CUDA kernels (K1 line sum in all its modes and the near-core
correction, K1-seg, the full-profile K4/K5, each for the voigt and the
phco2 family, K2/K3 march, K6/K7 fused table) and their wrappers.

This file imports no JAX, so that it also runs on a machine with a card and
no JAX (pytest then needs ``--noconftest``: tests/conftest.py imports jax):

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Tests marked ``gpu`` launch the kernels and skip without a CUDA card. Each
holds a float32 kernel to the plain PyTorch version in float64 on the same
inputs (line sum, K1-seg, K4 and K5: rtol 2e-3 where |sigma| > 1e-35, the
bar of tests/test_linesum_pallas.py; the windowed modes and the routes: 1e-5 of
each state's peak, float32 accumulation; the correction: 1e-4 of each
state's peak cross-section, float32 rounding amplified next to the
region-1 pole at x^2 = 1/2 + y^2, where the correction is largest, and
atomic adds in no fixed order; march:
3.5e-6 of peak, the float32 class of BASELINE.md; fused table: 1e-4 of
peak for the fluxes and rtol 1e-4 for tau, the bars of chip_smoke.py) and
checks that the wrapper raises on inputs the kernel does not take. The
tests without the marker check the wrappers' CPU path, the build flags and
key, and the float32 precision pin.
"""

import math
import subprocess
import sys

import numpy as np
import pytest
import torch

import clearsky_tpu_torch as ct
from clearsky_tpu_torch.ops import linesum_cuda
from clearsky_tpu_torch.ops import linesum_strategies as ls
from clearsky_tpu_torch.ops.linesum import (
    _line_params,
    build_line_window_plan,
    sigma_from_lines,
    sigma_from_lines_auto,
    two_float,
    voigt_coefficients,
)
from clearsky_tpu_torch.ops.linesum_cuda import sigma_lines, stencil_correction
from clearsky_tpu_torch.rt import discretized as td
from clearsky_tpu_torch.rt import march_cuda
from clearsky_tpu_torch.rt.march_cuda import olr_march, monoflux_march
from clearsky_tpu_torch.rt import fused_table as tft
from clearsky_tpu_torch.rt.fused_table_cuda import fused_olr, fused_monoflux
from clearsky_tpu_torch.utils import cuda_build
from clearsky_tpu_torch.utils.quadrature import stream_nodes

# the suite runs in several worker processes: a torch thread pool of every
# core in each of them oversubscribes the machine
torch.set_num_threads(2)

CTHETA = math.cos(0.841)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def cat():
    lines = ct.SpectralLines.from_par_dict(ct.synthetic_co2_par(600, seed=21),
                                             dtype=torch.float64, device="cpu")
    nu = np.linspace(590.0, 760.0, 2000)   # no multiple of the 128-point block
    plan = build_line_window_plan(nu, lines.positions64(), 25.0)
    states = [np.linspace(170.0, 310.0, 11), np.geomspace(10.0, 1e5, 11)]
    states.append(0.95 * states[1])
    return lines, plan, states


def _column(L=19, N=3000, seed=0):
    rng = np.random.default_rng(seed)
    tau = rng.exponential(0.5, (L, N))
    tau[0], tau[1], tau[2] = 0.0, 1e-9, 1e-4
    tau[-1, : N // 3] = 1e4
    return tau, 0.5 + rng.random((L + 1, N)), rng.random(N), 0.5 * rng.random(N)


def _t(xs, dtype=torch.float64, device="cpu"):
    return [torch.tensor(x, dtype=dtype, device=device) for x in xs]


def test_build_flags_keep_ieee_float32():
    """No fast math (FTZ, approximate expf) and the Hopper target with its 'a'."""
    flags = " ".join(cuda_build.NVCC_FLAGS)
    assert "fast_math" not in flags and "ftz=true" not in flags
    assert "arch=compute_90a,code=sm_90a" in flags
    for name in ("linesum", "march", "fused_table"):
        src = (cuda_build.CSRC / f"{name}.cu").read_text()
        assert "clearsky_tpu/" in src and "__expf" not in src


def test_library_key_covers_the_headers(tmp_path, monkeypatch):
    """An edit to any csrc/*.cuh, or a new one, names a new library."""
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    first = cuda_build.library_path("k")
    assert cuda_build.library_path("k") == first
    (tmp_path / "common.cuh").write_text("// v2\n")
    second = cuda_build.library_path("k")
    (tmp_path / "other.cuh").write_text("\n")
    assert len({first, second, cuda_build.library_path("k")}) == 3


_PIN = """
import sys, torch
from clearsky_tpu_torch.utils.interp import full_float32
mm = torch.backends.cuda.matmul
if sys.argv[1] == "legacy":
    mm.allow_tf32 = True
    read = lambda: mm.allow_tf32
else:
    mm.fp32_precision = "tf32"
    read = lambda: mm.fp32_precision
before = read()
with full_float32():
    inside = mm.fp32_precision if sys.argv[1] == "new" else mm.allow_tf32
assert inside in (False, "ieee"), inside
assert read() == before, (read(), before)
print("ok")
"""


@pytest.mark.parametrize("api", ["legacy", "new"])
def test_full_float32_pins_and_restores_tf32(api):
    """The pin turns TF32 off inside and restores the caller's setting,
    through whichever of PyTorch's two interfaces the process used (a
    fresh process: the setting is global)."""
    proc = subprocess.run([sys.executable, "-c", _PIN, api], capture_output=True, text=True,
                          timeout=120, cwd=str(cuda_build.CSRC.parent.parent))
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_cpu_tensors_take_the_plain_versions(cat):
    lines, plan, states = cat
    counts = (sigma_lines.launches, olr_march.launches, monoflux_march.launches)
    T, P, Pp = _t(states)
    np.testing.assert_array_equal(sigma_lines(plan, lines, T, P, Pp).numpy(),
                                  sigma_from_lines(plan, lines, T, P, Pp).numpy())
    tau, B, S, a = _t(_column(L=5, N=300))
    m, W = stream_nodes(5)
    np.testing.assert_array_equal(olr_march(tau, B, m, W).numpy(),
                                  td._olr_march(tau, B, m, W).numpy())
    for k, p in zip(monoflux_march(tau, B, S, a, CTHETA, m, W),
                    td._monoflux_march(tau, B, S, a, CTHETA, m, W)):
        np.testing.assert_array_equal(k.numpy(), p.numpy())
    assert (sigma_lines.launches, olr_march.launches, monoflux_march.launches) == counts


@pytest.mark.parametrize("shape", ["gauss", "phco2x", ""])
def test_line_sum_kernel_rejects_unported_shapes(shape):
    with pytest.raises(ValueError):
        linesum_cuda._mode(shape)


@pytest.mark.parametrize("n", [0, 9])
def test_march_kernels_take_one_to_eight_streams(n):
    with pytest.raises(ValueError):
        march_cuda._streams(np.ones(n), np.ones(n))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["voigt", "lorentz", "doppler"])
def test_line_sum_kernel_matches_plain(cat, cuda, shape):
    lines, plan, states = cat
    before = sigma_lines.launches
    out = sigma_lines(plan, lines.to(torch.float32, cuda), *_t(states, torch.float32, cuda),
                      shape=shape)
    torch.cuda.synchronize()
    assert sigma_lines.launches == before + 1
    ref = sigma_from_lines(plan, lines, *_t(states), shape=shape).numpy()
    out = out.double().cpu().numpy()
    m = np.abs(ref) > 1e-35
    np.testing.assert_allclose(out[m], ref[m], rtol=2e-3, atol=1e-32)
    assert np.all(np.abs(out[~m]) < 1e-30)


@pytest.mark.gpu
def test_line_sum_wrapper_rejects_bad_inputs(cat, cuda):
    lines, plan, states = cat
    l32 = lines.to(torch.float32, cuda)
    T, P, Pp = _t(states, torch.float32, cuda)
    with pytest.raises(TypeError):        # float64 states
        sigma_lines(plan, l32, T.double(), P, Pp)
    with pytest.raises(TypeError):        # float64 catalog
        sigma_lines(plan, lines.to(device=cuda), *_t(states, torch.float64, cuda))
    with pytest.raises(ValueError):       # not contiguous
        sigma_lines(plan, l32, torch.stack([T, T], 1)[:, 0], P, Pp)
    with pytest.raises(ValueError):       # wrong shape
        sigma_lines(plan, l32, T, P[:2], Pp)
    with pytest.raises(ValueError):       # another device
        sigma_lines(plan, l32, T, P.cpu(), Pp)


@pytest.fixture(scope="module")
def dense():
    """A catalog and grids where both routes' geometries accept: the
    uniform 2300-2350 cm^-1 band grid, the same with an odd point count,
    and a random-walk grid (gathered interpolation)."""
    lines = ct.SpectralLines.from_par_dict(ct.synthetic_co2_par(1500, seed=3),
                                           dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(3)
    walk = np.linspace(2300.0, 2350.0, 8192)
    walk = np.sort(walk + np.cumsum(rng.uniform(-0.2, 0.2, walk.shape)) * (walk[1] - walk[0]))
    grids = {"uniform": np.linspace(2300.0, 2350.0, 8192),
             "odd": np.linspace(2300.0, 2350.0, 8191), "nonuniform": walk}
    plans = {k: build_line_window_plan(nu, lines.positions64(), 25.0) for k, nu in grids.items()}
    return lines, plans


# (grid, states): one state, a padded tile of 11, an odd point count and a
# non-uniform grid
MODE_CASES = [("uniform", 1), ("uniform", 11), ("odd", 11), ("nonuniform", 11)]


def _mode_states(n):
    T = np.linspace(180.0, 310.0, n)
    P = np.geomspace(10.0, 1e5, n)
    return T, P, 0.5 * P


def _of_peak(out, ref):
    """max |out - ref| over each state's peak |ref|."""
    return float(((out.double().cpu() - ref).abs() / ref.abs().amax(dim=1, keepdim=True)).max())


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["farall", "fine", "fine_stencil", "coarse"])
@pytest.mark.parametrize("grid,n", MODE_CASES)
def test_windowed_modes_match_plain(dense, cuda, mode, grid, n):
    """K1's modes of the routes, float32 on the card, against their plain
    versions in float64 on the same windows."""
    lines, plans = dense
    plan = plans[grid]
    geom = ls.coarse_geometry(plan, lines, ls.coarse_params(plan, 0.6))
    l32 = lines.to(torch.float32, cuda)
    T, P, Pp = _t(_mode_states(n), torch.float32, cuda)
    S, a, g = _line_params(l32, T, P, Pp)
    coef = linesum_cuda.pack_coefficients(linesum_cuda.WINDOW_MODES[mode], S, a, g)
    co64 = voigt_coefficients(*_line_params(lines, *_t(_mode_states(n))))
    z = geom.zones
    if mode == "farall":
        blocks, windows, zz, n_out = plan.nu_blocks, plan.windows(), {"cut": plan.cut}, plan.n_nu
    elif mode == "coarse":
        blocks, windows, zz, n_out = geom.coarse_blocks, geom.coarse_windows, z, geom.params[2]
    else:
        blocks, windows, zz, n_out = geom.fine_blocks, geom.fine_windows, z, plan.n_nu
    hi, lo = (torch.as_tensor(x.reshape(-1), device=cuda) for x in two_float(blocks))
    grid_dev = {"nu_hi": hi, "nu_lo": lo,
                "win": torch.as_tensor(windows, dtype=torch.int32, device=cuda)}
    d_near = linesum_cuda.near_distance(a, z["cut_f"]) if mode == "fine" else None
    before = dict(sigma_lines.launches_by_mode)
    out = linesum_cuda.launch_mode(linesum_cuda.WINDOW_MODES[mode], grid_dev, l32, coef, n,
                                   n_out, linesum_cuda._zones(**zz), d_near)
    torch.cuda.synchronize()
    assert sigma_lines.launches_by_mode[mode] == before[mode] + 1
    d64 = None if d_near is None else d_near.double().cpu()
    ref = ls.sigma_mode_plain(mode, blocks, windows, lines, co64, zz, d64)[:, :n_out]
    assert bool(torch.isfinite(out).all())
    assert _of_peak(out, ref) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("grid,n", MODE_CASES)
def test_stencil_correction_matches_plain(dense, cuda, grid, n, weighted):
    lines, plans = dense
    plan = plans[grid]
    geom = ls.stencil_geometry(plan, lines)
    l32 = lines.to(torch.float32, cuda)
    co32 = voigt_coefficients(*_line_params(l32, *_t(_mode_states(n), torch.float32, cuda)))
    co64 = voigt_coefficients(*_line_params(lines, *_t(_mode_states(n))))
    weight = None
    if weighted:
        d_far = ls.coarse_params(plan, 0.6)[0]
        weight = (d_far * d_far, 4.0 * d_far * d_far)
    before = stencil_correction.launches
    out = stencil_correction(torch.zeros((n, plan.n_nu), device=cuda), geom, co32, 25.0, weight)
    torch.cuda.synchronize()
    assert stencil_correction.launches == before + 1
    ref = ls.stencil_correction_plain(geom, co64, 25.0, plan.n_nu, weight)
    # measured against each state's peak cross-section: at high pressure
    # w4 and region 1 nearly agree and the correction itself nearly vanishes
    peak = sigma_from_lines(plan, lines, *_t(_mode_states(n))).abs().amax(dim=1, keepdim=True)
    assert float(((out.double().cpu() - ref).abs() / peak).max()) < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("grid", ["uniform", "odd", "nonuniform"])
def test_routes_match_plain_and_count_modes(dense, cuda, grid):
    """The stencil and coarse routes on the card against their float64
    plain versions, and the launches each route makes."""
    lines, plans = dense
    plan = plans[grid]
    l32 = lines.to(torch.float32, cuda)
    x32, x64 = _t(_mode_states(11), torch.float32, cuda), _t(_mode_states(11))
    assert ls.route(plan, l32, "voigt", "auto") == "coarse"
    for strategy, plain, modes in (
            ("stencil", ls.sigma_stencil_plain(plan, lines, *x64), {"farall": 1}),
            ("coarse", ls.sigma_coarse_plain(plan, lines, *x64),
             {"fine_stencil": 1, "coarse": 1})):
        by_mode, corr = dict(sigma_lines.launches_by_mode), stencil_correction.launches
        out = sigma_from_lines_auto(plan, l32, *x32, strategy=strategy)
        torch.cuda.synchronize()
        got = {k: v - by_mode[k] for k, v in sigma_lines.launches_by_mode.items()
               if v != by_mode[k]}
        assert got == modes and stencil_correction.launches == corr + 1
        assert _of_peak(out, plain) < 1e-5, strategy


@pytest.mark.gpu
def test_route_wrappers_reject_bad_inputs(dense, cuda):
    lines, plans = dense
    plan = plans["uniform"]
    l32 = lines.to(torch.float32, cuda)
    T, P, Pp = _t(_mode_states(3), torch.float32, cuda)
    geom = ls.coarse_geometry(plan, l32, ls.coarse_params(plan, 0.6))
    S, a, g = _line_params(l32, T, P, Pp)
    coef = linesum_cuda.pack_coefficients(linesum_cuda.WINDOW_MODES["fine"], S, a, g)
    fine = {"nu_hi": torch.as_tensor(two_float(geom.fine_blocks)[0].reshape(-1), device=cuda),
            "win": torch.as_tensor(geom.fine_windows, dtype=torch.int32, device=cuda)}
    fine["nu_lo"] = torch.zeros_like(fine["nu_hi"])
    zones = linesum_cuda._zones(**geom.zones)
    d_near = linesum_cuda.near_distance(a, geom.zones["cut_f"])
    fine_mode = linesum_cuda.WINDOW_MODES["fine"]
    with pytest.raises(ValueError):       # FINE without its d_near
        linesum_cuda.launch_mode(fine_mode, fine, l32, coef, 3, plan.n_nu, zones)
    with pytest.raises(ValueError):       # a one-window table for a three-window mode
        linesum_cuda.launch_mode(fine_mode, dict(fine, win=fine["win"][:, :2].contiguous()),
                                 l32, coef, 3, plan.n_nu, zones, d_near)
    with pytest.raises(TypeError):        # a float64 pack
        linesum_cuda.launch_mode(fine_mode, fine, l32, coef.double(), 3, plan.n_nu, zones,
                                 d_near)
    with pytest.raises(ValueError):       # more outputs than the grid has points
        linesum_cuda.launch_mode(fine_mode, fine, l32, coef, 3, 10**7, zones, d_near)
    co = voigt_coefficients(S, a, g)
    with pytest.raises(ValueError):       # coefficients of another catalog size
        stencil_correction(torch.zeros((3, plan.n_nu), device=cuda), geom.stencil,
                           [c[:, :-1].contiguous() for c in co], 25.0)
    with pytest.raises(TypeError):        # a float64 output
        stencil_correction(torch.zeros((3, plan.n_nu), dtype=torch.float64, device=cuda),
                           geom.stencil, co, 25.0)
    with pytest.raises(ValueError):       # states on another device
        sigma_from_lines_auto(plan, l32, T, P.cpu(), Pp, strategy="coarse")


# --- the phco2 family and voigt_ref --------------------------------------------

@pytest.fixture(scope="module")
def dense_phco2():
    """A catalog over its span +- 500 cm^-1 (phco2's cut) on 8191 points,
    where the coarse split (FINE_STENCIL) and the stencil accept."""
    lines = ct.SpectralLines.from_par_dict(ct.synthetic_co2_par(400, seed=5),
                                           dtype=torch.float64, device="cpu")
    pos = lines.positions64()
    nu = np.linspace(pos.min() - 500.0, pos.max() + 500.0, 8191)
    return lines, build_line_window_plan(nu, pos, 500.0)


def test_phco2_rates_tile_the_states():
    """chi's rates as the kernels read them: [n_tiles, 2, ST], B1 then B2,
    zero past the last state."""
    T = torch.tensor([150.0, 200.0, 250.0, 300.0, 350.0, 400.0, 450.0, 500.0, 550.0])
    B = linesum_cuda.chi_rates(T)
    assert B.shape == (2, 2, linesum_cuda.ST) and B.dtype == torch.float32
    T64 = T.double()
    np.testing.assert_array_equal(B[0, 0].numpy(), (0.0888 - 0.16 * torch.exp(-0.0041 * T64[:8]))
                                  .float().numpy())
    np.testing.assert_array_equal(B[1, 1, :1].numpy(), (0.0526 * torch.exp(-0.00152 * T64[8:]))
                                  .float().numpy())
    assert float(B[1, :, 1:].abs().max()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["phco2", "phco2_ref", "voigt_ref"])
def test_split_mode_takes_the_voigt_family(dense_phco2, cuda, shape):
    """K1's split mode for phco2 (its own instance), phco2_ref and voigt_ref
    (alpha folded into the pack) against the plain float64 line sum."""
    lines, plan = dense_phco2
    if shape == "voigt_ref":
        plan = build_line_window_plan(plan.nu, lines.positions64(), 25.0)
    x = _mode_states(11)
    key = "voigt_split" if shape == "voigt_ref" else "phco2_split"
    before = sigma_lines.launches_by_mode[key]
    out = sigma_lines(plan, lines.to(torch.float32, cuda), *_t(x, torch.float32, cuda),
                      shape=shape)
    torch.cuda.synchronize()
    assert sigma_lines.launches_by_mode[key] == before + 1
    _check_sigma(out, sigma_from_lines(plan, lines, *_t(x), shape=shape))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["farall", "fine", "fine_stencil", "coarse"])
@pytest.mark.parametrize("n", [1, 11])
def test_phco2_windowed_modes_match_plain(dense_phco2, cuda, mode, n):
    """The phco2 instances of the routes' modes, float32 on the card,
    against their plain versions in float64 on the same windows."""
    lines, plan = dense_phco2
    geom = ls.coarse_geometry(plan, lines, ls.coarse_params(plan, 0.6))
    l32 = lines.to(torch.float32, cuda)
    T, P, Pp = _t(_mode_states(n), torch.float32, cuda)
    S, a, g = _line_params(l32, T, P, Pp)
    m = linesum_cuda.window_mode(mode, "phco2")
    coef = linesum_cuda.pack_coefficients(m, S, a, g)
    assert coef.shape[-1] == linesum_cuda.ST * 3
    T64 = _t(_mode_states(n))
    co64 = voigt_coefficients(*_line_params(lines, *T64))
    z = geom.zones
    if mode == "farall":
        blocks, windows, zz, n_out = plan.nu_blocks, plan.windows(), {"cut": plan.cut}, plan.n_nu
    elif mode == "coarse":
        blocks, windows, zz, n_out = geom.coarse_blocks, geom.coarse_windows, z, geom.params[2]
    else:
        blocks, windows, zz, n_out = geom.fine_blocks, geom.fine_windows, z, plan.n_nu
    hi, lo = (torch.as_tensor(x.reshape(-1), device=cuda) for x in two_float(blocks))
    grid_dev = {"nu_hi": hi, "nu_lo": lo,
                "win": torch.as_tensor(windows, dtype=torch.int32, device=cuda)}
    d_near = linesum_cuda.near_distance(a, z["cut_f"]) if mode == "fine" else None
    before = sigma_lines.launches_by_mode[f"phco2_{mode}"]
    out = linesum_cuda.launch_mode(m, grid_dev, l32, coef, n, n_out, linesum_cuda._zones(**zz),
                                   d_near, bcoef=linesum_cuda.chi_rates(T))
    torch.cuda.synchronize()
    assert sigma_lines.launches_by_mode[f"phco2_{mode}"] == before + 1
    d64 = None if d_near is None else d_near.double().cpu()
    ref = ls.sigma_mode_plain(mode, blocks, windows, lines, co64, zz, d64, T=T64[0])[:, :n_out]
    assert bool(torch.isfinite(out).all())
    assert _of_peak(out, ref) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("weighted", [False, True])
def test_phco2_correction_matches_plain(dense_phco2, cuda, weighted):
    """The correction's chi instance (y = y0 chi) against its plain version."""
    lines, plan = dense_phco2
    geom = ls.stencil_geometry(plan, lines)
    n = 11
    T32 = _t(_mode_states(n), torch.float32, cuda)
    co32 = voigt_coefficients(*_line_params(lines.to(torch.float32, cuda), *T32))
    x64 = _t(_mode_states(n))
    co64 = voigt_coefficients(*_line_params(lines, *x64))
    weight = None
    if weighted:
        d_far = ls.coarse_params(plan, 0.6)[0]
        weight = (d_far * d_far, 4.0 * d_far * d_far)
    before = stencil_correction.launches_phco2
    out = stencil_correction(torch.zeros((n, plan.n_nu), device=cuda), geom, co32, plan.cut,
                             weight, T=T32[0])
    torch.cuda.synchronize()
    assert stencil_correction.launches_phco2 == before + 1
    ref = ls.stencil_correction_plain(geom, co64, plan.cut, plan.n_nu, weight, T=x64[0])
    peak = sigma_from_lines(plan, lines, *x64, shape="phco2").abs().amax(dim=1, keepdim=True)
    assert float(((out.double().cpu() - ref).abs() / peak).max()) < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["phco2", "voigt_ref"])
def test_family_routes_match_plain_and_count_modes(dense_phco2, cuda, shape):
    """The stencil and coarse routes of phco2 (its own instances) and
    voigt_ref (the voigt instances) on the card against their float64 plain
    versions."""
    lines, plan = dense_phco2
    if shape == "voigt_ref":
        plan = build_line_window_plan(np.linspace(2300.0, 2350.0, 8192), lines.positions64(),
                                      25.0)
    l32 = lines.to(torch.float32, cuda)
    x32, x64 = _t(_mode_states(11), torch.float32, cuda), _t(_mode_states(11))
    assert ls.route(plan, l32, shape, "auto") == "coarse"
    fam = "phco2_" if shape == "phco2" else ""
    for strategy, plain, modes in (
            ("stencil", ls.sigma_stencil_plain(plan, lines, *x64, shape=shape),
             {fam + "farall": 1}),
            ("coarse", ls.sigma_coarse_plain(plan, lines, *x64, shape=shape),
             {fam + "fine_stencil": 1, fam + "coarse": 1})):
        by_mode = dict(sigma_lines.launches_by_mode)
        corr = (stencil_correction.launches, stencil_correction.launches_phco2)
        out = sigma_from_lines_auto(plan, l32, *x32, shape=shape, strategy=strategy)
        torch.cuda.synchronize()
        got = {k: v - by_mode[k] for k, v in sigma_lines.launches_by_mode.items()
               if v != by_mode[k]}
        assert got == modes
        k = 1 if shape == "phco2" else 0
        assert (stencil_correction.launches, stencil_correction.launches_phco2)[k] == corr[k] + 1
        assert _of_peak(out, plain) < 1e-5, strategy


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["segmented", "lane", "gathered"])
@pytest.mark.parametrize("shape", ["phco2", "voigt_ref"])
def test_family_large_catalog_kernels_match_plain(dense_phco2, cuda, kind, shape):
    """K1-seg (3 segments), K4 and K5 for phco2 (their phco2 instances) and
    voigt_ref, in float32 against their plain versions in float64."""
    lines, plan = dense_phco2
    if shape == "voigt_ref":
        plan = build_line_window_plan(plan.nu, lines.positions64(), 25.0)
    l32 = lines.to(torch.float32, cuda)
    L = _segment_length(plan, lines.n_lines, 3) if kind == "segmented" else None
    x32, x64 = _t(_mode_states(11), torch.float32, cuda), _t(_mode_states(11))
    before = dict(sigma_lines.launches_by_mode)
    if kind == "segmented":
        out = linesum_cuda.sigma_segmented(plan, l32, *x32, L, shape=shape)
        ref = ls.sigma_segmented_plain(plan, lines, *x64, L, shape=shape)
    else:
        out = _LARGE[kind](plan, l32, *x32, shape=shape)
        ref = {"lane": ls.sigma_lane_plain, "gathered": ls.sigma_gathered_plain}[kind](
            plan, lines, *x64, shape=shape)
    torch.cuda.synchronize()
    got = {k: v - before[k] for k, v in sigma_lines.launches_by_mode.items() if v != before[k]}
    key = ("phco2_" if shape == "phco2" else "") + kind
    assert got == {key: 3 if kind == "segmented" else 1}
    _check_sigma(out, ref)


@pytest.mark.gpu
def test_phco2_wrappers_reject_bad_inputs(dense_phco2, cuda):
    lines, plan = dense_phco2
    l32 = lines.to(torch.float32, cuda)
    T, P, Pp = _t(_mode_states(3), torch.float32, cuda)
    S, a, g = _line_params(l32, T, P, Pp)
    grid = plan.device_arrays(cuda)
    zones = linesum_cuda._zones(plan.cut)
    m = linesum_cuda.window_mode("farall", "phco2")
    coef = linesum_cuda.pack_coefficients(m, S, a, g)
    with pytest.raises(ValueError):       # a phco2 mode without chi's rates
        linesum_cuda.launch_mode(m, grid, l32, coef, 3, plan.n_nu, zones)
    with pytest.raises(ValueError):       # rates for a voigt mode
        linesum_cuda.launch_mode(3, grid, l32, linesum_cuda.pack_coefficients(3, S, a, g), 3,
                                 plan.n_nu, zones, bcoef=linesum_cuda.chi_rates(T))
    with pytest.raises(ValueError):       # rates of another number of states
        linesum_cuda.launch_mode(m, grid, l32, coef, 3, plan.n_nu, zones,
                                 bcoef=linesum_cuda.chi_rates(torch.cat([T] * 3)))
    with pytest.raises(TypeError):        # float64 rates
        linesum_cuda.launch_mode(m, grid, l32, coef, 3, plan.n_nu, zones,
                                 bcoef=linesum_cuda.chi_rates(T).double())
    lay = ls.lane_layout(plan, l32, S, a, g)
    win = torch.as_tensor(lay.windows, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):       # phco2 without its temperatures
        linesum_cuda.launch_fullprofile("phco2", False, grid, lay.nu, lay.nu_lo, lay.S,
                                        lay.alpha, lay.gamma, win[:, 0].contiguous(),
                                        win[:, 1].contiguous(), lay.nu.shape[0], plan.cut,
                                        plan.n_nu)
    with pytest.raises(ValueError):       # the stencil route takes the Voigt family only
        linesum_cuda.sigma_stencil(plan, l32, T, P, Pp, shape="lorentz")


# --- the large-catalog and baseline kernels: K1-seg, K4, K5 --------------------

def _segment_length(plan, n_lines, k):
    """A segment length that gives exactly ``k`` segments meeting a block."""
    for L in range(n_lines, 0, -1):
        if len(ls.segments(plan, n_lines, L)) == k:
            return L
    raise AssertionError(f"no segment length gives {k} segments")


_LARGE = {"segmented": linesum_cuda.sigma_segmented, "lane": linesum_cuda.sigma_lane,
          "gathered": linesum_cuda.sigma_gathered}


def _large_plain(kind, plan, lines, x, L_seg=None, conc=None):
    if kind == "segmented":
        return ls.sigma_segmented_plain(plan, lines, *x, L_seg, conc=conc)
    return {"lane": ls.sigma_lane_plain, "gathered": ls.sigma_gathered_plain}[kind](
        plan, lines, *x, conc=conc)


def _large_call(kind, plan, lines, x, L_seg=None, conc=None):
    if kind == "segmented":
        return linesum_cuda.sigma_segmented(plan, lines, *x, L_seg, conc=conc)
    return _LARGE[kind](plan, lines, *x, conc=conc)


def _check_sigma(out, ref):
    """The line-sum bar: rtol 2e-3 where |sigma| > 1e-35, else < 1e-30."""
    out, ref = out.double().cpu().numpy(), ref.numpy()
    m = np.abs(ref) > 1e-35
    np.testing.assert_allclose(out[m], ref[m], rtol=2e-3, atol=1e-32)
    assert np.all(np.abs(out[~m]) < 1e-30)


def test_large_catalog_wrappers_on_cpu_take_the_plain_versions(cat):
    lines, plan, states = cat
    x = _t(states)
    counts = dict(sigma_lines.launches_by_mode)
    for kind in _LARGE:
        L = 200 if kind == "segmented" else None
        np.testing.assert_array_equal(_large_call(kind, plan, lines, x, L).numpy(),
                                      _large_plain(kind, plan, lines, x, L).numpy())
    assert sigma_lines.launches_by_mode == counts


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["segmented", "lane", "gathered"])
@pytest.mark.parametrize("grid,n", MODE_CASES)
def test_large_catalog_kernels_match_plain(dense, cuda, kind, grid, n):
    """K1-seg (3 segments), K4 and K5 in float32 against their plain
    versions in float64, with their launch counts."""
    lines, plans = dense
    plan = plans[grid]
    l32 = lines.to(torch.float32, cuda)
    L = _segment_length(plan, lines.n_lines, 3) if kind == "segmented" else None
    before = dict(sigma_lines.launches_by_mode)
    out = _large_call(kind, plan, l32, _t(_mode_states(n), torch.float32, cuda), L)
    torch.cuda.synchronize()
    got = {k: v - before[k] for k, v in sigma_lines.launches_by_mode.items() if v != before[k]}
    assert got == {kind: 3 if kind == "segmented" else 1}
    _check_sigma(out, _large_plain(kind, plan, lines, _t(_mode_states(n)), L))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 2, 5])
def test_segmented_kernel_at_1_2_5_segments(dense, cuda, k):
    """Segments of the whole catalog: the first ones lie beyond the cut of
    every block of the 2300-2350 cm^-1 grid and launch nothing; per-state
    concentrations cut with the segments."""
    lines, plans = dense
    plan = plans["uniform"]
    L = _segment_length(plan, lines.n_lines, k)
    segs = ls.segments(plan, lines.n_lines, L)
    if k == 5:
        assert segs[0].a > 0           # the segments before it met no block
    n = 11
    conc = torch.linspace(0.1, 1.0, n * lines.n_lines, dtype=torch.float64).reshape(n, -1)
    before = sigma_lines.launches_by_mode["segmented"]
    out = linesum_cuda.sigma_segmented(plan, lines.to(torch.float32, cuda),
                                       *_t(_mode_states(n), torch.float32, cuda), L,
                                       conc=conc.float().to(cuda))
    torch.cuda.synchronize()
    assert sigma_lines.launches_by_mode["segmented"] == before + len(segs) == before + k
    _check_sigma(out, ls.sigma_segmented_plain(plan, lines, *_t(_mode_states(n)), L, conc=conc))


@pytest.mark.gpu
def test_accumulate_leaves_other_columns_unchanged(dense, cuda):
    """K1 adding into a view: the columns outside the segment's block range
    are bitwise what they were, and inside it the sum is before + the
    kernel's own result."""
    lines, plans = dense
    plan = plans["odd"]
    l32 = lines.to(torch.float32, cuda)
    T, P, Pp = _t(_mode_states(11), torch.float32, cuda)
    seg = ls.segments(plan, lines.n_lines, _segment_length(plan, lines.n_lines, 2))[1]
    sub = ls._slice_lines(l32, seg.a, seg.b)
    S, a, g = _line_params(sub, T, P, Pp)
    coef = linesum_cuda.pack_coefficients(0, S, a, g)
    B = plan.block
    full = plan.device_arrays(cuda)
    grid = {"nu_hi": full["nu_hi"][seg.blo * B: seg.bhi * B],
            "nu_lo": full["nu_lo"][seg.blo * B: seg.bhi * B],
            "win": torch.as_tensor(seg.windows, dtype=torch.int32, device=cuda)}
    args = (0, grid, sub, coef, 11, seg.n_out, linesum_cuda._zones(plan.cut),
            linesum_cuda.near_distance(a, plan.cut))
    fresh = linesum_cuda.launch_mode(*args)
    before = torch.randn((11, plan.n_nu), device=cuda)
    out = before.clone()
    linesum_cuda.launch_mode(*args, out=out[:, seg.blo * B:])
    torch.cuda.synchronize()
    lo, hi = seg.blo * B, seg.blo * B + seg.n_out
    assert 0 < lo or hi < plan.n_nu
    assert torch.equal(out[:, :lo], before[:, :lo]) and torch.equal(out[:, hi:], before[:, hi:])
    assert torch.equal(out[:, lo:hi], before[:, lo:hi] + fresh)


@pytest.mark.gpu
def test_gathered_kernel_runs_states_in_groups(dense, cuda, monkeypatch):
    """A byte budget of three states' slabs: four launches for 11 states,
    each state as in one launch."""
    lines, plans = dense
    plan = plans["uniform"]
    l32 = lines.to(torch.float32, cuda)
    x = _t(_mode_states(11), torch.float32, cuda)
    whole = linesum_cuda.sigma_gathered(plan, l32, *x)
    slab_pad = -(-plan.slab // 128) * 128
    monkeypatch.setattr(linesum_cuda, "GATHER_BYTES", 3 * 12 * plan.n_blocks * slab_pad)
    assert linesum_cuda.gather_group(plan) == 3
    before = sigma_lines.launches_by_mode["gathered"]
    grouped = linesum_cuda.sigma_gathered(plan, l32, *x)
    torch.cuda.synchronize()
    assert sigma_lines.launches_by_mode["gathered"] == before + 4
    assert torch.equal(grouped, whole)


@pytest.mark.gpu
def test_large_catalog_wrappers_reject_bad_inputs(dense, cuda):
    lines, plans = dense
    plan = plans["uniform"]
    l32 = lines.to(torch.float32, cuda)
    T, P, Pp = _t(_mode_states(3), torch.float32, cuda)
    for kind in _LARGE:
        L = 512 if kind == "segmented" else None
        with pytest.raises(TypeError):        # float64 states
            _large_call(kind, plan, l32, (T.double(), P, Pp), L)
        with pytest.raises(ValueError):       # concentrations of another catalog
            _large_call(kind, plan, l32, (T, P, Pp), L,
                        conc=torch.ones(lines.n_lines - 1, device=cuda))
        with pytest.raises(ValueError):       # states on another device
            _large_call(kind, plan, l32, (T, P.cpu(), Pp), L)
    with pytest.raises(ValueError):
        linesum_cuda.sigma_segmented(plan, l32, T, P, Pp, 0)
    S, a, g = _line_params(l32, T, P, Pp)
    grid = plan.device_arrays(cuda)
    args = (0, grid, l32, linesum_cuda.pack_coefficients(0, S, a, g), 3, plan.n_nu,
            linesum_cuda._zones(plan.cut), linesum_cuda.near_distance(a, plan.cut))
    with pytest.raises(ValueError):           # a float64 sum to add into
        linesum_cuda.launch_mode(*args, out=torch.zeros((3, plan.n_nu), dtype=torch.float64,
                                                        device=cuda))
    with pytest.raises(ValueError):           # columns not contiguous
        linesum_cuda.launch_mode(*args, out=torch.zeros((plan.n_nu, 3), device=cuda).t())
    coef = linesum_cuda.pack_coefficients(3, S, a, g)
    with pytest.raises(ValueError):           # only the split and single-sweep modes add
        linesum_cuda.launch_mode(3, grid, l32, coef, 3, plan.n_nu, linesum_cuda._zones(25.0),
                                 out=torch.zeros((3, plan.n_nu), device=cuda))
    lay = ls.lane_layout(plan, l32, S, a, g)
    win = torch.as_tensor(lay.windows, device=cuda)   # int64
    with pytest.raises(ValueError):
        linesum_cuda.launch_fullprofile("voigt", False, grid, lay.nu, lay.nu_lo, lay.S, lay.alpha,
                                        lay.gamma, win[:, 0], win[:, 1], lay.nu.shape[0],
                                        25.0, plan.n_nu)
    with pytest.raises(ValueError):           # rows of another length
        linesum_cuda.launch_fullprofile("voigt", False, grid, lay.nu, lay.nu_lo,
                                        lay.S[:, 1:].contiguous(), lay.alpha, lay.gamma,
                                        win[:, 0].int(), win[:, 1].int(), lay.nu.shape[0],
                                        25.0, plan.n_nu)


@pytest.mark.gpu
@pytest.mark.parametrize("nstream", [1, 5, 8])
def test_march_kernels_match_plain(cuda, nstream):
    m, W = stream_nodes(nstream)
    x32 = _t(_column(), torch.float32, cuda)
    x64 = [x.double().cpu() for x in x32]
    counts = (olr_march.launches, monoflux_march.launches)
    olr = olr_march(x32[0], x32[1], m, W)
    up, dn = monoflux_march(*x32, CTHETA, m, W)
    torch.cuda.synchronize()
    assert (olr_march.launches, monoflux_march.launches) == (counts[0] + 1, counts[1] + 1)
    olr_r = td._olr_march(x64[0], x64[1], m, W)
    up_r, dn_r = td._monoflux_march(*x64, CTHETA, m, W)
    for k, r in ((olr, olr_r), (up, up_r), (dn, dn_r)):
        assert float((k.double().cpu() - r).abs().max()) < 3.5e-6 * float(r.abs().max())


@pytest.mark.gpu
def test_march_wrappers_reject_bad_inputs(cuda):
    tau, B, S, a = _t(_column(L=4, N=256), torch.float32, cuda)
    m, W = stream_nodes(5)
    with pytest.raises(TypeError):
        olr_march(tau.double(), B.double(), m, W)
    with pytest.raises(ValueError):
        olr_march(tau, B[:-1], m, W)
    with pytest.raises(ValueError):
        olr_march(tau.t().contiguous().t(), B, m, W)
    with pytest.raises(ValueError):
        monoflux_march(tau, B, S[:-1], a, CTHETA, m, W)
    with pytest.raises(ValueError):
        monoflux_march(tau, B, S, a.cpu(), CTHETA, m, W)
    with pytest.raises(ValueError):
        olr_march(tau, B, *stream_nodes(9))


def _table_column(L, k, N, seed=0, K=16, T=272):
    """Split-table operands like a baked CO2 table's: ln sigma ~ -55 +- 2,
    with a tenth of the points transparent (-80: tau ~ 1e-11, the series
    branch) and a tenth opaque (-44: tau ~ 1e4)."""
    rng = np.random.default_rng(seed)
    lead = rng.normal(0.0, 0.3, (K, N))
    lead[0] = rng.uniform(-58.0, -52.0, N)
    lead[0, : N // 10] = -80.0
    lead[0, N // 10: N // 5] = -44.0
    tail = rng.normal(0.0, 0.02, (T, N))
    bl = rng.uniform(-1.0, 1.0, (L * k, K))
    bl[:, 0] = 1.0
    bt = rng.uniform(-1.0, 1.0, (L * k, T))
    wq = rng.uniform(0.5, 1.5, (L, k)) * math.exp(55.0) / (k * L)
    B = 0.5 + rng.random((L + 1, N))
    return dict(lead=lead, tail=tail, bl=bl, bt=bt, wq=wq, B=B, S=rng.random(N),
                a=0.5 * rng.random(N))


def _table_tensors(c, dtype=torch.float64, device="cpu"):
    """(lead, tail, bl, bt, wq, B, S, a): the tail and its basis in bfloat16."""
    t = lambda x, dt=dtype: torch.tensor(x, dtype=torch.float32, device=device).to(dt)
    return (t(c["lead"]), t(c["tail"], torch.bfloat16), t(c["bl"]), t(c["bt"], torch.bfloat16),
            t(c["wq"]), t(c["B"]), t(c["S"]), t(c["a"]))


def test_fused_wrappers_on_cpu_take_the_plain_versions():
    lead, tail, bl, bt, wq, B, S, a = _table_tensors(_table_column(L=4, k=3, N=200))
    m, W = stream_nodes(5)
    counts = (fused_olr.launches, fused_monoflux.launches)
    np.testing.assert_array_equal(fused_olr(lead, tail, bl, bt, wq, B, m, W).numpy(),
                                  tft._fused_olr_plain(lead, tail, bl, bt, wq, B, m, W).numpy())
    got = fused_monoflux(lead, tail, bl, bt, wq, B, S, a, CTHETA, m, W)
    for x, y in zip(got, tft._fused_monoflux_plain(lead, tail, bl, bt, wq, B, S, a, CTHETA,
                                                     m, W)):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert (fused_olr.launches, fused_monoflux.launches) == counts
    # the plain tau is the JAX package's dense block-diagonal quadrature
    L, k = wq.shape
    dense = torch.zeros((L, L * k), dtype=wq.dtype)
    for l in range(L):
        dense[l, l * k:(l + 1) * k] = wq[l]
    ln = bl @ lead + bt.double() @ tail.double()
    np.testing.assert_allclose(got[2].numpy(), (dense @ torch.exp(ln)).numpy(), rtol=1e-13)


@pytest.mark.parametrize("wrapper", ["fused_olr", "fused_monoflux"])
def test_fused_wrappers_refuse_gradients(wrapper):
    """Autograd through K6/K7 is not ported: the wrappers raise on any
    device (ROADMAP queue A item 5)."""
    lead, tail, bl, bt, wq, B, S, a = _table_tensors(_table_column(L=2, k=2, N=64))
    m, W = stream_nodes(5)
    lead.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="item 5"):
        if wrapper == "fused_olr":
            fused_olr(lead, tail, bl, bt, wq, B, m, W)
        else:
            fused_monoflux(lead, tail, bl, bt, wq, B, S, a, CTHETA, m, W)


@pytest.mark.gpu
@pytest.mark.parametrize("L,k,nstream,N", [(1, 3, 2, 333), (19, 3, 5, 4096), (40, 3, 8, 1000),
                                           (19, 2, 5, 2**16 + 37), (7, 5, 4, 515),
                                           (3, 8, 5, 130)])
def test_fused_kernels_match_plain(cuda, L, k, nstream, N):
    """K6 and K7 in float32 against their plain versions in float64 on the
    same split operands: N not a multiple of the 128-point block (but 4096),
    one to twenty node groups of 8 (L = 40, k = 3: two rounds of warps),
    k = 5 and 8 (groups of one layer)."""
    col = _table_column(L, k, N, seed=L + N)
    x32 = _table_tensors(col, torch.float32, cuda)
    lead, tail, bl, bt, wq, B, S, a = x32
    x64 = [x.cpu() if x.dtype == torch.bfloat16 else x.double().cpu() for x in x32]
    m, W = stream_nodes(nstream)
    counts = (fused_olr.launches, fused_monoflux.launches)
    olr = fused_olr(lead, tail, bl, bt, wq, B, m, W)
    up, dn, tau = fused_monoflux(*x32, CTHETA, m, W)
    torch.cuda.synchronize()
    assert (fused_olr.launches, fused_monoflux.launches) == (counts[0] + 1, counts[1] + 1)
    olr_r = tft._fused_olr_plain(*x64[:6], m, W)
    up_r, dn_r, tau_r = tft._fused_monoflux_plain(*x64, CTHETA, m, W)
    for kern, ref in ((olr, olr_r), (up, up_r), (dn, dn_r)):
        assert float((kern.double().cpu() - ref).abs().max()) < 1e-4 * float(ref.abs().max())
    np.testing.assert_allclose(tau.double().cpu().numpy(), tau_r.numpy(), rtol=1e-4, atol=0.0)


@pytest.mark.gpu
def test_fused_wrappers_reject_bad_inputs(cuda):
    lead, tail, bl, bt, wq, B, S, a = _table_tensors(_table_column(L=4, k=3, N=300),
                                                     torch.float32, cuda)
    m, W = stream_nodes(5)
    with pytest.raises(TypeError):         # a float32 tail
        fused_olr(lead, tail.float(), bl, bt, wq, B, m, W)
    with pytest.raises(TypeError):         # float64 coefficients
        fused_olr(lead.double(), tail, bl, bt, wq, B, m, W)
    with pytest.raises(ValueError):        # a Planck row short
        fused_olr(lead, tail, bl, bt, wq, B[:-1], m, W)
    with pytest.raises(ValueError):        # basis rows that are not L*k nodes
        fused_olr(lead, tail, bl[:-1], bt[:-1], wq, B, m, W)
    with pytest.raises(ValueError):        # not contiguous
        fused_olr(lead, tail, bl.t().contiguous().t(), bt, wq, B, m, W)
    with pytest.raises(ValueError):        # another device
        fused_monoflux(lead, tail, bl, bt, wq, B, S.cpu(), a, CTHETA, m, W)
    with pytest.raises(ValueError):        # nine streams
        fused_olr(lead, tail, bl, bt, wq, B, *stream_nodes(9))
    with pytest.raises(NotImplementedError):
        fused_monoflux(lead, tail, bl, bt, wq.requires_grad_(True), B, S, a, CTHETA, m, W)


@pytest.mark.gpu
def test_table_contractions_ignore_global_tf32(cuda):
    """With TF32 allowed process-wide, Gas.raw_sigma and cheb2d_coeffs keep
    full float32 (their bars fail under TF32's 10-bit mantissa: ~0.03 in an
    ln sigma of 55, 3% in sigma)."""
    from clearsky_tpu_torch.utils.interp import cheb2d_coeffs

    rng = np.random.default_rng(7)
    dom = ct.AtmosphericDomain.create((150.0, 350.0), 12, (9.0, 1.01e5), 24)
    coeffs = rng.normal(0.0, 0.3, (288, 4096)) / (1.0 + np.arange(288))[:, None]
    coeffs[0] = rng.uniform(-58.0, -52.0, 4096)
    nu = np.linspace(500.0, 900.0, 4096)
    T = rng.uniform(150.0, 350.0, 64)
    P = np.exp(rng.uniform(np.log(9.0), np.log(1.01e5), 64))
    V = rng.normal(-60.0, 5.0, (256, 12, 24))

    def gas(dtype, device):
        return ct.Gas(nu=torch.tensor(nu, dtype=dtype, device=device),
                      coeffs=torch.tensor(coeffs, dtype=dtype, device=device), domain=dom,
                      fC=lambda T_, P_: torch.ones_like(T_))

    g64 = gas(torch.float64, "cpu")
    ref_sig = {"full": g64, "split": g64.split_precision(16)}
    ref_sig = {k: g.raw_sigma(torch.tensor(T), torch.tensor(P)) for k, g in ref_sig.items()}
    ref_c = cheb2d_coeffs(torch.tensor(V))
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        g32 = gas(torch.float32, cuda)
        t32, p32 = (torch.tensor(x, dtype=torch.float32, device=cuda) for x in (T, P))
        got = {"full": g32.raw_sigma(t32, p32),
               "split": g32.split_precision(16).raw_sigma(t32, p32)}
        c32 = cheb2d_coeffs(torch.tensor(V, dtype=torch.float32, device=cuda))
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    for k in got:
        np.testing.assert_allclose(got[k].double().cpu().numpy(), ref_sig[k].numpy(),
                                   rtol=1e-4, err_msg=k)
    err = float((c32.double().cpu() - ref_c).abs().max())
    assert err < 1e-5 * float(ref_c.abs().max())

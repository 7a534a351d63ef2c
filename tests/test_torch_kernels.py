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
two launches equal bit for bit (a fixed summation order); march:
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
    sigma_from_lines_shards,
    two_float,
    voigt_coefficients,
)
from clearsky_tpu_torch.ops.linesum_cuda import sigma_lines, stencil_correction
from clearsky_tpu_torch.rt import discretized as td
from clearsky_tpu_torch.rt import march_cuda
from clearsky_tpu_torch.rt.march_cuda import olr_march, monoflux_march
from clearsky_tpu_torch.rt import fused_table as tft
from clearsky_tpu_torch.rt.fused_table_cuda import fused_olr, fused_monoflux
from clearsky_tpu_torch.utils import cuda_build, profiling
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
    counts = (profiling.counters["launch.linesum"], profiling.counters["launch.march.olr"],
              profiling.counters["launch.march.monoflux"])
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
    assert (profiling.counters["launch.linesum"], profiling.counters["launch.march.olr"],
            profiling.counters["launch.march.monoflux"]) == counts


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
    before = profiling.counters["launch.linesum"]
    out = sigma_lines(plan, lines.to(torch.float32, cuda), *_t(states, torch.float32, cuda),
                      shape=shape)
    torch.cuda.synchronize()
    assert profiling.counters["launch.linesum"] == before + 1
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
    before = profiling.counts("launch.linesum.")
    fast = linesum_cuda.far_reciprocal_ok(linesum_cuda.WINDOW_MODES[mode],
                                          voigt_coefficients(S, a, g), 1, zz["cut"])
    out = linesum_cuda.launch_mode(linesum_cuda.WINDOW_MODES[mode], grid_dev, l32, coef, n,
                                   n_out, linesum_cuda._zones(**zz), d_near, fast=fast)
    torch.cuda.synchronize()
    assert profiling.counts("launch.linesum.")[mode] == before[mode] + 1
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
    before = profiling.counters["launch.correction"]
    out = stencil_correction(torch.zeros((n, plan.n_nu), device=cuda), geom, co32, 25.0, weight)
    torch.cuda.synchronize()
    assert profiling.counters["launch.correction"] == before + 1
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
        by_mode, corr = profiling.counts("launch.linesum."), profiling.counters["launch.correction"]
        out = sigma_from_lines_auto(plan, l32, *x32, strategy=strategy)
        torch.cuda.synchronize()
        got = {k: v - by_mode[k] for k, v in profiling.counts("launch.linesum.").items()
               if v != by_mode[k]}
        assert got == modes and profiling.counters["launch.correction"] == corr + 1
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
    before = profiling.counts("launch.linesum.")[key]
    out = sigma_lines(plan, lines.to(torch.float32, cuda), *_t(x, torch.float32, cuda),
                      shape=shape)
    torch.cuda.synchronize()
    assert profiling.counts("launch.linesum.")[key] == before + 1
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
    if mode == "fine":
        assert coef.shape == (lines.n_lines, 2, n, 4)
    else:
        assert coef.shape == (lines.n_lines, n, linesum_cuda._N_COEF[m]) == (lines.n_lines, n, 4)
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
    before = profiling.counts("launch.linesum.")[f"phco2_{mode}"]
    bcoef = linesum_cuda.chi_rates(T)
    fast = linesum_cuda.far_reciprocal_ok(m, voigt_coefficients(S, a, g), 1, zz["cut"], bcoef)
    out = linesum_cuda.launch_mode(m, grid_dev, l32, coef, n, n_out, linesum_cuda._zones(**zz),
                                   d_near, bcoef=bcoef, fast=fast)
    torch.cuda.synchronize()
    assert profiling.counts("launch.linesum.")[f"phco2_{mode}"] == before + 1
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
    before = profiling.counters["launch.correction.phco2"]
    out = stencil_correction(torch.zeros((n, plan.n_nu), device=cuda), geom, co32, plan.cut,
                             weight, T=T32[0])
    torch.cuda.synchronize()
    assert profiling.counters["launch.correction.phco2"] == before + 1
    ref = ls.stencil_correction_plain(geom, co64, plan.cut, plan.n_nu, weight, T=x64[0])
    peak = sigma_from_lines(plan, lines, *x64, shape="phco2").abs().amax(dim=1, keepdim=True)
    assert float(((out.double().cpu() - ref).abs() / peak).max()) < 1e-4


# --- the correction's gather: order, crowding, widths and shapes ---------------

def _reordered(lines, order):
    """``lines`` with its lines in ``order``."""
    import dataclasses

    from clearsky_tpu_torch.spectra.lines import PER_LINE_FIELDS

    order = torch.as_tensor(order)
    return dataclasses.replace(lines, **{f: getattr(lines, f)[order] for f in PER_LINE_FIELDS})


def _permuted(lines, seed):
    """``lines`` in a random order (the readers sort; a merged mixture or a
    hand-built catalog need not)."""
    return _reordered(lines, np.random.default_rng(seed).permutation(lines.n_lines))


def _sorted(lines):
    return _reordered(lines, np.argsort(lines.positions64(), kind="stable"))


def _correction_case(lines, nu, cut, shape, n, weighted, cuda, K=None, monkeypatch=None):
    """The correction's operands for ``lines`` on ``nu``: (geometry, float32
    coefficients and T on the card, float64 ones on the host, weight, each
    state's peak float64 cross-section). ``K`` forces the stencil width."""
    plan = build_line_window_plan(nu, np.sort(lines.positions64()), cut)
    if K is not None:
        monkeypatch.setattr(ls, "_stencil_width", lambda plan, lines: K)
    geom = ls._build_stencil_geom(plan, lines)
    assert geom is not None and (K is None or geom.K == K)
    x32, x64 = _t(_mode_states(n), torch.float32, cuda), _t(_mode_states(n))
    co32 = ls.coefficients(lines.to(torch.float32, cuda), *x32, shape=shape)[1]
    co64 = ls.coefficients(lines, *x64, shape=shape)[1]
    weight = None
    if weighted:
        d_far = ls.coarse_params(plan, 0.6)[0]
        weight = (d_far * d_far, 4.0 * d_far * d_far)
    chi = shape.startswith("phco2")
    peak = sigma_from_lines(plan, _sorted(lines).to(torch.float64, cuda),
                            *_t(_mode_states(n), device=cuda),
                            shape=shape).abs().amax(dim=1, keepdim=True).cpu()
    return (geom, co32, x32[0] if chi else None, co64, x64[0] if chi else None, weight, peak)


def _correction_err(case, cut, n_nu, cuda, out=None):
    """(kernel result, its error against the float64 plain version over each
    state's peak sigma) of one launch onto zeros (or ``out``)."""
    geom, co32, T32, co64, T64, weight, peak = case
    n = co32[0].shape[0]
    out = torch.zeros((n, n_nu), device=cuda) if out is None else out
    got = stencil_correction(out, geom, co32, cut, weight, T=T32)
    torch.cuda.synchronize()
    ref = ls.stencil_correction_plain(geom, co64, cut, n_nu, weight, T=T64)
    assert bool(torch.isfinite(got).all())
    return got, float(((got.double().cpu() - ref).abs() / peak).max())


def _dense_case(which, dense, dense_phco2):
    """(lines, grid, cut, shape) of the voigt or the phco2 dense fixture."""
    if which == "voigt":
        lines, plans = dense
        return lines, plans["odd"].nu, 25.0, "voigt"
    lines, plan = dense_phco2
    return lines, plan.nu, plan.cut, "phco2"


@pytest.mark.gpu
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("which", ["voigt", "phco2"])
def test_correction_launches_are_bitwise_repeatable(dense, dense_phco2, cuda, which, weighted):
    """Each point's terms add in the schedule's order, with no float atomic:
    two launches on the same inputs (onto zeros, and onto a random sigma)
    give the same bits, and rows that no line reaches keep theirs."""
    lines, nu, cut, shape = _dense_case(which, dense, dense_phco2)
    case = _correction_case(lines, nu, cut, shape, 57, weighted, cuda)
    geom, co32, T32, _, _, weight, _ = case
    n_nu = nu.shape[0]
    a, err = _correction_err(case, cut, n_nu, cuda)
    b, _ = _correction_err(case, cut, n_nu, cuda)
    assert torch.equal(a, b) and err < 1e-4
    base = torch.randn((57, n_nu), generator=torch.Generator().manual_seed(1)).to(cuda)
    c = stencil_correction(base.clone(), geom, co32, cut, weight, T=T32)
    d = stencil_correction(base.clone(), geom, co32, cut, weight, T=T32)
    torch.cuda.synchronize()
    assert torch.equal(c, d)
    K = geom.K
    reached = np.zeros(geom.R, bool)
    reached[ls.correction_rows(geom, cut, n_nu)["rows"][:, 0]] = True
    idle = torch.as_tensor(~np.repeat(reached, K)[:n_nu])
    assert idle.any() and torch.equal(c.cpu()[:, idle], base.cpu()[:, idle])


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["voigt", "phco2"])
def test_correction_of_an_unsorted_catalog(dense, dense_phco2, cuda, which):
    """A catalog in random order: the schedule sorts each row's lines by
    (q, catalog index); the kernel agrees with its plain version on the
    same catalog, and with the sorted catalog's result to float32 rounding
    (the terms add in another order)."""
    lines, nu, cut, shape = _dense_case(which, dense, dense_phco2)
    mixed = _permuted(lines, 7)
    assert (np.diff(mixed.positions64()) < 0).any()
    got, err = _correction_err(_correction_case(mixed, nu, cut, shape, 11, True, cuda), cut,
                               nu.shape[0], cuda)
    want, _ = _correction_err(_correction_case(lines, nu, cut, shape, 11, True, cuda), cut,
                              nu.shape[0], cuda)
    assert err < 1e-4
    scale = want.abs().amax(dim=1, keepdim=True)
    assert float(((got - want).abs() / scale).max()) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("n", [11, 57])
@pytest.mark.parametrize("which", ["voigt", "phco2"])
def test_correction_of_one_crowded_row(dense, dense_phco2, cuda, which, n):
    """Every line of the catalog in one row of the stencil's row grid: two
    work items of all the lines, summed through many staged chunks and
    evaluation rounds, against the plain version."""
    import dataclasses

    lines, nu, cut, shape = _dense_case(which, dense, dense_phco2)
    g0 = ls._build_stencil_geom(build_line_window_plan(nu, lines.positions64(), cut), lines)
    K, r = g0.K, g0.R // 2
    lo, hi = nu[r * K + K // 2], nu[r * K + K // 2 + K - 1]
    pos = np.sort(np.random.default_rng(2).uniform(lo, hi, lines.n_lines))
    crowd = dataclasses.replace(lines, nu=torch.tensor(pos),
                                nu_lo=torch.zeros(lines.n_lines, dtype=torch.float64))
    case = _correction_case(crowd, nu, cut, shape, n, True, cuda)
    assert (case[0].q == r).all()
    _, err = _correction_err(case, cut, nu.shape[0], cuda)
    assert err < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("K", [40, 56, 64])
@pytest.mark.parametrize("which", ["voigt", "phco2"])
def test_correction_at_each_stencil_width(dense, dense_phco2, cuda, which, K, monkeypatch):
    """The row widths of the main grids (K = 40 phco2, 56 voigt) and the
    widest (64), at the main path's 57 states (7 x 8 + 1: two tiles)."""
    lines, nu, cut, shape = _dense_case(which, dense, dense_phco2)
    case = _correction_case(lines, nu, cut, shape, 57, True, cuda, K=K,
                            monkeypatch=monkeypatch)
    _, err = _correction_err(case, cut, nu.shape[0], cuda)
    assert err < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["voigt", "phco2"])
def test_correction_at_the_rcm_shape(cuda, shape):
    """chip_smoke.py's RCM shape: its 5,599-line catalog on 16,384 points
    (K = 8), 20 states; the stencil route's unweighted correction for voigt,
    the coarse route's weighted chi instance for phco2."""
    lines = ct.SpectralLines.from_par_dict(ct.synthetic_co2_par(5599, seed=0),
                                           dtype=torch.float64, device="cpu")
    pos = lines.positions64()
    cut = 25.0 if shape == "voigt" else 500.0
    nu = np.linspace(max(pos.min() - cut, 1.0), pos.max() + cut, 16384)
    case = _correction_case(lines, nu, cut, shape, 20, shape == "phco2", cuda)
    assert case[0].K == 8
    _, err = _correction_err(case, cut, nu.shape[0], cuda)
    assert err < 1e-4


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
        by_mode = profiling.counts("launch.linesum.")
        corr = (profiling.counters["launch.correction"],
                profiling.counters["launch.correction.phco2"])
        out = sigma_from_lines_auto(plan, l32, *x32, shape=shape, strategy=strategy)
        torch.cuda.synchronize()
        got = {k: v - by_mode[k] for k, v in profiling.counts("launch.linesum.").items()
               if v != by_mode[k]}
        assert got == modes
        k = 1 if shape == "phco2" else 0
        assert (profiling.counters["launch.correction"],
                profiling.counters["launch.correction.phco2"])[k] == corr[k] + 1
        assert _of_peak(out, plain) < 1e-5, strategy


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["phco2", "voigt"])
def test_coarse_route_without_stencil_matches_plain(dense_phco2, cuda, shape, monkeypatch):
    """The coarse route where the stencil geometry rejects the grid (as at
    2^20 points): the FINE mode's fine pass on its own pack and COARSE, on
    the card against the float64 plain version on the same geometry."""
    import dataclasses

    lines, plan = dense_phco2
    if shape == "voigt":
        plan = build_line_window_plan(np.linspace(2300.0, 2350.0, 8192), lines.positions64(),
                                      25.0)
    l32 = lines.to(torch.float32, cuda)
    x32, x64 = _t(_mode_states(11), torch.float32, cuda), _t(_mode_states(11))
    params = ls.coarse_params(plan, 0.6)
    nostencil = lambda g: dataclasses.replace(g, stencil=None, _on_device={})
    geom = nostencil(ls.coarse_geometry(plan, l32, params))
    monkeypatch.setattr(linesum_cuda, "coarse_geometry", lambda *a: geom)
    by_mode = profiling.counts("launch.linesum.")
    out = linesum_cuda.sigma_coarse(plan, l32, *x32, params, shape=shape)
    torch.cuda.synchronize()
    got = {k: v - by_mode[k] for k, v in profiling.counts("launch.linesum.").items()
           if v != by_mode[k]}
    fam = "phco2_" if shape == "phco2" else ""
    assert got == {fam + "fine": 1, fam + "coarse": 1}
    ref = ls.coarse_route_plain(nostencil(ls.coarse_geometry(plan, lines, params)), lines, *x64,
                                shape=shape)
    assert bool(torch.isfinite(out).all()) and _of_peak(out, ref) < 1e-5


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
    before = profiling.counts("launch.linesum.")
    if kind == "segmented":
        out = linesum_cuda.sigma_segmented(plan, l32, *x32, L, shape=shape)
        ref = ls.sigma_segmented_plain(plan, lines, *x64, L, shape=shape)
    else:
        out = _LARGE[kind](plan, l32, *x32, shape=shape)
        ref = {"lane": ls.sigma_lane_plain, "gathered": ls.sigma_gathered_plain}[kind](
            plan, lines, *x64, shape=shape)
    torch.cuda.synchronize()
    got = {k: v - before[k] for k, v in profiling.counts("launch.linesum.").items()
           if v != before[k]}
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
    bc = linesum_cuda.chi_rates(T)
    coef, reach, fast = linesum_cuda.full_pack("phco2", S, a, g, plan.cut, bc)
    with pytest.raises(ValueError):       # phco2 without chi's rates
        linesum_cuda.launch_fullprofile("phco2", False, grid, l32, coef, 3, plan.n_nu, plan.cut,
                                        reach, fast)
    with pytest.raises(ValueError):       # phco2 without its near reach
        linesum_cuda.launch_fullprofile("phco2", True, grid, l32, coef, 3, plan.n_nu, plan.cut,
                                        None, fast, bc)
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
    counts = profiling.counts("launch.linesum.")
    for kind in _LARGE:
        L = 200 if kind == "segmented" else None
        np.testing.assert_array_equal(_large_call(kind, plan, lines, x, L).numpy(),
                                      _large_plain(kind, plan, lines, x, L).numpy())
    assert profiling.counts("launch.linesum.") == counts


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
    before = profiling.counts("launch.linesum.")
    out = _large_call(kind, plan, l32, _t(_mode_states(n), torch.float32, cuda), L)
    torch.cuda.synchronize()
    got = {k: v - before[k] for k, v in profiling.counts("launch.linesum.").items()
           if v != before[k]}
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
    before = profiling.counts("launch.linesum.")["segmented"]
    out = linesum_cuda.sigma_segmented(plan, lines.to(torch.float32, cuda),
                                       *_t(_mode_states(n), torch.float32, cuda), L,
                                       conc=conc.float().to(cuda))
    torch.cuda.synchronize()
    assert profiling.counts("launch.linesum.")["segmented"] == before + len(segs) == before + k
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


# --- K1's work items: a block whose window holds most lines --------------------

def _crowded_grid():
    lines = ct.SpectralLines.from_par_dict(ct.synthetic_co2_par(6000, seed=3),
                                           dtype=torch.float64, device="cpu")
    nu = np.concatenate([np.linspace(2340.0, 2350.0, 128), 2450.0 + 0.1 * np.arange(1920)])
    return lines, build_line_window_plan(nu, lines.positions64(), 25.0)


@pytest.fixture(scope="module")
def crowded():
    """A 6000-line catalog (its 2349 cm^-1 band ends at 2419 cm^-1) under a
    grid whose first block (128 points on 2340-2350) sees the band's 851
    lines within the cut (4 pieces of 256); the other 15 blocks, 0.1 cm^-1
    apart from 2450 on, lie beyond every line's cut: empty windows."""
    return _crowded_grid()


def _crowded_launch(kind, lines, plan, cuda, n, out=None):
    """One K1 launch over the crowded grid, float32 on the card, with its
    float64 plain version: the split mode (with ``out``: adding into it),
    COARSE (voigt, phco2) and FINE_STENCIL on the same blocks at a split of
    d_far = 1 cm^-1, FARALL (voigt, phco2) over the plan's windows, and
    K1-dev (the grid as two shards of the same lines). The launch cuts
    the windows into pieces of ``linesum_cuda.PIECE_LINES`` as it stands
    when it runs (the window modes: as ``linesum_cuda.window_plan`` lays
    them out, its choices overridden by the launch's keyword ``window``)."""
    l32 = lines.to(torch.float32, cuda)
    x = _mode_states(n)
    T, P, Pp = _t(x, torch.float32, cuda)
    x64 = _t(x)
    shape = "phco2" if kind == "coarse_phco2" else "voigt"
    S, a, g = _line_params(l32, T, P, Pp)
    grid = plan.device_arrays(cuda)
    if kind in ("split", "dev"):
        coef, fast = linesum_cuda._packed(0, S, a, g, 1, plan.cut)
        d_near = linesum_cuda.near_distance(a, plan.cut)
        ref = sigma_from_lines(plan, lines, *x64)
        if kind == "dev":
            import dataclasses
            from clearsky_tpu_torch.spectra.lines import PER_LINE_FIELDS

            k, L = 2, lines.n_lines
            l32 = dataclasses.replace(l32, **{f: torch.cat([getattr(l32, f)] * 2)
                                              for f in PER_LINE_FIELDS})
            win = plan.windows().copy()
            win2 = np.concatenate([win, win + np.array([L, 0])])
            grid = {"nu_hi": torch.cat([grid["nu_hi"]] * 2),
                    "nu_lo": torch.cat([grid["nu_lo"]] * 2),
                    "win": torch.as_tensor(win2, dtype=torch.int32, device=cuda)}
            coef, fast = torch.cat([coef, coef]), torch.cat([fast, fast])
            return (lambda **kw: linesum_cuda.launch_mode(0, grid, l32, coef, n, plan.n_nu,
                                                     linesum_cuda._zones(plan.cut),
                                                     torch.cat([d_near, d_near]), n_shards=k,
                                                     fast=fast, **kw),
                    torch.cat([ref, ref], dim=-1))
        return (lambda **kw: linesum_cuda.launch_mode(0, grid, l32, coef, n, plan.n_nu,
                                                      linesum_cuda._zones(plan.cut), d_near,
                                                      out=out, fast=fast, **kw), ref)
    if kind.startswith("farall"):
        shape = "phco2" if kind == "farall_phco2" else "voigt"
        m = linesum_cuda.window_mode("farall", shape)
        bcoef = linesum_cuda.chi_rates(T) if shape == "phco2" else None
        coef, fast = linesum_cuda._packed(m, S, a, g, 1, plan.cut, bcoef)
        co64 = voigt_coefficients(*_line_params(lines, *x64))
        ref = ls.sigma_mode_plain("farall", plan.nu_blocks, plan.windows(), lines, co64,
                                  {"cut": plan.cut},
                                  T=x64[0] if shape == "phco2" else None)[:, :plan.n_nu]
        return (lambda **kw: linesum_cuda.launch_mode(m, grid, l32, coef, n, plan.n_nu,
                                                      linesum_cuda._zones(plan.cut), bcoef=bcoef,
                                                      fast=fast, **kw), ref)
    cut = 25.0
    z = ls.split_zones(cut, 1.0, 0.1)
    if kind.startswith("fine") and kind != "fine_stencil":
        # FINE (voigt, phco2) on the same blocks, the near core of d_near
        shape = "phco2" if kind == "fine_phco2" else "voigt"
        m = linesum_cuda.window_mode("fine", shape)
        bcoef = linesum_cuda.chi_rates(T) if shape == "phco2" else None
        coef, fast = linesum_cuda._packed(m, S, a, g, 1, cut, bcoef)
        d_near = linesum_cuda.near_distance(linesum_cuda.effective_alpha(shape, a), z["cut_f"])
        a64, co64 = ls.coefficients(lines, *x64, shape=shape)
        windows, _ = ls.split_windows(lines.positions64(), plan.nu_blocks, plan.nu_blocks, cut,
                                      1.0, 0.1)
        grid = {"nu_hi": grid["nu_hi"], "nu_lo": grid["nu_lo"],
                "win": torch.as_tensor(windows, dtype=torch.int32, device=cuda)}
        ref = ls.sigma_mode_plain("fine", plan.nu_blocks, windows, lines, co64, z,
                                  torch.clamp(15.0 * a64.max(), max=z["cut_f"]),
                                  T=x64[0] if shape == "phco2" else None)[:, :plan.n_nu]
        return (lambda **kw: linesum_cuda.launch_mode(m, grid, l32, coef, n, plan.n_nu,
                                                      linesum_cuda._zones(**z), d_near,
                                                      bcoef=bcoef, fast=fast, **kw), ref)
    if kind == "fine_stencil":
        coef, fast = linesum_cuda._packed(5, S, a, g, 1, cut)
        co64 = voigt_coefficients(*_line_params(lines, *x64))
        windows, _ = ls.split_windows(lines.positions64(), plan.nu_blocks, plan.nu_blocks, cut,
                                      1.0, 0.1)
        grid = {"nu_hi": grid["nu_hi"], "nu_lo": grid["nu_lo"],
                "win": torch.as_tensor(windows, dtype=torch.int32, device=cuda)}
        ref = ls.sigma_mode_plain("fine_stencil", plan.nu_blocks, windows, lines, co64,
                                  z)[:, :plan.n_nu]
        return (lambda **kw: linesum_cuda.launch_mode(5, grid, l32, coef, n, plan.n_nu,
                                                      linesum_cuda._zones(**z), fast=fast, **kw),
                ref)
    m = linesum_cuda.window_mode("coarse", shape)
    bcoef = linesum_cuda.chi_rates(T) if shape == "phco2" else None
    coef, fast = linesum_cuda._packed(m, S, a, g, 1, cut, bcoef)
    co64 = voigt_coefficients(*_line_params(lines, *x64))
    _, windows = ls.split_windows(lines.positions64(), plan.nu_blocks, plan.nu_blocks, cut, 1.0,
                                  0.1)
    grid = {"nu_hi": grid["nu_hi"], "nu_lo": grid["nu_lo"],
            "win": torch.as_tensor(windows, dtype=torch.int32, device=cuda)}
    ref = ls.sigma_mode_plain("coarse", plan.nu_blocks, windows, lines, co64, z,
                              T=x64[0] if shape == "phco2" else None)[:, :plan.n_nu]
    return (lambda **kw: linesum_cuda.launch_mode(m, grid, l32, coef, n, plan.n_nu,
                                                  linesum_cuda._zones(**z), bcoef=bcoef,
                                                  fast=fast, **kw), ref)


_CROWDED = ["split", "acc", "coarse", "coarse_phco2", "dev", "farall", "farall_phco2",
            "fine_stencil", "fine", "fine_phco2"]
_WINDOW_KINDS = ["farall", "farall_phco2", "fine_stencil", "fine", "fine_phco2"]


def _crowded_check(kind, out, ref):
    if kind.startswith(("coarse", "farall", "fine")):
        assert bool(torch.isfinite(out).all()) and _of_peak(out, ref) < 1e-5
    else:
        _check_sigma(out, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", _CROWDED)
@pytest.mark.parametrize("n", [1, 11, 57])
def test_crowded_window_matches_plain(crowded, cuda, kind, n):
    """K1 where one block's window holds every line within a cut (4 pieces),
    against its plain version in float64, the bars of the mode; ``acc`` adds
    into a sigma and leaves before + the fresh sum, bit for bit."""
    lines, plan = crowded
    table, n_slots = linesum_cuda.piece_schedule(plan.windows(), 1, linesum_cuda.PIECE_LINES)
    assert plan.count[1:].sum() == 0 and plan.count[0] > 3 * linesum_cuda.PIECE_LINES
    assert int(table[:, 5].max()) == 4 and n_slots == 4
    if kind == "acc":
        launch, ref = _crowded_launch("split", lines, plan, cuda, n)
        fresh = launch()
        before = torch.randn((n, plan.n_nu), device=cuda)
        out = before.clone()
        _crowded_launch("split", lines, plan, cuda, n, out=out)[0]()
        torch.cuda.synchronize()
        assert torch.equal(out, before + fresh)
        _check_sigma(fresh, ref)
        return
    launch, ref = _crowded_launch(kind, lines, plan, cuda, n)
    out = launch()
    torch.cuda.synchronize()
    _crowded_check(kind, out, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", _CROWDED[:1] + _CROWDED[2:])
def test_k1_launches_are_bitwise_repeatable(crowded, cuda, kind):
    """Two launches on the same operands give the same bits: a block's
    pieces add up in piece order, whichever finishes last."""
    lines, plan = crowded
    launch, _ = _crowded_launch(kind, lines, plan, cuda, 57)
    first = launch().clone()
    for _ in range(3):
        assert torch.equal(launch(), first)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", _CROWDED[:1] + _CROWDED[2:])
@pytest.mark.parametrize("piece_lines", [1, 7, 32])
def test_k1_many_pieces_equal_one_piece(crowded, cuda, kind, piece_lines, monkeypatch):
    """A window cut into many pieces (1, 7 or 32 lines each) against the same
    window as one piece, within the split mode's bar, and both against the
    plain version."""
    lines, plan = crowded
    launch, ref = _crowded_launch(kind, lines, plan, cuda, 11)
    pieces = lambda p: {"window": {"piece_lines": p}} if kind in _WINDOW_KINDS else {}
    monkeypatch.setattr(linesum_cuda, "PIECE_LINES", piece_lines)
    a = launch(**pieces(piece_lines)).clone()
    monkeypatch.setattr(linesum_cuda, "PIECE_LINES", 10**6)
    b = launch(**pieces(10**6))
    torch.cuda.synchronize()
    _check_sigma(a, b.double().cpu())
    _crowded_check(kind, a, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", _WINDOW_KINDS)
@pytest.mark.parametrize("groups,points", [(1, 2), (2, 1), (2, 2), (4, 2)])
def test_window_groups_equal_one_group(crowded, cuda, kind, groups, points):
    """The window kernel's thread groups (each summing its part of every
    chunk, the groups' sums added in group order) and points a thread
    against one group of one point a thread: the same bits with one group
    (a point's terms in the same order), else within float32 reordering
    (1e-6 of each state's peak); both against the plain version."""
    lines, plan = crowded
    launch, ref = _crowded_launch(kind, lines, plan, cuda, 11)
    plan_of = lambda g, t: {"window": {"groups": g, "points_per_thread": t}}
    a = launch(**plan_of(groups, points)).clone()
    assert torch.equal(launch(**plan_of(groups, points)), a)
    b = launch(**plan_of(1, 1))
    torch.cuda.synchronize()
    if groups == 1:
        assert torch.equal(a, b)
    assert _of_peak(a, b.double().cpu()) < 1e-6
    _crowded_check(kind, a, ref)


# sha1 of the window modes' output bytes on the crowded grid (57 states),
# as the kernels gave them before FINE joined the window kernel: its path
# leaves the other modes' bits
WINDOW_DIGESTS = {"farall": "f00d0d824dff16ce1558c6ca43a3af2cdbf631cc",
                  "farall_phco2": "a8bd45e6e61f53804db356d62ebaaf8c8280af25",
                  "fine_stencil": "74eeea8ecb2bacd0c7c966fde3492c5c189d0ff9"}


def window_digests(cuda):
    """{kind: sha1 of the output bytes} of FARALL (voigt, phco2) and
    FINE_STENCIL on the crowded grid at 57 states, for :data:`WINDOW_DIGESTS`."""
    import hashlib

    lines, plan = _crowded_grid()
    out = {}
    for kind in ("farall", "farall_phco2", "fine_stencil"):
        launch, _ = _crowded_launch(kind, lines, plan, cuda, 57)
        out[kind] = hashlib.sha1(launch().cpu().numpy().tobytes()).hexdigest()
    return out


@pytest.mark.gpu
def test_other_window_modes_keep_their_bits(cuda):
    """FARALL (voigt, phco2) and FINE_STENCIL give the bits recorded before
    FINE joined the window kernel, on fixed inputs: FINE's path leaves them."""
    assert window_digests(cuda) == WINDOW_DIGESTS


@pytest.mark.gpu
def test_k1_builds_for_half_the_warps(cuda):
    """Every K1 mode but the no-split sweeps holds at least 32 of an SM's 64
    warps resident in blocks of 128 threads (registers and shared memory)."""
    for mode in linesum_cuda._MODE_NAMES:
        info = linesum_cuda.kernel_info(mode, 128)
        if mode not in linesum_cuda.NOSPLIT_MODES.values():
            assert info["resident_warps"] >= 0.5, (mode, info)


@pytest.mark.gpu
def test_gathered_kernel_runs_every_state_in_one_launch(dense, cuda):
    """K5 at 11 states: one launch a call, no slab gathered; its output is
    the states' calls in groups of 3 (as the simple K5 ran them), to
    float32 summation order."""
    lines, plans = dense
    plan = plans["uniform"]
    l32 = lines.to(torch.float32, cuda)
    x = _t(_mode_states(11), torch.float32, cuda)
    before = profiling.counts("launch.linesum.")["gathered"]
    whole = linesum_cuda.sigma_gathered(plan, l32, *x)
    torch.cuda.synchronize()
    assert profiling.counts("launch.linesum.")["gathered"] == before + 1
    parts = torch.cat([linesum_cuda.sigma_gathered(plan, l32, *(v[a:a + 3] for v in x))
                       for a in range(0, 11, 3)])
    np.testing.assert_allclose(parts.cpu().numpy(), whole.cpu().numpy(), rtol=1e-5, atol=1e-32)


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
    coef, reach, fast = linesum_cuda.full_pack("voigt", S, a, g, 25.0)
    int64 = dict(grid, win=grid["win"].long())
    with pytest.raises(ValueError):           # an int64 window table
        linesum_cuda.launch_fullprofile("voigt", True, int64, l32, coef, 3, plan.n_nu, 25.0,
                                        reach, fast)
    with pytest.raises(ValueError):           # a pack of another catalog
        linesum_cuda.launch_fullprofile("voigt", False, grid, l32, coef[1:].contiguous(), 3,
                                        plan.n_nu, 25.0, reach, fast)
    with pytest.raises(TypeError):            # a float64 pack
        linesum_cuda.launch_fullprofile("voigt", False, grid, l32, coef.double(), 3, plan.n_nu,
                                        25.0, reach, fast)


# --- K4 and K5: the window kernel's FULL modes --------------------------------

FULL_SHAPES = ("voigt", "phco2", "lorentz", "doppler")


def _full_case(shape, crowded, dense_phco2, n):
    """(plan, float64 lines, float64 states) of a crowded window: the
    crowded grid's first block sees 851 lines within 25 cm^-1 (voigt,
    lorentz, doppler); phco2 the 400-line catalog under a 2048-point grid at
    cut 500, every block's window the whole catalog; ``n`` states from 2 Pa
    (y0 < 0.01) to 1e5 Pa."""
    if shape == "phco2":
        lines, _ = dense_phco2
        pos = lines.positions64()
        plan = build_line_window_plan(np.linspace(pos.min() - 500.0, pos.max() + 500.0, 2048),
                                      pos, 500.0)
    else:
        lines, plan = crowded
    x = (np.linspace(180.0, 310.0, n), np.geomspace(2.0, 1e5, n))
    return plan, lines, x + (0.5 * x[1],)


def _full_call(kind, shape, plan, lines, x, cuda, window=None):
    """K4 ("lane") or K5 through launch_fullprofile, the pack made as the
    wrappers make it, on the plan ``window`` overrides."""
    l32 = lines.to(torch.float32, cuda)
    T, P, Pp = _t(x, torch.float32, cuda)
    S, a, g = _line_params(l32, T, P, Pp)
    bc = linesum_cuda.chi_rates(T) if shape == "phco2" else None
    coef, reach, fast = linesum_cuda.full_pack(shape, S, a, g, plan.cut, bc)
    return linesum_cuda.launch_fullprofile(shape, kind == "gathered", plan.device_arrays(cuda),
                                           l32, coef, T.shape[0], plan.n_nu, plan.cut, reach,
                                           fast, bc, window=window)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["lane", "gathered"])
@pytest.mark.parametrize("shape", FULL_SHAPES)
def test_full_kernels_at_57_states_in_a_crowded_window(crowded, dense_phco2, cuda, shape, kind):
    """K4 and K5 at 57 states (y0 < 0.01 among them) over a window of more
    than 256 lines, in pieces of the plan's length and of 64 lines, against
    the plain version in float64; one launch a call."""
    plan, lines, x = _full_case(shape, crowded, dense_phco2, 57)
    assert int(plan.count.max()) > 256
    ref = {"lane": ls.sigma_lane_plain, "gathered": ls.sigma_gathered_plain}[kind](
        plan, lines, *_t(x), shape=shape)
    key = ("phco2_" if shape == "phco2" else "") + kind
    for window in (None, {"piece_lines": 64}):
        before = profiling.counts("launch.linesum.")[key]
        out = _full_call(kind, shape, plan, lines, x, cuda, window)
        torch.cuda.synchronize()
        assert profiling.counts("launch.linesum.")[key] == before + 1
        _check_sigma(out, ref)
    grid = plan.device_arrays(cuda)
    got = linesum_cuda.full_plan(shape, grid, 57, {"piece_lines": 64})
    assert got["pieces"] > plan.n_blocks and got["scratch_slots"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("shape", FULL_SHAPES)
def test_full_kernels_are_bitwise_repeatable(crowded, dense_phco2, cuda, shape):
    """Two launches of K4 and of K5 (pieces of 64 lines through scratch) give
    the same bits: no float atomic."""
    plan, lines, x = _full_case(shape, crowded, dense_phco2, 11)
    for kind in ("lane", "gathered"):
        a = _full_call(kind, shape, plan, lines, x, cuda, {"piece_lines": 64})
        b = _full_call(kind, shape, plan, lines, x, cuda, {"piece_lines": 64})
        torch.cuda.synchronize()
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", FULL_SHAPES)
def test_k4_against_k5(crowded, dense_phco2, cuda, shape):
    """K4 and K5 sum the same in-cut lines in the same order (the lane
    layout's windows add only lines beyond every point's cut), through the
    same launch: the same bits, each route's counter counted once."""
    plan, lines, x = _full_case(shape, crowded, dense_phco2, 57)
    fam = "phco2_" if shape == "phco2" else ""
    before = {k: profiling.counts("launch.linesum.")[fam + k] for k in ("lane", "gathered")}
    k4 = _full_call("lane", shape, plan, lines, x, cuda)
    k5 = _full_call("gathered", shape, plan, lines, x, cuda)
    torch.cuda.synchronize()
    assert torch.equal(k4, k5)
    assert all(profiling.counts("launch.linesum.")[fam + k] == v + 1 for k, v in before.items())


@pytest.mark.gpu
def test_full_kernels_build_without_heavy_spills(cuda):
    """K4/K5's FULL instances at one and two points a thread (blocks of one
    128-point row): at most 64 registers and 256 bytes of local memory a
    thread, and a quarter of an SM's warps resident at least (the voigt
    instance's two points a thread runs blocks of 2 warps, which registers
    and shared memory cap)."""
    for mode in linesum_cuda.FULL_MODES.values():
        for points in (1, 2):
            info = linesum_cuda.kernel_info(mode, 128 // points, points)
            assert info["registers"] <= 64 and info["local_bytes"] <= 256, (mode, points, info)
            assert info["resident_warps"] >= 0.25, (mode, points, info)


@pytest.mark.gpu
@pytest.mark.parametrize("nstream", [1, 5, 8])
def test_march_kernels_match_plain(cuda, nstream):
    m, W = stream_nodes(nstream)
    x32 = _t(_column(), torch.float32, cuda)
    x64 = [x.double().cpu() for x in x32]
    counts = (profiling.counters["launch.march.olr"], profiling.counters["launch.march.monoflux"])
    olr = olr_march(x32[0], x32[1], m, W)
    up, dn = monoflux_march(*x32, CTHETA, m, W)
    torch.cuda.synchronize()
    assert (profiling.counters["launch.march.olr"],
            profiling.counters["launch.march.monoflux"]) == (counts[0] + 1, counts[1] + 1)
    olr_r = td._olr_march(x64[0], x64[1], m, W)
    up_r, dn_r = td._monoflux_march(*x64, CTHETA, m, W)
    for k, r in ((olr, olr_r), (up, up_r), (dn, dn_r)):
        assert float((k.double().cpu() - r).abs().max()) < 3.5e-6 * float(r.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("nstream", [1, 5, 8])
@pytest.mark.parametrize("L,N", [(19, 2**19), (38, 16384), (160, 16384), (38, 16385),
                                 (40, 140001), (152, 2**19)])
def test_march_kernels_at_the_main_shapes(cuda, L, N, nstream):
    """K2/K3 in both layouts of their plan (a warp a stream below 135,168
    points, a thread a point above), at the main path's shapes (19 x 2^19,
    the RCM's 38 x 16,384, RadauEq(refine=8)'s 152 x 2^19), at L beyond one
    shared-memory tile (160 layers: K2 stages 2 chunks, K3 4; 40 and 152
    layers above K3's 28 kept ones) and at ragged N, against the plain
    float64 march: 3.5e-6 of peak. Two launches give the same bits."""
    m, W = stream_nodes(nstream)
    x32 = _t(_column(L, N, seed=L + nstream), torch.float32, cuda)
    x64 = [x.double() for x in x32]
    olr = [olr_march(x32[0], x32[1], m, W) for _ in range(2)]
    mono = [monoflux_march(*x32, CTHETA, m, W) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(olr[0], olr[1])
    assert all(torch.equal(a, b) for a, b in zip(*mono))
    olr_r = td._olr_march(x64[0], x64[1], m, W)
    up_r, dn_r = td._monoflux_march(*x64, CTHETA, m, W)
    for k, r in ((olr[0], olr_r), (mono[0][0], up_r), (mono[0][1], dn_r)):
        assert bool(torch.isfinite(k).all())
        assert float((k.double() - r).abs().max()) < 3.5e-6 * float(r.abs().max())


@pytest.mark.gpu
def test_march_kernel_info_matches_the_plan(cuda):
    """The build of each layout holds its plan's block: resident blocks,
    no spills."""
    for kind, L, N in (("olr", 19, 2**19), ("monoflux", 19, 2**19), ("olr", 38, 16384),
                       ("monoflux", 38, 16384), ("monoflux", 160, 16384)):
        info = march_cuda.kernel_info(kind, L, N, 5)
        assert info["blocks_per_sm"] >= 1 and info["local_bytes"] == 0, info
        assert info == {**march_cuda.march_plan(kind, L, N, 5), **info}


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


@pytest.mark.gpu
def test_march_kernel_mode_off_keeps_the_march_kernels(cuda):
    """march_kernel_mode("off") turns off only the fused table route: on the
    card the march wrappers still launch K2 and K3, with the same bits."""
    m, W = stream_nodes(5)
    x32 = _t(_column(L=19, N=4096), torch.float32, cuda)
    olr, (up, dn) = olr_march(x32[0], x32[1], m, W), monoflux_march(*x32, CTHETA, m, W)
    counts = (profiling.counters["launch.march.olr"], profiling.counters["launch.march.monoflux"])
    with td.march_kernel_mode("off"):
        olr_o = olr_march(x32[0], x32[1], m, W)
        up_o, dn_o = monoflux_march(*x32, CTHETA, m, W)
    assert (profiling.counters["launch.march.olr"],
            profiling.counters["launch.march.monoflux"]) == (counts[0] + 1, counts[1] + 1)
    for k, o in ((olr, olr_o), (up, up_o), (dn, dn_o)):
        assert torch.equal(k, o)


@pytest.mark.gpu
@pytest.mark.parametrize("refine", [2, 8])
def test_radaueq_is_the_refined_call_on_the_card(cuda, refine):
    """RadauEq's outgoing and radiate on the card: the line sum's kernels and
    K2 (outgoing) or K3 (radiate), one march launch a call, and the values of
    the same computation spelled out with Discretized on the refined levels
    (T interpolated against the caller's levels; the fluxes its rows at the
    caller's levels, integrated) within 1e-6 of peak; tau the refined
    layers' summed back."""
    from clearsky_tpu_torch.rt.fluxes import _refined

    lines = ct.SpectralLines.from_par_dict(ct.synthetic_co2_par(600, seed=21),
                                           dtype=torch.float32, device=cuda)
    p64 = lines.positions64()
    gas = ct.DirectGas.from_lines(lines, 0.95, np.linspace(p64.min() - 25.0, p64.max() + 25.0,
                                                            2**14))
    Pe = ct.pressuregrid(10.0, 1e5, 9)
    Te = np.maximum(288.0 * (Pe / 1e5) ** 0.22, 160.0)
    fS = lambda v: torch.full_like(v, 1e-3)
    Pr, idx = _refined(Pe, refine)
    prof = ct.AtmosphericProfile.create(torch.tensor(Pe, dtype=torch.float32, device=cuda),
                                        torch.tensor(Te, dtype=torch.float32, device=cuda))
    core, disc = ct.RadauEq(refine=refine), ct.Discretized(nlobatto=3)
    before = (profiling.counters["launch.march.olr"], profiling.counters["launch.march.monoflux"],
              profiling.counters["launch.linesum"],
              profiling.counters["launch.correction"])
    olr = ct.outgoing(Pe, 9.8, Te, 0.044, gas, core=core)
    F = ct.radiate(Pe, 9.8, Te, 0.044, fS, 0.1, gas, core=core)
    torch.cuda.synchronize()
    after = (profiling.counters["launch.march.olr"], profiling.counters["launch.march.monoflux"],
             profiling.counters["launch.linesum"],
             profiling.counters["launch.correction"])
    assert after[:2] == (before[0] + 1, before[1] + 1)
    assert after[2] + after[3] > before[2] + before[3]
    olr_r = ct.outgoing(Pr, 9.8, prof, 0.044, gas, core=disc)
    F_r = ct.radiate(Pr, 9.8, prof, 0.044, fS, 0.1, gas, core=disc)
    rows = torch.as_tensor(idx, device=cuda)
    of_peak = lambda a, b: float((a - b).abs().max() / b.abs().max())
    assert of_peak(olr, olr_r) < 1e-6
    # the refined call's rows at the caller's levels, integrated as
    # RadauEq's radiate integrates them
    M_up, M_down = F_r.M_up[rows], F_r.M_down[rows]
    F_up, F_down = td.integrate_flux(M_up, M_down, gas.nu)
    for k, ref in (("M_up", M_up), ("M_down", M_down), ("F_up", F_up), ("F_down", F_down),
                   ("F_net", F_up - F_down)):
        assert of_peak(getattr(F, k), ref) < 1e-6, k
    assert of_peak(F.tau, F_r.tau.reshape(8, refine, -1).sum(1)) < 1e-6


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
    counts = (profiling.counters["launch.fused.olr"], profiling.counters["launch.fused.monoflux"])
    np.testing.assert_array_equal(fused_olr(lead, tail, bl, bt, wq, B, m, W).numpy(),
                                  tft._fused_olr_plain(lead, tail, bl, bt, wq, B, m, W).numpy())
    got = fused_monoflux(lead, tail, bl, bt, wq, B, S, a, CTHETA, m, W)
    for x, y in zip(got, tft._fused_monoflux_plain(lead, tail, bl, bt, wq, B, S, a, CTHETA,
                                                     m, W)):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert (profiling.counters["launch.fused.olr"],
            profiling.counters["launch.fused.monoflux"]) == counts
    # the plain tau is the JAX package's dense block-diagonal quadrature
    L, k = wq.shape
    dense = torch.zeros((L, L * k), dtype=wq.dtype)
    for l in range(L):
        dense[l, l * k:(l + 1) * k] = wq[l]
    ln = bl @ lead + bt.double() @ tail.double()
    np.testing.assert_allclose(got[2].numpy(), (dense @ torch.exp(ln)).numpy(), rtol=1e-13)


@pytest.mark.parametrize("wrapper", ["fused_olr", "fused_monoflux"])
def test_fused_wrappers_carry_derivatives(wrapper, monkeypatch):
    """K6/K7 carry the derivatives of the unfused plain pipeline (the JAX
    package's custom JVPs): on the kernel path, here with the launch
    replaced by the plain version on the CPU, the JVP in the coefficients
    and the Planck rows and the gradient equal the plain version's."""
    from clearsky_tpu_torch.rt import fused_table_cuda
    from clearsky_tpu_torch.utils import twin

    lead, tail, bl, bt, wq, B, S, a = _table_tensors(_table_column(L=2, k=2, N=64))
    m, W = stream_nodes(5)
    plain = {"fused_olr": tft._fused_olr_plain, "fused_monoflux": tft._fused_monoflux_plain}
    wrap = {"fused_olr": fused_olr, "fused_monoflux": fused_monoflux}[wrapper]
    extra = () if wrapper == "fused_olr" else (S, a, CTHETA)

    def flat(fn):
        def f(ld, b):
            out = fn(ld, tail, bl, bt, wq, b, *extra, m, W)
            return torch.cat([o.reshape(-1) for o in (out if isinstance(out, tuple) else (out,))])
        return f

    calls = []
    monkeypatch.setattr(fused_table_cuda, f"_{wrapper}_launch",
                        lambda *x: calls.append(1) or plain[wrapper](*x))
    monkeypatch.setattr(twin, "kernel_path", lambda x: True)
    tangents = (torch.ones_like(lead), 0.1 * torch.ones_like(B))
    got = torch.func.jvp(flat(wrap), (lead, B), tangents)
    want = torch.func.jvp(flat(plain[wrapper]), (lead, B), tangents)
    assert calls == [1]
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-12, atol=0.0)
    lg, lp = lead.clone().requires_grad_(), lead.clone().requires_grad_()
    flat(wrap)(lg, B).sum().backward()
    flat(plain[wrapper])(lp, B).sum().backward()
    np.testing.assert_allclose(lg.grad.numpy(), lp.grad.numpy(), rtol=1e-12, atol=0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("L,k,nstream,N,T", [(1, 3, 2, 333, 272), (19, 3, 5, 4096, 272),
                                             (40, 3, 8, 1000, 272),
                                             (19, 2, 5, 2**16 + 37, 272), (7, 5, 4, 515, 272),
                                             (3, 8, 5, 130, 272), (128, 8, 5, 4099, 272),
                                             (19, 3, 5, 4096, 17)])
def test_fused_kernels_match_plain(cuda, L, k, nstream, N, T):
    """K6 and K7 in float32 against their plain versions in float64 on the
    same split operands: N not a multiple of the 128-point tile (but 4096,
    the 16-byte copies), one to sixteen passes of 64 nodes (L = 128, k = 8:
    1,024 nodes; L = 40, k = 3: a layer across a pass boundary), k = 5 and
    8, and T = 17 tail rows (a chunk of one row)."""
    col = _table_column(L, k, N, seed=L + N, T=T)
    x32 = _table_tensors(col, torch.float32, cuda)
    lead, tail, bl, bt, wq, B, S, a = x32
    x64 = [x.cpu() if x.dtype == torch.bfloat16 else x.double().cpu() for x in x32]
    m, W = stream_nodes(nstream)
    counts = (profiling.counters["launch.fused.olr"], profiling.counters["launch.fused.monoflux"])
    olr = fused_olr(lead, tail, bl, bt, wq, B, m, W)
    up, dn, tau = fused_monoflux(*x32, CTHETA, m, W)
    torch.cuda.synchronize()
    assert (profiling.counters["launch.fused.olr"],
            profiling.counters["launch.fused.monoflux"]) == (counts[0] + 1, counts[1] + 1)
    olr_r = tft._fused_olr_plain(*x64[:6], m, W)
    up_r, dn_r, tau_r = tft._fused_monoflux_plain(*x64, CTHETA, m, W)
    for kern, ref in ((olr, olr_r), (up, up_r), (dn, dn_r)):
        assert float((kern.double().cpu() - ref).abs().max()) < 1e-4 * float(ref.abs().max())
    np.testing.assert_allclose(tau.double().cpu().numpy(), tau_r.numpy(), rtol=1e-4, atol=0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("N", [4096, 1000])
def test_fused_launches_are_bitwise_repeatable(cuda, N):
    """Two launches on the same inputs agree bit for bit (every sum in a
    fixed order: the tensor-core products, the lead's FMAs, the layer
    sums), with 16-byte copies (N = 4096) and without."""
    lead, tail, bl, bt, wq, B, S, a = _table_tensors(_table_column(19, 3, N), torch.float32, cuda)
    m, W = stream_nodes(5)
    runs = [(fused_olr(lead, tail, bl, bt, wq, B, m, W),
             *fused_monoflux(lead, tail, bl, bt, wq, B, S, a, CTHETA, m, W)) for _ in range(2)]
    for x, y in zip(*runs):
        assert torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["olr", "monoflux"])
def test_fused_kernels_hold_the_designed_warps(cuda, kind):
    """At 19 layers (the main column) K6 and K7 keep 4 blocks of 4 warps on
    an SM (16 of 64: the ring, half a pass of sigma, tau and the staged rows
    in ~56 KB a block, at most 128 registers), spill nothing, and launch one
    persistent block per resident slot, at most one per 128-point tile."""
    from clearsky_tpu_torch.rt.fused_table_cuda import kernel_info

    info = kernel_info(kind, 19, 2**19)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert info["resident_warps"] >= 16 / 64
    assert info["local_bytes"] == 0
    assert info["ctas"] == min(2**19 // 128, sms * info["blocks_per_sm"])
    assert kernel_info(kind, 19, 1000)["ctas"] == 8


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
    # an operand that needs a derivative gets one (the Function's graph)
    up, _, _ = fused_monoflux(lead, tail, bl, bt, wq.requires_grad_(True), B, S, a, CTHETA,
                              m, W)
    assert up.grad_fn is not None


@pytest.mark.gpu
def test_table_contractions_ignore_global_tf32(cuda):
    """With TF32 allowed process-wide, Gas.raw_sigma and cheb2d_coeffs keep
    full float32 (their bars fail under TF32's 10-bit mantissa: ~0.03 in an
    ln sigma of 55, 3% in sigma), and K6/K7 give bit for bit what they give
    without it (the lead's FP32 FMAs never take TF32)."""
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
    x32 = _table_tensors(_table_column(19, 3, 4096), torch.float32, cuda)
    m, W = stream_nodes(5)

    def fused():
        lead, tail, bl, bt, wq, B, S, a = x32
        return (fused_olr(lead, tail, bl, bt, wq, B, m, W),
                *fused_monoflux(lead, tail, bl, bt, wq, B, S, a, CTHETA, m, W))

    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        fused_off = fused()
        torch.backends.cuda.matmul.allow_tf32 = True
        g32 = gas(torch.float32, cuda)
        t32, p32 = (torch.tensor(x, dtype=torch.float32, device=cuda) for x in (T, P))
        got = {"full": g32.raw_sigma(t32, p32),
               "split": g32.split_precision(16).raw_sigma(t32, p32)}
        c32 = cheb2d_coeffs(torch.tensor(V, dtype=torch.float32, device=cuda))
        fused_on = fused()
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    for x, y in zip(fused_off, fused_on):
        assert torch.equal(x, y)
    for k in got:
        np.testing.assert_allclose(got[k].double().cpu().numpy(), ref_sig[k].numpy(),
                                   rtol=1e-4, err_msg=k)
    err = float((c32.double().cpu() - ref_c).abs().max())
    assert err < 1e-5 * float(ref_c.abs().max())


@pytest.mark.gpu
def test_flux_contractions_ignore_global_tf32(cuda):
    """With TF32 allowed process-wide, layer_tau_flat (sigma to tau), the
    OLR and the RCM heating (the per-nu product of the heating operator
    with M_up - M_down, trap C5) give what they give with TF32 off: both
    products run in full float32 (TF32's 10-bit mantissa would move tau by
    ~5e-4 and the heating's level differences far more). Both runs also
    hold float64: tau and the OLR at 1e-5, the heating at the RCM's 5e-3 of
    peak."""
    from clearsky_tpu_torch.rt.discretized import layer_tau_flat

    nu = np.linspace(500.0, 900.0, 4096)
    Pe = ct.pressuregrid(10.0, 1e5, 16)
    Te = np.maximum(288.0 * (Pe / 1e5) ** 0.2226, 170.0)
    rng = np.random.default_rng(11)
    sig = np.exp(rng.uniform(-60.0, -45.0, (3 * 15, 4096)))
    muf = np.full(3 * 15, 0.044)

    def run(dtype, device):
        t = lambda x: torch.tensor(x, dtype=dtype, device=device)
        gas = ct.GrayGas.create(3e-25, nu, dtype=dtype, device=device)
        S0 = 340.0 / math.cos(0.841) / 400.0
        rcm = ct.RCM.create(Pe, Te, 9.8, lambda T, P: 0.044, lambda v: torch.full_like(v, S0),
                            0.1, lambda T, P: 850.0, 1e7, gas, radmul=2)
        out = (layer_tau_flat(t(Pe), t(muf), t(sig), 9.8, 3),
               ct.outgoing(Pe, 9.8, Te, 0.044, gas), ct.heating(rcm))
        return [x.double().cpu() for x in out]

    ref = run(torch.float64, "cpu")
    before = torch.backends.cuda.matmul.allow_tf32
    got = {}
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            got[tf32] = run(torch.float32, cuda)
            torch.cuda.synchronize()
            assert torch.backends.cuda.matmul.allow_tf32 == tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    of_peak = lambda a, b: float((a - b).abs().max() / b.abs().max())
    for k, bar in zip(("tau", "olr", "heating"), (1e-6, 1e-6, 1e-5)):
        i = ("tau", "olr", "heating").index(k)
        assert of_peak(got[True][i], got[False][i]) < bar, k
    np.testing.assert_allclose(got[True][0].numpy(), ref[0].numpy(), rtol=1e-5)
    assert of_peak(got[True][1], ref[1]) < 1e-5
    assert of_peak(got[True][2], ref[2]) < 5e-3


# --- K1's no-split sweep ----------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["resident", "segmented"])
@pytest.mark.parametrize("shape", ["voigt", "phco2"])
def test_nosplit_kernel_matches_plain(dense, dense_phco2, cuda, shape, kind):
    """K1's NOSPLIT and PH_NOSPLIT instances, over the whole catalog and
    added in place per segment (ACC, 3 segments), against their float64
    plain versions at the line-sum bar, and within rtol 1e-4 of the split
    mode (tests/test_linesum_pallas.py:62)."""
    lines, plan = (dense[0], dense[1]["odd"]) if shape == "voigt" else dense_phco2
    l32 = lines.to(torch.float32, cuda)
    x32, x64 = _t(_mode_states(11), torch.float32, cuda), _t(_mode_states(11))
    key = ("phco2_" if shape == "phco2" else "") + ("nosplit" if kind == "resident"
                                                     else "segmented")
    before = profiling.counts("launch.linesum.")
    if kind == "resident":
        out = linesum_cuda.sigma_nosplit(plan, l32, *x32, shape=shape)
        ref = ls.sigma_nosplit_plain(plan, lines, *x64, shape=shape)
    else:
        L = _segment_length(plan, lines.n_lines, 3)
        out = linesum_cuda.sigma_segmented(plan, l32, *x32, L, shape=shape, nosplit=True)
        ref = ls.sigma_segmented_plain(plan, lines, *x64, L, shape=shape)
    torch.cuda.synchronize()
    got = {k: v - before[k] for k, v in profiling.counts("launch.linesum.").items()
           if v != before[k]}
    assert got == {key: 1 if kind == "resident" else 3}
    _check_sigma(out, ref)
    split = sigma_lines(plan, l32, *x32, shape=shape).double().cpu()
    m = out.abs().cpu() > 1e-35
    np.testing.assert_allclose(split[m].numpy(), out.double().cpu()[m].numpy(), rtol=1e-4)


@pytest.mark.gpu
def test_nosplit_strategy_routes_through_its_kernel(dense, cuda):
    lines, plans = dense
    plan = plans["uniform"]
    l32 = lines.to(torch.float32, cuda)
    x32 = _t(_mode_states(11), torch.float32, cuda)
    assert ls.route(plan, l32, "voigt", "nosplit", 11) == "nosplit"
    before = profiling.counts("launch.linesum.")
    sigma_from_lines_auto(plan, l32, *x32, strategy="nosplit")
    torch.cuda.synchronize()
    got = {k: v - before[k] for k, v in profiling.counts("launch.linesum.").items()
           if v != before[k]}
    assert got == {"nosplit": 1}


# --- derivatives through the kernels on the card -----------------------------------

def _jvp_and_grad(f, x, t):
    """(f(x), its JVP along t, the gradient of sum f)."""
    y, dy = torch.func.jvp(f, (x,), (t,))
    xg = x.clone().requires_grad_()
    f(xg).sum().backward()
    return y, dy, xg.grad


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["linesum", "olr_march", "monoflux_march", "fused_olr",
                                    "fused_monoflux"])
def test_functions_carry_derivatives_on_the_card(dense, cuda, kernel):
    """Each kernel's Function on CUDA float32: the primal launches the
    kernel once per call, and the JVP and gradient are those of the plain
    twin on the same card tensors (JAX's custom JVPs)."""
    counts = {"linesum": lambda: profiling.counters["launch.linesum"],
              "olr_march": lambda: profiling.counters["launch.march.olr"],
              "monoflux_march": lambda: profiling.counters["launch.march.monoflux"],
              "fused_olr": lambda: profiling.counters["launch.fused.olr"],
              "fused_monoflux": lambda: profiling.counters["launch.fused.monoflux"]}[kernel]
    m, W = stream_nodes(5)
    if kernel == "linesum":
        lines, plans = dense
        plan, l32 = plans["uniform"], lines.to(torch.float32, cuda)
        T, P, Pp = _t(_mode_states(11), torch.float32, cuda)
        f = lambda x: sigma_from_lines_auto(plan, l32, x, P, Pp, strategy="grouped")
        g = lambda x: sigma_from_lines(plan, l32, x, P, Pp)
        x = T
    elif kernel in ("olr_march", "monoflux_march"):
        tau, B, S, a = _t(_column(L=6, N=4096), torch.float32, cuda)
        if kernel == "olr_march":
            f = lambda x: olr_march(tau * x[:, None], B, m, W)
            g = lambda x: td._olr_march(tau * x[:, None], B, m, W)
        else:
            f = lambda x: torch.cat(monoflux_march(tau * x[:, None], B, S, a, CTHETA, m, W))
            g = lambda x: torch.cat(td._monoflux_march(tau * x[:, None], B, S, a, CTHETA, m, W))
        x = torch.linspace(0.5, 1.5, 6, device=cuda)
    else:
        lead, tail, bl, bt, wq, B, S, a = _table_tensors(_table_column(L=4, k=3, N=4096),
                                                         torch.float32, cuda)
        if kernel == "fused_olr":
            f = lambda x: fused_olr(lead, tail, bl, bt, wq * x[:, None], B, m, W)
            g = lambda x: tft._fused_olr_plain(lead, tail, bl, bt, wq * x[:, None], B, m, W)
        else:
            f = lambda x: torch.cat(fused_monoflux(lead, tail, bl, bt, wq * x[:, None], B, S, a,
                                                   CTHETA, m, W))
            g = lambda x: torch.cat(tft._fused_monoflux_plain(lead, tail, bl, bt,
                                                              wq * x[:, None], B, S, a,
                                                              CTHETA, m, W))
        x = torch.linspace(0.8, 1.2, 4, device=cuda)
    t = torch.linspace(1.0, 2.0, x.shape[0], device=cuda)
    before = counts()
    y, dy, gr = _jvp_and_grad(f, x, t)
    torch.cuda.synchronize()
    assert counts() == before + 2
    y0, dy0, gr0 = _jvp_and_grad(g, x, t)
    assert counts() == before + 2
    scale = lambda r: 1e-5 * float(r.abs().max())
    assert float((y - y0).abs().max()) <= 1e-3 * float(y0.abs().max())
    assert float((dy - dy0).abs().max()) <= scale(dy0)
    assert float((gr - gr0).abs().max()) <= scale(gr0)


# --- K1-dev: the sharded path's line sum (one launch a mode for every shard) ---

def _sharded(lines64, nu, shape, k, device, dtype):
    from clearsky_tpu_torch.absorption.sharded import shard_line_gas

    lines = lines64 if dtype == torch.float64 else lines64.to(dtype, device)
    return shard_line_gas(ct.DirectGas.from_lines(lines, 0.9, nu, shape=shape), k)


@pytest.fixture(scope="module")
def sharded_cats():
    """The voigt family's dense band (1500 lines on 2300-2350 cm^-1, 8192
    points, where the coarse split engages) and the phco2 family's span
    +- 500 cm^-1 (400 lines, 8192 points), each in 4 shards."""
    dense = ct.SpectralLines.from_par_dict(ct.synthetic_co2_par(1500, seed=3),
                                           dtype=torch.float64, device="cpu")
    wide = ct.SpectralLines.from_par_dict(ct.synthetic_co2_par(400, seed=5),
                                          dtype=torch.float64, device="cpu")
    pos = wide.positions64()
    return {"voigt": (dense, np.linspace(2300.0, 2350.0, 8192)),
            "phco2": (wide, np.linspace(pos.min() - 500.0, pos.max() + 500.0, 8192))}


def _dev_call(sg, x, strategy):
    return linesum_cuda.sigma_device(sg.plans, sg.lines, *x, shape=sg.shape, strategy=strategy)


def test_k1_dev_on_cpu_takes_the_plain_version(sharded_cats):
    lines, nu = sharded_cats["voigt"]
    sg = _sharded(lines, nu, "voigt", 4, "cpu", torch.float64)
    x = _t(_mode_states(3))
    counts = profiling.counts("launch.linesum.")
    np.testing.assert_array_equal(_dev_call(sg, x, "coarse").numpy(),
                                  sigma_from_lines_shards(sg.plans, sg.lines, *x).numpy())
    assert profiling.counts("launch.linesum.") == counts


@pytest.mark.gpu
@pytest.mark.parametrize("family,shape,strategy,modes", [
    ("voigt", "voigt", "grouped", {"dev_voigt_split": 1}),
    ("voigt", "voigt", "nosplit", {"dev_nosplit": 1}),
    ("voigt", "voigt", "coarse", {"dev_fine": 1, "dev_coarse": 1}),
    ("voigt", "lorentz", "auto", {"dev_lorentz": 1}),
    ("voigt", "doppler", "auto", {"dev_doppler": 1}),
    ("phco2", "phco2", "grouped", {"dev_phco2_split": 1}),
    ("phco2", "phco2", "nosplit", {"dev_phco2_nosplit": 1}),
    ("phco2", "phco2", "coarse", {"dev_phco2_fine": 1, "dev_phco2_coarse": 1}),
])
@pytest.mark.parametrize("n", [1, 11])
def test_k1_dev_matches_plain(sharded_cats, cuda, family, shape, strategy, modes, n):
    """K1-dev in each mode and family, float32 on the card over 4 shards in
    one launch a mode, against its float64 plain version on the same
    shards: the exact line sum (rtol 2e-3 where |sigma| > 1e-35, K1's bar),
    or for the coarse route the route's plain version shard by shard (1e-5
    of each state's peak, the windowed modes' bar)."""
    lines, nu = sharded_cats[family]
    s64 = _sharded(lines, nu, shape, 4, "cpu", torch.float64)
    s32 = _sharded(lines, nu, shape, 4, cuda, torch.float32)
    x = _mode_states(n)
    before = profiling.counts("launch.linesum.")
    out = _dev_call(s32, _t(x, torch.float32, cuda), strategy)
    torch.cuda.synchronize()
    got = {k: v - before[k] for k, v in profiling.counts("launch.linesum.").items()
           if v != before[k]}
    assert got == modes
    x64 = _t(x)
    if strategy == "coarse":
        from clearsky_tpu_torch.ops.linesum import shard_lines

        ref = torch.cat([ls.sigma_coarse_device_plain(s64.plans.shard(s), shard_lines(s64.lines, s),
                                                      *x64, shape=shape) for s in range(4)], -1)
        assert bool(torch.isfinite(out).all()) and _of_peak(out, ref) < 1e-5
    else:
        _check_sigma(out, sigma_from_lines_shards(s64.plans, s64.lines, *x64, shape))


@pytest.mark.gpu
@pytest.mark.parametrize("family,strategy", [("voigt", "grouped"), ("voigt", "coarse"),
                                             ("phco2", "grouped"), ("phco2", "coarse")])
def test_k1_dev_one_launch_is_its_shards(sharded_cats, cuda, family, strategy):
    """Every shard in one launch gives each shard's columns bit for bit as
    the shard alone does; one shard of the whole grid is K1 itself."""
    lines, nu = sharded_cats[family]
    s32 = _sharded(lines, nu, family, 4, cuda, torch.float32)
    x = _t(_mode_states(11), torch.float32, cuda)
    out = _dev_call(s32, x, strategy)
    n = s32.n_local
    parts = torch.cat([_dev_call(s32.spectral_slab(s * n, (s + 1) * n), x, strategy)
                       for s in range(4)], -1)
    torch.cuda.synchronize()
    assert torch.equal(out, parts)
    if strategy == "grouped":
        from clearsky_tpu_torch.ops.linesum import DeviceWindowPlan

        gas = ct.DirectGas.from_lines(lines.to(torch.float32, cuda), 0.9, nu, shape=family)
        one = DeviceWindowPlan.from_plan(gas.plan, cuda).stacked()
        import dataclasses
        from clearsky_tpu_torch.spectra.lines import PER_LINE_FIELDS

        l1 = dataclasses.replace(gas.lines, **{f: getattr(gas.lines, f)[None]
                                               for f in PER_LINE_FIELDS})
        k1 = sigma_lines(gas.plan, gas.lines, *x, shape=family)
        dev1 = linesum_cuda.sigma_device(one, l1, *x, shape=family, strategy="grouped")
        torch.cuda.synchronize()
        assert torch.equal(k1, dev1)
        # and the sharded sum against K1 over the whole grid: the same lines
        # in every window; d_near from each shard's lines moves the switch
        # between region 1 and w4, where they agree
        assert _of_peak(out, k1.double().cpu()) < 1e-5


@pytest.mark.gpu
def test_k1_dev_rejects_bad_inputs(sharded_cats, cuda):
    lines, nu = sharded_cats["voigt"]
    s32 = _sharded(lines, nu, "voigt", 4, cuda, torch.float32)
    T, P, Pp = _t(_mode_states(3), torch.float32, cuda)
    with pytest.raises(TypeError):        # float64 states
        _dev_call(s32, (T.double(), P, Pp), "grouped")
    with pytest.raises(ValueError):       # a stack of plans for other slabs
        linesum_cuda.sigma_device(s32.plans.shard(slice(0, 2)), s32.lines, T, P, Pp)
    with pytest.raises(RuntimeError, match="derivative"):
        linesum_cuda._device_launch(s32.plans, s32.lines, T.requires_grad_(), P, Pp, None,
                                    "voigt", "grouped")


# --- the batched sweeps: a batch's refresh and march against its columns' -----

# route: (strategy, points, byte budget); at the budget one column's 20 edge
# states take the route, the batch's 160, routed by their own count, another
SWEEP_ROUTES = {"stencil": ("auto", 16384, 2_000_000), "coarse": ("coarse", 65536, 2_000_000),
                "grouped": ("grouped", 16384, 2_000_000),
                "segmented": ("grouped", 16384, 1_000_000)}
SWEEP_COLUMNS, SWEEP_EDGES = 8, 20


def _k1_counts():
    return dict(profiling.counts("launch.linesum."),
                correction=profiling.counters["launch.correction"])


def _counted(fn):
    before = _k1_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v - before[k] for k, v in _k1_counts().items() if v != before[k]}


@pytest.mark.gpu
@pytest.mark.parametrize("route", list(SWEEP_ROUTES))
def test_batched_refresh_matches_its_columns(cuda, route, monkeypatch):
    """A refresh of 8 columns (AcceleratedAbsorber.update on [8, 20]) takes
    one column's route and K1 modes, each launched once for all 160 states,
    and gives each column's refresh within 2e-5 of each state's peak (both
    float32, summed in other orders: the batch's launch plan is not one
    column's)."""
    strategy, n_nu, budget = SWEEP_ROUTES[route]
    monkeypatch.setattr(ls, "resident_budget", lambda device, limit=None: budget)
    lines = ct.SpectralLines.from_par_dict(ct.synthetic_co2_par(2000, seed=23),
                                           dtype=torch.float32, device=cuda)
    pos = lines.positions64()
    gas = ct.DirectGas.from_lines(lines, 0.9, np.linspace(pos.min() - 25.0, pos.max() + 25.0,
                                                          n_nu), strategy=strategy)
    one = ls._resolve(gas.plan, lines, "voigt", strategy, SWEEP_EDGES)
    assert one[0] == route
    assert ls._resolve(gas.plan, lines, "voigt", strategy, SWEEP_COLUMNS * SWEEP_EDGES) != one
    Pe = ct.pressuregrid(10.0, 1e5, SWEEP_EDGES)
    Te = np.maximum(288.0 * (Pe / 1e5) ** 0.2, 160.0)
    A = ct.AcceleratedAbsorber.create(Te, Pe, gas)
    Te_b = torch.tensor(np.stack([Te * (1.0 + 0.01 * b) for b in range(SWEEP_COLUMNS)]),
                        dtype=torch.float32, device=cuda)
    batch, n_batch = _counted(lambda: A.stacked(SWEEP_COLUMNS).update(Te_b))
    for b in range(SWEEP_COLUMNS):
        col, n_col = _counted(lambda: A.update(Te_b[b]))
        assert n_batch == n_col and n_col
        assert _of_peak(torch.exp(batch.ln_sigma[b]), torch.exp(col.ln_sigma).double().cpu()) < 2e-5


@pytest.mark.gpu
@pytest.mark.parametrize("n_cols", [8, 64])
def test_folded_march_matches_its_columns(cuda, n_cols):
    """K3 over columns folded into the lanes (``discretized.monoflux`` on
    [B, L, N]) in one launch, against K3 column by column: bit for bit in
    the columns' own layout (8 x 4,096 points, spread), within 3.5e-6 of
    peak in the other (64 x 4,096, a thread a point)."""
    L, N = 38, 4096
    cols = [_column(L, N, seed=b) for b in range(n_cols)]
    tau, B, S, alb = (torch.tensor(np.stack(x), dtype=torch.float32, device=cuda)
                      for x in zip(*cols))
    nu = torch.linspace(100.0, 2000.0, N, dtype=torch.float32, device=cuda)
    spread = march_cuda.march_plan("monoflux", L, n_cols * N, 5)["spread"]
    assert spread == (n_cols * N < march_cuda.SMS * march_cuda.SPREAD_BELOW) == (n_cols == 8)
    before = profiling.counters["launch.march.monoflux"]
    up, dn = td.monoflux(tau, B, nu, S, alb, 0.841, 5)
    torch.cuda.synchronize()
    assert profiling.counters["launch.march.monoflux"] == before + 1 and up.shape == (n_cols, L + 1,
                                                                                      N)
    m, W = stream_nodes(5)
    for b in range(n_cols):
        up1, dn1 = monoflux_march(tau[b], B[b], S[b], alb[b], CTHETA, m, W)
        if spread:
            assert torch.equal(up[b], up1) and torch.equal(dn[b], dn1)
        for got, want in ((up[b], up1), (dn[b], dn1)):
            assert float((got - want).abs().max() / want.abs().max()) < 3.5e-6


# --- the adaptive Radau kernel (csrc/radau.cu) ---------------------------------------
def _radau_cache(n_nu, dev, dtype=torch.float32, npc=48, seed=0, n_cols=0):
    """A column cache with thick and thin lanes: ln sigma rising with ln P
    (pressure broadening) over a wavy band; ``n_cols`` > 0 gives a batch of
    columns (T and mu [B, npc], one ln sigma each)."""
    from clearsky_tpu_torch.rt.radau import ColumnCache

    rng = np.random.default_rng(seed)
    P = np.geomspace(10.0, 1e5, npc)
    lnP = np.log(P)
    nu = np.linspace(500.0, 800.0, n_nu)
    band = -52.0 + 6.0 * np.sin(nu / 7.3) + rng.normal(0.0, 0.5, n_nu)
    ln_sigma = band[None] + 0.9 * (lnP[:, None] - lnP[-1])
    T = 190.0 + 12.0 * np.log(P / 10.0)
    mu = np.full(npc, 0.044)
    if n_cols:
        T = T[None] + rng.uniform(-8.0, 8.0, (n_cols, 1))
        mu = np.broadcast_to(mu, T.shape).copy()
        ln_sigma = ln_sigma[None] + rng.normal(0.0, 0.3, (n_cols, 1, n_nu))
    t = lambda x: torch.tensor(np.ascontiguousarray(x), dtype=dtype, device=dev)
    return ColumnCache(lnP=t(lnP), T=t(T), mu=t(mu), ln_sigma=t(ln_sigma), nu=t(nu))


def _to(cache, dev, dtype):
    return type(cache)(*(x.to(device=dev, dtype=dtype) for x in cache))


def _radau_counts():
    return profiling.counts("launch.radau.")


def _lane_peak_err(got, ref):
    """Max over lanes of |got - ref| / the lane's peak |ref| over its nodes."""
    got, ref = got.double().cpu(), ref.double().cpu()
    peak = ref.abs().amax(dim=0).clamp(min=1e-300) if ref.dim() > 1 else ref.abs()
    return float(((got - ref).abs() / peak).max())


def test_radau_wrapper_on_cpu_takes_the_plain_engine():
    """CPU tensors never reach the kernel; the wrapper refuses a CPU tensor
    at the launch itself."""
    from clearsky_tpu_torch.rt import radau as trad, radau_cuda

    cache = _radau_cache(64, "cpu")
    before = _radau_counts()
    olr = trad.radau_outgoing(cache, 1e5, 10.0, 9.8, tol=1e-4)
    assert _radau_counts() == before and bool(torch.isfinite(olr).all())
    with pytest.raises(ValueError, match="device"):
        radau_cuda._launch("emission", cache.lnP, cache.T[None], cache.mu[None],
                           cache.ln_sigma[None], cache.nu, [1.0], 9.8,
                           torch.ones(1), torch.ones(64), torch.ones(2), 1e-4, 10, False)


@pytest.mark.gpu
@pytest.mark.parametrize("leg", ["outgoing", "depth", "monoflux"])
def test_radau_kernel_matches_plain(cuda, leg, monkeypatch):
    """Both right-hand sides, single (outgoing: emission; depth) and dense
    (monoflux: emission down and up, depth): the float32 kernel against the
    plain float32 engine on the same lanes on the card within 10 x tol of
    each lane's peak; one launch a leg. The share of the last leg's lanes
    whose accepted steps equal the plain engine's is printed (the kernel
    contracts multiply-adds and the plain engine does not, which moves a
    step decision now and then)."""
    from clearsky_tpu_torch.rt import radau as trad, radau_cuda
    from clearsky_tpu_torch.utils import twin

    tol = 1e-5
    c32 = _radau_cache(4096, cuda)
    P = np.geomspace(10.0, 1e5, 12)
    calls = {"outgoing": lambda: trad.radau_outgoing(c32, 1e5, 10.0, 9.8, tol=tol),
             "depth": lambda: trad.radau_path_tau(c32, 1e5, 10.0, 9.8, m=1.3, tol=tol),
             "monoflux": lambda: trad.radau_monoflux(c32, P, 9.8, torch.full_like(c32.nu, 3.0),
                                                     0.2, 0.841, tol=tol)}
    before = _radau_counts()
    got = calls[leg]()
    torch.cuda.synchronize()
    after = _radau_counts()
    n = {"outgoing": (1, 0), "depth": (0, 1), "monoflux": (2, 1)}[leg]
    assert (after["emission"] - before["emission"], after["depth"] - before["depth"]) == n
    last = dict(radau_cuda.radau_leg.last)
    monkeypatch.setattr(twin, "kernel_path", lambda x: False)
    ref = calls[leg]()
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for g, r in zip(got, ref):
        assert bool(torch.isfinite(g).all()) and bool(torch.isfinite(r).all())
        assert _lane_peak_err(g, r) <= 10 * tol, leg
    print(f"radau {leg}: last leg {last['rhs']}, {last['lanes']} lanes, attempts mean "
          f"{float(last['attempts'].float().mean()):.1f}, max {int(last['attempts'].max())}")


@pytest.mark.gpu
def test_radau_kernel_steps_and_float64(cuda, monkeypatch):
    """Accepted steps lane by lane against the plain float32 engine on the
    card (the share that match is printed; float32 rounding in another
    order moves some), and the kernel's band OLR within 1e-4 of the float64
    plain engine's."""
    from clearsky_tpu_torch.rt import radau as trad, radau_cuda
    from clearsky_tpu_torch.utils import twin

    tol = 1e-5
    c32 = _radau_cache(2048, cuda, seed=1)
    olr = trad.radau_outgoing(c32, 1e5, 10.0, 9.8, tol=tol)
    launch = radau_cuda.radau_leg.last
    k_steps, k_att = launch["steps"], launch["attempts"]
    monkeypatch.setattr(twin, "kernel_path", lambda x: False)
    recorded = []
    plain_leg = trad._plain_leg
    monkeypatch.setattr(trad, "_plain_leg",
                        lambda *a, **k: recorded.append(plain_leg(*a, **k, with_steps=True))
                        or recorded[-1][0])
    trad.radau_outgoing(c32, 1e5, 10.0, 9.8, tol=tol)
    share = float((k_steps == recorded[0][1]).float().mean())
    print(f"radau steps: {share:.4f} of lanes match the plain float32 engine; kernel attempts "
          f"mean {float(k_att.float().mean()):.1f}, max {int(k_att.max())}")
    assert share > 0.2
    # the float64 plain engine, on the card
    ref = trad.radau_outgoing(_to(c32, cuda, torch.float64), 1e5, 10.0, 9.8, tol=tol)
    band = lambda x: float(ct.trapz(c32.nu.double(), x.double()))
    assert abs(band(olr) - band(ref)) <= 1e-4 * abs(band(ref))


@pytest.mark.gpu
def test_radau_kernel_max_steps_nan_and_backward(cuda):
    """A lane out of attempts comes back NaN, a NaN lane does not hold the
    others back (their values and steps are those of a run without it), and
    a backward span (x decreasing) matches the plain engine."""
    from clearsky_tpu_torch.rt import radau as trad, radau_cuda

    c32 = _radau_cache(512, cuda, seed=2)
    tau = trad.radau_path_tau(c32, 1e5, 10.0, 9.8, tol=1e-6, max_steps=3)
    assert bool(torch.isnan(tau).any())
    nu_ok = trad.radau_path_tau(c32, 1e5, 10.0, 9.8, tol=1e-6)
    steps_ok = radau_cuda.radau_leg.last["steps"].clone()
    assert bool(torch.isfinite(nu_ok).all())
    # poison one lane's ln sigma: the others keep their values and steps
    bad = c32.ln_sigma.clone()
    bad[:, 7] = float("nan")
    tau_bad = trad.radau_path_tau(c32._replace(ln_sigma=bad), 1e5, 10.0, 9.8, tol=1e-6)
    steps_bad = radau_cuda.radau_leg.last["steps"]
    keep = torch.arange(512, device=cuda) != 7
    assert bool(torch.isnan(tau_bad[7])) and torch.equal(tau_bad[keep], nu_ok[keep])
    assert torch.equal(steps_bad[keep], steps_ok[keep])
    # backward: the depth leg from the surface up (x decreasing)
    cpu = _to(c32, "cpu", torch.float32)
    atol = torch.tensor([1e-11], device=cuda)
    xs = torch.tensor([np.sqrt(1e5), np.sqrt(10.0)], dtype=torch.float32, device=cuda)
    y0 = torch.zeros(512, device=cuda)
    got = radau_cuda.radau_leg("depth", c32.lnP, c32.T[None], c32.mu[None], c32.ln_sigma[None],
                               c32.nu, [1.0], 9.8, atol, y0, xs, rtol=1e-5, max_steps=10_000,
                               dense=False)
    ref = trad._plain_leg("depth", cpu.lnP, cpu.T[None], cpu.mu[None], cpu.ln_sigma[None],
                          cpu.nu, [1.0], 9.8, atol.cpu(), y0.cpu(), xs.cpu(), 1e-5, 10_000, False)
    assert bool((got.cpu() < 0).all())
    assert _lane_peak_err(got, ref) <= 1e-4


@pytest.mark.gpu
def test_radau_batched_columns_and_entry_points(cuda):
    """A batch of columns (its own T, mu and ln sigma each) in one launch a
    leg equals each column alone; the entry points launch the kernel (1 for
    outgoing, 3 for radiate) and an RCM's heating holds 5e-3 of peak against
    the float64 plain engine on the card (a float64 cache from the CPU)."""
    import dataclasses

    from clearsky_tpu_torch.rt import radau as trad
    from clearsky_tpu_torch.utils import twin

    cb = _radau_cache(1024, cuda, seed=3, n_cols=3)
    P = np.geomspace(10.0, 1e5, 8)
    up, dn, tau = trad.radau_monoflux(cb, P, 9.8, torch.full((3, 1024), 2.0, device=cuda), 0.1,
                                      0.841, tol=1e-5)
    for b in range(3):
        one = cb._replace(T=cb.T[b], mu=cb.mu[b], ln_sigma=cb.ln_sigma[b])
        u1, d1, t1 = trad.radau_monoflux(one, P, 9.8, torch.full((1024,), 2.0, device=cuda), 0.1,
                                         0.841, tol=1e-5)
        assert torch.equal(up[b], u1) and torch.equal(dn[b], d1) and torch.equal(tau[b], t1)
    lines = ct.SpectralLines.from_par_dict(ct.synthetic_co2_par(600, seed=21),
                                           dtype=torch.float32, device=cuda)
    p64 = lines.positions64()
    nu = np.linspace(p64.min() - 25.0, p64.max() + 25.0, 2**12)
    gas = ct.DirectGas.from_lines(lines, 4e-4, nu)
    Pe = ct.pressuregrid(10.0, 1e5, 9)
    Te = np.maximum(288.0 * (Pe / 1e5) ** 0.22, 160.0)
    before = _radau_counts()
    ct.outgoing(Pe, 9.8, Te, 0.044, gas, core=ct.Radau())
    mid = _radau_counts()
    ct.radiate(Pe, 9.8, Te, 0.044, 1e-3, 0.1, gas, core=ct.Radau())
    torch.cuda.synchronize()
    after = _radau_counts()
    assert sum(mid.values()) - sum(before.values()) == 1
    assert sum(after.values()) - sum(mid.values()) == 3
    fcp = lambda T, P: 850.0
    r32 = ct.RCM.create(Pe, Te, 9.8, lambda T, P: 0.044, 1e-3, 0.1, fcp, 1e7, gas,
                        core=ct.Radau())
    H32 = ct.heating(r32)
    l64 = ct.SpectralLines.from_par_dict(ct.synthetic_co2_par(600, seed=21),
                                         dtype=torch.float64, device="cpu")
    A64 = ct.AcceleratedAbsorber.create(r32.A.T.double().cpu(), r32.Pe.double().cpu(),
                                        ct.DirectGas.from_lines(l64, 4e-4, nu))
    d = lambda x: x.double().to(cuda)
    A64 = dataclasses.replace(A64, ln_sigma=d(A64.ln_sigma), lnP=d(A64.lnP), T=d(A64.T),
                              nu=d(A64.nu))
    r64 = dataclasses.replace(r32, Pe=d(r32.Pe), P=d(r32.P), T=d(r32.T), Pr=d(r32.Pr),
                              S_nu=d(r32.S_nu), a_nu=d(r32.a_nu), A=A64)
    kernel_path = twin.kernel_path
    twin.kernel_path = lambda x: False
    try:
        H64 = ct.heating(r64)
    finally:
        twin.kernel_path = kernel_path
    assert float((H32.double() - H64).abs().max() / H64.abs().max()) <= 5e-3
    with pytest.raises(TypeError, match="float32"):
        trad.radau_outgoing(_to(cb, cuda, torch.float64)._replace(
            T=cb.T[0].double(), mu=cb.mu[0].double(), ln_sigma=cb.ln_sigma[0].double()),
            1e5, 10.0, 9.8)


@pytest.mark.gpu
def test_radau_carries_derivatives_on_the_card(cuda, monkeypatch):
    """The Radau wrapper's Function on CUDA float32: the primal launches the
    kernel once, and the JVP (in the column's temperatures) is the plain
    engine's, its twin's, on the same card tensors: forward mode, as JAX
    differentiates its while_loop (which has no reverse mode)."""
    from clearsky_tpu_torch.rt import radau as trad
    from clearsky_tpu_torch.utils import twin

    c32 = _radau_cache(512, cuda, seed=4)
    f = lambda x: trad.radau_outgoing(c32._replace(T=c32.T * x), 1e5, 10.0, 9.8, tol=1e-4)
    x = torch.ones_like(c32.T)
    t = torch.linspace(-1e-3, 1e-3, x.shape[0], device=cuda)
    before = sum(_radau_counts().values())
    y, dy = torch.func.jvp(f, (x,), (t,))
    torch.cuda.synchronize()
    assert sum(_radau_counts().values()) == before + 1
    monkeypatch.setattr(twin, "kernel_path", lambda x: False)
    y0, dy0 = torch.func.jvp(f, (x,), (t,))
    assert sum(_radau_counts().values()) == before + 1
    assert float((y - y0).abs().max()) <= 1e-4 * float(y0.abs().max())
    assert float((dy - dy0).abs().max()) <= 1e-5 * float(dy0.abs().max())


# chip_smoke.py's bars of a Radau launch against the plain float32 engine:
# RADAU_BAR lane scales atol + rtol |y| (|y| the lane's peak over its
# nodes) and RADAU_PEAK_BAR of the output's peak
RADAU_BAR, RADAU_PEAK_BAR = 100.0, 1e-4


def _leg_vs_plain(monkeypatch, rhs, lnP, Tg, mug, lnsig, nu, m, atol, y0, xs, dense,
                  rtol=1e-5):
    """One leg through the kernel (one launch) and through the plain
    float32 engine on the same card tensors, the kernel held at chip_smoke's
    bars with NaN lanes alike; returns (kernel y, plain y, the launch's
    steps and attempts)."""
    from clearsky_tpu_torch.rt import radau_cuda
    from clearsky_tpu_torch.utils import twin

    call = lambda: radau_cuda.radau_leg(rhs, lnP, Tg, mug, lnsig, nu, m, 9.8, atol, y0, xs,
                                        rtol=rtol, max_steps=10_000, dense=dense)
    before = _radau_counts()[rhs]
    got = call()
    torch.cuda.synchronize()
    assert _radau_counts()[rhs] == before + 1
    last = dict(radau_cuda.radau_leg.last)
    with monkeypatch.context() as mp:
        mp.setattr(twin, "kernel_path", lambda x: False)
        ref = call()
    assert torch.equal(torch.isnan(got), torch.isnan(ref)) and bool(torch.isfinite(ref).all())
    g, r = got.double(), ref.double()
    peak = r.abs().amax(dim=0) if r.dim() > 1 else r.abs()
    lane_atol = atol.double().repeat_interleave(len(m) * nu.shape[0])
    assert float(((g - r).abs() / (lane_atol + rtol * peak)).max()) <= RADAU_BAR, rhs
    assert float((g - r).abs().max() / r.abs().max()) <= RADAU_PEAK_BAR, rhs
    return got, ref, last


def _legs(monkeypatch, c, xs_down, dense):
    """Emission down (from 0), emission up (from the surface's Planck
    function) and the vertical depth on cache ``c`` (one column or a batch)
    over the nodes ``xs_down`` (+sqrt P, ascending) against the plain
    engine; [(rhs, kernel y, plain y, launch)]."""
    from clearsky_tpu_torch.ops.planck import planck

    npc = c.lnP.shape[0]
    Tg = c.T.reshape(-1, npc).contiguous()
    C, n = Tg.shape[0], c.nu.shape[0]
    mug = torch.broadcast_to(c.mu, c.T.shape).reshape(C, npc).contiguous()
    lnsig = c.ln_sigma.reshape(-1, npc, n).contiguous()
    m = stream_nodes(5)[0]
    B_s = planck(c.nu, Tg[:, -1:])                                      # [C, n]
    atol = (1e-8 * B_s.amax(dim=1)).contiguous()
    zeros = torch.zeros(C * len(m) * n, device=c.T.device)
    up0 = B_s[:, None].expand(C, len(m), n).reshape(-1).contiguous()
    xs_up = (-torch.flip(xs_down, (0,))).contiguous()
    out = []
    for rhs, mm, at, y0, xs in (("emission", m, atol, zeros, xs_down),
                                ("emission", m, atol, up0, xs_up),
                                ("depth", [1.0], torch.full_like(atol, 1e-11), zeros[:C * n],
                                 xs_down)):
        out.append((rhs, *_leg_vs_plain(monkeypatch, rhs, c.lnP, Tg, mug, lnsig, c.nu, mm, at,
                                        y0, xs.contiguous(), dense)))
    return out


@pytest.mark.gpu
def test_radau_stage_abscissae_on_the_nodes(cuda, monkeypatch):
    """Dense legs whose nodes are the cache's own levels, ln P formed on the
    card as the kernel forms an abscissa's (2 logf |x|): every segment starts
    on a level and its last stage abscissa lands on the next, where the
    bracket ties (searchsorted(side="right") takes the upper row). Emission
    down and up and the depth hold the plain float32 engine at chip_smoke's
    bars."""
    c = _radau_cache(1000, cuda, seed=5, npc=40)
    sp = torch.sqrt(torch.exp(c.lnP.double())).float()
    c = c._replace(lnP=2.0 * torch.log(sp))
    assert bool((c.lnP[1:] > c.lnP[:-1]).all())
    for rhs, got, ref, last in _legs(monkeypatch, c, sp, dense=True):
        assert got.shape[0] == sp.shape[0] and int(last["steps"].min()) >= sp.shape[0] - 1


@pytest.mark.gpu
def test_radau_steps_across_many_rows(cuda, monkeypatch):
    """A cache of 1,024 levels whose every other wavenumber is e^30 times
    thinner: those lanes cross the column's 1,023 rows in a few dozen
    attempts (steps growing tenfold, across hundreds of rows at the end:
    the hunt's doubling steps and bisection) beside thick lanes that step
    within a row; one segment each way and the depth hold the plain engine
    at chip_smoke's bars."""
    c = _radau_cache(2048, cuda, seed=6, npc=1024)
    ls = c.ln_sigma.clone()
    ls[:, ::2] -= 30.0
    c = c._replace(ln_sigma=ls)
    xs = torch.tensor([np.sqrt(10.0), np.sqrt(1e5)], dtype=torch.float32, device=cuda)
    for rhs, got, ref, last in _legs(monkeypatch, c, xs, dense=False):
        att = last["attempts"].view(-1, 2048)
        assert float(att[:, ::2].float().mean()) < 60.0 < float(att[:, 1::2].float().mean()), rhs


@pytest.mark.gpu
def test_radau_accelerated_absorber_rows(cuda, monkeypatch):
    """An AcceleratedAbsorber's own grid (24 levels even in ln P, their
    spacing in sqrt P 50-fold apart from top to bottom, the rows of an RCM's
    cache) through outgoing's legs and the depth, dense over the levels,
    against the plain engine at chip_smoke's bars."""
    from clearsky_tpu_torch.rt import radau as trad

    lines = ct.SpectralLines.from_par_dict(ct.synthetic_co2_par(600, seed=21),
                                           dtype=torch.float32, device=cuda)
    p64 = lines.positions64()
    gas = ct.DirectGas.from_lines(lines, 4e-4, np.linspace(p64.min() - 25.0,
                                                            p64.max() + 25.0, 2**12))
    fT = lambda P: torch.clamp(288.0 * (P / 1e5) ** 0.22, min=160.0)
    P = torch.tensor(np.geomspace(10.0, 1e5, 24), dtype=torch.float32, device=cuda)
    A = ct.AcceleratedAbsorber.create(fT(P), P, gas)
    c = trad.build_column_cache(None, fT, lambda T, P: torch.full_like(T, 0.044), A)
    w = torch.sqrt(torch.exp(c.lnP.double()))
    assert float((w[1:] - w[:-1]).max() / (w[1:] - w[:-1]).min()) > 10.0
    _legs(monkeypatch, c, w.float(), dense=True)


@pytest.mark.gpu
def test_radau_warp_across_columns(cuda, monkeypatch):
    """Four columns of 50 wavenumbers in one launch a leg: warps hold lanes of
    two columns (the depth's lanes 32-63, columns 0 and 1) and a block's
    columns share its staged T and mu. Each column's lanes equal the column
    launched alone, bit for bit and step for step (lanes are independent),
    and the batch holds the plain engine at chip_smoke's bars."""
    cb = _radau_cache(50, cuda, seed=7, n_cols=4)
    xs = torch.tensor(np.sqrt(np.geomspace(10.0, 1e5, 6)), dtype=torch.float32, device=cuda)
    batch = _legs(monkeypatch, cb, xs, dense=True)
    for b in range(4):
        one = cb._replace(T=cb.T[b], mu=cb.mu[b], ln_sigma=cb.ln_sigma[b])
        for (rhs, got, _, last), (_, got1, _, last1) in zip(batch, _legs(monkeypatch, one, xs,
                                                                         dense=True)):
            lanes = got.shape[1] // 4
            assert torch.equal(got[:, b * lanes:(b + 1) * lanes], got1), (rhs, b)
            assert torch.equal(last["steps"][b * lanes:(b + 1) * lanes], last1["steps"])


@pytest.mark.gpu
def test_radau_rows_read_from_device_memory(cuda, monkeypatch):
    """Eight columns of 20 wavenumbers on 1,024 levels: a block's columns'
    rows (16 bytes a row and column) exceed its 48 KB of shared memory, so
    its lanes read them from device memory. Each column equals the column
    launched alone (whose rows a block stages), bit for bit and step for
    step, and the batch holds the plain engine at chip_smoke's bars."""
    cb = _radau_cache(20, cuda, seed=8, npc=1024, n_cols=8)
    xs = torch.tensor([np.sqrt(10.0), np.sqrt(1e5)], dtype=torch.float32, device=cuda)
    batch = _legs(monkeypatch, cb, xs, dense=False)
    for b in (0, 5):
        one = cb._replace(T=cb.T[b], mu=cb.mu[b], ln_sigma=cb.ln_sigma[b])
        for (rhs, got, _, last), (_, got1, _, last1) in zip(batch, _legs(monkeypatch, one, xs,
                                                                         dense=False)):
            lanes = got.shape[0] // 8
            assert torch.equal(got[b * lanes:(b + 1) * lanes], got1), (rhs, b)
            assert torch.equal(last["steps"][b * lanes:(b + 1) * lanes], last1["steps"])

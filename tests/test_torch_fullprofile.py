"""K4 and K5 (strategies "lane" and "gathered") of the port: the full-profile
kernels' reading of their operands, against the plain versions and the JAX
package.

The CUDA kernel (``csrc/linesum.cu``, window_kernel's FULL modes) runs only
on a card; here a float64 stand-in reads what it reads: the pack and the
near reaches of :func:`linesum_cuda.full_pack`, the work items and balanced
state tiles of :func:`linesum_cuda.full_plan`, the plan's windows in place
in the catalog (K4 and K5 make the same launch), and takes each (point,
line, state) as the kernel does: w4 within the (line, state)'s near reach where the line's tile
reach meets the block, the pack's far term beyond (region 1, or the small-y
repair's form where y < 0.01). Bars and their reasons:

* the stand-in against ``sigma_lane_plain`` and ``sigma_gathered_plain`` in
  float64: 1e-12 (the same function in another order and algebra; the
  kernel's voigt region 1 takes 1/sqrt(pi) and phco2's small-y form 2 x
  0.5641896 where w4 takes 0.5641896 and 2/sqrt(pi), 2.9e-8 apart, below
  float32's rounding, which the stand-in puts back);
* the stand-in against the JAX package's interpret-mode "lane" and
  "gathered" kernels (float32): the line-sum oracle's bar of
  tests/test_linesum_pallas.py, rtol 2e-3 where |sigma| > 1e-35;
* beyond a (line, state)'s near reach |x| + y >= 15 (w4's region 1) in
  float64, exactly;
* chip_smoke.py's count of K4/K5's work (the bound's operations) against
  the same count made triple by triple: 1e-12.
"""

import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from clearsky_tpu.ops import linesum_pallas as jp
from clearsky_tpu.ops.linesum import build_line_window_plan as jplan
from clearsky_tpu.spectra.lines import SpectralLines as JLines
from clearsky_tpu_torch import convert
from clearsky_tpu_torch.ops import linesum_cuda
from clearsky_tpu_torch.ops import linesum_strategies as ls
from clearsky_tpu_torch.ops.faddeeva import wofz_re
from clearsky_tpu_torch.ops.lineshape import chi_phco2
from clearsky_tpu_torch.ops.linesum import (
    DEFAULT_CUT,
    _line_params,
    build_line_window_plan,
    effective_alpha,
    voigt_coefficients,
)
from clearsky_tpu_torch.spectra.synthetic import synthetic_co2_par

torch.set_num_threads(2)

CPU64 = dict(dtype=torch.float64, device="cpu")
SHAPES = ("voigt", "phco2", "lorentz", "doppler")
BAND = np.linspace(610.0, 780.0, 512)
# 11 states (balanced tiles of 6 and 5), the lowest pressures with y0 < 0.01
T11 = np.linspace(170.0, 310.0, 11)
P11 = np.geomspace(2.0, 1e5, 11)
# w4's constants over the kernel's: region 1's 0.5641896 over 1/sqrt(pi),
# the small-y repair's 2/sqrt(pi) over 2 x 0.5641896
W4_R1 = 0.5641896 * math.sqrt(math.pi)


@pytest.fixture(scope="module")
def cat():
    par = synthetic_co2_par(300, seed=7)
    jl = JLines.from_par_dict(par)
    return jl, convert.spectral_lines(jl, **CPU64)


def _states(dtype=torch.float64, T=T11, P=P11):
    return [torch.tensor(x, dtype=dtype) for x in (T, P, 0.5 * P)]


def _plans(cat, shape):
    jl, tl = cat
    cut = DEFAULT_CUT[shape]
    return jplan(BAND, np.asarray(jl.nu), cut), build_line_window_plan(BAND, tl.positions64(), cut)


def _far(shape, q0, dnu, D, T):
    """The pack's term beyond the reach, as the kernel takes it, with w4's
    constants put back (float64)."""
    if shape == "phco2":
        c, y0, A = q0[:, 0], q0[:, 1], q0[:, 2]
        y = y0 * chi_phco2(dnu, T)
        w = 0.5 - y * y - D * A
        r1 = c * y * (1.0 - w) / (w * w + 2.0 * y * y)
        r = 1.0 / (D * A)
        small = 2.0 * c * y * r * (0.5 + r * (0.75 + r * (1.875 + r * 6.5625))) / W4_R1
        return torch.where(y < 0.01, small, r1)
    A, h, g, k = q0[:, 0], q0[:, 1], q0[:, 2], q0[:, 3]
    w = h - D * A
    r1 = k * (1.0 - w) / (w * w + g) * W4_R1
    r = 1.0 / (D * A)
    small = k * r * (0.5 + r * (0.75 + r * (1.875 + r * 6.5625)))
    return torch.where(g < 0.0, small, r1)


def _emulate_full(shape, plan, tl, states, window=None):
    """K4 and K5 in float64 as the kernel reads its operands: sigma
    [n_states, n_nu]."""
    T = states[0]
    S, a, g = _line_params(tl, *states)
    a = effective_alpha(shape, a)
    n = S.shape[0]
    bcoef = linesum_cuda.chi_rates(T) if shape == "phco2" else None
    coef, reach, _ = linesum_cuda.full_pack(shape, S, a, g, plan.cut, bcoef)
    grid = plan.device_arrays("cpu")
    table = linesum_cuda.full_plan(shape, grid, n, window)["table"].numpy()
    win = grid["win_host"]
    nb = torch.tensor(np.asarray(plan.nu_blocks))
    pos = torch.tensor(tl.positions64())
    sizes = linesum_cuda.window_tile_sizes(n)
    firsts = np.cumsum([0] + sizes[:-1])
    parts = {}
    for row, _, off, cnt, part, _, _, _ in table:
        idx = torch.arange(cnt) + int(win[row, 0]) + int(off)
        dnu = nb[row][:, None] - pos[idx][None, :]                         # [B, cnt]
        D, inc = dnu * dnu, dnu.abs() <= plan.cut
        acc = torch.zeros(n, nb.shape[1], dtype=torch.float64)
        for t, (s0, ns) in enumerate(zip(firsts, sizes)):
            if reach is not None:
                rt = reach[idx, t, 0]
                near = (rt >= 0) & (dnu[0] <= rt + 1e-5) & (dnu[-1] >= -rt - 1e-5)
            for s in range(s0, s0 + ns):
                if shape == "lorentz":
                    q = coef[idx, s]
                    f = q[:, 0] / (D + q[:, 1])
                elif shape == "doppler":
                    q = coef[idx, s]
                    f = q[:, 0] * torch.exp(-D * q[:, 1])
                else:
                    q0, q1 = coef[idx, 0, s], coef[idx, 1, s]
                    y = q1[:, 2].expand_as(dnu)
                    if shape == "phco2":
                        y = y * chi_phco2(dnu, T[s])
                    w4 = q1[:, 0] * wofz_re(dnu * q1[:, 1], y)
                    f = torch.where(near & (dnu.abs() <= q1[:, 3]), w4,
                                    _far(shape, q0, dnu, D, T[s]))
                acc[s] = torch.where(inc, f, 0.0).sum(-1)
        parts.setdefault(int(row), []).append((int(part), acc))
    out = torch.zeros(n, *nb.shape, dtype=torch.float64)
    for row, ps in parts.items():
        for _, acc in sorted(ps, key=lambda p: p[0]):
            out[:, row] += acc
    return out.reshape(n, -1)[:, :plan.n_nu]


@pytest.fixture(scope="module")
def jax_full(cat):
    """JAX's interpret-mode "lane" and "gathered" kernels (float32) by
    (shape, kind)."""
    jl, _ = cat
    got = {}

    def run(shape, kind):
        if (shape, kind) not in got:
            jpl, _ = _plans(cat, shape)
            got[shape, kind] = np.asarray(jp.sigma_from_lines_pallas(
                jpl, jl, jnp.asarray(T11), jnp.asarray(P11), jnp.asarray(0.5 * P11), shape,
                interpret=True, strategy=kind))
        return got[shape, kind]

    return run


@pytest.mark.parametrize("kind", ["lane", "gathered"])
@pytest.mark.parametrize("shape", SHAPES)
def test_stand_in_reproduces_plain_and_jax(cat, jax_full, shape, kind):
    """The stand-in of K4/K5 (pieces of 64 lines, so several a block, and
    the plan's own) against the plain version and JAX's kernel."""
    _, tl = cat
    _, tpl = _plans(cat, shape)
    x = _states()
    _, _, y0 = voigt_coefficients(*_line_params(tl, *x))[:3]
    assert bool((y0 < 0.01).any()) and bool((y0 >= 0.01).any())
    plain = {"lane": ls.sigma_lane_plain, "gathered": ls.sigma_gathered_plain}[kind]
    ref = plain(tpl, tl, *x, shape=shape).numpy()
    ker = jax_full(shape, kind)
    m = np.abs(ker) > 1e-35
    for window in (None, {"piece_lines": 64}):
        got = _emulate_full(shape, tpl, tl, x, window).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-300)
        np.testing.assert_allclose(got[m], ker[m], rtol=2e-3, atol=1e-32)
        assert np.all(np.abs(got[~m]) < 1e-30)
    pieces = linesum_cuda.full_plan(shape, tpl.device_arrays("cpu"), 11, {"piece_lines": 64})
    assert pieces["pieces"] > tpl.n_blocks and pieces["scratch_slots"] > 0


@pytest.mark.parametrize("shape", ["voigt", "phco2"])
def test_pairs_beyond_the_near_reach_are_region_1(cat, shape):
    """Every in-cut pair of the plan's windows beyond its (line, state)'s reach,
    and of random (alpha, gamma, T, dnu) up to alphas whose 15 / ia passes
    3 cm^-1, has |x| + y >= 15 at y = y0 (chi for phco2), in float64."""
    _, tl = cat
    _, tpl = _plans(cat, shape)
    x = _states()
    S, a, g = _line_params(tl, *x)
    bcoef = linesum_cuda.chi_rates(x[0]) if shape == "phco2" else None
    coef, reach, _ = linesum_cuda.full_pack(shape, S, a, g, tpl.cut, bcoef)
    win = tpl.device_arrays("cpu")["win_host"]
    nb = torch.tensor(np.asarray(tpl.nu_blocks))
    pos = torch.tensor(tl.positions64())
    checked = 0
    for b, (s0, c) in enumerate(win):
        dnu = nb[b][:, None] - pos[s0:s0 + c][None, :]
        for s in range(11):
            q1 = coef[s0:s0 + c, 1, s]
            beyond = (dnu.abs() > q1[:, 3]) & (dnu.abs() <= tpl.cut)
            y = q1[:, 2] * (chi_phco2(dnu, x[0][s]) if shape == "phco2" else 1.0)
            sx = (dnu * q1[:, 1]).abs() + y
            assert bool((sx[beyond] >= 15.0).all())
            checked += int(beyond.sum())
    assert checked > 0
    # random widths, up to 1 cm^-1 (15 / ia beyond 3 cm^-1 for phco2)
    rng = np.random.default_rng(3)
    n, L = 5, 400
    alpha = torch.tensor(10.0 ** rng.uniform(-4, 0, (n, L)))
    gamma = torch.tensor(10.0 ** rng.uniform(-7, 0, (n, L)))
    T = torch.tensor(rng.uniform(160.0, 320.0, n))
    S = torch.ones(n, L, dtype=torch.float64)
    coef, _, _ = linesum_cuda.full_pack(shape, S, alpha, gamma, 500.0,
                                        linesum_cuda.chi_rates(T) if shape == "phco2" else None)
    d = torch.tensor(rng.uniform(-500.0, 500.0, (2000, 1)))
    for s in range(n):
        q1 = coef[:, 1, s]
        y = q1[:, 2] * (chi_phco2(d, T[s]) if shape == "phco2" else 1.0)
        beyond = d.abs() > q1[:, 3]
        assert bool((((d * q1[:, 1]).abs() + y)[beyond] >= 15.0).all())


def test_full_pack_layout(cat):
    """The pack's quads: voigt's small-y states carry (A, 0, -1, 2 Sia y0 /
    sqrt(pi)) and set their tile's flag; a line of zero strength has the
    reach -inf and a term of 0; lorentz and doppler one quad, no reach."""
    _, tl = cat
    x = _states()
    S, a, g = _line_params(tl, *x)
    S = S.clone()
    S[:, 0] = 0.0
    coef, reach, fast = linesum_cuda.full_pack("voigt", S, a, g, 25.0)
    Sia, ia, y0, A = voigt_coefficients(S, a, g)[:4]
    small = (y0 < 0.01).T & (Sia != 0).T
    assert bool(small.any())
    q0 = coef[:, 0]
    assert bool((q0[..., 2][small] == -1.0).all())
    np.testing.assert_allclose(q0[..., 3][small].numpy(),
                               (Sia * y0 * 2.0 / math.sqrt(math.pi)).T[small].numpy(), rtol=1e-15)
    assert bool(torch.isinf(coef[0, 1, :, 3]).all()) and bool((coef[0, 0, :, 3] == 0).all())
    sizes = linesum_cuda.window_tile_sizes(11)
    assert reach.shape == (tl.n_lines, len(sizes), 2)
    flags = torch.stack([small[:, sum(sizes[:t]):sum(sizes[:t + 1])].any(dim=1)
                         for t in range(len(sizes))], dim=1)
    np.testing.assert_array_equal(reach[..., 1].numpy() != 0, flags.numpy())
    assert fast.dtype == torch.int32 and fast.shape == (1,)
    for shape in ("lorentz", "doppler"):
        c, r, _ = linesum_cuda.full_pack(shape, S, a, g, 25.0)
        assert c.shape == (tl.n_lines, 11, 4) and r is None
    with pytest.raises(ValueError):
        linesum_cuda.full_pack("gaussian", S, a, g, 25.0)


@pytest.mark.parametrize("cut", ["none", "arith", "stage", "no_near", "chunk64"])
def test_probe_cuts_apply_to_the_full_path(cut):
    """tools/k1_probe.py's cuts of K4/K5 (``--full --cuts``) find their text
    in csrc/linesum.cu exactly once, and every cut but ``none`` changes it."""
    from clearsky_tpu_torch.tools import k1_probe
    from clearsky_tpu_torch.utils.cuda_build import CSRC

    src = (CSRC / "linesum.cu").read_text()
    out = k1_probe.cut_source(src, cut, k1_probe.FULL_CUTS[cut])
    assert (out == src) == (cut == "none")


@pytest.mark.parametrize("shape", ["voigt", "phco2"])
def test_bound_counts_each_triple_at_its_form(cat, shape):
    """chip_smoke.full_ops, the operations of K4/K5's bound, equals the
    count made triple by triple on a grid fine enough that pairs fall within
    the near reach: the two-float dnu a pair (phco2: chi's piece, and chi a
    state beyond 3 cm^-1), w4 by region with the product and the sum within
    the (line, state)'s reach, region 1 beyond it, or voigt's small-y form
    where y0 < 0.01."""
    import chip_smoke as cs

    _, tl = cat
    grid = np.linspace(660.0, 672.0, 6000)
    cut = DEFAULT_CUT[shape]
    x = _states()
    S, a, g = _line_params(tl, *x)
    bc = linesum_cuda.chi_rates(x[0]) if shape == "phco2" else None
    coef, _, _ = linesum_cuda.full_pack(shape, S, a, g, cut, bc)
    w4q = coef[:, 1].transpose(0, 1)
    ia, y0, reach = w4q[..., 1], w4q[..., 2], w4q[..., 3]
    T = x[0] if shape == "phco2" else None
    got = cs.full_ops(grid, tl.positions64(), ia, y0, reach, cut, T=T)
    pos = tl.positions64()
    dnu = grid[:, None] - pos[None, :]
    pi, li = np.nonzero(np.abs(dnu) <= cut)
    d = torch.tensor(dnu[pi, li], dtype=torch.float32).double()[None, :]
    inner = d.abs() <= reach[:, li]
    y = y0[:, li].expand_as(inner)
    if T is not None:
        y = y * chi_phco2(d, T[:, None])
    w_ops = cs.w4_ops((d * ia[:, li])[inner], y[inner]) + 2.0 * float(inner.sum())
    beyond = ~inner
    n_pairs = len(pi)
    if shape == "voigt":
        small = (y0[:, li] < 0.01).expand_as(inner) & beyond
        want = (n_pairs * cs.PAIR_OPS + w_ops + float((beyond & ~small).sum()) * cs.R1_OPS
                + float(small.sum()) * cs.SMALL_Y_OPS)
    else:
        far3 = float((np.abs(dnu[pi, li]) > 3.0).sum()) * x[0].shape[0]
        want = (n_pairs * (cs.PAIR_OPS + cs.PH_PAIR_OPS) + w_ops
                + float(beyond.sum()) * cs.PH_R1_OPS + far3 * cs.CHI_OPS)
        assert got["exps"] == far3
    assert 0 < got["within_reach"] == float(inner.sum()) < got["triples"]
    assert got["triples"] == n_pairs * x[0].shape[0]
    np.testing.assert_allclose(got["ops"], want, rtol=1e-12)

"""Plain line sum: cross-sections from a line table at chosen wavenumbers.

sigma(nu; T, P) = sum over lines within ``cut`` of nu of
conc S(T) Re w(x + iy) / (alpha sqrt(pi)), x = (nu - nu_l)/alpha,
y = gamma/alpha, with HITRAN's intensity scaling (TIPS partition function
by its Chebyshev fit), the Doppler 1/e half-width alpha and the pressure-
broadened Lorentz half-width gamma (self-broadening at the partial pressure
conc P). Re w is Humlicek's w4 with the real part taken off the real axis
by its Taylor series below y = 0.01 (a frozen copy of the formula ClearSky
uses, evaluated here in plain tensor arithmetic).

The sum runs over an explicit list of (point, line) pairs within the cut,
built from the sorted positions, so it costs the in-cut pairs and works at
any set of points: a sample of a fine grid or a whole coarse one. The
distance nu - nu_l is formed in float64 from the float64 grid and
positions, then everything runs in ``dtype``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["C2", "line_state", "wofz_re", "sigma_at", "line_sum", "in_cut_pairs",
           "in_cut_counts"]

C_LIGHT = 299792458.0
H_PLANCK = 6.62607015e-34
K_BOLTZ = 1.38064852e-23
R_GAS = 8.31446262
P_ATM = 101325.0
T_REF = 296.0
TIPS_T = (25.0, 1000.0)
C2 = 100.0 * H_PLANCK * C_LIGHT / K_BOLTZ
SQRT_PI = 1.7724538509055159


def line_state(tab: dict, T, P, dtype, device):
    """Per-(state, line) S(T) conc, alpha and gamma, each [n_states, n_lines],
    at state tensors T, P [n_states]."""
    f = lambda k: torch.as_tensor(tab[k], dtype=torch.float64, device=device)
    T = T.to(torch.float64)[:, None]
    P = P.to(torch.float64)[:, None]
    nu, S, conc = f("nu"), f("S"), f("conc")
    cheb = f("cheb")
    t = torch.clamp(2.0 * (T - TIPS_T[0]) / (TIPS_T[1] - TIPS_T[0]) - 1.0, -1.0, 1.0)
    c0, c1 = torch.ones_like(t), t
    q = cheb[:, 0] * c0 + cheb[:, 1] * c1
    for k in range(2, cheb.shape[1]):
        c0, c1 = c1, 2.0 * t * c1 - c0
        q = q + cheb[:, k] * c1
    a, b = -C2 * f("Epp"), -C2 * nu
    scale = (torch.exp(a / T) * -torch.expm1(b / T)) / (torch.exp(a / T_REF) * -torch.expm1(b / T_REF))
    S_T = conc * S * scale / q
    alpha = (nu / C_LIGHT) * torch.sqrt(2.0 * R_GAS * T / f("mu"))
    Pp = conc * P
    gamma = (T_REF / T) ** f("na") * (f("ga") * (P - Pp) + f("gs") * Pp) / P_ATM
    return S_T.to(dtype), alpha.to(dtype), gamma.to(dtype)


def _poly(coeffs, tr, ti):
    pr, pi = torch.full_like(tr, coeffs[0]), torch.zeros_like(tr)
    for c in coeffs[1:]:
        pr, pi = pr * tr - pi * ti + c, pr * ti + pi * tr
    return pr, pi


def _div(ar, ai, br, bi):
    d = br * br + bi * bi
    return (ar * br + ai * bi) / d, (ai * br - ar * bi) / d


def _near(x, y):
    """w(x + iy) for |x| + y < 15: Humlicek's regions 2-4."""
    ax = x.abs()
    s = ax + y
    tr, ti = y, -x
    ur, ui = tr * tr - ti * ti, 2.0 * tr * ti
    n2r, n2i = tr * (1.410474 + 0.5641896 * ur) - ti * 0.5641896 * ui, \
        tr * 0.5641896 * ui + ti * (1.410474 + 0.5641896 * ur)
    d2r, d2i = ur * (3.0 + ur) - ui * ui + 0.75, ur * ui + ui * (3.0 + ur)
    w2r, w2i = _div(n2r, n2i, d2r, d2i)
    n3r, n3i = _poly([0.5642236, 3.778987, 11.96482, 20.20933, 16.4955], tr, ti)
    d3r, d3i = _poly([1.0, 6.699398, 21.69274, 39.27121, 38.82363, 16.4955], tr, ti)
    w3r, w3i = _div(n3r, n3i, d3r, d3i)
    u4r = torch.clamp(ur, max=0.0)
    p4r, p4i = _poly([0.56419, 1.320522, 35.76683, 219.0313, 1540.787, 3321.9905, 36183.31],
                     -u4r, -ui)
    q4r, q4i = _poly([1.0, 1.841439, 61.57037, 364.2191, 2186.181, 9022.228, 24322.84,
                      32066.6], -u4r, -ui)
    fr, fi = _div(p4r, p4i, q4r, q4i)
    eu = torch.exp(u4r)
    w4r = eu * torch.cos(ui) - (tr * fr - ti * fi)
    w4i = eu * torch.sin(ui) - (tr * fi + ti * fr)
    r3 = y >= 0.195 * ax - 0.176
    wr = torch.where(s >= 5.5, w2r, torch.where(r3, w3r, w4r))
    wi = torch.where(s >= 5.5, w2i, torch.where(r3, w3i, w4i))
    # below y = 0.01 region 4's real part cancels: its Taylor series off the axis
    ex2 = torch.exp(u4r) * (1.0 - y * y)
    inv = 1.0 / torch.clamp(x * x, min=1.0)
    g_series = (2.0 / SQRT_PI) * inv * (0.5 + inv * (0.75 + inv * (1.875 + inv * 6.5625)))
    g_direct = 2.0 * x * (wi + 2.0 * x * y * ex2) - 2.0 / SQRT_PI
    g = torch.where(ax >= 5.5, g_series, g_direct)
    small = ex2 + y * g - y * y * (2.0 * x * x - 1.0) * ex2
    return torch.where(y < 0.01, small, wr)


def wofz_re(x, y):
    """Re w(x + iy), y >= 0 (Humlicek w4 with the small-y series)."""
    tr, ti = y, -x
    ur, ui = tr * tr - ti * ti, 2.0 * tr * ti
    out, _ = _div(0.5641896 * tr, 0.5641896 * ti, 0.5 + ur, ui)   # region 1: |x| + y >= 15
    near = (x.abs() + y) < 15.0
    if bool(near.any()):
        out = out.masked_scatter(near, _near(x[near], y[near]))
    small = (y < 0.01) & ~near
    if bool(small.any()):
        # the same series far from the core, where g takes its asymptotic form
        xs, ys = x[small], y[small]
        inv = 1.0 / (xs * xs)
        g = (2.0 / SQRT_PI) * inv * (0.5 + inv * (0.75 + inv * (1.875 + inv * 6.5625)))
        ex2 = torch.exp(torch.clamp(ys * ys - xs * xs, max=0.0)) * (1.0 - ys * ys)
        out = out.masked_scatter(small, ex2 + ys * g - ys * ys * (2.0 * xs * xs - 1.0) * ex2)
    return out


def in_cut_pairs(line_nu: np.ndarray, points: np.ndarray, cut: float):
    """(point index, line index) of every line within ``cut`` of each point,
    from sorted float64 positions (inclusive at both ends)."""
    lo = np.searchsorted(line_nu, points - cut, side="left")
    hi = np.searchsorted(line_nu, points + cut, side="right")
    n = hi - lo
    pt = np.repeat(np.arange(len(points)), n)
    start = np.repeat(lo - np.concatenate([[0], np.cumsum(n)[:-1]]), n)
    return pt, start + np.arange(n.sum())


def in_cut_counts(line_nu: np.ndarray, grid: np.ndarray, cut: float) -> int:
    """Number of (line, point) pairs of a grid within ``cut`` (each line's
    points by two searches)."""
    lo = np.searchsorted(grid, line_nu - cut, side="left")
    hi = np.searchsorted(grid, line_nu + cut, side="right")
    return int((hi - lo).sum())


def sigma_at(tab: dict, points: np.ndarray, T, P, cut: float = 25.0,
             dtype=torch.float64, device="cpu", budget: int = 2**23):
    """sigma [n_states, len(points)] [cm^2/molecule] at states T, P
    [n_states] (tensors): the exact in-cut line sum in ``dtype``."""
    device = torch.device(device)
    pt, li = in_cut_pairs(tab["nu"], np.asarray(points, np.float64), cut)
    dnu = torch.as_tensor(np.asarray(points, np.float64)[pt] - tab["nu"][li], device=device)
    dnu = dnu.to(dtype)
    pt_t = torch.as_tensor(pt, device=device)
    li_t = torch.as_tensor(li, device=device)
    S, alpha, gamma = line_state(tab, T, P, dtype, device)
    n_states = S.shape[0]
    out = torch.zeros((n_states, len(points)), dtype=dtype, device=device)
    if len(pt) == 0:
        return out
    rows = max(1, budget // len(pt))
    for a in range(0, n_states, rows):
        b = min(a + rows, n_states)
        for c in range(0, len(pt), budget):
            d = min(c + budget, len(pt))
            al, ga = alpha[a:b, li_t[c:d]], gamma[a:b, li_t[c:d]]
            inv = 1.0 / al
            w = wofz_re(dnu[c:d][None, :] * inv, ga * inv)
            contrib = S[a:b, li_t[c:d]] * inv * (1.0 / SQRT_PI) * w
            out[a:b].index_add_(1, pt_t[c:d], contrib)
    return out


def line_sum(tab: dict, cut: float = 25.0):
    """The exact in-cut line sum of ``tab`` as the cores' cross-section
    function: ``sigma(points, T, P, dtype, device)``."""
    return lambda points, T, P, dtype=torch.float64, device="cpu": sigma_at(
        tab, points, T, P, cut=cut, dtype=dtype, device=device)

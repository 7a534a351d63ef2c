"""Faddeeva function (Humlicek w4) for Voigt profiles.

Counterpart of ``clearsky_tpu.ops.faddeeva``, with the same arithmetic per
element: the four w4 regions on real pairs, and the real part repaired below
y = 0.01 with a Taylor expansion off the real axis. The JAX version
evaluates every region everywhere and selects; here region 1 (s = |x| + y
>= 15, nearly every element of a line sum) is evaluated everywhere and the
other regions and the repair only on the elements they apply to, which gives
the same values at a fraction of the cost. The CUDA line-sum kernel
(``csrc/linesum.cu``, ``wofz_re``) evaluates only the active region too.
Accuracy <= 2.4e-4 relative in float64.

Derivatives are those of the true function, as in the JAX version's
custom JVP: w'(z) = -2 z w + 2i/sqrt(pi) from the computed w in the core,
and the asymptotic series in u = 1/z^2 where |x| + y >= 6. Differentiating
the w4 rationals instead overflows float32 at the far-wing arguments of
narrow lines (|x| ~ 1e7), which the primal survives only through the
two-division form of :func:`_cdiv`.
"""

from __future__ import annotations

import torch

__all__ = ["wofz_re", "wofz_re_im"]

_SQRT_PI = 1.7724538509055159
_Y_SMALL = 0.01  # switch to the Taylor-off-axis real part below this y


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _cdiv(ar, ai, br, bi):
    # must stay in the two-division form: the single-reciprocal rewrite
    # overflows |d|^2 to inf in float32 for far-wing arguments (|z| ~ 1e5)
    d = br * br + bi * bi
    return (ar * br + ai * bi) / d, (ai * br - ar * bi) / d


def _cpoly(coeffs, tr, ti):
    """Horner evaluation of a real-coefficient polynomial at complex t."""
    pr = torch.zeros_like(tr) + coeffs[0]
    pi = torch.zeros_like(tr)
    for c in coeffs[1:]:
        pr, pi = _cmul(pr, pi, tr, ti)
        pr = pr + c
    return pr, pi


def _near_core(x, y, ax, s, ur, ui):
    """w on elements with s < 15: regions 2, 3 and 4, selected."""
    tr, ti = y, -x

    # region 2: 5.5 <= s < 15 -- w = t(1.410474 + 0.5641896 u)/(0.75 + u(3 + u))
    n2r, n2i = _cmul(tr, ti, 1.410474 + 0.5641896 * ur, 0.5641896 * ui)
    d2r, d2i = _cmul(ur, ui, 3.0 + ur, ui)
    w2r, w2i = _cdiv(n2r, n2i, 0.75 + d2r, d2i)

    # region 3: s < 5.5 and y >= 0.195|x| - 0.176 -- [4/5] rational in t
    n3r, n3i = _cpoly([0.5642236, 3.778987, 11.96482, 20.20933, 16.4955], tr, ti)
    d3r, d3i = _cpoly([1.0, 6.699398, 21.69274, 39.27121, 38.82363, 16.4955], tr, ti)
    w3r, w3i = _cdiv(n3r, n3i, d3r, d3i)

    # region 4: s < 5.5 and y < 0.195|x| - 0.176 -- w = exp(u) - t P(u)/Q(u);
    # u_r <= 0 in the active region, so the clamp only keeps inf out of the
    # discarded evaluations
    u4r = torch.clamp(ur, max=0.0)
    p4r, p4i = _cpoly(
        [0.56419, 1.320522, 35.76683, 219.0313, 1540.787, 3321.9905, 36183.31],
        -u4r, -ui,
    )
    q4r, q4i = _cpoly(
        [1.0, 1.841439, 61.57037, 364.2191, 2186.181, 9022.228, 24322.84, 32066.6],
        -u4r, -ui,
    )
    frac_r, frac_i = _cdiv(p4r, p4i, q4r, q4i)
    tf_r, tf_i = _cmul(tr, ti, frac_r, frac_i)
    eu = torch.exp(u4r)
    w4r = eu * torch.cos(ui) - tf_r
    w4i = eu * torch.sin(ui) - tf_i

    in_r2 = s >= 5.5
    in_r3 = y >= 0.195 * ax - 0.176
    wr = torch.where(in_r2, w2r, torch.where(in_r3, w3r, w4r))
    wi = torch.where(in_r2, w2i, torch.where(in_r3, w3i, w4i))
    return wr, wi


def _small_y_re(x, y, ax, ur, wi):
    """Re w for y < 0.01, where region 4 cancels catastrophically:
    Re w = e^{-x^2} + y g - y^2 (2x^2 - 1) e^{-x^2}, with
    g = 2x Im w(x,0) - 2/sqrt(pi) taken from its asymptotic series for
    |x| >= 5.5; e^{-x^2} ~ eu (1 - y^2) reuses region 4's exponential."""
    ex2 = torch.exp(torch.clamp(ur, max=0.0)) * (1.0 - y * y)
    x2 = torch.clamp(x * x, min=1.0)
    inv = 1.0 / x2
    g_series = (2.0 / _SQRT_PI) * inv * (0.5 + inv * (0.75 + inv * (1.875 + inv * 6.5625)))
    wi0 = wi + 2.0 * x * y * ex2
    g_direct = 2.0 * x * wi0 - 2.0 / _SQRT_PI
    g = torch.where(ax >= 5.5, g_series, g_direct)
    return ex2 + y * g - y * y * (2.0 * x * x - 1.0) * ex2


def _wofz_re_im_impl(x, y):
    """Real and imaginary parts of w(x + iy), y >= 0: the primal."""
    x, y = torch.broadcast_tensors(x, y)
    ax = torch.abs(x)
    s = ax + y
    tr, ti = y, -x
    ur, ui = _cmul(tr, ti, tr, ti)  # u = t^2

    # region 1: s >= 15 -- w = 0.5641896 t/(0.5 + t^2); the only form whose
    # float32 intermediates survive large |z|
    wr, wi = _cdiv(0.5641896 * tr, 0.5641896 * ti, 0.5 + ur, ui)

    near = s < 15.0
    if bool(near.any()):
        m = near
        nr, ni = _near_core(x[m], y[m], ax[m], s[m], ur[m], ui[m])
        wr = wr.masked_scatter(m, nr)
        wi = wi.masked_scatter(m, ni)
    small = y < _Y_SMALL
    if bool(small.any()):
        m = small
        wr = wr.masked_scatter(m, _small_y_re(x[m], y[m], ax[m], ur[m], wi[m]))
    return wr, wi


def _wprime(x, y, wr, wi):
    """(Re, Im) of w'(z) at z = x + iy from the computed w: the ODE form
    -2 z w + 2i/sqrt(pi) where |x| + y < 6, else the exact asymptotic
    derivative -(i/sqrt(pi)) u (1 + 3/2 u + 15/4 u^2 + 105/8 u^3), u = 1/z^2
    (``clearsky_tpu.ops.faddeeva._wofz_re_im_jvp``). In the far wings the
    ODE form cancels at leading order and amplifies w4's error by ~|z|^2;
    the series is cancellation-free and float32-safe at any |z|."""
    re_ode = -2.0 * (x * wr - y * wi)
    im_ode = -2.0 * (x * wi + y * wr) + 2.0 / _SQRT_PI
    z2r = x * x - y * y
    z2i = 2.0 * x * y
    ur, ui = _cdiv(torch.ones_like(x), torch.zeros_like(x), z2r, z2i)
    pr, pi = _cpoly([13.125, 3.75, 1.5, 1.0], ur, ui)
    sr, si = _cmul(ur, ui, pr, pi)
    far = (torch.abs(x) + y) >= 6.0
    return (torch.where(far, si * (1.0 / _SQRT_PI), re_ode),
            torch.where(far, -sr * (1.0 / _SQRT_PI), im_ode))


def _elementwise_batch(in_dims, *xs):
    """Operands of an elementwise map with their vmap dimensions moved to
    the front (size 1 where unbatched) and padded to a common rank."""
    moved = [x.movedim(d, 0) if d is not None else x.unsqueeze(0) for x, d in zip(xs, in_dims)]
    rank = max(m.dim() for m in moved)
    return [m.reshape(m.shape[:1] + (1,) * (rank - m.dim()) + m.shape[1:]) for m in moved]


class _Wofz(torch.autograd.Function):
    """w(z) with the derivative of :func:`_wprime`: dw = w'(z) (dx + i dy)."""

    @staticmethod
    def forward(x, y):
        return _wofz_re_im_impl(x, y)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, y = inputs
        ctx.save_for_forward(x, y, *output)
        ctx.save_for_backward(x, y, *output)

    @staticmethod
    def jvp(ctx, dx, dy):
        a, b = _wprime(*ctx.saved_tensors)
        dx = torch.zeros_like(a) if dx is None else dx
        dy = torch.zeros_like(a) if dy is None else dy
        return a * dx - b * dy, b * dx + a * dy

    @staticmethod
    def backward(ctx, gr, gi):
        x, y = ctx.saved_tensors[:2]
        a, b = _wprime(*ctx.saved_tensors)
        gx = a * gr + b * gi
        gy = a * gi - b * gr
        # sum the cotangents back to each operand's own shape
        return (gx.sum_to_size(x.shape) if ctx.needs_input_grad[0] else None,
                gy.sum_to_size(y.shape) if ctx.needs_input_grad[1] else None)

    @staticmethod
    def vmap(info, in_dims, x, y):
        # elementwise: the batch is one more broadcast dimension, and the
        # primal runs once over it
        return _Wofz.apply(*_elementwise_batch(in_dims, x, y)), (0, 0)


def wofz_re_im(x, y):
    """Real and imaginary parts of w(z) = exp(-z^2) erfc(-iz), z = x + iy, y >= 0,
    with the derivative of the true function (:func:`_wprime`)."""
    return _Wofz.apply(x, y)


def wofz_re(x, y):
    """Real part of the Faddeeva function w(x + iy), y >= 0."""
    return wofz_re_im(x, y)[0]

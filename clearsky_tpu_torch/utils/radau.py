"""Batched adaptive Radau IIA(5) for per-lane scalar ODEs: the plain engine.

Counterpart of ``clearsky_tpu.utils.radau``. Every lane is an independent
scalar ODE dy/dx = f(x, y) with its own position, step size and error
controller; all lanes march together in one loop of masked tensor
arithmetic, as the JAX package's ``lax.while_loop`` does: 3-stage Radau IIA
collocation, simplified Newton on the stage system in the eigenbasis of the
Butcher matrix (one real and one complex division a Newton step), the
3rd-order embedded error estimate with the stiffness-damped re-estimate on a
retry, and the predictive (Gustafsson) step-size controller (Hairer &
Wanner, "Solving ODEs II", IV.8, the construction scipy's ``Radau`` uses).

``f`` is a function f(x, y, args), or an object with three methods that
compute it in two stages: ``at(x, args)``, a tuple of tensors that depends
on x alone, ``apply(q, y)`` = f(x, y, args) from it, and ``dfdy(q, y)``. The
engine then evaluates ``at`` once per stage abscissa of an attempt (Newton
changes y, not x) and carries it across an accepted step (the last stage
abscissa is x + h); a plain function is evaluated in full each time, its
Jacobian by ``torch.func.jvp``. Both give the same numbers.

This is the generic API on a caller's own ``f``, on any device. The flux
cores (``rt.radau``) run their two right-hand sides through the CUDA kernel
on the card (``rt.radau_cuda``), whose CPU path, derivative twin and test
oracle this engine is.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["radau_scalar", "radau_dense", "RadauResult"]

_S6 = np.sqrt(6.0)
# collocation nodes and embedded-error weights (Hairer & Wanner IV.8)
_C = np.array([(4.0 - _S6) / 10.0, (4.0 + _S6) / 10.0, 1.0])
_E = np.array([-13.0 - 7.0 * _S6, -13.0 + 7.0 * _S6, -1.0]) / 3.0
# eigenvalues of inv(A): one real, one complex pair
_MU_REAL = 3.0 + 3.0 ** (2.0 / 3.0) - 3.0 ** (1.0 / 3.0)
_MU_C_RE = 3.0 + 0.5 * (3.0 ** (1.0 / 3.0) - 3.0 ** (2.0 / 3.0))
_MU_C_IM = 0.5 * (3.0 ** (5.0 / 6.0) + 3.0 ** (7.0 / 6.0))
# stage <-> eigenbasis transformations (Z = T W, W = TI Z)
_T = np.array([
    [0.09443876248897524, -0.14125529502095421, 0.03002919410514742],
    [0.25021312296533332, 0.20412935229379994, -0.38294211275726192],
    [1.0, 1.0, 0.0],
])
_TI = np.array([
    [4.17871859155190428, 0.32768282076106237, 0.52337644549944951],
    [-4.17871859155190428, -0.32768282076106237, 0.47662355450055044],
    [0.50287263494578682, -2.57192694985560522, 0.59603920482822492],
])

_MIN_FACTOR = 0.2
_MAX_FACTOR = 10.0


class RadauResult(NamedTuple):
    """y: final state per lane; steps: accepted steps; ok: reached x1 within
    ``max_steps`` (per lane)."""

    y: torch.Tensor
    steps: torch.Tensor
    ok: torch.Tensor


def _mix(M, V):
    """M [3, 3, 1] applied to the three rows of V [3, lanes]."""
    return (M * V[None]).sum(dim=1)


class _Plain:
    """A plain f(x, y, args) as the two-stage interface (its stage is x)."""

    def __init__(self, f, args):
        self.f, self.args = f, args

    def at(self, x, args):
        return (x,)

    def apply(self, q, y):
        return self.f(q[0], y, self.args)

    def dfdy(self, q, y):
        return torch.func.jvp(lambda yy: self.f(q[0], yy, self.args), (y,),
                              (torch.ones_like(y),))[1]


def _staged(f, args):
    return f if all(hasattr(f, k) for k in ("at", "apply", "dfdy")) else _Plain(f, args)


def _select(mask, a, b):
    """Lane-wise choice between two stage tuples of [lanes] tensors."""
    return tuple(torch.where(mask, u, v) for u, v in zip(a, b))


def _rdiv(a: float, x):
    """a / x as a true division (a Python number over a tensor is x's
    reciprocal times a in PyTorch, which rounds otherwise)."""
    return torch.tensor(a, dtype=x.dtype, device=x.device) / x


def _initial_step(f, x0, y0, f0, d, span, scale, args):
    """Per-lane starting step (the curvature heuristic; order-3 error
    control, so the exponent 1/4), in the positions' dtype (x0, d, span)
    from arithmetic in y's. 1e-300 is 0 in float32, as in JAX."""
    dtype = y0.dtype
    d0 = y0.abs() / scale
    d1 = f0.abs() / scale
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6, 0.01 * d0 / torch.clamp(d1, min=1e-300))
    h0 = torch.minimum(h0.to(span.dtype), span)
    dh = d * h0
    f1 = f.apply(f.at((x0 + dh).to(dtype), args), y0 + dh.to(dtype) * f0)
    h0 = h0.to(dtype)
    d2 = (f1 - f0).abs() / scale / torch.clamp(h0, min=1e-300)
    dm = torch.maximum(d1, d2)
    h1 = torch.where(dm <= 1e-15, torch.clamp(h0 * 1e-3, min=1e-6),
                     _rdiv(0.01, torch.clamp(dm, min=1e-300)) ** 0.25)
    return torch.minimum(torch.minimum(100.0 * h0, h1).to(span.dtype), span)


def _lanes(x, dtype, device, L):
    return torch.broadcast_to(torch.as_tensor(x, dtype=dtype, device=device), (L,))


def radau_scalar(f, y0, x0, x1, args=None, rtol: float = 1e-5, atol=1e-9,
                 newton_iters: int = 6, max_steps: int = 10_000) -> RadauResult:
    """Integrate dy/dx = f(x, y, args) from x0 to x1, one scalar ODE per lane.

    ``f(x, y, args)`` maps x, y [lanes] to [lanes] in tensor arithmetic; its
    Jacobian df/dy is ``torch.func.jvp`` of it (or ``f`` is the two-stage
    object of the module note). ``y0`` [lanes]; ``x0``,
    ``x1`` scalars or [lanes] whose direction sign(x1 - x0) is uniform;
    ``atol`` a scalar or [lanes]. ``newton_iters`` >= 2 (an RHS linear in y
    converges on the 2nd iteration). A lane that does not reach x1 within
    ``max_steps`` attempts is not ``ok``; a lane whose y0 or f(x0, y0) is
    NaN is done at once with y NaN. Finished lanes idle until the loop ends.

    The lanes' positions x and step sizes are carried in float64 whatever
    y's dtype (the JAX package carries them in y's): f sees x rounded to
    y's dtype, and the step floor 16 eps |x| that keeps x + h apart from x
    is float64's. In float32 a lane at |x| ~ 300 (the surface in sqrt P)
    whose boundary layer needs steps under float32's floor (6e-4 there)
    would otherwise reject at that floor until ``max_steps``.
    """
    if newton_iters < 2:
        raise ValueError("newton_iters must be >= 2 (convergence is rate-tested)")
    y0 = torch.atleast_1d(torch.as_tensor(y0))
    dtype = torch.promote_types(y0.dtype, torch.float32)
    y0 = y0.to(dtype)
    dev = y0.device
    L = y0.shape[0]
    pdtype = torch.float64    # positions and steps
    x0 = _lanes(x0, dtype, dev, L).to(pdtype)
    x1 = _lanes(x1, dtype, dev, L).to(pdtype)
    span = (x1 - x0).abs()
    # uniform direction across lanes (the sign of the lanes' summed span)
    d = torch.where((x1 - x0).sum() < 0, -1.0, 1.0).to(pdtype)

    eps = torch.finfo(dtype).eps
    eps_x = torch.finfo(pdtype).eps
    rtol = torch.as_tensor(rtol, dtype=dtype, device=dev)
    atol = torch.as_tensor(atol, dtype=dtype, device=dev)
    newton_tol = torch.maximum(_rdiv(10.0 * eps, rtol), torch.clamp(torch.sqrt(rtol), max=0.03))
    k = lambda v: torch.tensor(v, dtype=dtype, device=dev)
    MU_R, MU_CR, MU_CI = k(_MU_REAL), k(_MU_C_RE), k(_MU_C_IM)
    # the method's constants in dtype, shaped to broadcast over the lanes
    Tm, TIm = k(_T)[:, :, None], k(_TI)[:, :, None]
    E = k(_E)[:, None]
    C3 = torch.tensor(_C, dtype=pdtype, device=dev)[:, None]

    f = _staged(f, args)
    plain = isinstance(f, _Plain)   # a plain f takes one stage at a time
    q_x = f.at(x0.to(dtype), args)       # f's x-stage at each lane's position
    f0 = f.apply(q_x, y0).to(dtype)
    # a NaN lane can never accept a step: done at once, and its y NaN (done
    # lanes read as ok; a finite y0 must not pass for the integral)
    y0 = torch.where(torch.isnan(f0), torch.nan, y0)
    scale0 = atol + y0.abs() * rtol
    h = _initial_step(f, x0, y0, f0, d, torch.clamp(span, min=1e-30), scale0, args)

    x, y, f0 = x0, y0, f0
    done = (span <= 0) | torch.isnan(y0)
    h_old = torch.zeros(L, dtype=pdtype, device=dev)
    err_old = torch.full((L,), -1.0, dtype=dtype, device=dev)
    rej = torch.zeros(L, dtype=torch.bool, device=dev)
    steps = torch.zeros(L, dtype=torch.int32, device=dev)
    zeros = torch.zeros(L, dtype=dtype, device=dev)
    zeros3 = torch.zeros((3, L), dtype=dtype, device=dev)

    it = 0
    while it < max_steps and bool((~done).any()):
        it += 1
        active = ~done
        rem = (x1 - x).abs()
        h_abs = torch.minimum(h, rem)
        h_abs = torch.maximum(h_abs, 16.0 * eps_x * torch.clamp(x.abs(), min=1.0))
        hs_x = d * h_abs                              # the signed step, in positions
        J = f.dfdy(q_x, y)
        q3 = f.at((x + C3 * hs_x).to(dtype), args)    # the three stage abscissae at once
        hs = hs_x.to(dtype)                           # the step in y's arithmetic
        q_s = [tuple(u[k] for u in q3) for k in range(3)]

        mr, mcr, mci = MU_R / hs, MU_CR / hs, MU_CI / hs
        den_r = mr - J
        dcr = mcr - J
        inv_c = _rdiv(1.0, dcr * dcr + mci * mci)
        scale = atol + y.abs() * rtol

        # simplified Newton on the 3 stage increments, in the eigenbasis
        # (rows of W: the real eigen-component, then the complex pair's)
        W = zeros3
        dwn = nit = zeros
        rate = torch.full((L,), -1.0, dtype=dtype, device=dev)
        live = torch.ones(L, dtype=torch.bool, device=dev)
        for _ in range(newton_iters):
            Z = _mix(Tm, W)
            if plain:
                F = torch.stack([f.apply(q_s[k], y + Z[k]) for k in range(3)])
            else:
                F = f.apply(q3, y + Z)
            # the complex pair: TI inv(A) T has the block [[mcr, +mci],
            # [-mci, mcr]], so the off-diagonal signs below carry weight
            g = _mix(TIm, F) - torch.stack([mr * W[0], mcr * W[1] + mci * W[2],
                                            mcr * W[2] - mci * W[1]])
            dW = torch.stack([g[0] / den_r, (g[1] * dcr - g[2] * mci) * inv_c,
                              (g[2] * dcr + g[1] * mci) * inv_c])
            a = dW / scale
            dwn_new = torch.sqrt((a * a).sum(dim=0) / 3.0)
            rate_new = torch.where(dwn > 0, dwn_new / torch.clamp(dwn, min=1e-300), rate)
            W = torch.where(live, W + dW, W)
            settled = (dwn_new == 0.0) | ((rate_new >= 0) & (rate_new < 1.0)
                                          & (rate_new / (1.0 - rate_new) * dwn_new < newton_tol))
            dwn = torch.where(live, dwn_new, dwn)
            rate = torch.where(live, rate_new, rate)
            nit = nit + live.to(dtype)
            live = live & ~settled
        conv = (dwn == 0.0) | ((rate >= 0) & (rate < 1.0)
                               & (rate / torch.clamp(1.0 - rate, min=1e-6) * dwn < newton_tol))

        Z = _mix(Tm, W)
        y_new = y + Z[2]
        ZE = (Z * E).sum(dim=0) / hs
        scale_e = atol + torch.maximum(y.abs(), y_new.abs()) * rtol
        e_raw = (f0 + ZE) / den_r
        err = e_raw.abs() / scale_e
        # the stiffness-damped re-estimate, only on a retry of a rejected
        # step (RADAU5 / scipy: 'if rejected and error_norm > 1')
        f_damp = f.apply(q_x, y + e_raw)
        err2 = ((f_damp + ZE) / den_r).abs() / scale_e
        err = torch.where(rej & (err > 1.0), err2, err)

        safety = _rdiv(0.9 * (2.0 * newton_iters + 1.0), 2.0 * newton_iters + nit)
        # predictive (two-step) controller where history exists
        mult = torch.where((err_old > 0) & (h_old > 0) & (err > 0),
                           (h_abs / torch.clamp(h_old, min=1e-300)).to(dtype)
                           * (err_old / torch.clamp(err, min=1e-300)) ** 0.25, 1.0)
        factor = torch.clamp(mult, max=1.0) * torch.clamp(err, min=1e-12) ** -0.25
        accept = conv & (err <= 1.0) & active

        x_next = x + hs_x   # = x + C[2] hs: C[2] is 1, so q_s[2] is f's stage at x_next
        reached = (x1 - x_next).abs() <= 16.0 * eps_x * torch.clamp(x1.abs(), min=1.0)
        f_next = f.apply(q_s[2], y_new)

        h_acc = h_abs * torch.clamp(safety * factor, _MIN_FACTOR, _MAX_FACTOR)
        h_rej = torch.where(conv, h_abs * torch.clamp(safety * factor, min=_MIN_FACTOR),
                            0.5 * h_abs)

        x = torch.where(accept, x_next, x)
        y = torch.where(accept, y_new, y)
        f0 = torch.where(accept, f_next, f0)
        q_x = _select(accept, q_s[2], q_x)
        h = torch.where(active, torch.where(accept, h_acc, h_rej), h)
        done = done | (accept & reached)
        h_old = torch.where(accept, h_abs, h_old)
        err_old = torch.where(accept, err, err_old)
        rej = torch.where(active, ~accept, rej)
        steps = steps + accept.to(torch.int32)
    return RadauResult(y=y, steps=steps, ok=done)


def radau_dense(f, y0, xs, args=None, rtol: float = 1e-5, atol=1e-9,
                newton_iters: int = 6, max_steps: int = 10_000, with_steps: bool = False):
    """Adaptive integration with output at every node of ``xs`` [nx]: y at
    the nodes, [nx, lanes] (row 0 is y0).

    Each segment [xs[k], xs[k+1]] is a :func:`radau_scalar` of its own (a
    fresh initial step, no controller history, ``max_steps`` attempts), as
    the JAX package's ``lax.scan`` of segments. A lane that does not finish
    a segment is NaN from there on. ``xs`` is monotone and shared by the
    lanes. ``with_steps`` also returns the accepted steps per lane, summed
    over the segments.
    """
    y0 = torch.atleast_1d(torch.as_tensor(y0))
    dtype = torch.promote_types(y0.dtype, torch.float32)
    xs = torch.as_tensor(xs, dtype=dtype, device=y0.device)
    y = y0.to(dtype)
    ys, steps = [y], torch.zeros(y.shape[0], dtype=torch.int32, device=y.device)
    for k in range(xs.shape[0] - 1):
        r = radau_scalar(f, y, xs[k], xs[k + 1], args=args, rtol=rtol, atol=atol,
                         newton_iters=newton_iters, max_steps=max_steps)
        # a lane that ran out of steps mid-segment must not pass its partial
        # integral off as converged
        y = torch.where(r.ok, r.y, torch.nan)
        ys.append(y)
        steps = steps + r.steps
    out = torch.stack(ys)
    return (out, steps) if with_steps else out

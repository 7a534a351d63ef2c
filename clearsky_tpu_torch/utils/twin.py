"""Kernels with derivatives: a launch whose tangents ride its plain twin.

Counterpart of the JAX package's ``custom_jvp`` rules around its Pallas
kernels (``ops/linesum_pallas.py`` :1778-1801, ``rt/discretized.py``
:506-533 and :609-623, ``rt/fused_table.py`` :271-280 and :376-389): the
primal is the kernel, and the derivatives are those of the kernel's plain
PyTorch twin, which computes the same function. :func:`with_twin` applies
that pair as one ``torch.autograd.Function``:

* ``forward`` runs the kernel once, on the untransformed primals;
* ``jvp`` is ``torch.func.jvp`` of the twin on the primals and tangents
  (forward mode; ``torch.func.jacfwd`` is ``vmap`` of it, so the tangents
  may carry a batch dimension while the primal stays unbatched);
* ``backward`` is the twin's vector-Jacobian product (``torch.func.vjp``),
  so reverse mode works too;
* ``vmap`` runs the kernel once where no primal is batched (the case of
  ``jacfwd``), and once per slice otherwise.

The outer transform is ``torch.func`` (``jacfwd``, ``jvp``, ``vmap``,
``grad``) or plain autograd. ``torch.autograd.forward_ad`` cannot be the
outer one: its dual level does not nest with the ``torch.func.jvp`` of the
rule.

:func:`kernel_path` decides which tensors go to a kernel (those off the
CPU); :func:`refuse_derivatives` keeps a tensor that carries a derivative
from reaching a kernel's raw pointer, where the derivative would be lost.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["with_twin", "kernel_path", "refuse_derivatives"]


def kernel_path(x: torch.Tensor) -> bool:
    """True where ``x`` goes to a kernel: any tensor off the CPU (a kernel
    wrapper raises for a device it has no kernel for)."""
    return x.device.type != "cpu"


def refuse_derivatives(name: str, x: torch.Tensor) -> None:
    """Raise if ``x`` carries a derivative that a kernel launch would drop:
    it requires grad while grad mode is on, it is a forward-mode dual, or a
    ``torch.func`` transform wraps it. Inside :func:`with_twin`'s forward
    none of these hold."""
    if x.requires_grad and torch.is_grad_enabled():
        why = "requires grad"
    elif torch._C._functorch.is_functorch_wrapped_tensor(x):
        why = "is transformed by torch.func"
    elif torch.autograd.forward_ad.unpack_dual(x).tangent is not None:
        why = "is a forward-mode dual"
    else:
        return
    raise RuntimeError(f"{name} {why}: a kernel launch carries no derivative; call the "
                       "kernel through its differentiable wrapper")


def _restrict(plain: Callable, args, keep):
    """The twin as a function of the arguments ``keep`` only, the others
    fixed at ``args``."""
    def fn(*sub):
        full = list(args)
        for i, v in zip(keep, sub):
            full[i] = v
        return plain(*full)
    return fn


class _KernelFunction(torch.autograd.Function):
    """``kernel(*args)`` with the derivatives of ``plain(*args)``."""

    @staticmethod
    def forward(kernel, plain, *args):
        return kernel(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.plain, *args = inputs
        ctx.save_for_forward(*args)
        ctx.save_for_backward(*args)

    @staticmethod
    def jvp(ctx, _kernel, _plain, *tangents):
        args = ctx.saved_tensors
        keep = [i for i, t in enumerate(tangents) if t is not None]
        fn = _restrict(ctx.plain, args, keep)
        return torch.func.jvp(fn, tuple(args[i] for i in keep),
                              tuple(tangents[i] for i in keep))[1]

    @staticmethod
    def backward(ctx, *grads):
        args = ctx.saved_tensors
        keep = [i for i, need in enumerate(ctx.needs_input_grad[2:]) if need]
        out = [None] * len(args)
        if keep:
            fn = _restrict(ctx.plain, args, keep)
            with torch.enable_grad():
                _, vjp = torch.func.vjp(fn, *(args[i] for i in keep))
            for i, g in zip(keep, vjp(grads[0] if len(grads) == 1 else grads)):
                out[i] = g
        return (None, None, *out)

    @staticmethod
    def vmap(info, in_dims, kernel, plain, *args):
        dims = in_dims[2:]
        if all(d is None for d in dims):
            out = _KernelFunction.apply(kernel, plain, *args)
            return out, (tuple(None for _ in out) if isinstance(out, tuple) else None)
        outs = [_KernelFunction.apply(kernel, plain, *(a if d is None else a.select(d, i)
                                                       for a, d in zip(args, dims)))
                for i in range(info.batch_size)]
        if isinstance(outs[0], tuple):
            return tuple(torch.stack(o) for o in zip(*outs)), tuple(0 for _ in outs[0])
        return torch.stack(outs), 0


def _carries_derivatives(args) -> bool:
    """True if any tensor of ``args`` carries a derivative (the cases of
    :func:`refuse_derivatives`)."""
    grad = torch.is_grad_enabled()
    dual = getattr(torch.autograd.forward_ad, "_current_level", 0) >= 0
    for x in args:
        if not isinstance(x, torch.Tensor):
            continue
        if (grad and x.requires_grad) or torch._C._functorch.is_functorch_wrapped_tensor(x) \
                or (dual and torch.autograd.forward_ad.unpack_dual(x).tangent is not None):
            return True
    return False


def with_twin(kernel: Callable, plain: Callable, *args):
    """``kernel(*args)``, differentiable as ``plain(*args)`` is.

    ``args`` are tensors or None; everything else the two functions need
    they close over. ``kernel`` and ``plain`` compute the same function
    (a tensor or a tuple of tensors); ``kernel`` is called once per call
    (per slice of a batched primal under ``vmap``), ``plain`` only for
    derivatives. Where no argument carries a derivative the kernel runs
    without the Function: its apply binds the arguments to a signature on
    every call, ~0.1 ms of host time.
    """
    if not _carries_derivatives(args):
        return kernel(*args)
    return _KernelFunction.apply(kernel, plain, *args)

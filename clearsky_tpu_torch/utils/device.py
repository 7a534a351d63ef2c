"""Where the port's constructors put their tensors unless told otherwise.

The default is float32 on the CUDA card: the only combination the kernels
take. Without a card, torch raises at the first tensor; nothing falls back
to the CPU. CPU callers (the tests, float64 references) pass
``dtype=torch.float64, device="cpu"`` or float32 explicitly.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["placement", "as_tensor"]


def placement(dtype=None, device=None) -> tuple[torch.dtype, torch.device]:
    """``(dtype, device)`` with ``None`` read as float32 and ``cuda``."""
    return (torch.float32 if dtype is None else dtype,
            torch.device("cuda") if device is None else torch.device(device))


def as_tensor(x) -> torch.Tensor:
    """A tensor as it is; numbers and arrays as a float64 tensor on the CPU
    (set-up work, as the JAX package's host-side numpy)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x, dtype=np.float64))

"""Block-banded line sum: line profiles accumulated onto a wavenumber grid.

Counterpart of ``clearsky_tpu.ops.linesum``. Lines are sorted by wavenumber,
so the lines within ``cut`` of a contiguous block of the grid form a
contiguous index window; :func:`build_line_window_plan` finds the windows once
on the host (numpy, float64), and the line sum then runs dense over
[block x window] tiles.

:func:`sigma_from_lines` is the plain PyTorch version: the CPU path and the
oracle of the CUDA kernel. :func:`sigma_from_lines_auto` dispatches to the
kernel wrapper in :mod:`.linesum_cuda`, which runs the kernel for CUDA
tensors and this plain version for CPU tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .lineshape import (
    scale_intensity,
    cheb_qref_q,
    alpha_doppler,
    gamma_lorentz,
    fdoppler,
    florentz,
    fvoigt,
)

__all__ = [
    "LineWindowPlan",
    "build_line_window_plan",
    "sigma_from_lines",
    "sigma_from_lines_auto",
    "PROFILES",
    "DEFAULT_CUT",
]

# unified profile signature f(dnu, S, alpha, gamma) -> cross-section; the
# phco2 and *_ref shapes of the JAX package are not ported yet
PROFILES = {
    "voigt": lambda dnu, S, a, g: S * fvoigt(dnu, a, g),
    "lorentz": lambda dnu, S, a, g: S * florentz(dnu, g),
    "doppler": lambda dnu, S, a, g: S * fdoppler(dnu, a),
}

DEFAULT_CUT = {"voigt": 25.0, "lorentz": 25.0, "doppler": 25.0}


@dataclasses.dataclass(frozen=True, eq=False)
class LineWindowPlan:
    """Static banding plan mapping wavenumber blocks to line-index windows."""

    nu: np.ndarray          # [n_nu] sorted wavenumber grid (float64)
    cut: float              # profile truncation distance [cm^-1]
    block: int              # wavenumber block size
    n_blocks: int
    nu_blocks: np.ndarray   # [n_blocks, block] padded grid (float64)
    start: np.ndarray       # [n_blocks] first line index per block
    count: np.ndarray       # [n_blocks] number of in-window lines per block
    slab: int               # padded window length (max over blocks)
    _on_device: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n_nu(self) -> int:
        return len(self.nu)

    def device_arrays(self, device) -> dict:
        """The plan's per-block arrays as tensors on ``device``, cached.

        ``nu_hi``/``nu_lo`` are the float32 two-float split of the float64
        block grid (nu_hi + nu_lo reproduces it to ~1e-11 relative), flat
        [n_blocks * block]; ``start``/``count`` are int32 [n_blocks].
        """
        device = torch.device(device)
        got = self._on_device.get(device)
        if got is None:
            nb64 = np.asarray(self.nu_blocks, np.float64).reshape(-1)
            hi = nb64.astype(np.float32)
            lo = (nb64 - hi.astype(np.float64)).astype(np.float32)
            got = {
                "nu_hi": torch.as_tensor(hi, device=device),
                "nu_lo": torch.as_tensor(lo, device=device),
                "start": torch.as_tensor(self.start, dtype=torch.int32, device=device),
                "count": torch.as_tensor(self.count, dtype=torch.int32, device=device),
            }
            self._on_device[device] = got
        return got


def build_line_window_plan(
    nu_grid: np.ndarray,
    nu_lines: np.ndarray,
    cut: float,
    block: int = 128,
) -> LineWindowPlan:
    """Construct the static block -> line-window banding (host-side, set-up time)."""
    nu_grid = np.asarray(nu_grid, dtype=np.float64)
    nu_lines = np.asarray(nu_lines, dtype=np.float64)
    if np.any(np.diff(nu_grid) <= 0):
        raise ValueError("wavenumber grid must be strictly ascending")
    if len(nu_lines) > 1 and np.any(np.diff(nu_lines) < 0):
        raise ValueError("line wavenumbers must be sorted ascending")
    n = len(nu_grid)
    block = int(min(block, max(8, n)))
    n_blocks = -(-n // block)
    npad = n_blocks * block
    # pad with the last grid value; padded outputs are sliced away
    pad = np.full(npad - n, nu_grid[-1])
    nu_blocks = np.concatenate([nu_grid, pad]).reshape(n_blocks, block)
    lo = np.searchsorted(nu_lines, nu_blocks[:, 0] - cut, side="left")
    hi = np.searchsorted(nu_lines, nu_blocks[:, -1] + cut, side="right")
    count = (hi - lo).astype(np.int32)
    slab = int(max(1, count.max() if len(count) else 1))
    slab = -(-slab // 128) * 128 if slab > 128 else slab
    return LineWindowPlan(
        nu=nu_grid,
        cut=float(cut),
        block=block,
        n_blocks=n_blocks,
        nu_blocks=nu_blocks,
        start=lo.astype(np.int32),
        count=count,
        slab=slab,
    )


def _line_params(lines, T, P, Pp):
    """Per-line (S, alpha, gamma), each [..., n_lines], at states T, P, Pp [...]."""
    T = T[..., None]
    P = P[..., None]
    Pp = Pp[..., None]
    qq = cheb_qref_q(T, lines.tips_coeffs[lines.iso_ptr])
    S = scale_intensity(lines.S, lines.nu, lines.Epp, qq, T)
    alpha = alpha_doppler(lines.nu, lines.mu, T)
    gamma = gamma_lorentz(lines.ga, lines.gs, lines.na, T, P, Pp)
    return S, alpha, gamma


def sigma_from_lines(plan: LineWindowPlan, lines, T, P, Pp, shape: str = "voigt"):
    """Cross-sections sigma[..., n_nu] [cm^2/molecule]: the plain version.

    ``T``, ``P``, ``Pp`` (temperature [K], pressure and partial pressure
    [Pa]) are tensors of one batch shape [...], in the catalog's dtype and on
    its device. In float32 the line positions are differenced in two-float
    form (hi + lo) so that dnu keeps ~1e-7 cm^-1; in float64 one subtraction
    suffices. Blocks are evaluated in batches that keep each temporary near
    2^24 elements on a GPU and 2^20 on the CPU, where larger temporaries fall
    out of cache.
    """
    profile = PROFILES[shape]
    S, alpha, gamma = _line_params(lines, T, P, Pp)
    dev, dt = S.device, S.dtype
    two_float = dt == torch.float32
    if two_float:
        arrs = plan.device_arrays(dev)
        nu_blocks = arrs["nu_hi"].view(plan.n_blocks, plan.block)
        nu_blocks_lo = arrs["nu_lo"].view(plan.n_blocks, plan.block)
        nu_l_lo = lines.nu_lo
    else:
        nu_blocks = torch.as_tensor(plan.nu_blocks, dtype=dt, device=dev)
    nu_l = lines.nu
    n_lines = nu_l.shape[0]
    starts = torch.as_tensor(plan.start, dtype=torch.int64, device=dev)
    counts = torch.as_tensor(plan.count, dtype=torch.int64, device=dev)
    offs = torch.arange(plan.slab, device=dev)
    batch = S.shape[:-1]
    per_block = max(1, int(np.prod(batch))) * plan.block * plan.slab
    batch_blocks = max(1, (2**24 if dev.type == "cuda" else 2**20) // per_block)

    out = []
    for a in range(0, plan.n_blocks, batch_blocks):
        b = min(a + batch_blocks, plan.n_blocks)
        idx = torch.clamp(starts[a:b, None] + offs, 0, max(n_lines - 1, 0))  # [nb, slab]
        valid = offs < counts[a:b, None]
        dnu = nu_blocks[a:b, :, None] - nu_l[idx][:, None, :]                 # [nb, B, slab]
        if two_float:
            # the hi difference is exact for nearby values (Sterbenz); the
            # residuals restore the sub-f32 position information
            dnu = dnu + (nu_blocks_lo[a:b, :, None] - nu_l_lo[idx][:, None, :])
        mask = valid[:, None, :] & (torch.abs(dnu) <= plan.cut)
        f = profile(dnu, S[..., idx][..., None, :], alpha[..., idx][..., None, :],
                    gamma[..., idx][..., None, :])                            # [..., nb, B, slab]
        out.append(torch.where(mask, f, torch.zeros((), dtype=dt, device=dev)).sum(-1))
    sig = torch.cat(out, dim=-2)                                              # [..., n_blocks, B]
    return sig.reshape(batch + (plan.n_blocks * plan.block,))[..., : plan.n_nu]


def sigma_from_lines_auto(plan: LineWindowPlan, lines, T, P, Pp, shape: str = "voigt"):
    """Line sum through the kernel wrapper (K1 on CUDA, the plain version on CPU).

    Accepts any common batch shape of (T, P, Pp); the wrapper takes a flat
    state batch, so leading dimensions are flattened and restored around it.
    """
    from .linesum_cuda import sigma_lines

    shp = torch.broadcast_shapes(T.shape, P.shape, Pp.shape)
    flat = [torch.broadcast_to(x, shp).reshape(-1).contiguous() for x in (T, P, Pp)]
    sig = sigma_lines(plan, lines, *flat, shape=shape)
    return sig.reshape(shp + (plan.n_nu,))

"""Merging line catalogs across molecules for one line-sum pass.

Counterpart of ``clearsky_tpu.spectra.merge``. The line sum is banded in
wavenumber, so the union of several molecules' sorted catalogs runs as one
pass over shared windows. A fixed molar concentration folds into each line
(intensity and self-broadening, see ``ops.linesum._line_params``); a
concentration fC(T, P) is gathered per line through ``mol_ptr``.
"""

from __future__ import annotations

import numpy as np
import torch

from .lines import SpectralLines

__all__ = ["merge_catalogs", "merge_lines"]

_PER_LINE = ("S", "ga", "gs", "Epp", "na", "mu", "A", "iso")


def merge_catalogs(lines_list) -> tuple[SpectralLines, torch.Tensor]:
    """Merge several molecules' catalogs into one, sorted by wavenumber.

    Returns ``(merged, mol_ptr)``: every per-line field concatenated and
    sorted (stable) by the float64 position, the TIPS tables zero-padded to a
    common order and stacked with ``iso_ptr`` offset to match, and
    ``mol_ptr`` [n_lines] (int64) the index of the catalog each line came
    from. The float32 position residuals ``nu_lo`` are carried, so a float32
    catalog keeps its two-float positions. The merge is in the dtype and on
    the device of the first catalog.
    """
    if len(lines_list) == 0:
        raise ValueError("nothing to merge")
    host = lambda x: x.detach().cpu().numpy()
    tips = [host(l.tips_coeffs).astype(np.float64) for l in lines_list]
    ncheb = max(t.shape[1] for t in tips)
    tips = [np.pad(t, ((0, 0), (0, ncheb - t.shape[1]))) for t in tips]
    offsets = np.cumsum([0] + [t.shape[0] for t in tips[:-1]])
    cat = lambda f: np.concatenate([f(l) for l in lines_list])
    nu = cat(lambda l: l.positions64())
    order = np.argsort(nu, kind="stable")
    fields = {f: cat(lambda l: host(getattr(l, f)))[order] for f in _PER_LINE}
    fields.update(
        nu=nu[order],
        nu_lo=cat(lambda l: host(l.nu_lo))[order],
        iso_ptr=np.concatenate([host(l.iso_ptr) + o for l, o in zip(lines_list, offsets)])[order],
        tips_coeffs=np.concatenate(tips, axis=0))
    first = lines_list[0]
    merged = SpectralLines.from_arrays(
        fields, dtype=first.dtype, device=first.device,
        name="+".join(l.name for l in lines_list),
        formula="+".join(l.formula for l in lines_list), M=0)
    mol_ptr = np.concatenate([np.full(l.n_lines, m, dtype=np.int64)
                              for m, l in enumerate(lines_list)])[order]
    return merged, torch.as_tensor(mol_ptr, device=first.device)


def merge_lines(entries) -> tuple[SpectralLines, torch.Tensor]:
    """Merge ``[(SpectralLines, concentration), ...]`` with fixed scalar
    concentrations in [0, 1]: ``(merged, conc)``, ``conc`` [n_lines] in the
    merged catalog's dtype. For concentrations fC(T, P) use
    :func:`merge_catalogs` (``MultiGas`` does)."""
    concs = [float(c) for _, c in entries]
    for c in concs:
        if not (0.0 <= c <= 1.0):
            raise ValueError(f"gas molar concentration must be in [0,1], not {c}")
    merged, mol_ptr = merge_catalogs([l for l, _ in entries])
    conc = torch.tensor(concs, dtype=merged.dtype, device=merged.device)[mol_ptr]
    return merged, conc

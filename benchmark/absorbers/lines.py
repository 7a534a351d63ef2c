"""lines: the configuration's catalogs summed line by line on the cell's
grid, Voigt lines within the configuration's ``cut``: the program's
``DirectGas`` for one gas, its ``MultiGas`` for a mixture, float32 catalogs
on the card. The reference is the exact in-cut line sum of the same lines.

A configuration names it as ``"absorber": {"name": "lines"}``, with no
options: the program's default route ("auto") and its stated accuracy."""

import torch

from csbench.reference.linesum import line_sum


def validate(params):
    extra = set(params["absorber"]) - {"name"}
    if extra:
        raise ValueError(f"the absorber 'lines' has no reference for {sorted(extra)}")


def program(pars_concs, grid, device, params):
    """The program's absorber over ``grid`` from [(par, concentration)]."""
    import clearsky_tpu_torch as ct

    lines = [(ct.SpectralLines.from_par_dict(p, dtype=torch.float32, device=device), c)
             for p, c in pars_concs]
    if len(lines) == 1:
        return ct.DirectGas.from_lines(lines[0][0], lines[0][1], grid, cut=params["cut"])
    return ct.MultiGas.from_lines(lines, grid, cut=params["cut"])


def reference(tab, params):
    """The reference's cross-sections: ``sigma(points, T, P, dtype, device)``."""
    return line_sum(tab, params["cut"])

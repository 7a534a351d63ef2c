"""RadauEq: the grid-refined core (the program's ``RadauEq``): each layer
split ``refine`` times in sqrt P, the line sum at ``nlobatto`` Lobatto nodes
a refined layer, the stream march over the refined layers.

The reference evaluates the same refined states with the absorber's
reference cross-sections and marches them in float64."""

import torch

from csbench.reference import flux as ref_flux

FIELDS = {"refine", "nlobatto", "nstream"}
DEFAULTS = {"refine": 8, "nlobatto": 3}


def validate(params):
    extra = set(params["core"]) - FIELDS - {"name"}
    if extra:
        raise ValueError(f"the core 'RadauEq' has no reference for {sorted(extra)}")


def _field(params, key):
    return params["core"].get(key, DEFAULTS[key])


def linesum_states(params) -> int:
    """The (T, P) states the line sum evaluates a call: the refined layers'
    Lobatto nodes."""
    return (params["atmosphere"]["levels"] - 1) * _field(params, "refine") \
        * _field(params, "nlobatto")


def reference(params, sigma, Pe, Te, grid, idx, S0, dev, dtype, count_work=False):
    """(M_up, M_down) [C, levels, K] of the columns Te [C, levels] at the
    grid points ``idx``, and no work counts of its own."""
    atm, spec = params["atmosphere"], params["core"]
    pts = grid[idx]
    S = torch.full((len(pts),), S0, dtype=dtype, device=dev)
    up, dn = ref_flux.refined_fluxes(sigma, Pe, Te, pts, g=atm["g"], mu=atm["mu"], S_nu=S,
                                     albedo=atm["albedo"], theta_s=params["star"]["zenith"],
                                     nstream=spec.get("nstream", params.get("nstream", 5)),
                                     nlobatto=_field(params, "nlobatto"),
                                     refine=_field(params, "refine"), dtype=dtype, device=dev)
    return up, dn, {}

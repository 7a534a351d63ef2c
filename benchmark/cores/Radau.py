"""Radau: the adaptive core (the program's ``Radau``), an error-controlled
Radau IIA(5) integration of each wavenumber's streams and beam depth through
a column cache of ln sigma on ``nlevels`` levels.

The reference builds the same cache from the absorber's reference cross-
sections in float64 and integrates the same problem on graded fixed Radau
IIA(5) sub-steps (``check.n_sub`` a cache interval), far finer than the
tolerance; in a traced run it also counts the accepted steps an error-
controlled integration at the core's ``tol`` takes on the sampled lanes,
the work ``radau.roofline_pct`` reads."""

import torch

from csbench.reference import flux as ref_flux

FIELDS = {"tol", "nlevels", "nstream"}
DEFAULT_LEVELS = 256


def validate(params):
    extra = set(params["core"]) - FIELDS - {"name"}
    if extra:
        raise ValueError(f"the core 'Radau' has no reference for {sorted(extra)}")
    if "n_sub" not in params["check"]:
        raise ValueError("the core 'Radau' needs check.n_sub, the reference's sub-steps")


def linesum_states(params) -> int:
    """The (T, P) states the line sum evaluates a call: the cache's levels."""
    return params["core"].get("nlevels", 0) or DEFAULT_LEVELS


def reference(params, sigma, Pe, Te, grid, idx, S0, dev, dtype, count_work=False):
    """(M_up, M_down) [C, levels, K] of the columns Te [C, levels] at the
    grid points ``idx``, and the work a call (a traced run's, else {})."""
    atm, spec = params["atmosphere"], params["core"]
    pts = grid[idx]
    S = torch.full((len(pts),), S0, dtype=dtype, device=dev)
    nstream = spec.get("nstream", params.get("nstream", 5))
    cache = ref_flux.radau_cache(sigma, Pe, Te, pts, mu=atm["mu"], nlevels=linesum_states(params),
                                 dtype=dtype, device=dev)
    up, dn, lanes = ref_flux.radau_fluxes(cache, Pe, g=atm["g"], S_nu=S, albedo=atm["albedo"],
                                          theta_s=params["star"]["zenith"], nstream=nstream,
                                          n_sub=params["check"]["n_sub"])
    work = {}
    if count_work:
        # each column's largest Planck intensity over its levels and the grid
        nu = torch.as_tensor(grid, dtype=torch.float64, device=dev)
        T_lev = lanes["B_lev"].new_tensor(Te)
        B_peak = torch.stack([ref_flux.planck(nu, T_lev[c].max()).max()
                              for c in range(T_lev.shape[0])])
        steps = ref_flux.radau_steps(cache, Pe, lanes, g=atm["g"], nstream=nstream,
                                     tol=spec.get("tol", 1e-5), B_peak=B_peak)
        scale = len(grid) / len(pts) / Te.shape[0]
        work["radau_steps_per_call"] = {k: v * scale for k, v in steps.items()}
        work["radau_lanes_per_call"] = {"emission": 2 * nstream * len(grid), "depth": len(grid)}
    return up, dn, work

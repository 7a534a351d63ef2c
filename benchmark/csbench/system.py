"""The system under test: the calls the traffic kinds make into the program
(``clearsky_tpu_torch``), and nothing else of it; the program's absorbers are
built by the absorbers' own files (``absorbers/<name>.py``). Every input
arrives as plain numbers and numpy arrays made by the benchmark."""

from __future__ import annotations

__all__ = ["core", "radiate", "rcm", "sweep_period"]


def core(spec: dict):
    """The flux core a cell names: {"name": "Radau" | "RadauEq" |
    "Discretized", its fields...}."""
    import clearsky_tpu_torch as ct

    fields = {k: v for k, v in spec.items() if k != "name"}
    return getattr(ct, spec["name"])(**fields)


def radiate(P, g, T, mu, fS, albedo, absorber, flux_core):
    """One column's flux pack (the entry point a user calls)."""
    import clearsky_tpu_torch as ct

    return ct.radiate(P, g, T, mu, fS, albedo, absorber, core=flux_core)


def rcm(Pe, Te, g, mu, fS, albedo, cp, cs, absorber, radmul):
    """The radiative-convective model of one template column."""
    import clearsky_tpu_torch as ct

    return ct.RCM.create(Pe, Te, g, lambda T, P: mu, fS, albedo, lambda T, P: cp, cs, absorber,
                         radmul=radmul)


def sweep_period(model, factors, dt, period, T, A, cp, mu):
    """One refresh period of a batched sweep: ``period`` Euler steps with the
    convective adjustment after each and the cache refreshed after the last.
    Returns (T, A)."""
    import clearsky_tpu_torch as ct

    return ct.run_sweep(model, factors, dt, period, T0_b=T, A0_b=A, update_every=period,
                        adjust_every=1, cp=cp, mu=mu)

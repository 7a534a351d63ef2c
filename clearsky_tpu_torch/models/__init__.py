"""Time-stepping column models: the radiative-convective column and its batched sweeps."""

from .sweep import batched_heating, run_sweep, shard_sweep
from .rcm import (
    RCM,
    heating,
    radiate_state,
    step,
    step_n,
    run,
    jacobian,
    update_absorber,
    convective_adjustment,
    radiative_grid,
)

__all__ = [
    "RCM",
    "heating",
    "radiate_state",
    "step",
    "step_n",
    "run",
    "jacobian",
    "update_absorber",
    "convective_adjustment",
    "radiative_grid",
    "batched_heating",
    "run_sweep",
    "shard_sweep",
]

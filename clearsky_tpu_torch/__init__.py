"""clearsky_tpu_torch: the PyTorch and CUDA port of ``clearsky_tpu``.

Clear-sky line-by-line radiative transfer on an NVIDIA GPU: a line catalog is
summed into cross-sections (hand-written CUDA kernel K1), directly or baked
once into a Chebyshev ln sigma table (``Gas``), the column's layer optical
depths come from Gauss-Lobatto quadrature, and the hemispheric-stream
Schwarzschild march (kernels K2 and K3) gives the OLR spectrum, the up/down
fluxes and the heating of a radiative-convective column model. A column of
one split-precision table gas runs coefficients to fluxes in one fused
kernel (K6 for the OLR, K7 for whole-column fluxes). HITRAN ``.par`` line
lists and ``.cia`` continua are read on the host; a gas mixture sums its
merged catalog in one line sum (``MultiGas``), through catalog segments
(K1-seg) where the catalog outgrows the card's L2 cache. Every line-sum
route takes the Voigt family of shapes, voigt and the sub-Lorentzian CO2
far wing phco2 (with their *_ref conventions); the column model runs to
radiative-convective equilibrium (``run``: Euler steps, absorber refresh,
dry convective adjustment) from the adiabats of ``atmosphere``. Every
kernel carries the derivatives of its plain twin (``utils/twin.py``), so
``torch.func`` differentiates through the card's path: ``jacobian`` gives
the RCM's dH/dT by forward mode or by finite differences. ``parallel``
shards the wavenumber grid over processes (``torch.distributed``): each
line-by-line gas becomes per-shard line slabs (``ShardedLineGas``, summed
by K1-dev, every shard of a rank in one launch), each rank radiates its
slab, and one all-reduce adds the spectral integrals.

The module paths mirror ``clearsky_tpu``'s. Everything computes in the dtype
and on the device of its inputs; CUDA tensors go through the kernels of
``csrc/`` (float32), CPU tensors through their plain PyTorch versions.
"""

from .constants import SIGMA_SB
from .utils.grids import chebygrid, meshgrid, deriv
from .utils.rootfind import regula_falsi, secant
from .ops.lineshape import fvoigt, fvoigt_ref, chi_phco2
from .spectra.lines import SpectralLines
from .spectra.par import read_par
from .spectra.synthetic import synthetic_co2_par
from .absorption.domain import AtmosphericDomain
from .absorption.gas import Gas, DirectGas, GrayGas, MultiGas, WellMixedGas, VariableGas
from .absorption.cia import read_cia, CIATables, CIA, cia_xsec
from .absorption.absorbers import AbsorberStack, AcceleratedAbsorber
from .rt.discretized import FluxPack
from .rt.fluxes import (
    Discretized,
    outgoing,
    monochromatic_fluxes,
    radiate,
    fluxes,
    net_fluxes,
)
from .atmosphere.hydrostatics import scale_height, hydrostatic, altitude, Hydrostatic
from .atmosphere.adiabats import (
    lapse_rate_dry,
    lapse_rate_moist,
    lapse,
    DryAdiabat,
    MoistAdiabat,
    tropopause,
    pressure_of_temperature,
)
from .atmosphere.saturation import (
    psat_h2o,
    tsat_co2,
    ozonelayer,
    condensible_profile,
    haircut,
    rayleigh_co2,
)
from .models.rcm import (
    RCM,
    heating,
    radiate_state,
    step,
    step_n,
    run,
    jacobian,
    update_absorber,
    convective_adjustment,
)
from .utils.grids import trapz, pressuregrid, logrange
from .absorption.sharded import ShardedLineGas, shard_line_gas
from . import parallel

__all__ = [
    "SIGMA_SB",
    "chebygrid",
    "meshgrid",
    "deriv",
    "regula_falsi",
    "secant",
    "fvoigt",
    "fvoigt_ref",
    "chi_phco2",
    "SpectralLines",
    "read_par",
    "synthetic_co2_par",
    "AtmosphericDomain",
    "Gas",
    "DirectGas",
    "GrayGas",
    "MultiGas",
    "ShardedLineGas",
    "shard_line_gas",
    "WellMixedGas",
    "VariableGas",
    "read_cia",
    "CIATables",
    "CIA",
    "cia_xsec",
    "AbsorberStack",
    "AcceleratedAbsorber",
    "FluxPack",
    "Discretized",
    "outgoing",
    "monochromatic_fluxes",
    "radiate",
    "fluxes",
    "net_fluxes",
    "scale_height",
    "hydrostatic",
    "altitude",
    "Hydrostatic",
    "lapse_rate_dry",
    "lapse_rate_moist",
    "lapse",
    "DryAdiabat",
    "MoistAdiabat",
    "tropopause",
    "pressure_of_temperature",
    "psat_h2o",
    "tsat_co2",
    "ozonelayer",
    "condensible_profile",
    "haircut",
    "rayleigh_co2",
    "RCM",
    "heating",
    "radiate_state",
    "step",
    "step_n",
    "run",
    "jacobian",
    "update_absorber",
    "convective_adjustment",
    "trapz",
    "pressuregrid",
    "logrange",
]

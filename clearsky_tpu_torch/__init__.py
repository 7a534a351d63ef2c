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
(K1-seg) where the catalog outgrows the card's L2 cache.

The module paths mirror ``clearsky_tpu``'s. Everything computes in the dtype
and on the device of its inputs; CUDA tensors go through the kernels of
``csrc/`` (float32), CPU tensors through their plain PyTorch versions.
"""

from .constants import SIGMA_SB
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
from .models.rcm import RCM, heating, step, update_absorber
from .utils.grids import trapz, pressuregrid, logrange

__all__ = [
    "SIGMA_SB",
    "SpectralLines",
    "read_par",
    "synthetic_co2_par",
    "AtmosphericDomain",
    "Gas",
    "DirectGas",
    "GrayGas",
    "MultiGas",
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
    "RCM",
    "heating",
    "step",
    "update_absorber",
    "trapz",
    "pressuregrid",
    "logrange",
]

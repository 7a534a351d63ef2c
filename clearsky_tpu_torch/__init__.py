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
dry convective adjustment) from the adiabats of ``atmosphere``, and a
batch of columns (an insolation sweep: ``batched_heating``, ``run_sweep``,
``shard_sweep``) runs through one launch set a step. Every
kernel carries the derivatives of its plain twin (``utils/twin.py``), so
``torch.func`` differentiates through the card's path: ``jacobian`` gives
the RCM's dH/dT by forward mode or by finite differences. ``parallel``
shards the wavenumber grid over processes (``torch.distributed``): each
line-by-line gas becomes per-shard line slabs (``ShardedLineGas``, summed
by K1-dev, every shard of a rank in one launch), each rank radiates its
slab, and one all-reduce adds the spectral integrals. Around the column
path: slant optical depth and transmittance, the grid-refined core
``RadauEq`` (the same kernels on a grid refined in sqrt P), the adaptive
core ``Radau`` (an error-controlled Radau IIA(5) integration a stream and
wavenumber, one thread a lane in the kernel ``csrc/radau.cu``), the Planck
family, checkpoints of baked gases and model state (``utils.checkpoint``,
the JAX package's file format), the scipy validation oracle
(``rt.ode_ref``), orbital forcing (``orbital``), the line-sum cost model
and tracing (``utils.profiling``) and the native ``.par`` parser
(``native``).

The module paths mirror ``clearsky_tpu``'s. Everything computes in the dtype
and on the device of its inputs; CUDA tensors go through the kernels of
``csrc/`` (float32), CPU tensors through their plain PyTorch versions.
"""

from . import constants
from .constants import (
    C_LIGHT,
    H_PLANCK,
    K_BOLTZ,
    SIGMA_SB,
    R_GAS,
    P_ATM,
    N_AVOGADRO,
    DALTON,
    G_GRAV,
    LOSCHMIDT_SQ,
    T_REF_HITRAN,
    T_ICE,
    P_MIN,
)
from .utils.grids import chebygrid, meshgrid, deriv
from .utils.rootfind import regula_falsi, secant
from .ops.planck import (
    nu2f,
    f2nu,
    nu2lam,
    lam2nu,
    lam2f,
    f2lam,
    planck,
    normplanck,
    dplanck,
    stefanboltzmann,
    equilibrium_temperature,
    dtau_dP,
)
from .ops.faddeeva import wofz_re
from .ops.lineshape import (
    scale_intensity,
    alpha_doppler,
    gamma_lorentz,
    fdoppler,
    florentz,
    fvoigt,
    fvoigt_ref,
    chi_phco2,
)
from .ops.linesum import build_line_window_plan, sigma_from_lines
from .spectra.lines import SpectralLines
from .spectra.par import read_par
from .spectra.molparam import molparam
from .spectra.synthetic import synthetic_co2_par
from .absorption.domain import AtmosphericDomain
from .absorption.gas import (
    Gas,
    DirectGas,
    GrayGas,
    SemiGrayGas,
    MultiGas,
    WellMixedGas,
    VariableGas,
    opacity_error,
)
from .absorption.cia import read_cia, CIATables, CIA, cia_xsec
from .absorption.absorbers import AbsorberStack, AcceleratedAbsorber, unify_absorbers
from .atmosphere.profile import AtmosphericProfile
from .rt.discretized import FluxPack, march_kernel_mode
from .rt.fused_table import table_olr_fused, table_monoflux_fused, fused_table_applicable
from .rt.fluxes import (
    Discretized,
    Radau,
    RadauEq,
    optical_depth,
    transmittance,
    outgoing,
    monochromatic_fluxes,
    radiate,
    fluxes,
    net_fluxes,
    top_fluxes,
    top_imbalance,
    bottom_fluxes,
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
from .models.sweep import batched_heating, run_sweep, shard_sweep
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
from .orbital import (
    periapsis,
    apoapsis,
    semimajoraxis,
    eccentricity,
    meananomaly,
    trueanomaly,
    eccentricanomaly,
    orbitalperiod,
    orbitaldistance,
    orbit,
    substellarlatitude,
    hourangle,
    diurnalfluxfactor,
    diurnalfluxfactors,
    annualfluxfactor,
    annualfluxfactors,
)
from . import orbital, parallel

__all__ = [
    "C_LIGHT",
    "H_PLANCK",
    "K_BOLTZ",
    "SIGMA_SB",
    "R_GAS",
    "P_ATM",
    "N_AVOGADRO",
    "DALTON",
    "G_GRAV",
    "LOSCHMIDT_SQ",
    "T_REF_HITRAN",
    "T_ICE",
    "P_MIN",
    "nu2f",
    "f2nu",
    "nu2lam",
    "lam2nu",
    "lam2f",
    "f2lam",
    "planck",
    "normplanck",
    "dplanck",
    "stefanboltzmann",
    "equilibrium_temperature",
    "dtau_dP",
    "scale_intensity",
    "alpha_doppler",
    "gamma_lorentz",
    "fdoppler",
    "florentz",
    "fvoigt",
    "fvoigt_ref",
    "chi_phco2",
    "Gas",
    "DirectGas",
    "GrayGas",
    "SemiGrayGas",
    "MultiGas",
    "WellMixedGas",
    "VariableGas",
    "opacity_error",
    "Discretized",
    "Radau",
    "RadauEq",
    "optical_depth",
    "transmittance",
    "outgoing",
    "monochromatic_fluxes",
    "radiate",
    "fluxes",
    "net_fluxes",
    "top_fluxes",
    "top_imbalance",
    "bottom_fluxes",
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
    "batched_heating",
    "run_sweep",
    "shard_sweep",
    "update_absorber",
    "convective_adjustment",
    "periapsis",
    "apoapsis",
    "semimajoraxis",
    "eccentricity",
    "meananomaly",
    "trueanomaly",
    "eccentricanomaly",
    "orbitalperiod",
    "orbitaldistance",
    "orbit",
    "substellarlatitude",
    "hourangle",
    "diurnalfluxfactor",
    "diurnalfluxfactors",
    "annualfluxfactor",
    "annualfluxfactors",
    "chebygrid",
    "meshgrid",
    "deriv",
    "regula_falsi",
    "secant",
    "wofz_re",
    "build_line_window_plan",
    "sigma_from_lines",
    "SpectralLines",
    "read_par",
    "molparam",
    "synthetic_co2_par",
    "AtmosphericDomain",
    "read_cia",
    "CIATables",
    "CIA",
    "cia_xsec",
    "AbsorberStack",
    "AcceleratedAbsorber",
    "unify_absorbers",
    "AtmosphericProfile",
    "FluxPack",
    "march_kernel_mode",
    "table_olr_fused",
    "table_monoflux_fused",
    "fused_table_applicable",
    "scale_height",
    "hydrostatic",
    "altitude",
    "Hydrostatic",
    "trapz",
    "pressuregrid",
    "logrange",
    "ShardedLineGas",
    "shard_line_gas",
]

"""Physical constants (same CODATA values as ``clearsky_tpu.constants``)."""

# speed of light [m/s]
C_LIGHT = 299792458.0
# Planck constant [J*s]
H_PLANCK = 6.62607015e-34
# Boltzmann constant [J/K]
K_BOLTZ = 1.38064852e-23
# Stefan-Boltzmann constant [W/m^2/K^4]
SIGMA_SB = 5.67037442e-8
# universal gas constant [J/K/mole]
R_GAS = 8.31446262
# Pascals in 1 atm
P_ATM = 101325.0
# Avogadro's number [molecules/mole]
N_AVOGADRO = 6.02214076e23
# Dalton [kg]
DALTON = 1.66053907e-27
# gravitational constant [m^3/kg/s^2]
G_GRAV = 6.6743e-11
# Loschmidt number squared [molecules^2/cm^6]
LOSCHMIDT_SQ = 7.21879268e38
# Loschmidt number [molecules/cm^3 at 1 amagat]; LOSCHMIDT_SQ exceeds the
# float32 maximum, so float32 code multiplies by this one twice
LOSCHMIDT = 2.686781e19

# HITRAN reference temperature [K]
T_REF_HITRAN = 296.0
# 0 degrees Celsius [K]
T_ICE = 273.15
# minimum pressure for temperature/pressure profiles [Pa]
P_MIN = 1e-9

# second radiation constant c2 = 100*h*c/k [cm K]
C2_RADIATION = 100.0 * H_PLANCK * C_LIGHT / K_BOLTZ

# TIPS partition-function fit temperature validity range [K]
TIPS_TMIN = 25.0
TIPS_TMAX = 1000.0

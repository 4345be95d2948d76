"""Physical constants (SI units).

Values match the reference implementation exactly (reference:
``src/constants.rs:4-28``) so that physics output is bit-comparable at
the level of rate coefficients and field-energy ledgers.
"""

# Speed of light in vacuum, m/s
SPEED_OF_LIGHT: float = 2.997925e8
# Speed of light squared, m^2/s^2
SPEED_OF_LIGHT_SQD: float = 89875517873681764.0
# epsilon_0, F/m
VACUUM_PERMITTIVITY: float = 8.854188e-12
# mu_0, H/m
VACUUM_PERMEABILITY: float = 1.256637e-6
# Electron charge (negative), C
ELECTRON_CHARGE: float = -1.602177e-19
# |e|, C
ELEMENTARY_CHARGE: float = -ELECTRON_CHARGE
# Electron mass, kg
ELECTRON_MASS: float = 9.109383e-31
# Proton mass, kg
PROTON_MASS: float = 1.672622e-27
# Electron rest mass in MeV
ELECTRON_MASS_MEV: float = 0.510999
# Sauter-Schwinger (critical) field, V/m
CRITICAL_FIELD: float = 1.323285e18
# Fine-structure constant
ALPHA_FINE: float = 7.29735257e-3
# hbar / (m c^2), s
COMPTON_TIME: float = 1.28808867e-21
# Classical electron radius, m
CLASSICAL_ELECTRON_RADIUS: float = 2.817940e-15

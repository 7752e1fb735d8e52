"""Gas thermophysical properties (the part of ``heatx.physics.gas`` that the
TR-BDF2 day march uses).

Every gas is a flat tuple of linear-polynomial coefficients (gas.rs:27-42), so
the property functions are plain arithmetic that works on Python floats, numpy
arrays and torch tensors alike.  The ISO 15099 cavity convection correlations
(``rayleigh``, ``nusselt``, ``cavity_convection``) are not ported yet: gas
cavities in the day kernel are ROADMAP item B5.

All temperature arguments are in Kelvin.
"""

from __future__ import annotations

from typing import NamedTuple

# Universal gas constant used by ISO 15099 Eq. 55 (gas.rs:176).
_R: float = 8314.46261815324


class GasProps(NamedTuple):
    """Linear-polynomial description of a gas (gas.rs:27-42).

    Each property is ``p0 + p1 * T[K]``.
    """

    k0: float  # thermal conductivity intercept, W/m.K
    k1: float  # thermal conductivity slope
    mu0: float  # dynamic viscosity intercept, N.s/m^2
    mu1: float  # dynamic viscosity slope
    cp0: float  # specific heat intercept, J/kg.K
    cp1: float  # specific heat slope
    molar_mass: float  # kg/kMol


# Gas constants (gas.rs:45-74).
AIR = GasProps(2.873e-3, 7.760e-5, 3.723e-6, 4.94e-8, 1002.7370, 1.2324e-2, 28.97)
ARGON = GasProps(2.285e-3, 5.149e-5, 3.379e-6, 6.451e-8, 521.9285, 0.0, 39.948)
KRYPTON = GasProps(9.443e-4, 2.826e-5, 2.213e-6, 7.777e-8, 248.0907, 0.0, 83.8)
XENON = GasProps(4.538e-4, 1.723e-5, 1.069e-6, 7.414e-8, 158.3397, 0.0, 131.30)

GASES = {"air": AIR, "argon": ARGON, "krypton": KRYPTON, "xenon": XENON}


def heat_capacity(gas: GasProps, temp_k):
    """cp(T), J/kg.K (gas.rs:165-167)."""
    return gas.cp0 + gas.cp1 * temp_k


def density(gas: GasProps, temp_k):
    """Ideal-gas density at 101325 Pa (ISO 15099 Eq. 55; gas.rs:175-179)."""
    return 101325.0 * gas.molar_mass / (_R * temp_k)

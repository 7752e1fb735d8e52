"""Gas thermophysical properties and ISO 15099 cavity convection (PyTorch
twin of ``heatx.physics.gas``).

Every gas is a flat tuple of linear-polynomial coefficients (gas.rs:27-42), so
the property functions are plain arithmetic that works on Python floats, numpy
arrays and torch tensors alike.  The Rayleigh number, the piecewise Nusselt
correlation and the cavity convection coefficient take torch tensors.

heatx evaluates every branch of the Nusselt correlation and selects with
``jnp.where``; its gradient multiplies the unselected branches by zero, so an
unselected branch that overflows (``(ra/3160)**20.6`` in float32 above Ra ~
2.3e5, ``1708/safe**2`` at a tilt beyond 90 deg) makes the gradient NaN.  Here
each correlation reads its own lanes' Ra (and tilt), and on the other lanes
a point inside its own range, so its value and gradient there are finite and
selected away; the 60 deg correlation's overflowing term is the 0 it rounds
to.  The values on the selected lanes are heatx's, the gradient stays
finite, and no branch choice waits on the device.

Temperatures are in Kelvin unless noted.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from heatx_torch.constants import KELVIN, PI

# Universal gas constant used by ISO 15099 Eq. 55 (gas.rs:176).
_R: float = 8314.46261815324
_G: float = 9.81


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


def thermal_conductivity(gas: GasProps, temp_k):
    """lambda(T), W/m.K (gas.rs:155-157)."""
    return gas.k0 + gas.k1 * temp_k


def dynamic_viscosity(gas: GasProps, temp_k):
    """mu(T), N.s/m^2 (gas.rs:160-162)."""
    return gas.mu0 + gas.mu1 * temp_k


def heat_capacity(gas: GasProps, temp_k):
    """cp(T), J/kg.K (gas.rs:165-167)."""
    return gas.cp0 + gas.cp1 * temp_k


def density(gas: GasProps, temp_k):
    """Ideal-gas density at 101325 Pa (ISO 15099 Eq. 55; gas.rs:175-179)."""
    return 101325.0 * gas.molar_mass / (_R * temp_k)


def rayleigh(gas: GasProps, t_front_c, t_back_c, thickness):
    """Rayleigh number of a gas cavity (ISO 15099 Eq. 40; gas.rs:82-102).
    Temperatures in Celsius (interchangeable); 1e-7 where the faces are
    (numerically) isothermal, like the reference."""
    dt = torch.abs(t_front_c - t_back_c)
    temp = (t_front_c + t_back_c) / 2.0 + KELVIN
    beta = 1.0 / temp
    c_p = heat_capacity(gas, temp)
    mu = dynamic_viscosity(gas, temp)
    lam = thermal_conductivity(gas, temp)
    rho = density(gas, temp)
    ra = rho * rho * thickness**3 * _G * beta * c_p * dt / (mu * lam)
    return torch.where(dt < 1e-10, torch.full_like(ra, 1e-7), ra)


def _relu(x):
    # aux(x) = (x + |x|)/2 (gas.rs:234); torch.maximum splits a tie's
    # cotangent as jnp.maximum does.
    return torch.maximum(x, torch.zeros_like(x))


def _nu_0_60(ra, gamma, a_gi):
    """Nusselt for tilt 0..60 deg (ISO 15099 Eq. 43-44; gas.rs:227-244)."""
    del a_gi
    cos_g = torch.cos(gamma)
    safe = torch.maximum(ra * cos_g, torch.full_like(ra, 1e-30))
    a = _relu(1.0 - 1708.0 / safe)
    sin_t = _relu(torch.sin(1.8 * gamma))
    b = 1.0 - 1708.0 * sin_t**1.6 / safe
    c = (safe / 5830.0) ** (1.0 / 3.0) - 1.0
    return 1.0 + 1.44 * a * b + _relu(c)


def _nu_60(ra, a_gi):
    """Nusselt at 60 deg (ISO 15099 Eq. 45-48; gas.rs:249-263).  Where
    ``(ra/3160)**20.6`` overflows the dtype, g is the 0 heatx rounds it to."""
    r = ra / 3160.0
    big = ~torch.isfinite(r.detach() ** 20.6)
    x = torch.where(big, torch.ones_like(r), r) ** 20.6
    g = torch.where(big, torch.zeros_like(r), 0.5 / (1.0 + x) ** 0.1)
    nu1 = (1.0 + (0.0936 * ra**0.314 / (1.0 + g)) ** 7) ** (1.0 / 7.0)
    nu2 = (0.104 + 0.175 / a_gi) * ra**0.283
    return torch.maximum(nu1, nu2)


def _nu_90(ra, a_gi):
    """Nusselt at 90 deg (ISO 15099 Eq. 49-53; gas.rs:285-307)."""
    nu1_low = 1.0 + 1.7596678e-10 * ra**2.2984755  # Eq. 52, ra <= 1e4
    nu1_mid = 0.028154 * ra**0.4134  # Eq. 51, 1e4 < ra < 5e4
    nu1_high = 0.0673838 * ra ** (1.0 / 3.0)  # Eq. 50, ra >= 5e4
    nu1 = torch.where(ra <= 1e4, nu1_low, torch.where(ra < 5e4, nu1_mid, nu1_high))
    nu2 = 0.242 * (ra / a_gi) ** 0.272  # Eq. 53
    return torch.maximum(nu1, nu2)


def _nu_60_90(nu60, nu90, gamma):
    """Linear interpolation between 60 and 90 deg (gas.rs:269-280), of the
    two correlations' values."""
    x = (gamma - PI / 3.0) / (PI / 2.0 - PI / 3.0)
    return nu60 + (nu90 - nu60) * x


def _nu_90_180(nu90, gamma):
    """Nusselt for tilt 90..180 deg (ISO 15099 Eq. 54; gas.rs:312-315), of
    the 90 deg correlation's value."""
    return 1.0 + (nu90 - 1.0) * torch.sin(gamma)


# The Ra and tilt a correlation reads on the lanes that do not take it.
_OFF_RA = 1e4
_OFF_TILT = PI / 6.0


def nusselt(ra, gamma, a_gi):
    """Cavity Nusselt number (gas.rs:197-221): the branch of the tilt
    ``gamma`` (radians, 0 horizontal, pi/2 vertical, reduced modulo pi) in
    0.5 deg bands around 60 and 90 deg.  Each correlation is evaluated once
    on every lane, with ``_OFF_RA`` (and the 0-60 deg one ``_OFF_TILT``) on
    the lanes that do not read it (module docstring)."""
    thirty = 30.0 * PI / 180.0
    eps = 0.5 * PI / 180.0
    gamma = torch.remainder(gamma, PI)
    m_0_60 = gamma < 2.0 * thirty - eps
    m_60 = ~m_0_60 & (gamma < 2.0 * thirty + eps)
    m_60_90 = ~m_0_60 & ~m_60 & (gamma < 3.0 * thirty - eps)
    m_90 = ~m_0_60 & ~m_60 & ~m_60_90 & (gamma < 3.0 * thirty + eps)

    def on(mask):
        return torch.where(mask, ra, _OFF_RA)

    nu_low = _nu_0_60(on(m_0_60), torch.where(m_0_60, gamma, _OFF_TILT), a_gi)
    nu60 = _nu_60(on(m_60 | m_60_90), a_gi)
    nu90 = _nu_90(on(~(m_0_60 | m_60)), a_gi)
    return torch.where(m_0_60, nu_low, torch.where(m_60, nu60, torch.where(
        m_60_90, _nu_60_90(nu60, nu90, gamma), torch.where(m_90, nu90, _nu_90_180(nu90, gamma)))))


def cavity_convection(gas: GasProps, height, thickness, gamma, t_front_c, t_back_c):
    """Convective coefficient h of a gas cavity (ISO 15099 5.3.3.1;
    gas.rs:126-152), with the ``180 - gamma`` complement when the front face
    is the warmer one.  Temperatures in Celsius."""
    gamma = torch.where(t_front_c > t_back_c, PI - gamma, gamma)
    # Padded lanes carry zero-thickness cavities whose h is masked out.
    safe_thickness = torch.where(thickness > 0.0, thickness, torch.ones_like(thickness))
    a_gi = height / safe_thickness
    ra = rayleigh(gas, t_front_c, t_back_c, thickness)
    nu = nusselt(ra, gamma, a_gi)
    temp = (t_front_c + t_back_c) / 2.0 + KELVIN
    lam = thermal_conductivity(gas, temp)
    # Eq. 39 of ISO15099/2003
    return nu * lam / safe_thickness

"""Gas-filled cavity U-value, convective plus radiative (PyTorch twin of
``heatx.physics.cavity``).

A cavity is a set of parallel coefficient tensors (gas polynomials, geometry,
emissivities) carried in the compiled surface layout; ``cavity_u_value``
evaluates a whole batch at once.
"""

from __future__ import annotations

from heatx_torch.constants import KELVIN, SIGMA
from heatx_torch.physics.gas import GasProps, cavity_convection


def cavity_u_value(gas: GasProps, thickness, height, angle, ein, eout, t_front_c, t_back_c):
    """U-value of a gas cavity, W/m^2.K (cavity.rs:59-69):
    ``U = h_conv + 4 Tm^3 sigma e_in e_out / (1 - (1-e_in)(1-e_out))`` with Tm
    the mean cavity temperature in Kelvin.  Temperatures in Celsius."""
    conv = cavity_convection(gas, height, thickness, angle, t_front_c, t_back_c)
    tm = (t_back_c + t_front_c) / 2.0 + KELVIN
    rad = 4.0 * tm**3 * SIGMA * ein * eout / (1.0 - (1.0 - ein) * (1.0 - eout))
    return rad + conv

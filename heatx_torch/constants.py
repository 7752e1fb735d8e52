"""Physical constants shared across heatx_torch (a copy of heatx.constants).

Mirrors the numerics configuration of the reference crate root
(the reference's src/lib.rs:40-49): the Stefan-Boltzmann constant and pi.
Unlike the reference (whose ``Float`` is chosen at compile time), heatx keeps
all host-side model building in float64 and lets the device dtype be chosen
per-simulation via :class:`heatx_torch.config.SimConfig`.
"""

import math

# Stefan-Boltzmann constant, W m^-2 K^-4 (lib.rs:49)
SIGMA: float = 5.670374419e-8

PI: float = math.pi

# Celsius -> Kelvin offset used throughout ISO 15099 / TARP formulas.
KELVIN: float = 273.15

# Default thermal emissivity when a substance does not define one
# (surface.rs:449, discretization.rs:265, glazing.rs:88-89 use 0.84).
DEFAULT_EMISSIVITY: float = 0.84

# Default solar absorbtance (glazing.rs:88-89).
DEFAULT_SOLAR_ABSORBTANCE: float = 0.84

# Initial values registered into the simulation state by the reference
# (surface_trait.rs:229-232 and :356-378, zone.rs:45-49).
INITIAL_CONVECTION_COEFFICIENT: float = 1.739658084820765
INITIAL_TEMPERATURE: float = 22.0

# Convection floor (convection.rs:22).
MIN_H: float = 0.1

# Surface-resistance bound used by the discretization stability heuristic
# (discretization.rs:21).
MAX_RS: float = 0.05

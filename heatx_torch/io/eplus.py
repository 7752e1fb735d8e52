"""EnergyPlus ``eplusout.csv`` fixture reader.

heatx_torch copy of ``heatx.io.eplus`` (numpy only; heatx's native CSV
parser is not ported, the port reads with numpy, heatx's own fallback).

Reads the 12-column timestep output used by the reference's validation
harness (tests/validate_wall_heat_transfer.rs:634-650 and
tests/validate_convection.rs:39-54).  The fixtures are pure data; heatx
consumes them directly from the reference checkout (SURVEY.md section 4).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class EPlusWallRun:
    """One fixture: 21 days of 3-minute-step EnergyPlus output."""

    site_wind_speed: np.ndarray  # col 1, m/s
    site_wind_direction: np.ndarray  # col 2, deg
    incident_solar: np.ndarray  # col 3, W/m2 (outside face)
    inside_surface_temp: np.ndarray  # col 4, C
    outside_surface_temp: np.ndarray  # col 5, C
    hs_inside: np.ndarray  # col 6, W/m2K
    indoor_thermal_gain: np.ndarray  # col 7, W
    outdoor_temp: np.ndarray  # col 8, C
    surface_wind_speed: np.ndarray  # col 9, m/s
    hs_outside: np.ndarray  # col 10, W/m2K
    outdoor_thermal_gain: np.ndarray  # col 11, W
    zone_air_temp: np.ndarray  # col 12, C

    @property
    def n_steps(self) -> int:
        return len(self.outdoor_temp)


def read_eplusout(path: str) -> EPlusWallRun:
    """The 12 data columns of an ``eplusout.csv`` (its date column and
    header row skipped)."""
    data = np.genfromtxt(path, delimiter=",", skip_header=1, usecols=range(1, 13))
    return EPlusWallRun(*[np.ascontiguousarray(data[:, i]) for i in range(12)])

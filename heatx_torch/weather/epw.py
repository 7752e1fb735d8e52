"""Weather helpers: the part of ``heatx.weather.epw`` the day march uses.

EPW parsing, ground temperatures and the solar model are not ported yet
(ROADMAP A11); the port takes hourly weather series as arrays.
"""

from __future__ import annotations

import numpy as np


def interpolate_to_steps(values: np.ndarray, steps_per_hour: int) -> np.ndarray:
    """Linearly interpolate an hourly series to ``steps_per_hour`` sub-values
    per hour (length n_hours * steps_per_hour), wrapping at the year end."""
    n = len(values)
    xi = np.arange(n * steps_per_hour) / steps_per_hour
    wrapped = np.concatenate([values, values[:1]])
    return np.interp(xi, np.arange(n + 1), wrapped)

"""TARP convection correlations (EnergyPlus formulation) on torch tensors.

PyTorch twin of ``heatx.physics.convection`` for the parts the day march
uses: the natural-convection branch coefficients, the natural h, and the
windward test.  The exterior forced term lives in
``heatx_torch.engine.surface.forced_context``, as in heatx.
"""

from __future__ import annotations

import torch

from heatx_torch.constants import MIN_H


def tarp_natural_coeffs(cos_surface_tilt):
    """Static per-face TARP branch coefficients (9.482/(7.238-|cos|),
    1.81/(1.382+|cos|)); |cos| is tilt-flip invariant, so one pair serves
    both faces."""
    abs_cos = torch.abs(cos_surface_tilt)
    return 9.482 / (7.238 - abs_cos), 1.81 / (1.382 + abs_cos)


def tarp_natural_convection_coefficient(
    air_temperature, surface_temperature, cos_surface_tilt, coeffs=None
):
    """Natural (indoor) TARP h (convection.rs:87-110).

    Three cases keyed on the sign of ``delta_t * cos(tilt)``:

    * either magnitude ~ 0:          ``h = 1.31 |dT|^(1/3)``
    * same sign (enhanced/buoyant):  ``h = 9.482 |dT|^(1/3) / (7.238 - |cos|)``
    * opposite sign (stable):        ``h = 1.81 |dT|^(1/3) / (1.382 + |cos|)``

    floored at ``MIN_H``.  The cube root is ``pow(max(|dT|, 1e-30), 1/3)``,
    the form heatx's day kernel uses (and the CUDA kernel uses): the clamp is
    value-exact because 1.31 * 1e-10 is far below the floor.  ``coeffs``
    passes precomputed :func:`tarp_natural_coeffs`.
    """
    delta_t = air_temperature - surface_temperature
    abs_dt = torch.abs(delta_t)
    abs_cos = torch.abs(cos_surface_tilt)
    cbrt = torch.pow(torch.clamp_min(abs_dt, 1e-30), 1.0 / 3.0)
    near_zero = (abs_dt < 1e-3) | (abs_cos < 1e-3)
    same_sign = delta_t * cos_surface_tilt > 0.0
    if coeffs is None:
        coeffs = tarp_natural_coeffs(cos_surface_tilt)
    c_same, c_opp = coeffs
    # Select the branch coefficient, then multiply once (each lane sees the
    # single rounding c * cbrt, as in heatx's hoisted-coefficient form).
    coef = torch.where(
        near_zero,
        torch.full_like(c_same, 1.31),
        torch.where(same_sign, c_same, c_opp),
    )
    return torch.clamp_min(coef * cbrt, MIN_H)


def is_windward(wind_direction, cos_tilt, normal_x, normal_y):
    """Whether a surface faces the wind (surface.rs:37-46).

    ``wind_direction`` in radians (a Python float or a 0-d tensor).
    Horizontal surfaces (|cos_tilt| >= 0.98) are always windward.
    """
    wd = torch.as_tensor(wind_direction, dtype=normal_x.dtype, device=normal_x.device)
    dot = normal_x * torch.sin(wd) + normal_y * torch.cos(wd)
    return (torch.abs(cos_tilt) >= 0.98) | (dot > 0.0)

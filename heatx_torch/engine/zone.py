"""Zone (space air) update: the exact exponential solution and the
setpoint-landing ideal-loads control.

PyTorch counterpart of ``heatx.engine.zone`` for what the day march runs:
:func:`future_zone_temperatures` and :func:`zone_update`.  Plain functions on
tensors of one shape (any leading layout: ``[Z]`` zone order or the blocked
``[NB*ZB]`` rows); the plain day march calls them, and the CUDA kernels carry
the same arithmetic in ``csrc/day_common.cuh``.
"""

from __future__ import annotations

import torch

#: |B| at or below this holds the zone temperature (model.rs:662-670).
SMALL_B = 1e-9


def future_zone_temperatures(zone_T, a, b, c, dt):
    """Exact exponential update T(t) = A/B + (T0 - A/B) e^(-Bt/C)
    (model.rs:650-674) in the expm1 form T0 - (A/B - T0) expm1(-Bt/C), which
    loses no precision when B dt/C << 1.  Zones with |B| ~ 0 hold their
    temperature."""
    ok = torch.abs(b) > SMALL_B
    safe_b = torch.where(ok, b, torch.ones_like(b))
    ratio = a / safe_b
    t_new = zone_T - (ratio - zone_T) * torch.expm1(-(safe_b * dt / c))
    return torch.where(ok, t_new, zone_T)


def zone_update(zone_T, a, b, c, dt, heat_sp, cool_sp, max_heat, max_cool):
    """Zone update with setpoint-driven ideal-loads control (heatx
    ``zone.zone_update`` / the kernel's ``_zone_update_ctl``).

    Returns ``(zone_T_new, load)`` with ``load`` the power (W, heating
    positive, cooling negative) injected this sub-step.  The free-float
    temperature is predicted first; where it crosses a setpoint the closed
    form gives the power that lands T(t + dt) on the setpoint,

        P = B (T0 (1 + em) - T_set) / em - A,   em = expm1(-B dt/C)

    (|B| <= 1e-9: P = C (T_set - T0)/dt - A), clamped to the unit's capacity
    ``[0, max_heat]`` or ``[-max_cool, 0]``.  Zones with |B| ~ 0 hold their
    temperature and control stands down with them.  Where the load is zero
    the result is the free-float update, bit for bit.  Never-act sentinels
    (``heat_sp = -1e9``, ``cool_sp = 1e9``, zero capacities) make the control
    a no-op on a zone."""
    smallb = torch.abs(b) <= SMALL_B
    safe_b = torch.where(smallb, torch.ones_like(b), b)
    em = torch.expm1(-(safe_b * dt / c))
    t_free = zone_T - (a / safe_b - zone_T) * em
    t_free = torch.where(smallb, zone_T, t_free)

    def a_required(t_set):
        a_gen = safe_b * (zone_T * (1.0 + em) - t_set) / em
        a_lin = c * (t_set - zone_T) / dt
        return torch.where(smallb, a_lin, a_gen)

    zero = torch.zeros_like(a)
    load = torch.where(
        t_free < heat_sp,
        torch.clamp(a_required(heat_sp) - a, min=zero, max=max_heat),
        torch.where(
            t_free > cool_sp,
            torch.clamp(a_required(cool_sp) - a, min=-max_cool, max=zero),
            zero,
        ),
    )
    load = torch.where(smallb, zero, load)
    t_ctl = zone_T - ((a + load) / safe_b - zone_T) * em
    t_ctl = torch.where(smallb, zone_T, t_ctl)
    return torch.where(load == 0.0, t_free, t_ctl), load

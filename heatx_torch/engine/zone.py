"""Zone (space air) energy balance: the A/B/C assembly, the exact
exponential solution and the setpoint-landing ideal-loads control.

PyTorch counterpart of ``heatx.engine.zone``.  :func:`future_zone_temperatures`
and :func:`zone_update` are plain functions on tensors of one shape (any
leading layout: ``[Z]`` zone order or the blocked ``[NB*ZB]`` rows); the plain
day march calls them, and the CUDA kernels carry the same arithmetic in
``csrc/day_common.cuh``.  :func:`zone_abc`, :func:`building_zone_update` and
:func:`mean_future_zone_temperatures` work on a whole building in zone order
(``engine.step.device_building``'s view), as the XLA-path integrators
(``engine.step``, ``engine.implicit``, ``engine.exponential``) read them;
heatx's ``segment_sum`` is ``index_add_`` here.
"""

from __future__ import annotations

import torch

from heatx_torch.build.layout import B_SPACE
from heatx_torch.constants import KELVIN
from heatx_torch.physics import gas

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


def _segment_sum(x, idx, n: int):
    return torch.zeros(n, dtype=x.dtype, device=x.device).index_add_(0, idx, x)


def zone_abc(building, zone_T, h_front, h_back, surf_T_front, surf_T_back, inputs):
    """Per-zone A, B, C coefficients (model.rs:489-597 calculate_zones_abc).

    A collects gains (HVAC, luminaires, infiltration/ventilation enthalpy,
    inter-zone mixing, surface convective h A T); B the
    temperature-proportional loss terms; C is the zone air capacitance
    V rho(T) cp(T) (zone.rs:59-65)."""
    sb = building.surfaces
    Z = building.n_zones
    a = zone_T.new_zeros(Z)
    b = zone_T.new_zeros(Z)
    if building.hvac_pair_unit.numel():
        a = a + _segment_sum(inputs.hvac_power[building.hvac_pair_unit], building.hvac_pair_space, Z)
    if building.lum_space.numel():
        a = a + _segment_sum(inputs.lum_power, building.lum_space, Z)

    def air_exchange(a, b, vol, temp, mask):
        t_k = temp + KELVIN
        term = torch.where(mask, gas.density(gas.AIR, t_k) * vol * gas.heat_capacity(gas.AIR, t_k), 0.0)
        # The product is masked too: a masked-off channel may carry NaN.
        return a + torch.where(mask, term * temp, 0.0), b + term

    a, b = air_exchange(a, b, inputs.inf_vol, inputs.inf_temp, inputs.inf_mask)
    a, b = air_exchange(a, b, inputs.vent_vol, inputs.vent_temp, inputs.vent_mask)

    # Inter-zone mixing (heatx extension): ventilation whose inlet is the
    # source zone's current air.
    if building.mix_src.numel():
        vol = building.mix_vol if inputs.mix_vol is None else inputs.mix_vol
        t_src = zone_T[building.mix_src]
        t_k = t_src + KELVIN
        term = gas.density(gas.AIR, t_k) * vol * gas.heat_capacity(gas.AIR, t_k)
        a = a + _segment_sum(term * t_src, building.mix_dst, Z)
        b = b + _segment_sum(term, building.mix_dst, Z)

    # Surface convective coupling into the adjacent zones; faces that bound
    # no space sum into a dump slot.
    def face(a, b, code, space, h, t_s):
        idx = torch.where(code == B_SPACE, space, Z).long()
        ha = h * sb.area
        return a + _segment_sum(ha * t_s, idx, Z + 1)[:Z], b + _segment_sum(ha, idx, Z + 1)[:Z]

    a, b = face(a, b, sb.front_code, sb.front_space, h_front, surf_T_front)
    a, b = face(a, b, sb.back_code, sb.back_space, h_back, surf_T_back)

    t_k = zone_T + KELVIN
    c = building.zone_volume * gas.density(gas.AIR, t_k) * gas.heat_capacity(gas.AIR, t_k)
    return a, b, c


def building_zone_update(building, zone_T, a, b, c, dt, heat_sp=None, cool_sp=None):
    """heatx ``zone.zone_update`` on a building: the free-float update, or on
    a building with thermostats :func:`zone_update` with the compiled
    setpoints (``heat_sp``/``cool_sp`` override them: scalar, ``[Z]`` or
    ``[1, Z]``).  Returns ``(zone_T_new, ideal_load)``, ``ideal_load`` None
    without thermostats."""
    if not building.has_ideal_hvac:
        return future_zone_temperatures(zone_T, a, b, c, dt), None

    def sp(v, compiled):
        v = compiled if v is None else torch.as_tensor(v, dtype=zone_T.dtype, device=zone_T.device)
        return torch.broadcast_to(v, zone_T.shape) if v.ndim < 2 else v.reshape(zone_T.shape)

    return zone_update(
        zone_T, a, b, c, dt, sp(heat_sp, building.ctl_heat_sp), sp(cool_sp, building.ctl_cool_sp),
        building.ctl_max_heat, building.ctl_max_cool,
    )


def mean_future_zone_temperatures(zone_T, a, b, c, dt):
    """Average temperature over the next dt (model.rs:617-644; dead code in
    the reference but part of its public math)."""
    ok = torch.abs(b) > SMALL_B
    safe_b = torch.where(ok, b, torch.ones_like(b))
    ratio = a / safe_b
    t_mean = ratio - (c * (zone_T - ratio) / (dt * safe_b)) * torch.expm1(-safe_b * dt / c)
    return torch.where(ok, t_mean, zone_T)

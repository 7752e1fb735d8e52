"""Time marching on the XLA path: sub-step, main step and multi-step runs.

PyTorch counterpart of ``heatx.engine.step`` (ThermalModel::march,
model.rs:359-427): one main timestep is ``dt_subdivisions`` serial
reference-parity sub-steps, and a run marches a ``[T, ...]`` input sequence
main step by main step.  heatx compiles both loops into ``lax.scan``s; here
they are Python loops over tensor operations on the building's device, and a
run stacks its histories once at the end.  This path calls no kernel of the
port's own: it is the plain counterpart of ``heatx.engine.step`` beside the
day march (``ops.day_march``), as heatx's XLA path is beside its Pallas
kernel.

The functions read the building through :func:`device_building`, a view of a
``CompiledBuilding`` whose arrays are tensors on one device in one dtype
(heatx passes ``building.astype(dtype)`` to its jitted calls).  With the
adaptive no-mass loop (``nomass_fixed_iters=None``, heatx's default) every
loop iteration waits for the device once; autograd through a run works where
heatx's ``jax.grad`` does, the fixed-iteration and fast modes, and raises
through the adaptive loop.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Optional, Tuple

import numpy as np
import torch

from heatx_torch.engine import surface as surf_mod
from heatx_torch.engine import zone as zone_mod
from heatx_torch.engine.state import SimState, StepInputs
from heatx_torch.physics.gas import GasProps


def _tensor(v, dtype, device):
    """A building array as a tensor: floating ones in ``dtype``, integer ones
    as int64 (indices), booleans as they are; other values unchanged."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype if v.is_floating_point() else None)
    if not isinstance(v, np.ndarray):
        return v
    if np.issubdtype(v.dtype, np.floating):
        return torch.as_tensor(v, dtype=dtype, device=device)
    if v.dtype == np.bool_:
        return torch.as_tensor(v, device=device)
    return torch.as_tensor(v.astype(np.int64), device=device)


def device_building(building, dtype=None, device="cpu") -> SimpleNamespace:
    """The building as the integrators of this module, ``engine.implicit``
    and ``engine.exponential`` read it: every array a tensor on ``device``
    (floating arrays in ``dtype``, default the config's; index arrays int64),
    ``surfaces.normal`` as the ``(nx, ny)`` pair the surface physics reads,
    and the gas-cavity segments' flat indices (``surfaces.cav_index``).
    Fields that already are tensors keep their autograd graph.  Make a new
    view after editing the compiled building (heatx's ``invalidate``)."""
    dtype = dtype or building.config.dtype
    sb = building.surfaces
    sv = {f.name: getattr(sb, f.name) for f in dataclasses.fields(sb)}
    sv = {k: _tensor(v, dtype, device) for k, v in sv.items() if k not in ("normal", "cav_gas")}
    normal = _tensor(sb.normal, dtype, device)
    sv["normal"] = (normal[:, 0], normal[:, 1])
    sv["cav_gas"] = GasProps(*(_tensor(x, dtype, device) for x in sb.cav_gas))
    sv["nomass_chunk_count"] = sv["nomass_chunk_count"].to(dtype)
    if sb.has_cavity:
        sv["cav_index"] = surf_mod.cavity_index(sv["seg_is_cavity"])
    out = {
        f.name: _tensor(getattr(building, f.name), dtype, device)
        for f in dataclasses.fields(building) if f.name not in ("surfaces", "discretizations")
    }
    out.update(
        surfaces=SimpleNamespace(**sv), n_surfaces=building.n_surfaces,
        max_nodes=building.max_nodes, device=torch.device(device), dtype=dtype,
    )
    return SimpleNamespace(**out)


# ---------------------------------------------------------------------------
# In-run zone-state controls
# ---------------------------------------------------------------------------


def apply_zone_shading(building, state: SimState, inputs: StepInputs) -> StepInputs:
    """In-run window shading (heatx extension; EnergyPlus's zone-state
    WindowShadingControl family): scale each controlled pane's incident
    front solar by its deployed transmittance while the controlling zone's
    air, read from the state at the main step's start, is above the setpoint
    (``inputs.shade_sp`` overrides the compiled setpoints for the step; a
    schedule gate passes +1e9).  The identity on buildings without it."""
    if not building.has_zone_shading:
        return inputs
    zi = building.shade_zone
    sp = building.shade_sp if inputs.shade_sp is None else inputs.shade_sp
    t_zone = state.zone_T[zi.clamp_min(0)]
    deploy = (zi >= 0) & (t_zone > sp)
    mult = torch.where(deploy, building.shade_tau, 1.0)
    return dataclasses.replace(inputs, sol_front=inputs.sol_front * mult)


def apply_vent_gates(building, state: SimState, inputs: StepInputs) -> StepInputs:
    """In-run ventilation gates (heatx extension; EnergyPlus's
    ZoneVentilation:DesignFlowRate limits): a controlled zone's ventilation
    channel is off for the main step unless every gate passes, min_indoor <
    T_zone < max_indoor, T_zone - T_out > delta, min_outdoor < T_out <
    max_outdoor and wind < max_wind, with the zone air of the step's start
    and the step means of the outdoor conditions.  Infiltration is never
    gated.  The identity on buildings without gates."""
    if not building.has_vent_gates:
        return inputs
    t_out = torch.as_tensor(inputs.t_out).mean()
    wind = torch.as_tensor(inputs.wind_speed).mean()
    zT = state.zone_T
    on = (
        (zT > building.vent_min_tin)
        & (zT < building.vent_max_tin)
        & (zT - t_out > building.vent_delta)
        & (t_out > building.vent_min_tout)
        & (t_out < building.vent_max_tout)
        & (wind < building.vent_max_wind)
    )
    return dataclasses.replace(inputs, vent_mask=inputs.vent_mask & on)


def apply_state_controls(building, state: SimState, inputs: StepInputs) -> StepInputs:
    """Window shading, then the ventilation gates, once at the main step's start."""
    return apply_vent_gates(building, state, apply_zone_shading(building, state, inputs))


# ---------------------------------------------------------------------------
# The reference-parity sub-step and main step
# ---------------------------------------------------------------------------


def substep(building, state: SimState, t_out, wind_speed, wind_direction, inputs: StepInputs,
            mrt_static=None, statics=None) -> SimState:
    """One stability sub-step (the body of model.rs:369-424): the boundary
    air from the zone temperatures; every surface's march (the no-mass
    solve, then RK4 on the massive nodes); the film coefficients and
    convective flows of the new node temperatures; the exact zone update.
    ``statics`` passes :func:`engine.surface.compute_statics` of the
    building's surfaces (computed here when None)."""
    sb = building.surfaces
    cfg = building.config
    st = statics if statics is not None else surf_mod.compute_statics(sb)
    t_front, t_back = surf_mod.boundary_temperatures(sb, state.zone_T, t_out)
    mrt = None
    if cfg.interior_mrt:  # from the sub-step's start state, like every coefficient
        mrt = surf_mod.interior_mrt(sb, state.node_T, state.zone_T, building.n_zones, st,
                                    mrt_static=mrt_static)
    node_T = surf_mod.march_surfaces(
        sb, state.node_T, t_front, t_back, wind_direction, wind_speed, inputs.sol_front,
        inputs.sol_back, inputs.ir_front, inputs.ir_back, building.dt, cfg,
        has_massive=sb.has_massive, statics=st, mrt=mrt,
    )
    # model.rs:145-169: h and the convective flows from the new temperatures.
    env_f, env_b = surf_mod.border_conditions(
        sb, node_T, t_front, t_back, wind_direction, wind_speed, inputs.ir_front,
        inputs.ir_back, cfg, statics=st,
    )
    ts_front = node_T[0]
    ts_back = surf_mod._last_node(sb, node_T, st)
    a, b, c = zone_mod.zone_abc(building, state.zone_T, env_f.h, env_b.h, ts_front, ts_back, inputs)
    zone_T, ideal_load = zone_mod.building_zone_update(
        building, state.zone_T, a, b, c, building.dt, heat_sp=inputs.heat_sp, cool_sp=inputs.cool_sp
    )
    return SimState(
        node_T=node_T, zone_T=zone_T, h_front=env_f.h, h_back=env_b.h,
        q_front=(ts_front - t_front) * env_f.h, q_back=(ts_back - t_back) * env_b.h,
        ideal_load=ideal_load,
    )


def _per_substep_weather(building, value, n: int = None):
    """A scalar held for the main step, or a ``[n]`` per-sub-step series
    (``n`` defaults to the building's ``dt_subdivisions``), as ``[n]``."""
    n = building.dt_subdivisions if n is None else n
    value = torch.as_tensor(value, dtype=building.dtype, device=building.device)
    if value.ndim == 0:
        return value.expand(n)
    if value.shape[0] != n:
        raise ValueError(
            f"per-sub-step weather series has length {value.shape[0]} but this march runs "
            f"{n} sub-steps; pass a scalar or a [{n}] series"
        )
    return value


def _mean_load(state: SimState, loads) -> SimState:
    """The main step's mean ideal-load power (energy-consistent; the last
    sub-step's instantaneous power otherwise)."""
    if loads and loads[0] is not None:
        state = dataclasses.replace(state, ideal_load=torch.stack(loads).mean(dim=0))
    return state


def march(building, state: SimState, inputs: StepInputs, mrt_static=None, statics=None) -> SimState:
    """One main timestep, ``dt_subdivisions`` sub-steps (model.rs:359-427):
    the in-run controls at its start, weather per sub-step (scalars held),
    irradiance and gains held for the step.  On a building with thermostats
    the state's ``ideal_load`` is the step's mean power."""
    inputs = apply_state_controls(building, state, inputs)
    t_out = _per_substep_weather(building, inputs.t_out)
    ws = _per_substep_weather(building, inputs.wind_speed)
    wd = _per_substep_weather(building, inputs.wind_direction)
    if building.config.interior_mrt and mrt_static is None:
        mrt_static = surf_mod.mrt_statics(building.surfaces, building.n_zones)
    if statics is None:
        statics = surf_mod.compute_statics(building.surfaces)
    loads = []
    for i in range(building.dt_subdivisions):
        state = substep(building, state, t_out[i], ws[i], wd[i], inputs, mrt_static, statics)
        loads.append(state.ideal_load)
    return _mean_load(state, loads)


def make_march_fn(building):
    """``(state, inputs) -> state``, one :func:`march` of ``building`` (a
    :func:`device_building` view)."""

    def fn(state, inputs):
        return march(building, state, inputs)

    return fn


def _with_time_axis_mix(inputs_seq: StepInputs) -> StepInputs:
    """Broadcast the static optional leaves over the time axis (heatx's
    rules): ``mix_vol`` [M] and ``shade_sp`` [S] become [T, ...];
    ``heat_sp``/``cool_sp`` given as a scalar or ``[Z]`` become [T, ...], and
    a 1-D series of length T (one setpoint for every zone each step) becomes
    [T, 1] — when T equals the zone count the time-series reading wins."""
    T = torch.as_tensor(inputs_seq.t_out).shape[0]
    upd = {}
    for name in ("mix_vol", "shade_sp"):
        v = getattr(inputs_seq, name)
        if v is not None:
            v = torch.as_tensor(v)
            upd[name] = v.expand((T,) + tuple(v.shape)) if v.ndim == 1 else v
    for name in ("heat_sp", "cool_sp"):
        v = getattr(inputs_seq, name)
        if v is None:
            continue
        v = torch.as_tensor(v)
        if v.ndim == 1 and v.shape[0] == T:
            upd[name] = v[:, None]
        elif v.ndim <= 1:
            upd[name] = v.expand((T,) + tuple(v.shape))
        else:
            upd[name] = v
    return dataclasses.replace(inputs_seq, **upd) if upd else inputs_seq


def _step(inputs_seq: StepInputs, t: int) -> StepInputs:
    """Main step ``t`` of a sequence whose leaves all lead with the time axis."""
    return StepInputs(**{
        f.name: None if getattr(inputs_seq, f.name) is None else getattr(inputs_seq, f.name)[t]
        for f in dataclasses.fields(inputs_seq)
    })


def run(
    building,
    state: SimState,
    inputs_seq: StepInputs,
    collect_zone_T: bool = True,
    collect_loads: bool = False,
    collect_operative: bool = False,
    march_fn=None,
) -> Tuple[SimState, Optional[torch.Tensor]]:
    """March over a whole ``[T, ...]`` input sequence, main step by main step.

    ``march_fn(building, state, step_inputs) -> state`` replaces the
    reference-parity :func:`march` (``engine.implicit.imp_march`` and
    ``engine.exponential.exp_march`` partials run the fast modes).  Every
    leaf of ``inputs_seq`` leads with the time axis (weather leaves may be
    ``[T]`` or ``[T, dt_subdivisions]``; the static forms of ``mix_vol``,
    ``shade_sp`` and the setpoints are lifted here).  Returns the final
    state and the ``[T, Z]`` zone-temperature history (None without
    ``collect_zone_T``); with ``collect_loads`` (thermostats only) the tuple
    ``(zone_T_hist, ideal_load_hist)`` of per-step mean powers; with
    ``collect_operative`` the ``[T, Z]`` operative-temperature history
    ``(zone_T + zone_MRT) / 2`` appended."""
    if collect_loads and not building.has_ideal_hvac:
        raise ValueError(
            "collect_loads requires setpoint-driven HVAC "
            "(IdealHeaterCooler with heat_setpoint/cool_setpoint)"
        )
    mrt_static = None
    if (building.config.interior_mrt and march_fn is None) or collect_operative:
        mrt_static = surf_mod.mrt_statics(building.surfaces, building.n_zones)
    statics = surf_mod.compute_statics(building.surfaces)
    seq = _with_time_axis_mix(inputs_seq)
    zt, loads, top = [], [], []
    for t in range(torch.as_tensor(seq.t_out).shape[0]):
        step_inputs = _step(seq, t)
        if march_fn is None:
            state = march(building, state, step_inputs, mrt_static=mrt_static, statics=statics)
        else:
            state = march_fn(building, state, step_inputs)
        zt.append(state.zone_T)
        loads.append(state.ideal_load)
        if collect_operative:
            mrt = surf_mod.zone_mrt(building.surfaces, state.node_T, state.zone_T, building.n_zones,
                                    statics, mrt_static=mrt_static)
            top.append((state.zone_T + mrt) / 2.0)
    out = torch.stack(zt) if collect_zone_T and zt else None
    if collect_loads:
        out = (out, torch.stack(loads))
    if collect_operative:
        out = (*out, torch.stack(top)) if collect_loads else (out, torch.stack(top))
    return state, out


def make_run_fn(building, collect_zone_T: bool = True, collect_loads: bool = False):
    """``(state, inputs_seq) -> (state, history)``, :func:`run` of ``building``."""

    def fn(state, inputs_seq):
        return run(building, state, inputs_seq, collect_zone_T=collect_zone_T,
                   collect_loads=collect_loads)

    return fn


def make_checked_run_fn(collect_zone_T: bool = True):
    """``fn(building, state, inputs_seq) -> (state, zone_T_hist)``: a
    reference-parity run with a finiteness guard after every main step (the
    reference's NaN asserts, model.rs:416-419).  It raises
    :class:`FloatingPointError` on the first non-finite zone or node
    temperature, naming the main step and the first bad zone (0 when only a
    node is bad), as heatx's checkify message does; each check waits for
    the device."""

    def fn(building, state, inputs_seq):
        mrt_static = None
        if building.config.interior_mrt:
            mrt_static = surf_mod.mrt_statics(building.surfaces, building.n_zones)
        statics = surf_mod.compute_statics(building.surfaces)
        seq = _with_time_axis_mix(inputs_seq)
        mask = building.surfaces.node_mask
        hist = []
        for t in range(torch.as_tensor(seq.t_out).shape[0]):
            state = march(building, state, _step(seq, t), mrt_static=mrt_static, statics=statics)
            zone_ok = torch.isfinite(state.zone_T)
            node_ok = torch.isfinite(torch.where(mask, state.node_T, 0.0))
            if not bool(zone_ok.all() & node_ok.all()):
                zone = int(torch.argmin(zone_ok.to(torch.int32)))
                raise FloatingPointError(
                    f"non-finite temperature at main step {t} (first bad zone {zone})"
                )
            hist.append(state.zone_T)
        return state, (torch.stack(hist) if collect_zone_T and hist else None)

    return fn

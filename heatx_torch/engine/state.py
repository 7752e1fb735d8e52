"""Simulation state and exogenous inputs as dataclasses of torch tensors.

PyTorch twin of ``heatx.engine.state``: the same fields, the reference's
registered initial values (node/zone T = 22 C, h = 1.739658084820765), and
an explicit ``device``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from heatx_torch.constants import INITIAL_CONVECTION_COEFFICIENT, INITIAL_TEMPERATURE


@dataclasses.dataclass
class SimState:
    """Everything that evolves during the simulation."""

    node_T: torch.Tensor  # [N, S] node temperatures (node-major), C
    zone_T: torch.Tensor  # [Z] zone dry-bulb temperatures, C
    h_front: torch.Tensor  # [S] front convection coefficient, W/m2.K
    h_back: torch.Tensor  # [S]
    q_front: torch.Tensor  # [S] front convective heat flow, W/m2
    q_back: torch.Tensor  # [S]
    # [Z] ideal-loads power (W, heating positive) of a building with
    # thermostats: the mean over the last marched hour.  None on other
    # buildings (an absent leaf of the state tree).
    ideal_load: torch.Tensor = None


@dataclasses.dataclass
class StepInputs:
    """Exogenous inputs for one main timestep, or — with a leading [T] axis
    on each channel — for a sequence (``FastRunner.run``,
    ``ThermalModel.run``; ``ThermalModel.inputs_sequence`` builds one).

    Weather entries may be scalars (held over the sub-steps), per-sub-step
    ``[dt_subdivisions]`` arrays in one main step, or per-hour series.
    ``mix_vol`` carries the inter-zone mixing flows ``[M]`` (a ``[T, M]``
    schedule on the XLA-path integrators; the day march mixes at the
    compiled flows, as heatx's kernel does).  ``heat_sp``/``cool_sp`` are
    optional thermostat setpoint schedules (None: the compiled setpoints).
    ``shade_sp`` overrides the compiled setpoints of the in-run zone-shading
    controls (scalar, ``[S]`` or ``[T, S]``; a schedule gate passes +1e9 on
    blocked hours; None: the compiled setpoints).
    """

    t_out: torch.Tensor  # scalar or [T]
    wind_speed: torch.Tensor
    wind_direction: torch.Tensor  # radians
    sol_front: torch.Tensor  # [S] incident solar irradiance, W/m2
    sol_back: torch.Tensor  # [S]
    ir_front: torch.Tensor  # [S] incident infrared irradiance, W/m2
    ir_back: torch.Tensor  # [S]
    hvac_power: torch.Tensor  # [H] heating(+)/cooling(-) delivered, W
    lum_power: torch.Tensor  # [L] lighting power, W
    inf_vol: torch.Tensor  # [Z] infiltration volume flow, m3/s
    inf_temp: torch.Tensor  # [Z] infiltration inlet temperature, C
    inf_mask: torch.Tensor  # [Z] bool: space has infiltration state
    vent_vol: torch.Tensor  # [Z]
    vent_temp: torch.Tensor  # [Z]
    vent_mask: torch.Tensor  # [Z] bool
    mix_vol: torch.Tensor = None  # [M] inter-zone mixing flows, m3/s (heatx extension)
    heat_sp: torch.Tensor = None  # scalar, [Z], [1, Z], [T] or [T, Z] heating setpoints, C
    cool_sp: torch.Tensor = None
    shade_sp: torch.Tensor = None  # scalar, [S] or [T, S] zone-shading setpoints, C

    def replace(self, **kw) -> "StepInputs":
        return dataclasses.replace(self, **kw)


def initial_state(building, dtype=None, device="cpu") -> SimState:
    """Fresh state with the reference's registered initial values."""
    dtype = dtype or building.config.dtype
    S = building.n_surfaces
    Z = building.n_zones
    node_T = np.where(building.surfaces.node_mask, INITIAL_TEMPERATURE, 0.0)
    kw = dict(dtype=dtype, device=device)
    return SimState(
        node_T=torch.as_tensor(node_T, **kw),
        zone_T=torch.full((Z,), INITIAL_TEMPERATURE, **kw),
        h_front=torch.full((S,), INITIAL_CONVECTION_COEFFICIENT, **kw),
        h_back=torch.full((S,), INITIAL_CONVECTION_COEFFICIENT, **kw),
        q_front=torch.zeros((S,), **kw),
        q_back=torch.zeros((S,), **kw),
        ideal_load=torch.zeros((Z,), **kw) if building.has_ideal_hvac else None,
    )


def default_inputs(building, dtype=None, device="cpu", **overrides) -> StepInputs:
    """Zero-filled StepInputs; override individual channels by name (an
    explicit None keeps the default)."""
    dtype = dtype or building.config.dtype
    S = building.n_surfaces
    Z = building.n_zones
    kw = dict(dtype=dtype, device=device)
    base = StepInputs(
        t_out=torch.zeros((), **kw),
        wind_speed=torch.zeros((), **kw),
        wind_direction=torch.zeros((), **kw),
        sol_front=torch.zeros((S,), **kw),
        sol_back=torch.zeros((S,), **kw),
        ir_front=torch.zeros((S,), **kw),
        ir_back=torch.zeros((S,), **kw),
        hvac_power=torch.zeros((building.n_hvacs,), **kw),
        lum_power=torch.zeros((building.n_luminaires,), **kw),
        inf_vol=torch.zeros((Z,), **kw),
        inf_temp=torch.zeros((Z,), **kw),
        inf_mask=torch.zeros((Z,), dtype=torch.bool, device=device),
        vent_vol=torch.zeros((Z,), **kw),
        vent_temp=torch.zeros((Z,), **kw),
        vent_mask=torch.zeros((Z,), dtype=torch.bool, device=device),
        mix_vol=torch.as_tensor(building.mix_vol, **kw),
    )
    upd = {}
    for k, v in overrides.items():
        if v is None:
            continue
        if k.endswith("mask"):
            upd[k] = torch.as_tensor(v, dtype=torch.bool, device=device)
        else:
            upd[k] = torch.as_tensor(v, **kw)
    return base.replace(**upd)

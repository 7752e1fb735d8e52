"""Implicit fast mode: TR-BDF2 on the fully-coupled node system.

PyTorch counterpart of ``heatx.engine.implicit``: the scheme constants and
the stage matrix, ``heatx.engine.exponential``'s full-system K and forcing
(which the implicit day march shares), and the XLA-path march behind
``ThermalModel.march_imp`` and ``ThermalModel.run(mode="trbdf2"...)``:
:func:`build_operators`, :func:`imp_substep` and :func:`imp_march`, plain
tensor code on the building's device (``engine.step.device_building``'s
view), with the Thomas solves of ``ops.tridiag``.  Coefficients and cavity
U-values freeze per main step (or per group of ``refresh_every``
sub-steps), so each surface's node chain is the linear DAE
``C dT/dt = K T + q`` with C = 0 on no-mass rows.

The scheme (Bank et al. 1985), gamma = 2 - sqrt(2), one step dt, on
``C dT/dt = K T + q`` (C = 0 on no-mass rows):

    stage 1 (trapezoidal to t + gamma*dt):
        (C - gamma*dt/2 K) T1 = (C + gamma*dt/2 K) T0 + gamma*dt q
    stage 2 (BDF2 to t + dt):
        (C - beta*dt K) T2 = c1 C T1 - c2 C T0 + beta*dt q

With this gamma, gamma/2 == beta, so both stages share one matrix and one
factorization.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from heatx_torch.engine import surface as surf_mod
from heatx_torch.engine import zone as zone_mod
from heatx_torch.engine.state import SimState
from heatx_torch.ops import tridiag

GAMMA = 2.0 - math.sqrt(2.0)
BETA = (1.0 - GAMMA) / (2.0 - GAMMA)
C1 = 1.0 / (GAMMA * (2.0 - GAMMA))
C2 = (1.0 - GAMMA) ** 2 / (GAMMA * (2.0 - GAMMA))


def _stage_matrix(sb, K, C, a_dt):
    """(C - a_dt * K) with identity rows on invalid (padded) nodes so one
    padded solve serves every surface."""
    lower, diag, upper = K
    m = sb.node_mask
    zero = torch.zeros_like(diag)
    return (
        torch.where(m, -a_dt * lower, zero),
        torch.where(m, C - a_dt * diag, torch.ones_like(diag)),
        torch.where(m, -a_dt * upper, zero),
    )


def _full_system_K(sb, U, env_f, env_b, rad_hs_f, rad_hs_b, st):
    """The fully-coupled tridiagonal K of each surface's node chain: adjacent
    nodes couple whenever both exist, and the linearized radiation's -T_s
    part sits on the boundary diagonals."""
    zero = torch.zeros_like(U)
    U_left = torch.cat([zero[:1], U[:-1]], dim=0)

    def sel(mask, v):
        return torch.where(mask, v, zero)

    diag = -(
        sel(st.left_exists, U_left)
        + sel(st.right_exists, U)
        + sel(st.is_first, (env_f.h + rad_hs_f).expand_as(U))
        + sel(st.is_last, (env_b.h + rad_hs_b).expand_as(U))
    )
    lower = sel(st.left_exists, U_left)
    upper = sel(st.right_exists, U)
    return lower, diag, upper


def _substep_forcing(env_f, env_b, rad_hs_f, rad_hs_b, solar_q, st):
    """Forcing q of the full system: solar + boundary convection/radiation
    sources (independent of the node temperatures)."""
    zero = torch.zeros_like(solar_q)
    q = solar_q
    q = q + torch.where(
        st.is_first, (env_f.air * env_f.h + rad_hs_f * env_f.rad).expand_as(q), zero
    )
    q = q + torch.where(
        st.is_last, (env_b.air * env_b.h + rad_hs_b * env_b.rad).expand_as(q), zero
    )
    return q


# ---------------------------------------------------------------------------
# The XLA-path TR-BDF2 march (heatx implicit.py:67-335)
# ---------------------------------------------------------------------------


class ImplicitOperators(NamedTuple):
    K: tuple  # the frozen full-system tridiagonal K, 3 x [N, S]
    C: torch.Tensor  # [N, S] capacity (0 on no-mass rows)
    M1: tuple  # the stage matrix (C - gamma dt/2 K), 3 x [N, S]
    M2: tuple  # the same matrix (gamma/2 == beta)
    env_f: object
    env_b: object
    rad_hs_f: torch.Tensor
    rad_hs_b: torch.Tensor
    statics: object


def build_operators(building, state, t_out0, wind_speed0, wind_direction0, inputs, dt_sub,
                    mrt_static=None, statics=None) -> ImplicitOperators:
    """Freeze the film coefficients, the linearized radiation and the cavity
    U-values of ``state`` (and, with ``config.interior_mrt``, its Carroll
    network) and assemble the TR-BDF2 stage matrix."""
    sb = building.surfaces
    cfg = building.config
    st = statics if statics is not None else surf_mod.compute_statics(sb)
    t_front, t_back = surf_mod.boundary_temperatures(sb, state.zone_T, t_out0)
    env_f, env_b = surf_mod.border_conditions(
        sb, state.node_T, t_front, t_back, wind_direction0, wind_speed0, inputs.ir_front,
        inputs.ir_back, cfg, statics=st,
    )
    mrt = None
    if cfg.interior_mrt:
        mrt = surf_mod.interior_mrt(sb, state.node_T, state.zone_T, building.n_zones, st,
                                    mrt_static=mrt_static)
    env_f, env_b, rad_eps_f, rad_eps_b = surf_mod.apply_interior_mrt(sb, env_f, env_b, mrt)
    rad_hs_f = surf_mod.linearized_rad_coefficient(rad_eps_f, env_f)
    rad_hs_b = surf_mod.linearized_rad_coefficient(rad_eps_b, env_b)
    U = surf_mod.segment_u(sb, state.node_T, env_b.air)
    K = _full_system_K(sb, U, env_f, env_b, rad_hs_f, rad_hs_b, st)
    C = torch.where(sb.massive, sb.mass, 0.0)
    M1 = _stage_matrix(sb, K, C, GAMMA * dt_sub / 2.0)
    return ImplicitOperators(K, C, M1, M1, env_f, env_b, rad_hs_f, rad_hs_b, st)


def imp_substep(building, ops: ImplicitOperators, state, t_out, inputs, dt_sub, solver=None):
    """One TR-BDF2 sub-step and the exact zone update: the operators stay
    frozen, the forcing follows the current boundary air."""
    sb = building.surfaces
    st = ops.statics
    solve = solver if solver is not None else tridiag.solve
    t_front, t_back = surf_mod.boundary_temperatures(sb, state.zone_T, t_out)
    env_f = ops.env_f._replace(air=t_front)
    env_b = ops.env_b._replace(air=t_back)
    solar_q = surf_mod.absorbed_solar_q(sb, inputs.sol_front, inputs.sol_back)
    q = _substep_forcing(env_f, env_b, ops.rad_hs_f, ops.rad_hs_b, solar_q, st)
    T0 = state.node_T
    KT0 = tridiag.matvec(*ops.K, T0)
    half = GAMMA * dt_sub / 2.0
    rhs1 = torch.where(sb.node_mask, ops.C * T0 + half * KT0 + GAMMA * dt_sub * q, T0)
    T1 = solve(*ops.M1, rhs1)
    rhs2 = torch.where(sb.node_mask, C1 * ops.C * T1 - C2 * ops.C * T0 + BETA * dt_sub * q, T0)
    T = solve(*ops.M2, rhs2)
    ts_front = T[0]
    ts_back = surf_mod._last_node(sb, T, st)
    a, b, c = zone_mod.zone_abc(building, state.zone_T, env_f.h, env_b.h, ts_front, ts_back, inputs)
    zone_T, ideal_load = zone_mod.building_zone_update(
        building, state.zone_T, a, b, c, dt_sub, heat_sp=inputs.heat_sp, cool_sp=inputs.cool_sp
    )
    return SimState(
        node_T=T, zone_T=zone_T, h_front=env_f.h, h_back=env_b.h,
        q_front=(ts_front - t_front) * env_f.h, q_back=(ts_back - t_back) * env_b.h,
        ideal_load=ideal_load,
    )


def _first(v):
    v = torch.as_tensor(v)
    return v if v.ndim == 0 else v[0]


def imp_march(building, state, inputs, substeps: int, refresh_h: bool = False,
              refresh_every: int = None):
    """One main step of ``substeps`` TR-BDF2 sub-steps.  The operators are
    frozen from the step's start state and first sub-step weather;
    ``refresh_h=True`` rebuilds them every sub-step from the marching state,
    and ``refresh_every=k`` (dividing ``substeps``) at the start of every
    group of k sub-steps (k = substeps is the frozen mode, k = 1
    ``refresh_h``).  The in-run controls act at the step's start.  Weather
    may be scalars or ``[substeps]`` series (wind enters only the
    operators)."""
    from heatx_torch.engine import step as step_mod

    if substeps < 1:
        raise ValueError(f"substeps must be >= 1, got {substeps}")
    if refresh_every is not None:
        if refresh_every < 1:
            raise ValueError(f"refresh_every must be >= 1, got {refresh_every}")
        if substeps % refresh_every:
            raise ValueError(f"refresh_every {refresh_every} must divide substeps {substeps}")
    elif refresh_h:
        refresh_every = 1
    else:
        refresh_every = substeps
    inputs = step_mod.apply_state_controls(building, state, inputs)
    dt_sub = 3600.0 / building.n_steps_per_hour / substeps
    t_out = step_mod._per_substep_weather(building, inputs.t_out, substeps)
    ws = step_mod._per_substep_weather(building, inputs.wind_speed, substeps)
    wd = step_mod._per_substep_weather(building, inputs.wind_direction, substeps)
    mrt_static = None
    if building.config.interior_mrt:
        mrt_static = surf_mod.mrt_statics(building.surfaces, building.n_zones)
    st = surf_mod.compute_statics(building.surfaces)
    loads = []
    for i0 in range(0, substeps, refresh_every):
        ops = build_operators(building, state, t_out[i0], ws[i0], wd[i0], inputs, dt_sub,
                              mrt_static, st)
        for i in range(i0, i0 + refresh_every):
            state = imp_substep(building, ops, state, t_out[i], inputs, dt_sub)
            loads.append(state.ideal_load)
    return step_mod._mean_load(state, loads)

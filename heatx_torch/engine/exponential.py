"""Exponential-integrator fast mode: exact DAE reduction + matrix exponential.

PyTorch counterpart of ``heatx.engine.exponential``, the march behind
``ThermalModel.march_exp`` and ``ThermalModel.run(mode="exp")``.  With the
film coefficients, linearized radiation and cavity U-values frozen per main
step, each surface's node chain is the linear DAE

    C_m dT_m/dt = K_mm T_m + K_mn T_n + q_m      (massive nodes)
    0           = K_nm T_m + K_nn T_n + q_n      (no-mass nodes)

Eliminating the algebraic block (Schur complement) leaves a linear ODE whose
one-step solution ``T_m(t+dt) = E T_m + P q_eff`` (E = exp(A dt), P =
phi1(A dt)) is exact for any step; the no-mass nodes are recovered
algebraically.  E, P and the Schur operators are built once per main step by
batched dense ``[S, N, N]`` algebra: :func:`expm_phi1` keeps heatx's
order-8 Taylor series with 6 squarings (``torch.linalg.matrix_exp`` scales
differently and would not give heatx's numbers), and ``torch.linalg.inv``
inverts the padded no-mass blocks.  The full-system K and forcing are
``engine.implicit``'s.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from heatx_torch.engine import surface as surf_mod
from heatx_torch.engine import zone as zone_mod
from heatx_torch.engine.implicit import _full_system_K, _substep_forcing
from heatx_torch.engine.state import SimState


def _tridiag_to_dense(lower, diag, upper):
    """[N, S] tridiagonals -> [S, N, N] dense, ``lower[i]`` at ``A[i, i-1]``
    (``tridiag.matvec``'s convention)."""
    d, l, u = diag.T, lower.T, upper.T  # [S, N]
    return (
        torch.diag_embed(d) + torch.diag_embed(l[:, 1:], offset=-1)
        + torch.diag_embed(u[:, :-1], offset=1)
    )


def expm_phi1(A, order: int = 8, squarings: int = 6):
    """Batched exp(A) and phi1(A) by scaling and squaring of the Taylor
    series (E = sum B^k/k!, P = sum B^k/(k+1)! with B = A/2^s), doubled by
    ``E(2B) = E(B)^2`` and ``P(2B) = (E(B) P(B) + P(B)) / 2``."""
    N = A.shape[-1]
    eye = torch.eye(N, dtype=A.dtype, device=A.device)
    B = A / (2.0**squarings)
    E = eye + torch.zeros_like(A)
    P = eye + torch.zeros_like(A)
    term = eye + torch.zeros_like(A)
    for k in range(1, order + 1):
        term = (term @ B) / k
        E = E + term
        P = P + term / (k + 1.0)
    for _ in range(squarings):
        P = (E @ P + P) / 2.0
        E = E @ E
    return E, P


class ExpOperators(NamedTuple):
    E: torch.Tensor  # [S, N, N] exp(A_schur dt) (massive rows)
    PMq: torch.Tensor  # [S, N, N] phi1 diag(dt/C) Mq (forcing -> massive)
    M2: torch.Tensor  # [S, N, N] K_nn^-1 K_nm (massive -> algebraic)
    M3: torch.Tensor  # [S, N, N] K_nn^-1 on the algebraic block
    env_f: object
    env_b: object
    rad_hs_f: torch.Tensor
    rad_hs_b: torch.Tensor
    statics: object


def build_operators(building, state, t_out0, wind_speed0, wind_direction0, inputs, dt_sub,
                    mrt_static=None, statics=None) -> ExpOperators:
    """Freeze h, rad_hs and the cavity U-values of ``state``, eliminate the
    no-mass nodes and compute the propagators of the reduced system."""
    sb = building.surfaces
    cfg = building.config
    st = statics if statics is not None else surf_mod.compute_statics(sb)
    dtype = state.node_T.dtype
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
    Kd = _tridiag_to_dense(*_full_system_K(sb, U, env_f, env_b, rad_hs_f, rad_hs_b, st))

    m = sb.massive.T.to(dtype)  # [S, N]
    alg = (sb.node_mask & ~sb.massive).T.to(dtype)
    eyeN = torch.eye(Kd.shape[-1], dtype=dtype, device=Kd.device)
    # K_nn padded to the identity off the algebraic block: one batched
    # inverse serves every surface wherever its no-mass nodes sit.
    Knn = alg[:, :, None] * Kd * alg[:, None, :] + (1.0 - alg)[:, :, None] * eyeN
    inv_nn = torch.linalg.inv(Knn)
    K_mn = m[:, :, None] * Kd * alg[:, None, :]
    K_nm = alg[:, :, None] * Kd * m[:, None, :]
    mm = K_mn @ inv_nn
    A_red = m[:, :, None] * Kd * m[:, None, :] - mm @ K_nm
    # Mq maps the raw forcing to the reduced one, q_m - K_mn K_nn^-1 q_n.
    Mq = m[:, :, None] * eyeN - mm * alg[:, None, :]
    mass = sb.mass.T
    scale = torch.where(m > 0, dt_sub / torch.where(m > 0, mass, 1.0), 0.0)
    E, P = expm_phi1(scale[:, :, None] * A_red)
    # phi1's identity rows on frozen nodes must not inject forcing there.
    PMq = m[:, :, None] * (P @ (scale[:, :, None] * Mq))
    M2 = alg[:, :, None] * (inv_nn @ K_nm)
    M3 = alg[:, :, None] * inv_nn * alg[:, None, :]
    return ExpOperators(E, PMq, M2, M3, env_f, env_b, rad_hs_f, rad_hs_b, st)


def exp_substep(building, ops: ExpOperators, state, t_out, inputs, dt_sub):
    """One fast sub-step: the forcing from the current boundary air, the
    massive nodes propagated exactly, the no-mass nodes recovered, the zones
    updated.  The operators stay frozen."""
    sb = building.surfaces
    st = ops.statics
    t_front, t_back = surf_mod.boundary_temperatures(sb, state.zone_T, t_out)
    env_f = ops.env_f._replace(air=t_front)
    env_b = ops.env_b._replace(air=t_back)
    solar_q = surf_mod.absorbed_solar_q(sb, inputs.sol_front, inputs.sol_back)
    q = _substep_forcing(env_f, env_b, ops.rad_hs_f, ops.rad_hs_b, solar_q, st)
    qs = q.T[:, :, None]  # [S, N, 1]
    T_m = (ops.E @ state.node_T.T[:, :, None] + ops.PMq @ qs)[:, :, 0]
    T = torch.where(sb.massive, T_m.T, state.node_T)
    # The algebraic recovery T_n = -K_nn^-1 (K_nm T_m + q_n), exact.
    T_n = -(ops.M2 @ T.T[:, :, None] + ops.M3 @ qs)[:, :, 0]
    T = torch.where(sb.node_mask & ~sb.massive, T_n.T, T)
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


def exp_march(building, state, inputs, substeps: int):
    """One main step: the in-run controls at its start, the operators frozen
    from its start state and first sub-step weather, then ``substeps`` exact
    sub-steps.  Weather may be scalars or ``[substeps]`` series."""
    from heatx_torch.engine import step as step_mod

    if substeps < 1:
        raise ValueError(f"substeps must be >= 1, got {substeps}")
    inputs = step_mod.apply_state_controls(building, state, inputs)
    dt_sub = 3600.0 / building.n_steps_per_hour / substeps
    t_out = step_mod._per_substep_weather(building, inputs.t_out, substeps)
    ws = step_mod._per_substep_weather(building, inputs.wind_speed, substeps)
    wd = step_mod._per_substep_weather(building, inputs.wind_direction, substeps)
    ops = build_operators(building, state, t_out[0], ws[0], wd[0], inputs, dt_sub)
    loads = []
    for i in range(substeps):
        state = exp_substep(building, ops, state, t_out[i], inputs, dt_sub)
        loads.append(state.ideal_load)
    return step_mod._mean_load(state, loads)

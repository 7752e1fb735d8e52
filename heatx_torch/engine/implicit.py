"""TR-BDF2 operators on the fully-coupled node system.

PyTorch twin of the operator pieces of ``heatx.engine.implicit`` (the scheme
constants and the stage matrix) and of ``heatx.engine.exponential``'s
full-system K and forcing, which the implicit day march shares.

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

import torch

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

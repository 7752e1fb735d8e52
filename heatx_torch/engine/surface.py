"""Per-surface boundary physics on node-major ``[N, S]`` torch tensors.

PyTorch twin of the parts of ``heatx.engine.surface`` that the TR-BDF2 day
march uses: the node-network masks, the last-node read, the outdoor radiant
temperatures, the TARP border conditions, the linearized radiation
coefficient, the segment U-values (no gas cavities) and the absorbed solar
forcing.  The parity integrator's pieces (``assemble_K``/``assemble_q``,
``march_nomass``, ``march_massive``) and the interior MRT network are ROADMAP
items A7 and A9.

``sb`` is any object with the ``SurfaceBatch`` attribute names holding
tensors; ``normal`` is an ``(nx, ny)`` pair of ``[S]`` tensors, as on heatx's
kernel path.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from heatx_torch.build.layout import B_AMBIENT, B_OUTDOOR
from heatx_torch.config import SimConfig
from heatx_torch.constants import KELVIN, SIGMA
from heatx_torch.physics.convection import (
    is_windward,
    tarp_natural_coeffs,
    tarp_natural_convection_coefficient,
)


class FaceEnv(NamedTuple):
    """ConvectionParams of one face of every surface (convection.rs:27-52)
    plus the resolved convection coefficient."""

    air: torch.Tensor  # [S] air temperature, C
    rad: torch.Tensor  # [S] radiant temperature, C
    surf: torch.Tensor  # [S] surface temperature used for h / rad_hs, C
    h: torch.Tensor  # [S] convection coefficient, W/m2.K


class SurfaceStatics(NamedTuple):
    """Loop-invariant mask structure of the node network."""

    left_exists: torch.Tensor  # [N, S] node i-1 exists
    right_exists: torch.Tensor  # [N, S] node i+1 exists
    is_first: torch.Tensor  # [N, S] node 0 of its surface
    is_last: torch.Tensor  # [N, S] last valid node of its surface
    nat_coeffs: tuple  # ([S], [S]) TARP branch coefficients


def _shift_prev(mask):
    """mask[i-1] (False for i=0)."""
    return torch.cat([torch.zeros_like(mask[:1]), mask[:-1]], dim=0)


def _shift_next(mask):
    """mask[i+1] (False for i=N-1)."""
    return torch.cat([mask[1:], torch.zeros_like(mask[:1])], dim=0)


def compute_statics(sb) -> SurfaceStatics:
    """Node-network masks of ``sb.node_mask`` (heatx compute_statics; the
    chunk and parity-path hoists are not on this path)."""
    valid = sb.node_mask
    left_exists = _shift_prev(valid) & valid
    right_exists = _shift_next(valid) & valid
    return SurfaceStatics(
        left_exists=left_exists,
        right_exists=right_exists,
        is_first=valid & ~left_exists,
        is_last=valid & ~right_exists,
        nat_coeffs=tarp_natural_coeffs(sb.cos_tilt),
    )


def _last_node(sb, T, statics: SurfaceStatics = None):
    """T at each surface's last valid node: [S] (masked sum over nodes)."""
    if statics is not None:
        is_last = statics.is_last
    else:
        valid = sb.node_mask
        is_last = valid & ~_shift_next(valid)
    return torch.where(is_last, T, torch.zeros_like(T)).sum(dim=0)


def radiant_out_temperatures(ir_front, ir_back):
    """Outdoor radiant temperatures from incident IR:
    (ir/sigma)^0.25 - 273.15 (surface.rs:611-702)."""
    rad_out_front = torch.pow(torch.clamp_min(ir_front, 1e-30) / SIGMA, 0.25) - KELVIN
    rad_out_back = torch.pow(torch.clamp_min(ir_back, 1e-30) / SIGMA, 0.25) - KELVIN
    return rad_out_front, rad_out_back


def forced_context(sb, wind_direction, wind_speed):
    """Forced-convection terms (convection.rs:151-168): zero on faces that
    are not outdoor.  Returns (forced_front, forced_back), each [S]."""
    normal_x, normal_y = sb.normal
    windward = is_windward(wind_direction, sb.cos_tilt, normal_x, normal_y)
    wf = torch.where(windward, 1.0, 0.5).to(sb.area.dtype)
    pva = sb.perimeter * (wind_speed * sb.wind_mod) / sb.area
    pnz = pva > 0.0
    base = 2.537 * wf * sb.rf * torch.where(
        pnz, torch.sqrt(torch.where(pnz, pva, torch.ones_like(pva))), torch.zeros_like(pva)
    )
    zero = torch.zeros_like(base)
    forced_front = torch.where(sb.front_code == B_OUTDOOR, base, zero)
    forced_back = torch.where(sb.back_code == B_OUTDOOR, base, zero)
    return forced_front, forced_back


def border_conditions(
    sb,
    T,
    t_front,
    t_back,
    wind_direction,
    wind_speed,
    ir_front,
    ir_back,
    config: SimConfig,
    statics: SurfaceStatics = None,
):
    """Front/back ConvectionParams + h for every surface
    (surface.rs:596-717 calc_border_conditions), from the state ``T``.

    Space and ambient faces: air = rad = the boundary temperature, natural
    convection only.  Outdoor faces: radiant temperature from the incident
    IR, forced + natural convection; the front face flips the tilt cosine.
    With ``config.replicate_ambient_back_bug`` (default), a back-side ambient
    boundary reuses the front surface temperature and the front boundary
    temperature as radiant temperature (surface.rs:672-686).
    """
    if statics is None:
        statics = compute_statics(sb)
    front_surf = T[0]
    back_surf = _last_node(sb, T, statics)

    f_out = sb.front_code == B_OUTDOOR
    b_out = sb.back_code == B_OUTDOOR
    b_amb = sb.back_code == B_AMBIENT
    rad_out_front, rad_out_back = radiant_out_temperatures(ir_front, ir_back)

    front_rad = torch.where(f_out, rad_out_front, t_front)
    front_cos = torch.where(f_out, -sb.cos_tilt, sb.cos_tilt)

    if config.replicate_ambient_back_bug:
        amb_rad, amb_surf = t_front, front_surf
    else:
        amb_rad, amb_surf = t_back, back_surf
    back_rad = torch.where(b_out, rad_out_back, torch.where(b_amb, amb_rad, t_back))
    back_surf_eff = torch.where(b_amb, amb_surf, back_surf)

    forced_front, forced_back = forced_context(sb, wind_direction, wind_speed)
    coeffs = statics.nat_coeffs
    h_front = (
        tarp_natural_convection_coefficient(t_front, front_surf, front_cos, coeffs)
        + forced_front
    )
    h_back = (
        tarp_natural_convection_coefficient(t_back, back_surf_eff, sb.cos_tilt, coeffs)
        + forced_back
    )
    # Debug/test override (surface.rs:374-381), also the ground-contact h.
    h_front = torch.where(torch.isnan(sb.fixed_h_front), h_front, sb.fixed_h_front)
    h_back = torch.where(torch.isnan(sb.fixed_h_back), h_back, sb.fixed_h_back)
    return (
        FaceEnv(t_front, front_rad, front_surf, h_front),
        FaceEnv(t_back, back_rad, back_surf_eff, h_back),
    )


def linearized_rad_coefficient(eps, env: FaceEnv):
    """rad_hs = 4 eps sigma (273.15 + (T_rad + T_s)/2)^3 (surface.rs:941-948)."""
    x = KELVIN + (env.rad + env.surf) / 2.0
    return 4.0 * eps * SIGMA * (x * x * x)


def segment_u(sb, T, back_air):
    """Per-segment U-value (discretization.rs:46-56).  Without gas cavities it
    is the static ``seg_u``; the temperature-dependent cavity U is ROADMAP
    item B5."""
    if sb.has_cavity:
        raise NotImplementedError(
            "gas cavities in the day march are ROADMAP item B5 (not ported yet)"
        )
    return sb.seg_u


def absorbed_solar_q(sb, sol_front, sol_back):
    """Per-node absorbed solar forcing with the reference's clamping quirks
    (surface.rs:916-931): the front irradiance is zeroed when NaN or
    negative, the back one only when NaN."""
    zero_f = torch.zeros_like(sol_front)
    sol_f = torch.where(torch.isnan(sol_front) | (sol_front < 0.0), zero_f, sol_front)
    sol_b = torch.where(torch.isnan(sol_back), torch.zeros_like(sol_back), sol_back)
    return sb.front_alphas * sol_f + sb.back_alphas * sol_b

"""Per-surface boundary physics on node-major ``[N, S]`` torch tensors.

PyTorch twin of the parts of ``heatx.engine.surface`` that the day march
uses: the node-network masks, the last-node read, the outdoor radiant
temperatures, the TARP border conditions, the linearized radiation
coefficient, the segment U-values (with the ISO 15099 U-value of gas
cavities at the working temperatures), the absorbed solar forcing, and the
reference-parity integrator: ``assemble_K``/``assemble_q``, the relaxed
no-mass solve ``march_nomass``, the RK4 march
``march_massive`` and ``march_surfaces``, one sub-step of every surface.

heatx keeps two forms of the K/q assembly, inline and hoisted into its
statics, proven bit-identical and selected by identity guards on ``U``, ``K``
and ``sb.has_cavity``; the port has the inline form only.  With gas cavities
the parity integrator re-evaluates U, K and q on every no-mass iteration and
again on the post-no-mass column before RK4, as heatx does.  The adaptive
no-mass loop (``nomass_fixed_iters=None``) is ROADMAP B6/A10.

Interior longwave exchange (``config.interior_mrt``): Carroll's MRT network,
``carroll_view_factors``, ``mrt_statics``, ``interior_mrt``, ``zone_mrt`` and
``apply_interior_mrt``, with zone sums by ``index_add_`` where heatx takes
``segment_sum``.  They read ``sb.front_space``/``sb.back_space`` [S].

``sb`` is any object with the ``SurfaceBatch`` attribute names holding
tensors; ``normal`` is an ``(nx, ny)`` pair of ``[S]`` tensors, as on heatx's
kernel path.  The parity functions also read ``sb.massive``/``sb.mass``
[N, S], ``sb.same_chunk`` [N, S], ``sb.nomass_chunk_id`` [N, S],
``sb.nomass_chunk_count`` [C, S] and the static ``sb.max_nomass_run``;
with ``sb.has_cavity`` also ``sb.seg_is_cavity`` [N, S], ``sb.cav_gas`` (a
``GasProps`` of [N, S] tensors) and ``sb.cav_thickness``/``cav_height``/
``cav_angle``/``cav_ein``/``cav_eout`` [N, S], and optionally
``sb.cav_index`` (:func:`cavity_index` of the mask, kept by the caller).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch

from heatx_torch.build.layout import B_AMBIENT, B_GROUND, B_OUTDOOR, B_SPACE
from heatx_torch.config import SimConfig
from heatx_torch.constants import KELVIN, SIGMA
from heatx_torch.ops import tridiag
from heatx_torch.physics.cavity import cavity_u_value
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
    # The chunk structure the parity integrator reads; None when ``sb``
    # carries no chunk data (the TR-BDF2 march).
    couple_left: torch.Tensor = None  # [N, S] coupled to node i-1 within its chunk
    couple_right: torch.Tensor = None  # [N, S]
    dirichlet_left: torch.Tensor = None  # [N, S] left neighbour is a frozen source
    dirichlet_right: torch.Tensor = None  # [N, S]
    nomass_sel: torch.Tensor = None  # [N, S] valid no-mass node
    chunk_masks: tuple = None  # C x [N, S] per-chunk node masks
    pair_head: torch.Tensor = None  # [N, S] no-mass node coupled to node i+1
    pair_tail: torch.Tensor = None  # [N, S] its partner


def _shift_prev(mask):
    """mask[i-1] (False for i=0)."""
    return torch.cat([torch.zeros_like(mask[:1]), mask[:-1]], dim=0)


def _shift_next(mask):
    """mask[i+1] (False for i=N-1)."""
    return torch.cat([mask[1:], torch.zeros_like(mask[:1])], dim=0)


def compute_statics(sb) -> SurfaceStatics:
    """Node-network masks of ``sb.node_mask`` and, where ``sb`` has
    ``same_chunk``, the chunk structure (heatx compute_statics without its
    static-U and dt/C hoists)."""
    valid = sb.node_mask
    left_exists = _shift_prev(valid) & valid
    right_exists = _shift_next(valid) & valid
    chunks = {}
    if getattr(sb, "same_chunk", None) is not None:
        couple_left = left_exists & _shift_prev(sb.same_chunk)
        couple_right = right_exists & sb.same_chunk
        sel = valid & ~sb.massive
        # 2-node no-mass runs: couple_right stays within a chunk and chunks
        # are homogeneous in massiveness.
        pair_head = couple_right & sel
        chunks = dict(
            couple_left=couple_left,
            couple_right=couple_right,
            dirichlet_left=left_exists & ~couple_left,
            dirichlet_right=right_exists & ~couple_right,
            nomass_sel=sel,
            chunk_masks=tuple(
                (sb.nomass_chunk_id == c) & sel for c in range(sb.nomass_chunk_count.shape[0])
            ),
            pair_head=pair_head,
            pair_tail=_shift_prev(pair_head),
        )
    return SurfaceStatics(
        left_exists=left_exists,
        right_exists=right_exists,
        is_first=valid & ~left_exists,
        is_last=valid & ~right_exists,
        nat_coeffs=tarp_natural_coeffs(sb.cos_tilt),
        **chunks,
    )


def boundary_temperatures(sb, zone_T, t_out):
    """Air temperature on each side of each surface (model.rs:79-96
    get_boundary_temperature): outdoor air, the air of the zone a space face
    bounds, or the fixed temperature of an ambient or ground boundary."""
    zone_padded = torch.cat([zone_T, zone_T.new_zeros(1)])
    t_out = torch.as_tensor(t_out, dtype=zone_T.dtype, device=zone_T.device)

    def side(code, space, temp):
        t = torch.where(code == B_OUTDOOR, t_out, torch.zeros_like(temp))
        t = torch.where(code == B_SPACE, zone_padded[space.long()], t)
        return torch.where((code == B_AMBIENT) | (code == B_GROUND), temp, t)

    return side(sb.front_code, sb.front_space, sb.front_temp), side(sb.back_code, sb.back_space, sb.back_temp)


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
    rad_out=None,
    forced=None,
):
    """Front/back ConvectionParams + h for every surface
    (surface.rs:596-717 calc_border_conditions), from the state ``T``.
    ``rad_out`` passes the hour's :func:`radiant_out_temperatures` and
    ``forced`` the sub-step's :func:`forced_context`, which the parity
    sub-step shares between its two evaluations.

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
    if rad_out is None:
        rad_out = radiant_out_temperatures(ir_front, ir_back)
    rad_out_front, rad_out_back = rad_out

    front_rad = torch.where(f_out, rad_out_front, t_front)
    front_cos = torch.where(f_out, -sb.cos_tilt, sb.cos_tilt)

    if config.replicate_ambient_back_bug:
        amb_rad, amb_surf = t_front, front_surf
    else:
        amb_rad, amb_surf = t_back, back_surf
    back_rad = torch.where(b_out, rad_out_back, torch.where(b_amb, amb_rad, t_back))
    back_surf_eff = torch.where(b_amb, amb_surf, back_surf)

    if forced is None:
        forced = forced_context(sb, wind_direction, wind_speed)
    forced_front, forced_back = forced
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
    """Per-segment U-value at the working temperatures ``T``
    (discretization.rs:46-56): the static ``seg_u``, and on a gas-cavity
    segment the ISO 15099 cavity U of its two bounding node temperatures.
    Segment i joins nodes i and i+1; past a surface's last node the 'next'
    temperature is the back air (a cavity never sits there).  The cavity U
    is evaluated on the cavity segments only, gathered by their flat indices
    (``sb.cav_index`` where the caller keeps them, so that no step waits on
    the device): heatx evaluates it everywhere and selects, and on the other
    segments (all-zero gas operands) it is 0/0, which a ``where`` keeps out
    of the value but not out of autograd's products.  seg_u's cotangent on a
    cavity segment is exactly 0."""
    if not sb.has_cavity:
        return sb.seg_u
    t_next = torch.cat([T[1:], torch.zeros_like(T[:1])], dim=0)
    t_next = torch.where(_shift_next(sb.node_mask), t_next, back_air)
    idx = getattr(sb, "cav_index", None)
    if idx is None:
        idx = cavity_index(sb.seg_is_cavity)

    def at(x):
        return x.reshape(-1).index_select(0, idx)

    u_cav = cavity_u_value(
        type(sb.cav_gas)(*(at(f) for f in sb.cav_gas)), at(sb.cav_thickness), at(sb.cav_height),
        at(sb.cav_angle), at(sb.cav_ein), at(sb.cav_eout), at(T), at(t_next),
    )
    return sb.seg_u.reshape(-1).index_copy(0, idx, u_cav).reshape(sb.seg_u.shape)


def cavity_index(seg_is_cavity):
    """The flat indices of the gas-cavity segments of an [N, S] mask."""
    return seg_is_cavity.reshape(-1).nonzero().squeeze(1)


def absorbed_solar_q(sb, sol_front, sol_back):
    """Per-node absorbed solar forcing with the reference's clamping quirks
    (surface.rs:916-931): the front irradiance is zeroed when NaN or
    negative, the back one only when NaN."""
    zero_f = torch.zeros_like(sol_front)
    sol_f = torch.where(torch.isnan(sol_front) | (sol_front < 0.0), zero_f, sol_front)
    sol_b = torch.where(torch.isnan(sol_back), torch.zeros_like(sol_back), sol_back)
    return sb.front_alphas * sol_f + sb.back_alphas * sol_b


# ---------------------------------------------------------------------------
# The reference-parity integrator
# ---------------------------------------------------------------------------


def _row_prev(x):
    """x[i-1] over axis 0, a zero row first."""
    return torch.cat([torch.zeros_like(x[:1]), x[:-1]], dim=0)


def _row_next(x):
    """x[i+1] over axis 0, a zero row last."""
    return torch.cat([x[1:], torch.zeros_like(x[:1])], dim=0)


def segment_sum(x, idx, n: int):
    """Sums of ``x`` over the segments ``idx`` (jax.ops.segment_sum), [n]."""
    return torch.zeros(n, dtype=x.dtype, device=x.device).index_add_(0, idx, x)


def carroll_view_factors(area, space, participating, n_zones, iters=20):
    """Carroll (1980) MRT-network view factors, one per participating face:
    ``F_i = 1 / (1 - A_i F_i / sum_{j in zone} A_j F_j)`` by the fixed point
    from ``F = 1``, the denominator clamped at 0.05 (a face that holds most
    of its zone's weighted area saturates).  Non-participating faces get 0."""
    idx = torch.where(participating, space, n_zones).long()
    F = torch.ones_like(area)
    for _ in range(iters):
        af = torch.where(participating, area * F, 0.0)
        tot = segment_sum(af, idx, n_zones + 1)
        denom = 1.0 - af / torch.clamp_min(tot[idx], 1e-30)
        F = 1.0 / torch.clamp_min(denom, 0.05)
    return torch.where(participating, F, 0.0)


def mrt_statics(sb, n_zones):
    """The static part of the Carroll network over the [2S] (front, back)
    faces: ``(part, idx, eps_eff)``, the participation mask (a face bounds a
    space, emits, and its zone has at least two such faces), the zone index
    (``n_zones`` off the network) and the effective emissivity
    ``eps F / (F (1 - eps) + eps)`` (0 off the network)."""
    part = torch.cat([
        (sb.front_code == B_SPACE) & (sb.eps_front > 1e-6),
        (sb.back_code == B_SPACE) & (sb.eps_back > 1e-6),
    ])
    area = torch.cat([sb.area, sb.area])
    space = torch.cat([sb.front_space, sb.back_space]).long()
    eps = torch.cat([sb.eps_front, sb.eps_back])
    idx = torch.where(part, space, n_zones)
    count = segment_sum(part.to(area.dtype), idx, n_zones + 1)
    part = part & (count[idx] >= 1.5)
    idx = torch.where(part, space, n_zones)
    F = carroll_view_factors(area, space, part, n_zones)
    # The masked branch is guarded: F = eps = 0 off the network would make
    # the quotient 0/0, whose NaN autograd carries through the where.
    den = torch.where(part, F * (1.0 - eps) + eps, 1.0)
    eps_eff = torch.where(part, eps * F / den, 0.0)
    return part, idx, eps_eff


def mrt_fixed_point(ts, area, part, idx, eps_eff, tm_face, z_fallback):
    """The 4-iteration linearized fixed point of the MRT node: each face's
    conductance ``4 sigma eps_eff (K + (tm_face + ts)/2)^3 A`` toward its
    zone's node, the node at the conductance-weighted mean of its faces'
    temperatures ``ts``, ``z_fallback`` where a zone has no conductance.
    ``idx`` is each face's zone (``len(z_fallback)`` off the network),
    ``tm_face`` the linearization's start.  Returns ``(tm [Z], tm_face)``."""
    n = z_fallback.shape[0]
    zpad = torch.cat([z_fallback, z_fallback.new_zeros(1)])
    tm = z_fallback
    for _ in range(4):
        x = KELVIN + (tm_face + ts) / 2.0
        w = torch.where(part, 4.0 * SIGMA * eps_eff * (x * x * x) * area, 0.0)
        num = segment_sum(w * ts, idx, n + 1)
        den = segment_sum(w, idx, n + 1)
        tm = torch.where(den > 1e-30, num / torch.clamp_min(den, 1e-30), zpad)
        tm_face = tm[idx]
        tm = tm[:n]
    return tm, tm_face


def _mrt_solve(sb, node_T, zone_T, n_zones, statics=None, mrt_static=None):
    """The Carroll network over the [2S] (front, back) faces from the state
    (``interior_mrt``): ``(part, idx, eps_eff, ts, tm [Z], tm_face [2S])``,
    the linearization started at the zone air temperature."""
    ts = torch.cat([node_T[0], _last_node(sb, node_T, statics)])
    if mrt_static is None:
        mrt_static = mrt_statics(sb, n_zones)
    part, idx, eps_eff = mrt_static
    area = torch.cat([sb.area, sb.area])
    zpad = torch.cat([zone_T, zone_T.new_zeros(1)])
    tm, tm_face = mrt_fixed_point(ts, area, part, idx, eps_eff, zpad[idx], zone_T)
    return part, idx, eps_eff, ts, tm, tm_face


def interior_mrt(sb, node_T, zone_T, n_zones, statics=None, mrt_static=None):
    """Interior longwave exchange context (``config.interior_mrt``): every
    participating face exchanges with its zone's MRT node, from the current
    state, through its effective emissivity.  Returns ``(mask_f, tm_f,
    eps_f, mask_b, tm_b, eps_b)`` [S] each (masks False off the network)."""
    part, _, eps_eff, _, _, tm_face = _mrt_solve(sb, node_T, zone_T, n_zones, statics, mrt_static)
    S = sb.area.shape[0]
    return part[:S], tm_face[:S], eps_eff[:S], part[S:], tm_face[S:], eps_eff[S:]


def zone_mrt(sb, node_T, zone_T, n_zones, statics=None, mrt_static=None):
    """Per-zone mean radiant temperature [Z] of a state, the Carroll node of
    :func:`interior_mrt` as an observable (zone air where a zone has no
    network).  Operative temperature is ``(zone_T + zone_mrt) / 2``."""
    return _mrt_solve(sb, node_T, zone_T, n_zones, statics, mrt_static)[4]


def apply_interior_mrt(sb, env_f: FaceEnv, env_b: FaceEnv, mrt):
    """Merge an :func:`interior_mrt` context into the face environments:
    participating faces take the zone's MRT as radiant temperature and their
    effective emissivity; the film coefficients are unchanged, and
    ``mrt=None`` is the identity.  Returns ``(env_f, env_b, eps_front,
    eps_back)``."""
    if mrt is None:
        return env_f, env_b, sb.eps_front, sb.eps_back
    mf, tmf, ef, mb, tmb, eb = mrt
    env_f = env_f._replace(rad=torch.where(mf, tmf, env_f.rad))
    env_b = env_b._replace(rad=torch.where(mb, tmb, env_b.rad))
    return env_f, env_b, torch.where(mf, ef, sb.eps_front), torch.where(mb, eb, sb.eps_back)


def assemble_K(sb, U, env_f: FaceEnv, env_b: FaceEnv, statics: SurfaceStatics = None):
    """The tridiagonal K of discretization.rs:596-700 for all nodes, as
    ``(lower, diag, upper)``: the U couplings within a chunk off the
    diagonal; on it every neighbour's U and the faces' film coefficients.
    Constant within a sub-step (h is frozen per sub-step, U is static)."""
    st = statics if statics is not None else compute_statics(sb)
    zero = torch.zeros_like(U)
    U_left = _row_prev(U)
    diag = -(
        torch.where(st.left_exists, U_left, zero)
        + torch.where(st.right_exists, U, zero)
        + torch.where(st.is_first, env_f.h + zero, zero)
        + torch.where(st.is_last, env_b.h + zero, zero)
    )
    return torch.where(st.couple_left, U_left, zero), diag, torch.where(st.couple_right, U, zero)


def assemble_q(sb, T, U, env_f: FaceEnv, env_b: FaceEnv, rad_hs_f, rad_hs_b, solar_q, statics=None):
    """The forcing q of discretization.rs:596-700 at the working
    temperatures ``T``: absorbed solar, the faces' convection and linearized
    radiation, and the couplings across chunk boundaries as frozen Dirichlet
    sources."""
    st = statics if statics is not None else compute_statics(sb)
    zero = torch.zeros_like(U)
    return (
        solar_q
        + torch.where(st.is_first, env_f.air * env_f.h + rad_hs_f * (env_f.rad - T), zero)
        + torch.where(st.is_last, env_b.air * env_b.h + rad_hs_b * (env_b.rad - T), zero)
        + torch.where(st.dirichlet_left, _row_prev(U) * _row_prev(T), zero)
        + torch.where(st.dirichlet_right, U * _row_next(T), zero)
    )


def assemble_k_q(sb, T, U, env_f, env_b, rad_hs_f, rad_hs_b, solar_q, statics=None):
    """``(lower, diag, upper, q)`` of :func:`assemble_K` and :func:`assemble_q`."""
    st = statics if statics is not None else compute_statics(sb)
    lower, diag, upper = assemble_K(sb, U, env_f, env_b, st)
    return lower, diag, upper, assemble_q(sb, T, U, env_f, env_b, rad_hs_f, rad_hs_b, solar_q, st)


def _ftz(x, threshold=1e-25):
    """Flush magnitudes below ``threshold`` to zero."""
    return torch.where(torch.abs(x) < threshold, torch.zeros_like(x), x)


#: Names of the gradient refusal for the adaptive no-mass loop (heatx
#: pallas_adjoint.py:156-161): the loop's data-dependent stop has no
#: reverse-mode rule, in heatx (``lax.while_loop``) or here.
ADAPTIVE_GRAD_REFUSAL = (
    "parity adjoint requires config.nomass_fixed_iters (the adaptive while_loop fixed point "
    "has no reverse-mode rule; the fixed-iteration composition unrolls instead)"
)

#: The recorders :func:`record_nomass_stops` installs (a stack, innermost last).
_STOP_RECORDERS = []


class NomassStops:
    """What :func:`march_nomass` reports while installed
    (``with record_nomass_stops() as rec:``): per call, ``rec.iters`` gets
    the ``[C, S]`` count of iterations each no-mass run stayed active (0 on
    an absent run; with the adaptive loop the iteration at which the run
    stopped), ``rec.counts`` the ``[C, S]`` run lengths, ``rec.broke`` the
    ``[C, S]`` runs stopped by the error-increase break, ``rec.closest``
    the ``[C, S]`` distance (K) of each run's closest stop decision to its
    threshold (the mean error to the tolerance, or the error to the last
    accepted one; inf where the run took none), and ``rec.loops`` the number
    of iterations the call ran.  The tensors stay on their device until
    read."""

    def __init__(self):
        self.iters, self.counts, self.broke, self.closest, self.loops = [], [], [], [], []

    def __enter__(self):
        _STOP_RECORDERS.append(self)
        return self

    def __exit__(self, *exc):
        _STOP_RECORDERS.remove(self)

    def stacked(self):
        """``(iters, present, broke, closest)``, each ``[calls, C, S]`` numpy."""
        it = torch.stack(self.iters).cpu().numpy()
        return (it, torch.stack(self.counts).cpu().numpy() > 0,
                torch.stack(self.broke).cpu().numpy(), torch.stack(self.closest).cpu().numpy())


def record_nomass_stops() -> NomassStops:
    """A context manager that records the no-mass runs' stopping iterations
    of every :func:`march_nomass` call made inside it, and how close each
    run's stop decisions came to their thresholds (:class:`NomassStops`)."""
    return NomassStops()


def march_nomass(
    sb, T0, env_f: FaceEnv, env_b: FaceEnv, rad_hs_f, rad_hs_b, solar_q, config: SimConfig,
    solver=None, statics: SurfaceStatics = None, K=None,
):
    """The relaxed fixed-point solve of all no-mass chunks (surface.rs:790-898):
    iterations of ``T <- (T + T_solve)/2`` on the steady-state system
    ``K x = -q(T)``, with the per-chunk convergence test on the mean |dT|
    (``nomass_tol``, escalated after ``nomass_escalate_after`` iterations) and
    the reference's error-increase break, which discards the increasing
    update.  One iteration is one relaxed solve on every valid no-mass node.

    ``config.nomass_fixed_iters`` runs that many iterations; None runs heatx's
    adaptive loop: iterate while any chunk is active and fewer than
    ``nomass_max_iter`` iterations have run.  The loop stops on a host check
    of ``active.any()`` (one synchronize per iteration on a GPU).  Autograd
    through the adaptive loop raises (heatx has no reverse rule for it).

    ``solver(lower, diag, upper, rhs)`` defaults to the Thomas solve; when
    every no-mass run has at most 2 nodes (``sb.max_nomass_run``) the
    closed-form pair solve takes its place, whatever the caller supplied.
    ``K`` is the sub-step's K where U is static; with gas cavities each
    iteration assembles K and q at its own U (and ``K`` is not read).
    """
    adaptive = config.nomass_fixed_iters is None
    if adaptive and torch.is_grad_enabled() and any(
        isinstance(x, torch.Tensor) and x.requires_grad
        for x in (T0, rad_hs_f, rad_hs_b, solar_q, sb.seg_u, *env_f, *env_b)
    ):
        raise ValueError(ADAPTIVE_GRAD_REFUSAL)
    st = statics if statics is not None else compute_statics(sb)
    sel = st.nomass_sel
    chunk_n = sb.nomass_chunk_count
    chunk_masks = st.chunk_masks
    if solver is None:
        solver = tridiag.solve
    if 0 < sb.max_nomass_run <= 2:
        solver = partial(tridiag.solve_runs2, pair_head=st.pair_head, pair_tail=st.pair_tail)

    zero, one = torch.zeros_like(T0), torch.ones_like(T0)

    def one_iteration(T, K):
        U = segment_u(sb, T, env_b.air)
        if K is None:
            K = assemble_K(sb, U, env_f, env_b, st)
        q = assemble_q(sb, T, U, env_f, env_b, rad_hs_f, rad_hs_b, solar_q, st)
        return solver(
            torch.where(sel, K[0], zero), torch.where(sel, K[1], one),
            torch.where(sel, K[2], zero), torch.where(sel, -q, T),
        )

    if sb.has_cavity:
        K = None
    elif K is None:
        K = assemble_K(sb, sb.seg_u, env_f, env_b, st)

    recorders = list(_STOP_RECORDERS)
    if config.nomass_fixed_iters == 1:
        for r in recorders:
            r.iters.append((chunk_n > 0).to(chunk_n.dtype))
            r.counts.append(chunk_n)
            r.broke.append(torch.zeros_like(chunk_n, dtype=torch.bool))
            r.closest.append(torch.full_like(chunk_n, torch.inf))
            r.loops.append(1)
        return torch.where(sel, 0.5 * (T0 + one_iteration(T0, K)), T0)

    T = T0
    old_err = torch.full_like(chunk_n, 99999.0)
    count = torch.zeros_like(chunk_n)
    active = chunk_n > 0
    if recorders:
        ran, broke, closest = torch.zeros_like(chunk_n), torch.zeros_like(active), torch.full_like(chunk_n, torch.inf)
    it, cap = 0, config.nomass_max_iter if adaptive else config.nomass_fixed_iters
    while it < cap and (not adaptive or bool(active.any())):
        T_sol = one_iteration(T, K)
        err_node = _ftz(torch.where(sel, torch.abs(T_sol - T), zero))
        err_chunk = torch.stack(
            [torch.where(m, err_node, zero).sum(dim=0) for m in chunk_masks], dim=0
        )  # [C, S]
        increase = err_chunk > old_err
        upd_chunk = active & ~increase
        upd_node = torch.zeros_like(sel)
        for m, u in zip(chunk_masks, upd_chunk):
            upd_node = upd_node | (m & u)
        T = torch.where(upd_node, 0.5 * (T + T_sol), T)
        tol = torch.where(
            count < config.nomass_escalate_after,
            torch.full_like(count, config.nomass_tol),
            torch.full_like(count, config.nomass_tol_escalated),
        )
        converged = err_chunk / torch.clamp_min(chunk_n, 1.0) < tol
        if recorders:
            ran = ran + active.to(ran.dtype)
            broke = broke | (active & increase)
            gap = torch.minimum((err_chunk / torch.clamp_min(chunk_n, 1.0) - tol).abs(), (err_chunk - old_err).abs())
            closest = torch.where(active, torch.minimum(closest, gap), closest)
        active = active & ~increase & ~converged
        old_err = torch.where(upd_chunk, err_chunk, old_err)
        count = count + active.to(count.dtype)
        it += 1
    for r in recorders:
        r.iters.append(ran)
        r.counts.append(chunk_n)
        r.broke.append(broke)
        r.closest.append(closest)
        r.loops.append(it)
    return T


def rk4_apply(lower, diag, upper, q, T, flush_tiny: bool = True):
    """Classic RK4 update for dT = K'T + q' with K', q' pre-scaled by dt/C
    (surface.rs:228-308)."""
    mv = partial(tridiag.matvec, lower, diag, upper)
    ftz = _ftz if flush_tiny else (lambda x: x)
    k1 = ftz(mv(T) + q)
    k2 = ftz(mv(T + 0.5 * k1) + q)
    k3 = ftz(mv(T + 0.5 * k2) + q)
    k4 = ftz(mv(T + k3) + q)
    return T + k1 / 6.0 + k2 / 3.0 + k3 / 3.0 + k4 / 6.0


def march_massive(
    sb, T, env_f: FaceEnv, env_b: FaceEnv, rad_hs_f, rad_hs_b, solar_q, dt,
    statics: SurfaceStatics = None, K=None, flush_tiny: bool = True,
):
    """RK4 march of all massive chunks (surface.rs:720-787): K and q are
    frozen for the sub-step and scaled by dt/C row by row.  Rows of
    non-massive nodes are zeroed, so those nodes stay frozen and the
    couplings across chunks read their frozen temperatures in every stage.
    With gas cavities K and q are assembled at the U of ``T`` (``K`` is not
    read)."""
    sel = sb.massive
    U = segment_u(sb, T, env_b.air)
    if K is None or sb.has_cavity:
        K = assemble_K(sb, U, env_f, env_b, statics)
    lower, diag, upper = K
    q = assemble_q(sb, T, U, env_f, env_b, rad_hs_f, rad_hs_b, solar_q, statics)
    scale = torch.where(sel, dt / torch.where(sel, sb.mass, torch.ones_like(T)), torch.zeros_like(T))
    T_new = rk4_apply(lower * scale, diag * scale, upper * scale, q * scale, T, flush_tiny=flush_tiny)
    return torch.where(sel, T_new, T)


def march_surfaces(
    sb, node_T, t_front, t_back, wind_direction, wind_speed, sol_front, sol_back, ir_front,
    ir_back, dt, config: SimConfig, has_massive: bool = True, skip_nomass: bool = False,
    solver=None, statics: SurfaceStatics = None, rad_out=None, envs=None, solar_q=None, mrt=None,
):
    """One sub-step of every surface (surface.rs:902-1001 march): solar
    distribution, then the no-mass chunks, then the massive chunks.  Returns
    the new node temperatures.  ``envs`` passes the border conditions of the
    current state and ``solar_q`` the absorbed solar forcing where the
    caller has them; ``mrt`` is an :func:`interior_mrt` context or None."""
    if statics is None:
        statics = compute_statics(sb)
    if envs is not None:
        env_f, env_b = envs
    else:
        env_f, env_b = border_conditions(
            sb, node_T, t_front, t_back, wind_direction, wind_speed, ir_front, ir_back,
            config, statics=statics, rad_out=rad_out,
        )
    env_f, env_b, rad_eps_f, rad_eps_b = apply_interior_mrt(sb, env_f, env_b, mrt)
    rad_hs_f = linearized_rad_coefficient(rad_eps_f, env_f)
    rad_hs_b = linearized_rad_coefficient(rad_eps_b, env_b)
    if solar_q is None:
        solar_q = absorbed_solar_q(sb, sol_front, sol_back)
    # With a static U, K is sub-step-constant: assembled once for both the
    # no-mass iterations and RK4.
    K = None if sb.has_cavity else assemble_K(sb, sb.seg_u, env_f, env_b, statics)
    T = node_T
    if sb.has_nomass and not skip_nomass:
        T = march_nomass(
            sb, T, env_f, env_b, rad_hs_f, rad_hs_b, solar_q, config,
            solver=solver, statics=statics, K=K,
        )
    if has_massive:
        T = march_massive(
            sb, T, env_f, env_b, rad_hs_f, rad_hs_b, solar_q, dt,
            statics=statics, K=K, flush_tiny=config.flush_tiny,
        )
    return T

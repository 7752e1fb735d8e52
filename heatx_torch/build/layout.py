"""Building "compiler": BuildingModel -> static padded device arrays.

This is the TPU-native replacement for the reference's ``ThermalModel::new``
build phase (model.rs:215-354).  Where the reference builds a
``Vec<ThermalSurface>`` of ragged per-surface objects, heatx compiles the
whole building into one padded tensor layout

    [n_surfaces, MAX_NODES]

plus per-surface scalars, so that every wall and window in the building
marches as a single batched XLA computation.  Chunk structure (massive vs
no-mass runs, discretization.rs:139-160) is expressed as masks and chunk-id
arrays rather than index ranges.

Everything here is host-side numpy/float64; ``SurfaceBatch.astype`` casts to
the simulation dtype right before the arrays go to the device.

heatx_torch copy of ``heatx.build.layout``: the same numpy code, without the
jax pytree registration (PyTorch passes the arrays explicitly) and without the
optional native chunk-id labeller (its pure-Python fallback is used).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, fields, replace
from typing import Dict, List, Optional, Tuple

import numpy as np

from heatx_torch.config import DEFAULT_CONFIG, SimConfig
from heatx_torch.constants import DEFAULT_EMISSIVITY
from heatx_torch.build import discretize as disc_mod
from heatx_torch.model.building import (
    Boundary,
    BuildingModel,
    ElectricHeater,
    IdealHeaterCooler,
    SurfaceDef,
    wind_speed_modifier,
)
from heatx_torch.physics import glazing as glazing_mod
from heatx_torch.physics.gas import GasProps

# Boundary codes used on device.
B_OUTDOOR = 0
B_SPACE = 1
B_AMBIENT = 2
# Ground reads its fixed soil temperature like ambient but is exempt from the
# replicate_ambient_back_bug quirk (surface.rs:672-686 reuses *front* values
# for ambient back faces; soil faces must radiate against the soil, not the
# front environment — a back-side ground face would otherwise silently run
# its radiative exchange against the indoor zone).
B_GROUND = 3

_ROUGHNESS_RF = 1.67  # reference always uses roughness_index=1 (surface.rs:619)


# ---------------------------------------------------------------------------
# Glazing scan (host)
# ---------------------------------------------------------------------------


def glazing_system(
    construction, model: BuildingModel, reverse: bool = False
) -> List[Tuple[int, glazing_mod.Glazing]]:
    """Collect translucent layers from one side until the first opaque layer
    (glazing.rs:67-137), returning (original_layer_index, Glazing) pairs.

    Layer properties (front/back solar absorbtance) are used as stored, not
    swapped for the back scan — matching the reference exactly.
    """
    n_layers = len(construction.materials)
    if n_layers == 0:
        raise ValueError(
            f"trying to get glazing system of empty construction '{construction.name}'"
        )
    order = list(range(n_layers))
    if reverse:
        order = order[::-1]

    out: List[Tuple[int, glazing_mod.Glazing]] = []
    i = 0
    while True:
        li = order[i]
        sub = model.get_material_substance(construction.materials[li])
        if sub.is_gas:
            raise ValueError(
                f"construction '{construction.name}': not expecting a gas layer here"
            )
        tau = sub.solar_transmittance or 0.0
        af = (
            sub.front_solar_absorbtance
            if sub.front_solar_absorbtance is not None
            else DEFAULT_EMISSIVITY
        )
        ab = (
            sub.back_solar_absorbtance
            if sub.back_solar_absorbtance is not None
            else DEFAULT_EMISSIVITY
        )
        out.append((li, glazing_mod.Glazing(tau, 1.0 - tau - af, 1.0 - tau - ab)))
        if tau < 1e-9:
            break
        i += 1
        if i >= len(order):
            break
        gas_li = order[i]
        gas_sub = model.get_material_substance(construction.materials[gas_li])
        if not gas_sub.is_gas:
            raise ValueError(
                f"construction '{construction.name}': expected a gas cavity between "
                "translucent layers"
            )
        i += 1
        if i >= len(order):
            raise ValueError(
                f"construction '{construction.name}' has a gas as its outermost layer"
            )
    return out


def node_alphas(
    construction,
    model: BuildingModel,
    d: disc_mod.Discretization,
    n_nodes: int,
    back: bool,
) -> np.ndarray:
    """Distribute glazing-layer absorbed fractions onto nodes
    (surface.rs:465-537): opaque layers put all absorption on their boundary
    node; transparent layers spread it uniformly over their n+1 nodes."""
    pairs = glazing_system(construction, model, reverse=back)
    layer_alphas = glazing_mod.alphas([g for _, g in pairs])

    # Node start index of each layer (gas/no-mass layers consume 1 segment).
    counts = [max(n, 1) for n in d.n_elements]
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(int)

    out = np.zeros(n_nodes, dtype=np.float64)
    for (li, _), alpha in zip(pairs, layer_alphas):
        n = counts[li]
        sub = model.get_material_substance(construction.materials[li])
        tau = (sub.solar_transmittance or 0.0) if not sub.is_gas else 0.0
        if tau > 0.0:
            out[starts[li] : starts[li] + n + 1] += alpha / (n + 1)
        elif back:
            out[starts[li] + n] += alpha
        else:
            out[starts[li]] += alpha
    return out


# ---------------------------------------------------------------------------
# Compiled layout
# ---------------------------------------------------------------------------


@dataclass
class SurfaceBatch:
    """Padded per-surface arrays — the compiled thermal network of a building.

    Shapes: S = number of surfaces (+fenestrations), N = MAX_NODES,
    C = max no-mass chunks per surface.  Node arrays are **node-major**
    ``[N, S]``: the tiny node axis sits on TPU sublanes, the large surface
    batch on the 128-wide vector lanes, and per-surface ``[S]`` scalars
    broadcast against them without reshapes.
    """

    # node data
    node_mask: np.ndarray  # [N, S] bool
    n_nodes: np.ndarray  # [S] int32
    mass: np.ndarray  # [N, S]
    massive: np.ndarray  # [N, S] bool (mass >= 1e-5 and valid)
    seg_u: np.ndarray  # [N, S] static solid U of segment i->i+1 (0 otherwise)
    seg_is_cavity: np.ndarray  # [N, S] bool
    cav_gas: GasProps  # each field [N, S]
    cav_thickness: np.ndarray  # [N, S]
    cav_height: np.ndarray  # [N, S]
    cav_angle: np.ndarray  # [N, S]
    cav_ein: np.ndarray  # [N, S]
    cav_eout: np.ndarray  # [N, S]
    same_chunk: np.ndarray  # [N, S] bool: nodes i,i+1 belong to the same chunk
    nomass_chunk_id: np.ndarray  # [N, S] int32, -1 for massive/invalid nodes
    nomass_chunk_count: np.ndarray  # [C, S] float: nodes per chunk (0 = absent)
    has_nomass: bool  # whether any surface has no-mass nodes (static)
    has_massive: bool  # whether any surface has massive nodes (static)
    has_cavity: bool  # whether any cavity exists (static)
    # Longest no-mass run (static): <= 2 lets the steady-state solve use the
    # closed-form pair solver (ops/tridiag.solve_runs2) instead of a padded
    # full-system sweep — true for ordinary constructions, whose insulation
    # skins / panes discretize to 1-2 no-mass nodes (discretization.rs:467-501).
    max_nomass_run: int
    front_alphas: np.ndarray  # [N, S]
    back_alphas: np.ndarray  # [N, S]

    # per-surface scalars
    area: np.ndarray  # [S]
    perimeter: np.ndarray  # [S]
    normal: np.ndarray  # [S, 3]
    cos_tilt: np.ndarray  # [S]
    wind_mod: np.ndarray  # [S]
    eps_front: np.ndarray  # [S]
    eps_back: np.ndarray  # [S]
    rf: np.ndarray  # [S] roughness multiplier (1.67)

    front_code: np.ndarray  # [S] int32 boundary code
    front_space: np.ndarray  # [S] int32 (0 when unused)
    front_temp: np.ndarray  # [S] ambient temperature (0 when unused)
    back_code: np.ndarray  # [S] int32
    back_space: np.ndarray  # [S] int32
    back_temp: np.ndarray  # [S]

    # test-only convection overrides (surface.rs:374-381); NaN = none
    fixed_h_front: np.ndarray  # [S]
    fixed_h_back: np.ndarray  # [S]

    is_fenestration: np.ndarray  # [S] bool

    def astype(self, dtype):
        """Cast floating arrays to the simulation dtype (device-bound copy)."""
        def cast(v):
            if isinstance(v, np.ndarray) and np.issubdtype(v.dtype, np.floating):
                return v.astype(dtype)
            return v

        kw = {}
        for f in fields(self):
            v = getattr(self, f.name)
            if isinstance(v, GasProps):
                v = GasProps(*[cast(x) for x in v])
            else:
                v = cast(v)
            kw[f.name] = v
        return replace(self, **kw)

    @property
    def n_surfaces(self) -> int:
        return int(self.node_mask.shape[1])

    @property
    def max_nodes(self) -> int:
        return int(self.node_mask.shape[0])


@dataclass
class CompiledBuilding:
    """Everything the engine needs to march a building."""

    surfaces: SurfaceBatch
    n_zones: int
    zone_volume: np.ndarray  # [Z]
    dt: float
    dt_subdivisions: int
    n_steps_per_hour: int  # `n` of the host loop (main timesteps per hour)

    # gains wiring
    lum_space: np.ndarray  # [L] int32
    hvac_pair_space: np.ndarray  # [P] int32 (flattened hvac->space pairs)
    hvac_pair_unit: np.ndarray  # [P] int32 index into the hvac power channel
    n_hvacs: int
    n_luminaires: int

    n_real_surfaces: int  # surfaces [0:n_real_surfaces], fenestrations after
    config: SimConfig = field(default_factory=lambda: DEFAULT_CONFIG)
    discretizations: List[disc_mod.Discretization] = field(default_factory=list)

    # Inter-zone air mixing (heatx extension; model.rs:546 leaves it
    # unimplemented): vol_rate[m] m3/s of zone mix_src[m]'s air into zone
    # mix_dst[m].  The default mix_vol input channel carries these rates;
    # schedules override it per step on the XLA paths.
    mix_src: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    mix_dst: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    mix_vol: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float64))

    # Setpoint-driven ideal loads (heatx extension; the reference's
    # IdealHeaterCooler is todo!(), heating_cooling.rs:66-90).  Dense [Z]
    # arrays: sentinel setpoints (+-1e9) and zero capacity on uncontrolled
    # zones make the control a no-op there.  has_ideal_hvac is static so
    # uncontrolled buildings trace zero extra ops.
    ctl_heat_sp: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float64))
    ctl_cool_sp: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float64))
    ctl_max_heat: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float64))
    ctl_max_cool: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float64))
    has_ideal_hvac: bool = False

    # In-run zone-state window shading (heatx extension; EnergyPlus's
    # OnIfHighZoneAirTemperature control family).  Dense [S] arrays:
    # shade_zone[s] is the controlling zone (-1 = uncontrolled),
    # shade_tau the deployed transmittance, shade_sp the zone-air
    # setpoint (C; the optional StepInputs.shade_sp channel overrides it
    # per main step — schedule gates render blocked hours as +1e9).
    # has_zone_shading is static so uncontrolled buildings trace zero
    # extra ops.
    shade_zone: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    shade_tau: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float64))
    shade_sp: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float64))
    has_zone_shading: bool = False

    # In-run ventilation temperature gates (heatx extension; EnergyPlus's
    # ZoneVentilation:DesignFlowRate limit fields).  Dense [Z] arrays of
    # gate limits; EnergyPlus's no-op defaults (+-100 C, 40 m/s) on
    # uncontrolled zones.  has_vent_gates is static so uncontrolled
    # buildings trace zero extra ops.
    vent_min_tin: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float64))
    vent_max_tin: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float64))
    vent_delta: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float64))
    vent_min_tout: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float64))
    vent_max_tout: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float64))
    vent_max_wind: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float64))
    has_vent_gates: bool = False

    @property
    def n_surfaces(self) -> int:
        return self.surfaces.n_surfaces

    @property
    def max_nodes(self) -> int:
        return self.surfaces.max_nodes

    def astype(self, dtype) -> "CompiledBuilding":
        """Cast all floating-point arrays to the simulation dtype (do this
        once before handing the building to jitted engine functions so no
        implicit f64->f32 conversion happens at every call)."""
        return replace(
            self,
            surfaces=self.surfaces.astype(dtype),
            zone_volume=self.zone_volume.astype(dtype),
            mix_vol=self.mix_vol.astype(dtype),
            ctl_heat_sp=self.ctl_heat_sp.astype(dtype),
            ctl_cool_sp=self.ctl_cool_sp.astype(dtype),
            ctl_max_heat=self.ctl_max_heat.astype(dtype),
            ctl_max_cool=self.ctl_max_cool.astype(dtype),
            shade_tau=self.shade_tau.astype(dtype),
            shade_sp=self.shade_sp.astype(dtype),
            vent_min_tin=self.vent_min_tin.astype(dtype),
            vent_max_tin=self.vent_max_tin.astype(dtype),
            vent_delta=self.vent_delta.astype(dtype),
            vent_min_tout=self.vent_min_tout.astype(dtype),
            vent_max_tout=self.vent_max_tout.astype(dtype),
            vent_max_wind=self.vent_max_wind.astype(dtype),
        )

    def set_fixed_h(self, front=None, back=None):
        """Pin convection coefficients (the reference's debug-only
        front_hs/back_hs override, surface.rs:374-381).  Pass scalars or [S]
        arrays; None leaves the side untouched.

        Ground-contact faces are exempt: their fixed-h channel carries the
        compiled soil-contact coefficient (config.ground_contact_h), which
        this debug override must not clobber (and a NaN "unset" must not
        strip)."""
        sb = self.surfaces
        if front is not None:
            keep = np.asarray(sb.front_code) == B_GROUND
            sb.fixed_h_front[:] = np.where(keep, sb.fixed_h_front, front)
        if back is not None:
            keep = np.asarray(sb.back_code) == B_GROUND
            sb.fixed_h_back[:] = np.where(keep, sb.fixed_h_back, back)
        return self


def _boundary_arrays(b: Boundary, model: BuildingModel):
    """(code, space_index, fixed_temp, is_ground) for one face.

    Ground (a heatx extension; the reference leaves it unimplemented,
    model.rs:92) lowers to a fixed-temperature boundary whose convective
    film is replaced by the soil contact coefficient — the caller pins
    fixed_h on that face to ``config.ground_contact_h``."""
    if b.kind == "outdoor":
        return B_OUTDOOR, 0, 0.0, False
    if b.kind == "space":
        return B_SPACE, model.space_index(b.space), 0.0, False
    if b.kind == "ambient":
        return B_AMBIENT, 0, float(b.temperature), False
    if b.kind == "ground":
        return B_GROUND, 0, float(b.temperature), True
    raise ValueError(f"unknown boundary kind '{b.kind}'")


def compile_building(
    model: BuildingModel,
    n: int = 1,
    config: SimConfig = DEFAULT_CONFIG,
    pad_surfaces_to: Optional[int] = None,
) -> CompiledBuilding:
    """ThermalModel::new equivalent (model.rs:215-354).

    ``n`` is the number of main timesteps per hour taken by the caller's
    simulation loop; the compiled building subdivides it further into
    ``dt_subdivisions`` stability sub-steps (times the safety factor 2).

    ``pad_surfaces_to`` appends thermally isolated dummy surfaces (ambient
    boundaries, no zone coupling) so the surface axis divides a device mesh
    evenly for sharding.
    """
    main_dt = 3600.0 / n

    surf_defs: List[Tuple[SurfaceDef, bool]] = [(s, False) for s in model.surfaces]
    surf_defs += [(s, True) for s in model.fenestrations]
    if not surf_defs:
        raise ValueError("building has no surfaces")
    n_pad = 0
    if pad_surfaces_to is not None and pad_surfaces_to > len(surf_defs):
        n_pad = pad_surfaces_to - len(surf_defs)
        template = surf_defs[0][0]
        for i in range(n_pad):
            area, perimeter, normal, height = template.resolved_geometry()
            surf_defs.append(
                (
                    SurfaceDef(
                        f"__pad{i}",
                        template.construction,
                        Boundary.ambient(22.0),
                        Boundary.ambient(22.0),
                        area=area,
                        perimeter=perimeter,
                        normal=tuple(normal),
                        height=height,
                    ),
                    False,
                )
            )

    discs: List[disc_mod.Discretization] = []
    geo = []
    dt_subdivisions = 1
    disc_cache: Dict[Tuple[str, float], disc_mod.Discretization] = {}
    for sdef, _is_fen in surf_defs:
        construction = model.get_construction(sdef.construction)
        area, perimeter, normal, height = sdef.resolved_geometry()
        cos_tilt = float(normal[2])
        # math.acos, not np.arccos: scalar numpy calls cost ~us each and this
        # loop runs once per surface (seconds at 1M surfaces).
        angle = math.acos(min(1.0, max(-1.0, cos_tilt)))
        # The reference hard-codes the cavity-correlation height to 1 m with a
        # debug note (model.rs:250-252); replicated here.
        cavity_height = 1.0
        # A discretization depends only on (construction, tilt angle) — one
        # per unique pair, shared by all surfaces using it.
        key = (construction.name, round(angle, 12))
        d = disc_cache.get(key)
        if d is None:
            d = disc_mod.discretize(
                construction, model, main_dt, config.max_dx, config.min_dt,
                cavity_height, angle,
            )
            disc_cache[key] = d
        dt_subdivisions = max(dt_subdivisions, d.tstep_subdivision)
        discs.append(d)
        geo.append((area, perimeter, normal, height, cos_tilt))

    # model.rs:326-331: dt = main_dt / (subdivisions * SAFETY)
    dt = 3600.0 / (n * dt_subdivisions)
    dt /= config.safety
    dt_subdivisions *= config.safety

    S = len(surf_defs)
    N = max(len(d.segments) for d in discs)

    f64 = np.float64
    zeros = lambda *sh: np.zeros(sh, dtype=f64)  # noqa: E731

    node_mask = np.zeros((S, N), dtype=bool)
    n_nodes = np.zeros(S, dtype=np.int32)
    mass = zeros(S, N)
    seg_u = zeros(S, N)
    seg_is_cavity = np.zeros((S, N), dtype=bool)
    cav_fields = [zeros(S, N) for _ in range(len(GasProps._fields))]
    cav_thickness = zeros(S, N)
    cav_height = np.ones((S, N), dtype=f64)
    cav_angle = zeros(S, N)
    cav_ein = zeros(S, N)
    cav_eout = zeros(S, N)
    front_alphas = zeros(S, N)
    back_alphas = zeros(S, N)

    area_a = zeros(S)
    perim_a = zeros(S)
    normal_a = zeros(S, 3)
    cos_tilt_a = zeros(S)
    wind_mod_a = zeros(S)
    eps_f = zeros(S)
    eps_b = zeros(S)
    front_code = np.zeros(S, dtype=np.int32)
    front_space = np.zeros(S, dtype=np.int32)
    front_temp = zeros(S)
    back_code = np.zeros(S, dtype=np.int32)
    back_space = np.zeros(S, dtype=np.int32)
    back_temp = zeros(S)
    is_fen = np.zeros(S, dtype=bool)
    # Ground faces replace the convective film with the soil contact
    # coefficient, carried through the fixed-h override channel.
    ground_h_front = np.full(S, np.nan, dtype=f64)
    ground_h_back = np.full(S, np.nan, dtype=f64)

    alpha_cache: Dict[tuple, tuple] = {}
    for si, ((sdef, fen), d, (area, perimeter, normal, height, cos_tilt)) in enumerate(
        zip(surf_defs, discs, geo)
    ):
        construction = model.get_construction(sdef.construction)
        nn = len(d.segments)
        n_nodes[si] = nn
        node_mask[si, :nn] = True
        for i, seg in enumerate(d.segments):
            mass[si, i] = seg.mass
            if seg.kind == "solid":
                seg_u[si, i] = seg.u
            elif seg.kind == "cavity":
                seg_is_cavity[si, i] = True
                c = seg.cavity
                for j, v in enumerate(c.gas):
                    cav_fields[j][si, i] = v
                cav_thickness[si, i] = c.thickness
                cav_height[si, i] = c.height
                cav_angle[si, i] = c.angle
                cav_ein[si, i] = c.ein
                cav_eout[si, i] = c.eout

        # Emissivities from the outermost substances (surface.rs:444-461).
        front_sub = model.get_material_substance(construction.materials[0])
        back_sub = model.get_material_substance(construction.materials[-1])
        if front_sub.is_gas or back_sub.is_gas:
            raise ValueError(
                f"construction '{construction.name}' has a gas as an outer layer"
            )
        eps_f[si] = (
            front_sub.front_thermal_absorbtance
            if front_sub.front_thermal_absorbtance is not None
            else DEFAULT_EMISSIVITY
        )
        eps_b[si] = (
            back_sub.back_thermal_absorbtance
            if back_sub.back_thermal_absorbtance is not None
            else DEFAULT_EMISSIVITY
        )

        # Alphas depend only on (construction, node count) — the node layout
        # is angle-independent (discretize_construction takes no angle), so
        # every tilt of a construction shares one computation (the
        # per-surface call was a top build cost at 100k surfaces; keying on
        # id(d) still recomputed once per distinct tilt).
        akey = (construction.name, nn)
        al = alpha_cache.get(akey)
        if al is None:
            al = (
                node_alphas(construction, model, d, nn, back=False),
                node_alphas(construction, model, d, nn, back=True),
            )
            alpha_cache[akey] = al
        front_alphas[si, :nn] = al[0]
        back_alphas[si, :nn] = al[1]

        area_a[si] = area
        perim_a[si] = perimeter
        normal_a[si] = normal
        cos_tilt_a[si] = cos_tilt
        wind_mod_a[si] = wind_speed_modifier(height, model.site_details)
        front_code[si], front_space[si], front_temp[si], f_gnd = _boundary_arrays(
            sdef.front_boundary, model
        )
        back_code[si], back_space[si], back_temp[si], b_gnd = _boundary_arrays(
            sdef.back_boundary, model
        )
        if f_gnd:
            ground_h_front[si] = config.ground_contact_h
        if b_gnd:
            ground_h_back[si] = config.ground_contact_h
        is_fen[si] = fen

    massive = node_mask & (mass >= 1e-5)

    # same_chunk[i]: nodes i and i+1 are in the same chunk (both valid and
    # same massiveness) — the mask form of get_chunks (discretization.rs:144).
    same_chunk = np.zeros((S, N), dtype=bool)
    same_chunk[:, : N - 1] = (
        node_mask[:, : N - 1]
        & node_mask[:, 1:]
        & (massive[:, : N - 1] == massive[:, 1:])
    )

    # No-mass chunk ids per node: consecutive runs of no-mass nodes.
    nomass = node_mask & ~massive
    nomass_chunk_id = -np.ones((S, N), dtype=np.int32)
    max_chunks = 1
    for si in range(S):
        cid = -1
        prev = False
        for i in range(int(n_nodes[si])):
            if nomass[si, i]:
                if not prev:
                    cid += 1
                nomass_chunk_id[si, i] = cid
            prev = bool(nomass[si, i])
        max_chunks = max(max_chunks, cid + 1)
    C = max_chunks
    nomass_chunk_count = np.zeros((S, C), dtype=f64)
    for si in range(S):
        for i in range(int(n_nodes[si])):
            cid = nomass_chunk_id[si, i]
            if cid >= 0:
                nomass_chunk_count[si, cid] += 1.0

    # Device layout is node-major [N, S] (see SurfaceBatch docstring); the
    # host-side build loops above fill surface-major [S, N] naturally.
    tr = lambda a: np.ascontiguousarray(a.T)  # noqa: E731

    batch = SurfaceBatch(
        node_mask=tr(node_mask),
        n_nodes=n_nodes,
        mass=tr(mass),
        massive=tr(massive),
        seg_u=tr(seg_u),
        seg_is_cavity=tr(seg_is_cavity),
        cav_gas=GasProps(*[tr(f) for f in cav_fields]),
        cav_thickness=tr(cav_thickness),
        cav_height=tr(cav_height),
        cav_angle=tr(cav_angle),
        cav_ein=tr(cav_ein),
        cav_eout=tr(cav_eout),
        same_chunk=tr(same_chunk),
        nomass_chunk_id=tr(nomass_chunk_id),
        nomass_chunk_count=np.ascontiguousarray(nomass_chunk_count.T),
        has_nomass=bool(nomass.any()),
        has_massive=bool(massive.any()),
        has_cavity=bool(seg_is_cavity.any()),
        max_nomass_run=int(nomass_chunk_count.max()) if nomass.any() else 0,
        front_alphas=tr(front_alphas),
        back_alphas=tr(back_alphas),
        area=area_a,
        perimeter=perim_a,
        normal=normal_a,
        cos_tilt=cos_tilt_a,
        wind_mod=wind_mod_a,
        eps_front=eps_f,
        eps_back=eps_b,
        rf=np.full(S, _ROUGHNESS_RF, dtype=f64),
        front_code=front_code,
        front_space=front_space,
        front_temp=front_temp,
        back_code=back_code,
        back_space=back_space,
        back_temp=back_temp,
        fixed_h_front=ground_h_front,
        fixed_h_back=ground_h_back,
        is_fenestration=is_fen,
    )

    # Zones
    Z = len(model.spaces)
    zone_volume = np.array([sp.volume for sp in model.spaces], dtype=f64)

    # Luminaires
    lum_space = np.array(
        [model.space_index(l.target_space) for l in model.luminaires], dtype=np.int32
    )

    # HVAC pairs (scheduled units) + ideal-loads thermostats (setpoint units)
    pair_space: List[int] = []
    pair_unit: List[int] = []
    ctl_heat_sp = np.full(Z, -1e9, dtype=f64)
    ctl_cool_sp = np.full(Z, 1e9, dtype=f64)
    ctl_max_heat = np.zeros(Z, dtype=f64)
    ctl_max_cool = np.zeros(Z, dtype=f64)
    has_ideal = False
    ctl_owner: Dict[int, str] = {}
    for hi, hvac in enumerate(model.hvacs):
        if isinstance(hvac, ElectricHeater):
            pair_space.append(model.space_index(hvac.target_space))
            pair_unit.append(hi)
        elif isinstance(hvac, IdealHeaterCooler):
            if hvac.heat_setpoint is not None or hvac.cool_setpoint is not None:
                hs = -1e9 if hvac.heat_setpoint is None else float(hvac.heat_setpoint)
                cs = 1e9 if hvac.cool_setpoint is None else float(hvac.cool_setpoint)
                if hs >= cs:
                    raise ValueError(
                        f"IdealHeaterCooler {hvac.name!r}: heat_setpoint {hs} "
                        f"must be below cool_setpoint {cs}"
                    )
                for sp in hvac.target_spaces:
                    zi = model.space_index(sp)
                    if zi in ctl_owner:
                        raise ValueError(
                            f"space {sp!r} is controlled by both "
                            f"{ctl_owner[zi]!r} and {hvac.name!r}"
                        )
                    ctl_owner[zi] = hvac.name
                    ctl_heat_sp[zi] = hs
                    ctl_cool_sp[zi] = cs
                    ctl_max_heat[zi] = float(hvac.max_heating)
                    ctl_max_cool[zi] = float(hvac.max_cooling)
                    has_ideal = True
            else:
                for sp in hvac.target_spaces:
                    pair_space.append(model.space_index(sp))
                    pair_unit.append(hi)
        else:
            raise ValueError(f"unknown HVAC type {type(hvac)}")

    # In-run zone-state window shading (heatx extension): dense [S]
    # arrays over the compiled surface order, -1 zone = uncontrolled.
    shade_zone = np.full(S, -1, dtype=np.int32)
    shade_tau = np.ones(S, dtype=f64)
    shade_sp_arr = np.full(S, 1e9, dtype=f64)
    has_zone_shading = False
    if model.zone_shading:
        surf_index = {sd.name: i for i, (sd, _) in enumerate(surf_defs)}
        for ctl in model.zone_shading:
            si = surf_index.get(ctl.surface)
            if si is None:
                raise ValueError(
                    f"zone shading control names unknown surface "
                    f"{ctl.surface!r}"
                )
            shade_zone[si] = model.space_index(ctl.space)
            shade_tau[si] = float(ctl.transmittance)
            shade_sp_arr[si] = float(ctl.setpoint)
            has_zone_shading = True

    # In-run ventilation temperature gates (heatx extension): dense [Z]
    # limit arrays, EnergyPlus's no-op defaults on uncontrolled zones.
    vent_min_tin = np.full(Z, -100.0, dtype=f64)
    vent_max_tin = np.full(Z, 100.0, dtype=f64)
    vent_delta = np.full(Z, -100.0, dtype=f64)
    vent_min_tout = np.full(Z, -100.0, dtype=f64)
    vent_max_tout = np.full(Z, 100.0, dtype=f64)
    vent_max_wind = np.full(Z, 40.0, dtype=f64)
    has_vent_gates = False
    for vctl in model.vent_controls:
        zi = model.space_index(vctl.space)
        vent_min_tin[zi] = float(vctl.min_indoor)
        vent_max_tin[zi] = float(vctl.max_indoor)
        vent_delta[zi] = float(vctl.delta)
        vent_min_tout[zi] = float(vctl.min_outdoor)
        vent_max_tout[zi] = float(vctl.max_outdoor)
        vent_max_wind[zi] = float(vctl.max_wind)
        has_vent_gates = True

    # Inter-zone mixing pairs (heatx extension; model.rs:546).
    mix_src = np.array(
        [model.space_index(f) for f, _, _ in model.mixings], dtype=np.int32
    )
    mix_dst = np.array(
        [model.space_index(t) for _, t, _ in model.mixings], dtype=np.int32
    )
    mix_vol = np.array([v for _, _, v in model.mixings], dtype=f64)

    return CompiledBuilding(
        surfaces=batch,
        n_zones=Z,
        zone_volume=zone_volume,
        dt=dt,
        dt_subdivisions=dt_subdivisions,
        n_steps_per_hour=n,
        lum_space=lum_space,
        hvac_pair_space=np.array(pair_space, dtype=np.int32),
        hvac_pair_unit=np.array(pair_unit, dtype=np.int32),
        n_hvacs=len(model.hvacs),
        n_luminaires=len(model.luminaires),
        n_real_surfaces=len(model.surfaces),
        config=config,
        discretizations=discs,
        mix_src=mix_src,
        mix_dst=mix_dst,
        mix_vol=mix_vol,
        ctl_heat_sp=ctl_heat_sp,
        ctl_cool_sp=ctl_cool_sp,
        ctl_max_heat=ctl_max_heat,
        ctl_max_cool=ctl_max_cool,
        has_ideal_hvac=has_ideal,
        shade_zone=shade_zone,
        shade_tau=shade_tau,
        shade_sp=shade_sp_arr,
        has_zone_shading=has_zone_shading,
        vent_min_tin=vent_min_tin,
        vent_max_tin=vent_max_tin,
        vent_delta=vent_delta,
        vent_min_tout=vent_min_tout,
        vent_max_tout=vent_max_tout,
        vent_max_wind=vent_max_wind,
        has_vent_gates=has_vent_gates,
    )

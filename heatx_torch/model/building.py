"""Building data model: the subset of SIMPLE's ``simple_model`` that the
thermal module consumes.

The reference depends on an external crate for substances / materials /
constructions / surfaces / spaces / boundaries / HVACs / luminaires
(SURVEY.md section 1, layer L0).  heatx re-creates that data model here as
plain immutable-ish dataclasses.  Everything in this module is host-side
build-time description; the compiled, padded device arrays live in
``heatx_torch.build.layout``.

heatx_torch copy of ``heatx.model.building`` (numpy only, unchanged).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from heatx_torch.model import geometry

# Polygon math cached per distinct vertex loop (generated city models reuse
# a handful of loops across 10k-100k surfaces); bounded, cleared on overflow.
_GEOMETRY_CACHE: dict = {}

# ---------------------------------------------------------------------------
# Substances / materials / constructions
# ---------------------------------------------------------------------------


@dataclass
class Substance:
    """A 'Normal' (solid) substance.

    Optional properties mirror simple_model's optional fields; `None` means
    "not specified" and consumers fall back to defaults (e.g. emissivity 0.84,
    surface.rs:449-461) or raise when the property is required
    (discretization.rs:440-445).
    """

    name: str
    thermal_conductivity: Optional[float] = None  # W/m.K
    density: Optional[float] = None  # kg/m3
    specific_heat_capacity: Optional[float] = None  # J/kg.K
    front_thermal_absorbtance: Optional[float] = None  # emissivity
    back_thermal_absorbtance: Optional[float] = None
    solar_transmittance: Optional[float] = None
    front_solar_absorbtance: Optional[float] = None
    back_solar_absorbtance: Optional[float] = None

    @property
    def is_gas(self) -> bool:
        return False


@dataclass
class GasSubstance:
    """A gas substance referencing a standard gas (gas.rs:45-74)."""

    name: str
    gas: str = "air"  # one of air/argon/krypton/xenon

    @property
    def is_gas(self) -> bool:
        return True


@dataclass
class Material:
    name: str
    substance: str  # substance name
    thickness: float  # m


@dataclass
class Construction:
    name: str
    materials: List[str] = field(default_factory=list)  # material names, front->back


# ---------------------------------------------------------------------------
# Boundaries
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Boundary:
    """Boundary condition of one face of a surface (simple_model::Boundary).

    kind: 'outdoor' | 'space' | 'ambient' | 'ground'
    The reference leaves 'ground' unimplemented (model.rs:92, surface.rs:642);
    heatx implements it as a documented extension: the face is in conductive
    contact with soil at ``temperature`` — compiled as a fixed-temperature
    boundary with the contact coefficient ``SimConfig.ground_contact_h``
    instead of a convective film.  Seasonal ground temperatures are updates
    to the compiled ``surfaces.front_temp``/``back_temp`` arrays (cheap
    pytree-leaf swaps between calls); soil mass belongs in the construction
    as soil layers.
    """

    kind: str = "outdoor"
    space: Optional[str] = None
    temperature: Optional[float] = None

    @staticmethod
    def outdoor() -> "Boundary":
        return Boundary("outdoor")

    @staticmethod
    def space_(name: str) -> "Boundary":
        return Boundary("space", space=name)

    @staticmethod
    def ambient(temperature: float) -> "Boundary":
        return Boundary("ambient", temperature=temperature)

    @staticmethod
    def ground(temperature: float = 10.0) -> "Boundary":
        return Boundary("ground", temperature=temperature)


# ---------------------------------------------------------------------------
# Surfaces / spaces / systems
# ---------------------------------------------------------------------------


@dataclass
class SurfaceDef:
    """A wall/roof/floor (or fenestration — the solver treats them alike,
    surface.rs:310-314).  Geometry can be given as an explicit polygon or as
    precomputed scalars (tests drive single walls directly, surface.rs tests).
    """

    name: str
    construction: str
    front_boundary: Boundary = field(default_factory=Boundary.outdoor)
    back_boundary: Boundary = field(default_factory=Boundary.outdoor)
    vertices: Optional[np.ndarray] = None  # (n,3) outer loop
    # Explicit overrides (used when vertices is None, or to force values):
    area: Optional[float] = None
    perimeter: Optional[float] = None
    normal: Optional[Tuple[float, float, float]] = None
    height: Optional[float] = None  # centroid z, for the wind profile
    # Solar ground view factor of the outdoor face (EnergyPlus's explicit
    # "View Factor to Ground" surface field).  None = geometric
    # (1 - cos_tilt)/2.  Consumed by heatx.weather.solar, not the solver
    # (incident solar is an input channel, surface.rs:916-931).
    ground_view_factor: Optional[float] = None

    def resolved_geometry(self):
        """area, perimeter, normal, centroid-height."""
        if self.vertices is not None:
            v = np.asarray(self.vertices, dtype=np.float64)
            # Generated city models reuse one vertex loop across thousands of
            # surfaces; cache the polygon math per distinct loop (it was the
            # dominant cost of a 100k-surface build).
            use_cache = (
                self.area is None
                and self.perimeter is None
                and self.normal is None
                and self.height is None
            )
            key = v.tobytes() if use_cache else None
            if use_cache:
                cached = _GEOMETRY_CACHE.get(key)
                if cached is not None:
                    return cached
            area = self.area if self.area is not None else geometry.polygon_area(v)
            perim = (
                self.perimeter
                if self.perimeter is not None
                else geometry.polygon_perimeter(v)
            )
            normal = (
                np.asarray(self.normal, dtype=np.float64)
                if self.normal is not None
                else geometry.polygon_normal(v)
            )
            height = (
                self.height
                if self.height is not None
                else float(geometry.polygon_centroid(v)[2])
            )
            out = float(area), float(perim), normal, float(height)
            if use_cache:
                if len(_GEOMETRY_CACHE) > 4096:
                    _GEOMETRY_CACHE.clear()
                _GEOMETRY_CACHE[key] = out
            return out
        if self.area is None or self.perimeter is None or self.normal is None:
            raise ValueError(
                f"surface '{self.name}': provide either vertices or "
                "(area, perimeter, normal)"
            )
        return (
            float(self.area),
            float(self.perimeter),
            np.asarray(self.normal, dtype=np.float64),
            float(self.height if self.height is not None else 0.0),
        )


@dataclass
class SpaceDef:
    name: str
    volume: float  # m3


@dataclass
class ElectricHeater:
    """heating_cooling.rs:41-47 — heat delivered to one space, power read from
    the state vector at run time."""

    name: str
    target_space: str


@dataclass
class IdealHeaterCooler:
    """heating_cooling.rs:29-38.  ``todo!()`` in the reference; implemented
    here (documented deviation) in two modes:

    * **scheduled** (default, no setpoints): delivers its heating/cooling
      consumption — read from the ``hvac_power`` input channel, like the
      reference reads power from the state vector — to each target space.
    * **setpoint-driven ideal loads** (``heat_setpoint``/``cool_setpoint``
      given): a thermostat.  Each sub-step the zone update computes the
      exact power that lands the analytical zone solution on the setpoint
      (zero inside the deadband), clamps it to ``max_heating`` /
      ``max_cooling`` (W, both positive; capacity applies per target
      space), applies it, and records it in ``SimState.ideal_load`` — the
      EnergyPlus "ideal loads air system" pattern, which is how
      heating/cooling *demand* is computed.  Setpoint units do not consume
      the ``hvac_power`` channel."""

    name: str
    target_spaces: List[str] = field(default_factory=list)
    heat_setpoint: Optional[float] = None
    cool_setpoint: Optional[float] = None
    max_heating: float = float("inf")
    max_cooling: float = float("inf")


HVAC = Union[ElectricHeater, IdealHeaterCooler]


@dataclass
class Luminaire:
    """luminaire.rs — lighting heat gain into a space."""

    name: str
    target_space: str


@dataclass
class ZoneShadingControl:
    """In-run window-shading control (heatx extension — the reference has
    no shading machinery; EnergyPlus's zone-state-dependent
    WindowShadingControl types, e.g. OnIfHighZoneAirTemperature).

    While the controlling ``space``'s air temperature exceeds
    ``setpoint`` (C), the pane's incident FRONT solar input is scaled by
    the deployed device's ``transmittance``.  Deployment is evaluated at
    each main-step start from the marching zone temperature — the
    previous timestep's value, EnergyPlus's own control convention — so
    it runs inside the compiled scan on every XLA integrator and inside
    the fused Pallas kernel (the controlling zone is read from the
    in-VMEM carry; blocking places it in the pane's block).  The optional
    ``StepInputs.shade_sp`` channel overrides the compiled setpoints per
    main step (a schedule gate renders blocked hours as +inf there)."""

    surface: str  # controlled pane (fenestration or surface) name
    space: str  # the zone whose air temperature controls deployment
    transmittance: float  # deployed-device solar transmittance, 0..1
    setpoint: float  # zone air temperature threshold, C


@dataclass
class ZoneVentilationControl:
    """In-run ventilation temperature gates (heatx extension — the
    reference has no airflow control machinery; EnergyPlus's
    ZoneVentilation:DesignFlowRate temperature/wind limit fields).

    While any gate FAILS, the controlled ``space``'s ventilation channel
    (``StepInputs.vent_vol``/``vent_temp``/``vent_mask``) is masked off
    for that main step.  Gates pass when

    * ``min_indoor < T_zone < max_indoor`` (zone air temperature, read
      from the marching state at main-step start — the previous
      timestep's value, EnergyPlus's own control convention),
    * ``T_zone - T_out > delta`` (free cooling only while the zone is
      warmer than outdoors by at least ``delta``),
    * ``min_outdoor < T_out < max_outdoor`` and
      ``wind_speed < max_wind`` (step-mean outdoor conditions).

    Defaults are EnergyPlus's own no-op limits, so a default-constructed
    control gates nothing.  Infiltration is NOT gated (EnergyPlus
    semantics: ZoneInfiltration has no temperature controls)."""

    space: str  # the ventilated zone (gates read ITS air temperature)
    min_indoor: float = -100.0  # C; vent off while T_zone <= min_indoor
    max_indoor: float = 100.0  # C; vent off while T_zone >= max_indoor
    delta: float = -100.0  # K; vent off while T_zone - T_out <= delta
    min_outdoor: float = -100.0  # C
    max_outdoor: float = 100.0  # C
    max_wind: float = 40.0  # m/s; vent off while wind_speed >= max_wind


@dataclass
class SiteDetails:
    """Terrain class for the wind-speed profile (surface.rs:135-166)."""

    terrain: str = "urban"  # country|suburbs|city|ocean|urban


TERRAIN_TABLE = {
    "country": (0.14, 270.0),
    "suburbs": (0.22, 370.0),
    "city": (0.33, 460.0),
    "ocean": (0.10, 210.0),
    "urban": (0.22, 370.0),
}


def wind_speed_modifier(height: float, site_details: Optional[SiteDetails]) -> float:
    """EnergyPlus wind profile factor (surface.rs:104-166).

    Zero for surfaces at ground level; defaults to Urban terrain when no site
    details are given.
    """
    if height < 1e-5:
        return 0.0
    if site_details is not None and site_details.terrain in TERRAIN_TABLE:
        alpha, delta = TERRAIN_TABLE[site_details.terrain]
    else:
        alpha, delta = TERRAIN_TABLE["urban"]
    return (270.0 / 10.0) ** 0.14 * (height / delta) ** alpha


# ---------------------------------------------------------------------------
# The whole building
# ---------------------------------------------------------------------------


@dataclass
class BuildingModel:
    """Equivalent of ``SimpleModel`` for thermal purposes."""

    substances: Dict[str, Union[Substance, GasSubstance]] = field(default_factory=dict)
    materials: Dict[str, Material] = field(default_factory=dict)
    constructions: Dict[str, Construction] = field(default_factory=dict)
    surfaces: List[SurfaceDef] = field(default_factory=list)
    fenestrations: List[SurfaceDef] = field(default_factory=list)
    spaces: List[SpaceDef] = field(default_factory=list)
    hvacs: List[HVAC] = field(default_factory=list)
    luminaires: List[Luminaire] = field(default_factory=list)
    site_details: Optional[SiteDetails] = None
    # Inter-zone air mixing (from_space, to_space, m3/s).  The reference
    # comments this out as unimplemented (model.rs:546, 592-593); heatx
    # implements it as ventilation whose source temperature is the other
    # zone's air: A_to += rho*cp(T_from)*vol*T_from, B_to += rho*cp*vol.
    mixings: List[tuple] = field(default_factory=list)
    #: Opaque shading polygons ((n, 3) world-space vertex loops — context
    #: buildings, overhangs, fins; EnergyPlus's Shading:*:Detailed).  Not
    #: part of the thermal network: heatx.weather.shadow ray-casts them
    #: into per-surface sunlit beam fractions for the solar inputs.
    shades: List[np.ndarray] = field(default_factory=list)
    #: In-run zone-state window-shading controls (see ZoneShadingControl).
    zone_shading: List[ZoneShadingControl] = field(default_factory=list)
    #: In-run ventilation temperature gates (see ZoneVentilationControl).
    vent_controls: List[ZoneVentilationControl] = field(default_factory=list)

    # -- construction helpers ------------------------------------------------

    def add_substance(self, s):
        self.substances[s.name] = s
        return s

    def add_material(self, m: Material) -> Material:
        self.materials[m.name] = m
        return m

    def add_construction(self, c: Construction) -> Construction:
        self.constructions[c.name] = c
        return c

    def add_surface(self, s: SurfaceDef) -> SurfaceDef:
        self.surfaces.append(s)
        return s

    def add_fenestration(self, s: SurfaceDef) -> SurfaceDef:
        self.fenestrations.append(s)
        return s

    def add_space(self, s: SpaceDef) -> SpaceDef:
        # Duplicate names are rejected: space_index resolves by name, so a
        # second 'Room' would silently absorb every surface/gain bound to
        # the name while the first zone floats unreferenced.
        if any(sp.name == s.name for sp in self.spaces):
            raise ValueError(f"duplicate space name {s.name!r}")
        self.spaces.append(s)
        return s

    def add_hvac(self, h: HVAC) -> HVAC:
        self.hvacs.append(h)
        return h

    def add_luminaire(self, l: Luminaire) -> Luminaire:
        self.luminaires.append(l)
        return l

    def add_shade(self, vertices) -> np.ndarray:
        """Register an opaque shading polygon ((n, 3) world-space loop —
        an overhang, fin, or neighboring building).  Shades block beam
        solar only (heatx.weather.shadow.sunlit_fraction); they carry no
        thermal state."""
        v = np.asarray(vertices, dtype=np.float64)
        if v.ndim != 2 or v.shape[0] < 3 or v.shape[1] != 3:
            raise ValueError(
                f"shade vertices must be (n>=3, 3), got {v.shape}"
            )
        self.shades.append(v)
        return v

    def add_zone_shading(self, ctl: ZoneShadingControl) -> ZoneShadingControl:
        """Register an in-run zone-state window-shading control: while
        ``ctl.space``'s air temperature exceeds ``ctl.setpoint``, the
        named pane's incident front solar scales by
        ``ctl.transmittance`` (evaluated each main step from the
        previous step's zone temperature, inside the compiled scan)."""
        if not 0.0 <= ctl.transmittance <= 1.0:
            raise ValueError(
                f"zone shading on {ctl.surface!r}: transmittance must be "
                f"in [0, 1], got {ctl.transmittance}"
            )
        if any(c.surface == ctl.surface for c in self.zone_shading):
            raise ValueError(
                f"surface {ctl.surface!r} already has a zone-shading "
                "control"
            )
        self.zone_shading.append(ctl)
        return ctl

    def add_vent_control(
        self, ctl: ZoneVentilationControl
    ) -> ZoneVentilationControl:
        """Register in-run ventilation temperature gates: the named
        space's ventilation channel is masked off on main steps where any
        gate fails (evaluated from the previous step's zone temperature
        and the step-mean outdoor conditions, inside the compiled scan).
        One control per space."""
        if ctl.min_indoor >= ctl.max_indoor:
            raise ValueError(
                f"ventilation control on {ctl.space!r}: min_indoor "
                f"({ctl.min_indoor}) must be < max_indoor ({ctl.max_indoor})"
            )
        if ctl.min_outdoor >= ctl.max_outdoor:
            raise ValueError(
                f"ventilation control on {ctl.space!r}: min_outdoor "
                f"({ctl.min_outdoor}) must be < max_outdoor "
                f"({ctl.max_outdoor})"
            )
        if any(c.space == ctl.space for c in self.vent_controls):
            raise ValueError(
                f"space {ctl.space!r} already has a ventilation control"
            )
        self.vent_controls.append(ctl)
        return ctl

    def add_mixing(
        self, from_space: str, to_space: str, vol_rate: float, bidirectional: bool = True
    ):
        """Inter-zone air mixing: ``vol_rate`` m3/s of air carried from
        ``from_space`` into ``to_space`` (and, by default, back — balanced
        exchange through an opening).  Unimplemented in the reference
        (model.rs:546); see BuildingModel.mixings."""
        self.mixings.append((from_space, to_space, float(vol_rate)))
        if bidirectional:
            self.mixings.append((to_space, from_space, float(vol_rate)))
        return self

    # -- lookups -------------------------------------------------------------

    def get_substance(self, name: str):
        try:
            return self.substances[name]
        except KeyError:
            raise KeyError(f"unknown substance '{name}'") from None

    def get_material(self, name: str) -> Material:
        try:
            return self.materials[name]
        except KeyError:
            raise KeyError(f"unknown material '{name}'") from None

    def get_material_substance(self, mat_name: str):
        return self.get_substance(self.get_material(mat_name).substance)

    def get_construction(self, name: str) -> Construction:
        try:
            return self.constructions[name]
        except KeyError:
            raise KeyError(f"unknown construction '{name}'") from None

    def space_index(self, name: str) -> int:
        # Dict lookup, rebuilt when spaces were added since (the linear scan
        # made 100k-surface boundary resolution O(S*Z)).  A cache hit is
        # verified against the live list (O(1)) so renaming/replacing a
        # space without changing the count cannot return a stale index.
        idx = self.__dict__.get("_space_index_cache")
        i = idx.get(name) if idx is not None else None
        if (
            idx is None
            or len(idx) != len(self.spaces)
            or i is None
            or self.spaces[i].name != name
        ):
            idx = {s.name: i for i, s in enumerate(self.spaces)}
            self.__dict__["_space_index_cache"] = idx
        try:
            return idx[name]
        except KeyError:
            raise KeyError(f"unknown space '{name}'") from None

"""Minimal EnergyPlus IDF reader: the thermal-envelope subset.

heatx_torch copy of ``heatx.model.idf`` (numpy only); it builds the port's
``heatx_torch.model.building.BuildingModel``.

The reference validates against EnergyPlus fixtures whose models are
re-authored by hand in Rust (tests/validate_wall_heat_transfer.rs:95-613 and
the ``simple_test_models`` dev-crate) — the ``in.idf`` files themselves are
only consumed by EnergyPlus.  heatx closes that loop: :func:`load_idf` parses
the envelope subset of an IDF directly into a :class:`BuildingModel`, so the
validation fixtures (and any IDF restricted to the same object set) can be
simulated without re-authoring.  Supported objects:

* ``Material`` / ``Material:NoMass`` / ``WindowMaterial:Glazing`` /
  ``WindowMaterial:Gas`` (Air/Argon/Krypton/Xenon -> an ISO 15099 gas
  cavity) / ``WindowMaterial:SimpleGlazingSystem`` (U/SHGC -> an
  equivalent single pane: glass-only resistance ``1/U`` minus NFRC winter
  film resistances sets the conductivity, SHGC realizes as the direct
  solar transmittance with 8 % absorption — the inward-flowing share of
  that absorption overshoots the SHGC by <3 %, and the film coefficients
  are simulated dynamically with TARP rather than held at rating
  conditions)
* ``Construction``
* ``Zone`` (an ``autocalculate`` volume derives as ceiling height x floor
  area — explicit or computed from the zone's Floor surfaces)
* ``BuildingSurface:Detailed`` (Outdoors / Ground / Zone / Surface outside
  boundary conditions)
* ``FenestrationSurface:Detailed`` (window hosted in a wall; its area is
  subtracted from the host, matching the reference's window-as-a-hole model,
  validate_wall_heat_transfer.rs:106-118)
* ``ZoneInfiltration:DesignFlowRate`` (Flow/Zone or AirChanges/Hour; the
  resulting design m3/s is *reported*, not compiled — infiltration is a
  per-step input channel in heatx, ``StepInputs.inf_vol``)
* ``Building`` (terrain -> :class:`SiteDetails` wind profile),
  ``Timestep`` (main steps per hour, the ``n`` of ``ThermalModel``),
  ``SurfaceConvectionAlgorithm:*`` (must be TARP — the only algorithm the
  reference and heatx implement, convection.rs:1-22)
* ``Schedule:Constant`` / ``Schedule:Compact`` / the classic
  ``Schedule:Day:Hourly|Interval`` -> ``Schedule:Week:Daily|Compact`` ->
  ``Schedule:Year`` family -> hourly [8760] series
  (``LoadedIdf.schedules``; Through/For/Until grammar, day-of-week groups)
* Internal gains — ``Lights`` (-> :class:`Luminaire` +
  ``StepInputs.lum_power`` series), ``ElectricEquipment`` and ``People``
  (-> :class:`ElectricHeater` + ``StepInputs.hvac_power`` series).  Like
  infiltration, schedules stay *input channels*: the importer adds the
  gain device to the model and :meth:`LoadedIdf.hourly_channels` renders
  the [T, n] power series (design level x schedule), because heatx
  compiles buildings, not time series.
* Thermostats -> setpoint-driven :class:`IdealHeaterCooler` (ideal loads):
  ``HVACTemplate:Thermostat`` + ``HVACTemplate:Zone:IdealLoadsAirSystem``,
  or ``ZoneControl:Thermostat`` + ``ThermostatSetpoint:DualSetpoint`` /
  ``:SingleHeating`` / ``:SingleCooling`` (scheduled setpoints ride the
  ``StepInputs.heat_sp``/``cool_sp`` channels via ``hourly_channels``).

Geometry follows ``GlobalGeometryRules``: clockwise vertex entry flips to
the counter-clockwise winding the normal math assumes, and Relative
coordinates lower to world (rotate by Building North Axis + the zone's
Direction of Relative North, translate by the zone origin).  Absent rules
default to the reference fixtures' convention (world, counter-clockwise).
Everything else (RunPeriod beyond its begin-date weekday, Output:*) is
ignored — with one summarized warning for object types that may carry
thermal content.

Mapping notes (documented deviations, all lossless for the fixture set):

* ``Material:NoMass`` carries only a thermal resistance.  heatx's
  discretizer (like the reference's, discretization.rs:410-544) decides
  massive-vs-no-mass from layer properties, so the R-value is realized as an
  equivalent slab of a standard light insulator (polyurethane-like:
  k=0.0252 W/m.K, rho=17.5 kg/m3, cp=2400 J/kg.K — the exact substance the
  reference's own "nomass" fixture models use,
  validate_wall_heat_transfer.rs:949) with thickness ``R*k``.  Its time
  constant is far below any simulation dt, so it discretizes to a pure-R
  no-mass segment either way.
* The fixtures' ``WindowMaterial:Glazing`` objects omit thickness and
  conductivity (a truncated field list); standard-schema objects are parsed
  in full, truncated ones fall back to 6 mm / k=1.0 glass (the reference's
  in-source test glass, surface.rs:1048-1075).  Solar absorptance per side is
  ``1 - tau - reflectance``.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from heatx_torch.model.building import (
    Boundary,
    BuildingModel,
    Construction,
    ElectricHeater,
    GasSubstance,
    IdealHeaterCooler,
    Luminaire,
    Material,
    SiteDetails,
    SpaceDef,
    Substance,
    SurfaceDef,
    ZoneShadingControl,
    ZoneVentilationControl,
)

# Equivalent-slab properties for Material:NoMass (see module docstring).
NOMASS_CONDUCTIVITY = 0.0252
NOMASS_DENSITY = 17.5
NOMASS_SPECIFIC_HEAT = 2400.0

# Fallback pane properties for truncated WindowMaterial:Glazing objects.
GLAZING_THICKNESS = 0.006
GLAZING_CONDUCTIVITY = 1.0
GLAZING_DENSITY = 2500.0
GLAZING_SPECIFIC_HEAT = 840.0

_TERRAINS = {"country", "suburbs", "city", "ocean", "urban"}

# Object types the importer realizes in the thermal model.
_SUPPORTED_TYPES = {
    "version", "building", "timestep", "runperiod",
    "surfaceconvectionalgorithm:inside", "surfaceconvectionalgorithm:outside",
    "material", "material:nomass", "windowmaterial:glazing",
    "windowmaterial:gas", "windowmaterial:simpleglazingsystem",
    "construction", "zone", "zonelist",
    "buildingsurface:detailed", "fenestrationsurface:detailed", "internalmass",
    "globalgeometryrules", "material:airgap", "window", "glazeddoor",
    "schedule:constant", "schedule:compact", "schedule:year",
    "schedule:week:daily", "schedule:week:compact",
    "schedule:day:hourly", "schedule:day:interval",
    "zoneinfiltration:designflowrate", "zoneventilation:designflowrate",
    "lights", "electricequipment", "people",
    "hvactemplate:thermostat", "hvactemplate:zone:idealloadsairsystem",
    "zonecontrol:thermostat", "thermostatsetpoint:dualsetpoint",
    "thermostatsetpoint:singleheating", "thermostatsetpoint:singlecooling",
    "windowmaterial:shade", "windowmaterial:screen", "windowmaterial:blind",
    "windowshadingcontrol",
    "windowproperty:shadingcontrol",
    "shading:site:detailed", "shading:building:detailed",
    "shading:zone:detailed", "shading:site", "shading:building",
    "shading:overhang", "shading:overhang:projection",
    "shading:fin", "shading:fin:projection",
}
# Pure-reporting / solver-configuration types that genuinely have no thermal
# content to import — silently skipped.
_IGNORABLE_PREFIXES = (
    "output", "scheduletypelimits", "site:",
    "sizing", "simulationcontrol", "heatbalancealgorithm",
    "shadowcalculation", "convergencelimits", "zoneairheatbalancealgorithm",
    "runperiodcontrol", "zoneaircontaminantbalance", "zonecapacitance",
)


# Sensible fraction of metabolic heat applied when a People object says
# ``autocalculate``: EnergyPlus splits sensible/latent from the activity
# level at run time; at typical activity (~120 W/person) the sensible share
# is ~0.6, which is the fixed approximation used here (heatx models
# sensible zone heat only).
PEOPLE_SENSIBLE_FRACTION = 0.6

_WEEKDAYS = ("sunday", "monday", "tuesday", "wednesday", "thursday",
             "friday", "saturday")
_MONTH_DAYS = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)


@dataclass
class ImportedGain:
    """An internal-gain device added to the model by the importer: design
    sensible watts x (product of) schedules = the per-hour power to feed its
    input channel (``lum_power`` for Lights -> Luminaire, ``hvac_power`` for
    ElectricEquipment / People -> ElectricHeater)."""

    name: str
    zone: str
    channel: str  # "lum" | "hvac"
    index: int  # index into model.luminaires / model.hvacs
    design_w: float  # sensible design power at schedule value 1.0
    schedules: List[str] = field(default_factory=list)  # multiplied in


@dataclass
class AirflowRule:
    """One ZoneInfiltration/ZoneVentilation:DesignFlowRate object: design
    m3/s x schedule = the per-hour outdoor-air exchange for its zone
    (rendered by :meth:`LoadedIdf.airflow_series`)."""

    kind: str  # "infiltration" | "ventilation"
    zone: str
    flow: float  # design m3/s at schedule value 1.0
    schedule: Optional[str] = None


@dataclass
class ShadingRule:
    """A window-shading rule (WindowShadingControl /
    WindowProperty:ShadingControl subset): when deployed, the controlled
    panes' incident solar scales by the shade's transmittance.

    ``control`` is the normalized deployment condition — ``"always"``
    (AlwaysOn / OnIfScheduleAllows), ``"high_solar"``
    (OnIfHighSolarOnWindow: incident solar on the pane > setpoint W/m2),
    ``"high_horizontal_solar"`` (OnIfHighHorizontalSolar: global
    horizontal > setpoint W/m2), ``"high_outdoor_temp"``
    (OnIfHighOutdoorAirTemperature: dry bulb > setpoint C), or one of
    the AND-combinations ``"high_outdoor_and_solar"`` /
    ``"high_outdoor_and_horizontal"``
    (OnIfHighOutdoorAirTempAndHighSolarOnWindow /
    OnIfHighOutdoorAirTempAndHighHorizontalSolar: dry bulb > setpoint C
    AND the solar condition > ``setpoint2`` W/m2).  A ``schedule``
    (when present) additionally gates deployment, matching
    EnergyPlus's "and schedule, if specified, allows shading".

    Zone-state-dependent rules (``"high_zone_temp"``,
    OnIfHighZoneAirTemperature: the controlling ``zone``'s air
    temperature > setpoint C) do NOT render host-side — load_idf lowers
    them to in-run ``ZoneShadingControl``s on the model (deployment
    reads the marching zone temperature inside the compiled scan) and
    lists them in ``LoadedIdf.zone_shading``; their schedule AND-gates
    render through :meth:`LoadedIdf.shading_setpoint_series`."""

    name: str
    fenestrations: List[str]
    transmittance: float  # the shade material's solar transmittance
    schedule: Optional[str] = None  # AND-gate; None = no schedule gate
    control: str = "always"
    setpoint: float = 0.0  # W/m2 or C, per control
    setpoint2: float = 0.0  # W/m2 (the AND-combination solar condition)
    zone: Optional[str] = None  # controlling zone (high_zone_temp only)


@dataclass
class ImportedThermostat:
    """A thermostat imported as a setpoint-driven IdealHeaterCooler; the
    scheduled setpoints (if any) render through
    :meth:`LoadedIdf.hourly_channels` as ``heat_sp``/``cool_sp`` series."""

    name: str
    zone: str
    heat_schedule: Optional[str] = None
    cool_schedule: Optional[str] = None


@dataclass
class LoadedIdf:
    """Result of :func:`load_idf`."""

    model: BuildingModel
    timestep: int = 1  # main steps per hour (E+ ``Timestep``)
    #: zone name -> design infiltration flow, m3/s (drive it through
    #: ``StepInputs.inf_vol``; heatx does not compile schedules).
    infiltration: Dict[str, float] = field(default_factory=dict)
    #: zone name -> design ventilation flow, m3/s (``StepInputs.vent_vol``).
    ventilation: Dict[str, float] = field(default_factory=dict)
    #: per-object airflow rules with their schedules (airflow_series).
    airflows: List[AirflowRule] = field(default_factory=list)
    #: object type (lower-case) -> count parsed, for diagnostics.
    counts: Dict[str, int] = field(default_factory=dict)
    #: (start day-of-year, end day-of-year), 0-based inclusive, from the
    #: first RunPeriod with explicit begin/end dates (else None).
    run_period: Optional[tuple] = None
    #: schedule name (lower-case) -> hourly [8760] value series.
    schedules: Dict[str, np.ndarray] = field(default_factory=dict)
    #: internal-gain devices (Lights / ElectricEquipment / People).
    gains: List[ImportedGain] = field(default_factory=list)
    #: imported thermostats (one IdealHeaterCooler per controlled zone).
    thermostats: List[ImportedThermostat] = field(default_factory=list)
    #: scheduled window-shading rules (shading_series renders them).
    shading: List["ShadingRule"] = field(default_factory=list)
    #: zone-state shading rules (lowered to in-run ZoneShadingControls on
    #: the model; shading_setpoint_series renders their schedule gates).
    zone_shading: List["ShadingRule"] = field(default_factory=list)
    #: zone name -> Zone Multiplier (only non-1 entries).  heatx marches
    #: ONE instance of the zone (EnergyPlus's own semantics: the
    #: multiplier scales the zone's contribution to building totals, not
    #: its physics); multiply per-zone loads by these when aggregating —
    #: :meth:`multipliers` gives the compiled-order vector, and the CLI
    #: applies it to the building demand totals automatically.
    zone_multipliers: Dict[str, float] = field(default_factory=dict)

    def schedule_series(self, name: str, T: int, start_hour: int = 0):
        """The named schedule rendered over ``T`` hours (year-periodic)."""
        s = self.schedules.get(name.lower())
        if s is None:
            raise KeyError(f"schedule {name!r} not found in the IDF")
        return s[(start_hour + np.arange(T)) % 8760]

    def multipliers(self) -> np.ndarray:
        """[n_zones] Zone Multiplier vector in compiled zone order (1.0
        where unset) — multiply per-zone loads by this when aggregating
        to building totals (EnergyPlus Zone field 7 semantics)."""
        return np.array([
            self.zone_multipliers.get(sp.name, 1.0)
            for sp in self.model.spaces
        ])

    def shading_series(
        self,
        T: int,
        start_hour: int = 0,
        *,
        dry_bulb: Optional[np.ndarray] = None,
        horizontal_solar: Optional[np.ndarray] = None,
        incident: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Per-hour incident-solar multipliers from the imported shading
        rules: a [T, n_surfaces + n_fenestrations] array aligned with the
        compiled surface order, 1.0 everywhere except controlled panes
        during deployed hours, where it is the shade's solar
        transmittance.  Multiply the ``sol_front``/``sol_back`` inputs by
        it (the CLI does this automatically).

        Weather-dependent control types evaluate host-side from the
        keyword context: ``dry_bulb`` [T] C for
        OnIfHighOutdoorAirTemperature, ``horizontal_solar`` [T] W/m2
        (EPW global horizontal) for OnIfHighHorizontalSolar, and
        ``incident`` [T, n_surfaces + n_fenestrations] W/m2 (the same
        incident-solar array the multipliers will scale, pre-scaling) for
        OnIfHighSolarOnWindow.  A rule whose needed context is missing
        warns and leaves its panes unshaded for this call.

        Approximation (documented in the import warning semantics): a
        deployed shade scales the pane's incident solar by its
        transmittance — exact for the transmitted beam of an exterior
        shade, ignoring shade absorption re-emission and inter-reflection
        (EnergyPlus's full shade layer model); interior shades are treated
        the same (conservative for gain reduction)."""
        S = len(self.model.surfaces)
        names = {
            f.name: S + i for i, f in enumerate(self.model.fenestrations)
        }
        out = np.ones((T, S + len(self.model.fenestrations)))
        # (kw, context, is-per-pane, which rule setpoint) conditions per
        # control kind; AND-combinations list two.
        needs = {
            "high_outdoor_temp": [("dry_bulb", dry_bulb, False, "setpoint")],
            "high_horizontal_solar": [
                ("horizontal_solar", horizontal_solar, False, "setpoint")
            ],
            "high_solar": [("incident", incident, True, "setpoint")],
            "high_outdoor_and_solar": [
                ("dry_bulb", dry_bulb, False, "setpoint"),
                ("incident", incident, True, "setpoint2"),
            ],
            "high_outdoor_and_horizontal": [
                ("dry_bulb", dry_bulb, False, "setpoint"),
                ("horizontal_solar", horizontal_solar, False, "setpoint2"),
            ],
        }
        for rule in self.shading:
            if rule.schedule is None:
                deployed = np.ones(T, bool)
            else:
                deployed = self.schedule_series(
                    rule.schedule, T, start_hour
                ) > 0.0
            conds = needs.get(rule.control, [])
            missing = [kw for kw, ctx, _, _ in conds if ctx is None]
            if missing:
                warnings.warn(
                    f"{rule.name}: control needs the "
                    f"{'/'.join(missing)}= weather context (not passed "
                    "to shading_series) — these panes run unshaded for "
                    "this call",
                    stacklevel=2,
                )
                continue
            per_pane = []  # (ctx [T, cols], threshold) per-pane conditions
            for kw, ctx, is_pane, sp_attr in conds:
                ctx = np.asarray(ctx, np.float64)
                if ctx.shape[0] != T:
                    raise ValueError(
                        f"{rule.name}: {kw} has {ctx.shape[0]} steps, "
                        f"expected {T}"
                    )
                sp = getattr(rule, sp_attr)
                if is_pane:
                    if ctx.shape[1:] != out.shape[1:]:
                        raise ValueError(
                            f"{rule.name}: incident must be [T, "
                            f"{out.shape[1]}] (surfaces then "
                            "fenestrations in compiled order)"
                        )
                    per_pane.append((ctx, sp))
                else:
                    deployed = deployed & (ctx > sp)
            for fname in rule.fenestrations:
                col = names[fname]
                dep = deployed
                for ctx, sp in per_pane:
                    dep = dep & (ctx[:, col] > sp)
                out[dep, col] = np.minimum(
                    out[dep, col], rule.transmittance
                )
        return out

    def shading_setpoint_series(
        self, T: int, start_hour: int = 0
    ) -> Optional[np.ndarray]:
        """The ``StepInputs.shade_sp`` override implementing the schedule
        AND-gates of the imported in-run (zone-state) shading rules: a
        [T, n_surfaces + n_fenestrations] array carrying each controlled
        pane's setpoint on schedule-allowed hours and +1e9 (never
        deploy) on blocked hours / uncontrolled panes.  ``None`` when no
        in-run rule carries a schedule — the compiled setpoints then
        already say everything (pass nothing to the run)."""
        if not any(r.schedule for r in self.zone_shading):
            return None
        S = len(self.model.surfaces)
        names = {
            f.name: S + i for i, f in enumerate(self.model.fenestrations)
        }
        out = np.full((T, S + len(self.model.fenestrations)), 1e9)
        for rule in self.zone_shading:
            allow = (
                np.ones(T, bool)
                if rule.schedule is None
                else self.schedule_series(rule.schedule, T, start_hour) > 0.0
            )
            for fname in rule.fenestrations:
                out[:, names[fname]] = np.where(allow, rule.setpoint, 1e9)
        return out

    def airflow_series(self, T: int, start_hour: int = 0) -> Dict[str, np.ndarray]:
        """Per-hour outdoor-air exchange from the imported
        ZoneInfiltration/ZoneVentilation objects: a dict with ``inf_vol`` /
        ``vent_vol`` [T, n_zones] m3/s (design flow x schedule; keys only
        present when the IDF has objects of that kind).  The caller supplies
        the inlet temperature (outdoor dry bulb for both; the CLI wires
        it)."""
        out: Dict[str, np.ndarray] = {}
        zn = [s.name for s in self.model.spaces]
        for kind, key in (("infiltration", "inf_vol"), ("ventilation", "vent_vol")):
            rules = [r for r in self.airflows if r.kind == kind]
            if not rules:
                continue
            v = np.zeros((T, len(zn)), np.float64)
            for r in rules:
                s = (
                    self.schedule_series(r.schedule, T, start_hour)
                    if r.schedule
                    else 1.0
                )
                v[:, zn.index(r.zone)] += r.flow * s
            out[key] = v
        return out

    def hourly_channels(self, T: int, start_hour: int = 0) -> Dict[str, np.ndarray]:
        """StepInputs channel overrides driving the imported internal gains
        and thermostat setpoint schedules over ``T`` hours.

        Returns a dict with any of ``lum_power`` [T, n_luminaires],
        ``hvac_power`` [T, n_hvacs], ``heat_sp``/``cool_sp`` [T, n_zones]
        — feed it to ``ThermalModel.inputs_sequence(T, **channels)`` or the
        corresponding ``FastRunner.run`` sequence.  Schedules repeat
        year-periodically; ``start_hour`` offsets into the year."""
        out: Dict[str, np.ndarray] = {}

        def render(g: ImportedGain) -> np.ndarray:
            p = np.full(T, g.design_w, np.float64)
            for s in g.schedules:
                p = p * self.schedule_series(s, T, start_hour)
            return p

        lum = [g for g in self.gains if g.channel == "lum"]
        if lum:
            lp = np.zeros((T, len(self.model.luminaires)), np.float64)
            for g in lum:
                lp[:, g.index] += render(g)
            out["lum_power"] = lp
        hv = [g for g in self.gains if g.channel == "hvac"]
        if hv:
            hp = np.zeros((T, len(self.model.hvacs)), np.float64)
            for g in hv:
                hp[:, g.index] += render(g)
            out["hvac_power"] = hp
        if any(t.heat_schedule or t.cool_schedule for t in self.thermostats):
            zn = [s.name for s in self.model.spaces]
            heat = np.full((T, len(zn)), -1e9, np.float64)
            cool = np.full((T, len(zn)), 1e9, np.float64)
            for t in self.thermostats:
                zi = zn.index(t.zone)
                hvac = next(
                    h for h in self.model.hvacs
                    if isinstance(h, IdealHeaterCooler) and h.name == t.name
                )
                heat[:, zi] = (
                    self.schedule_series(t.heat_schedule, T, start_hour)
                    if t.heat_schedule
                    else (-1e9 if hvac.heat_setpoint is None
                          else hvac.heat_setpoint)
                )
                cool[:, zi] = (
                    self.schedule_series(t.cool_schedule, T, start_hour)
                    if t.cool_schedule
                    else (1e9 if hvac.cool_setpoint is None
                          else hvac.cool_setpoint)
                )
            out["heat_sp"] = heat
            out["cool_sp"] = cool
        return out


def _tokenize(text: str) -> List[List[str]]:
    """IDF statements as lists of stripped fields.

    An IDF is ``Type, f1, f2, ... ;`` with ``!`` comments to end-of-line."""
    lines = []
    for raw in text.splitlines():
        bang = raw.find("!")
        lines.append(raw if bang < 0 else raw[:bang])
    objects = []
    for stmt in "\n".join(lines).split(";"):
        fields = [f.strip() for f in stmt.split(",")]
        if fields and fields[0]:
            objects.append(fields)
    return objects


def _num(fields: List[str], i: int, default: Optional[float] = None) -> Optional[float]:
    if i >= len(fields) or fields[i] == "":
        return default
    return float(fields[i])


def _str(fields: List[str], i: int, default: str = "") -> str:
    return fields[i] if i < len(fields) else default


def _plane_frame(n: np.ndarray):
    """In-plane axes of a non-horizontal surface with outward normal
    ``n``: ``(w, u)`` with ``w`` the horizontal width axis
    (``cross(z_hat, n)`` normalized — "to the right" viewed from
    outside) and ``u`` the up-slope axis (``cross(n, w)``).  ``None``
    for (near-)horizontal surfaces, where the frame is undefined.
    Shared by the rectangular-window vertex synthesis and the
    Overhang/Fin shading lowering."""
    horiz = np.array([-n[1], n[0], 0.0])  # cross(z_hat, n)
    nh = float(np.linalg.norm(horiz))
    if nh < 1e-9:
        return None
    w = horiz / nh
    return w, np.cross(n, w)


def _vertices(fields: List[str], n_field: int) -> np.ndarray:
    # Number of Vertices may be blank OR 'autocalculate' (the E+ default
    # many tools emit): both mean "derive from the coordinate list".
    try:
        n = _num(fields, n_field)
    except ValueError:
        n = None
    coords = [float(f) for f in fields[n_field + 1 :] if f != ""]
    if n is not None and len(coords) != int(n) * 3:
        raise ValueError(
            f"surface '{fields[1]}': {len(coords)} coordinates for "
            f"{int(n)} declared vertices"
        )
    return np.asarray(coords, dtype=np.float64).reshape(-1, 3)


def _polygon_area(v: np.ndarray) -> float:
    # One area implementation for the whole model layer (the hand-rolled
    # cross-sum twin could drift from the one resolved_geometry uses).
    from heatx_torch.model.geometry import polygon_area

    return polygon_area(v)


def _parse_md(s: str) -> int:
    """``M/D`` -> 0-based day-of-year (365-day year, no leap day)."""
    m, d = (int(x) for x in s.strip().split("/"))
    return sum(_MONTH_DAYS[: m - 1]) + d - 1


def _dow_matches(groups: set, dow: str) -> bool:
    """Does a For: day-type group cover the given weekday name?

    Special-day groups (Holidays, SummerDesignDay, ...) never match a real
    calendar day — the rendered year has none of them; ``AllOtherDays``
    matches anything not covered by an earlier rule (the caller tries rules
    in listing order, so plain membership is the right reading)."""
    if "alldays" in groups or "allotherdays" in groups:
        return True
    if dow in groups:
        return True
    if "weekdays" in groups and dow in _WEEKDAYS[1:6]:
        return True
    if "weekends" in groups and dow in ("saturday", "sunday"):
        return True
    return False


def _compact_schedule(o: List[str], start_dow: int) -> np.ndarray:
    """Render a ``Schedule:Compact`` object to an hourly [8760] series.

    Grammar: ``Through: M/D`` periods, ``For:`` day-type groups, ``Until:
    HH:MM, value`` pairs.  Hour ``k`` (0-based, hour-beginning) takes the
    value of the first Until whose end time exceeds ``k`` — EnergyPlus's
    hour-ending convention rendered on the hour-beginning grid every other
    heatx series uses."""
    name = o[1]
    hourly = np.full((365, 24), np.nan)
    periods: List = []  # (end_day inclusive, [(day groups, [(until_h, v)])])
    cur_rules = cur_until = None
    pending_h = None
    for f in o[3:]:  # skip object type, name, schedule-type-limits
        low = f.lower()
        if not low:
            continue
        if low.startswith("through"):
            cur_rules = []
            periods.append((_parse_md(f.split(":", 1)[1]), cur_rules))
        elif low.startswith("for"):
            if cur_rules is None:
                raise ValueError(f"Schedule:Compact {name!r}: For before Through")
            cur_until = []
            cur_rules.append((set(f.split(":", 1)[1].lower().split()), cur_until))
        elif low.startswith("interpolate"):
            if "no" not in low:
                warnings.warn(
                    f"Schedule:Compact {name!r}: Interpolate is ignored "
                    "(hourly rendering)",
                    stacklevel=2,
                )
        elif low.startswith("until"):
            t = f.split(":", 1)[1].strip()
            parts = t.split(":")
            h = int(parts[0])
            if len(parts) > 1 and int(parts[1]) != 0:
                raise ValueError(
                    f"Schedule:Compact {name!r}: Until {t!r} is not a whole "
                    "hour (hourly rendering only)"
                )
            pending_h = h
        else:
            if pending_h is None or cur_until is None:
                raise ValueError(
                    f"Schedule:Compact {name!r}: value {f!r} without an Until"
                )
            cur_until.append((pending_h, float(f)))
            pending_h = None
    day = 0
    for end_day, rules in periods:
        if end_day >= 365:
            end_day = 364
        while day <= end_day:
            dow = _WEEKDAYS[(start_dow + day) % 7]
            for groups, untils in rules:
                if _dow_matches(groups, dow):
                    prev = 0
                    for h, v in untils:
                        hourly[day, prev:h] = v
                        prev = h
                    break
            day += 1
    if np.isnan(hourly).any():
        d, h = np.argwhere(np.isnan(hourly))[0]
        raise ValueError(
            f"Schedule:Compact {name!r} leaves day {int(d)} hour {int(h)} "
            "undefined (add a For: AllOtherDays rule and Until: 24:00)"
        )
    return hourly.reshape(8760)


def _parse_until_pairs(name: str, fields: List[str], prof: np.ndarray):
    """Fill a [24] day profile from ``Until HH:MM, value`` field pairs
    (hour-ending times rendered on the hour-beginning grid, like
    :func:`_compact_schedule`)."""
    prev = 0
    vals = [f for f in fields if f != ""]
    if len(vals) % 2:
        raise ValueError(f"{name}: dangling Until/value field {vals[-1]!r}")
    for i in range(0, len(vals), 2):
        t = vals[i].lower().replace("until", "").lstrip(": ").strip()
        parts = t.split(":")
        h = int(parts[0])
        if len(parts) > 1 and int(parts[1]) != 0:
            raise ValueError(
                f"{name}: Until {t!r} is not a whole hour (hourly rendering "
                "only)"
            )
        prof[prev:h] = float(vals[i + 1])
        prev = h
    if np.isnan(prof).any():
        raise ValueError(
            f"{name} leaves hour {int(np.argwhere(np.isnan(prof))[0])} "
            "undefined (end with Until: 24:00)"
        )


def _day_week_year_schedules(by_type, start_dow: int) -> Dict[str, np.ndarray]:
    """Render the classic ``Schedule:Day:Hourly`` / ``Schedule:Day:Interval``
    -> ``Schedule:Week:Daily`` / ``Schedule:Week:Compact`` -> ``Schedule:Year``
    family to hourly [8760] series (one per Schedule:Year; the day/week
    objects are building blocks and are not directly referenceable by gains).

    Day-of-week anchoring uses the same RunPeriod-derived ``start_dow`` as
    Schedule:Compact.  Special-day columns (Holiday, design days, custom
    days) never occur in the rendered calendar and are ignored."""
    days: Dict[str, np.ndarray] = {}
    for o in by_type.get("schedule:day:hourly", []):
        # Name, Type Limits, 24 hour-ending values (EnergyPlus requires all
        # 24; defaulting missing ones to 0 would silently zero evening gains
        # on a truncated object).
        if len(o) < 3 + 24:
            raise ValueError(
                f"Schedule:Day:Hourly {o[1]!r} has {max(0, len(o) - 3)} of "
                "the required 24 hourly values"
            )
        # Blank-but-present fields keep the IDD's per-hour default of 0.
        days[o[1].lower()] = np.asarray(
            [_num(o, 3 + i, 0.0) for i in range(24)], np.float64
        )
    for o in by_type.get("schedule:day:interval", []):
        # Name, Type Limits, Interpolate to Timestep, (Time, value)*.
        if _str(o, 3).lower() not in ("", "no"):
            warnings.warn(
                f"Schedule:Day:Interval {o[1]!r}: Interpolate is ignored "
                "(hourly rendering)",
                stacklevel=3,
            )
        prof = np.full(24, np.nan)
        _parse_until_pairs(f"Schedule:Day:Interval {o[1]!r}", o[4:], prof)
        days[o[1].lower()] = prof

    def day_ref(owner: str, name: str) -> np.ndarray:
        d = days.get(name.lower())
        if d is None:
            raise ValueError(
                f"{owner}: day schedule {name!r} is not a parsed "
                "Schedule:Day:Hourly/Schedule:Day:Interval"
            )
        return d

    weeks: Dict[str, List[np.ndarray]] = {}  # name -> [Sun..Sat] profiles
    for o in by_type.get("schedule:week:daily", []):
        # Name, then day-schedule names Sunday..Saturday (fields 2-8; the
        # holiday/design-day/custom columns that follow never render).
        weeks[o[1].lower()] = [
            day_ref(f"Schedule:Week:Daily {o[1]!r}", _str(o, 2 + i))
            for i in range(7)
        ]
    for o in by_type.get("schedule:week:compact", []):
        # Name, (DayType List: For ..., day-schedule-name)*.  Earlier rules
        # win, so only unfilled slots take later matches (AllOtherDays).
        prof: List[Optional[np.ndarray]] = [None] * 7
        vals = [f for f in o[2:] if f != ""]
        if len(vals) % 2:
            raise ValueError(
                f"Schedule:Week:Compact {o[1]!r}: dangling DayType list "
                f"{vals[-1]!r} without a day-schedule name"
            )
        for i in range(0, len(vals) - 1, 2):
            groups = set(
                vals[i].lower().replace("for", "").lstrip(": ").split()
            )
            d = day_ref(f"Schedule:Week:Compact {o[1]!r}", vals[i + 1])
            for di, dow in enumerate(_WEEKDAYS):
                if prof[di] is None and _dow_matches(groups, dow):
                    prof[di] = d
        if any(p is None for p in prof):
            missing = next(d for d, p in zip(_WEEKDAYS, prof) if p is None)
            raise ValueError(
                f"Schedule:Week:Compact {o[1]!r} leaves {missing} uncovered "
                "(add a For: AllOtherDays rule)"
            )
        weeks[o[1].lower()] = prof

    out: Dict[str, np.ndarray] = {}
    for o in by_type.get("schedule:year", []):
        # Name, Type Limits, (week name, begin M, begin D, end M, end D)*.
        hourly = np.full((365, 24), np.nan)
        vals = [f for f in o[3:] if f != ""]
        if len(vals) % 5:
            raise ValueError(
                f"Schedule:Year {o[1]!r}: fields after the name must come in "
                "(week, begin M/D, end M/D) groups of five"
            )
        for i in range(0, len(vals), 5):
            wk = weeks.get(vals[i].lower())
            if wk is None:
                raise ValueError(
                    f"Schedule:Year {o[1]!r}: week schedule {vals[i]!r} is "
                    "not a parsed Schedule:Week:Daily/Schedule:Week:Compact"
                )
            d0 = _parse_md(f"{int(float(vals[i + 1]))}/{int(float(vals[i + 2]))}")
            d1 = _parse_md(f"{int(float(vals[i + 3]))}/{int(float(vals[i + 4]))}")
            for day in range(d0, min(d1, 364) + 1):
                hourly[day] = wk[(start_dow + day) % 7]
        if np.isnan(hourly).any():
            d = int(np.argwhere(np.isnan(hourly[:, 0]))[0, 0])
            raise ValueError(
                f"Schedule:Year {o[1]!r} leaves day {d + 1} uncovered "
                "(periods must span 1/1 through 12/31)"
            )
        out[o[1].lower()] = hourly.reshape(8760)
    return out


def load_idf(path_or_text: str) -> LoadedIdf:
    """Parse an EnergyPlus IDF (path or raw text) into a ``LoadedIdf``.

    Raises ``ValueError`` on objects outside the supported envelope subset
    that affect the thermal model (unknown boundary conditions, gas layers,
    autocalculated volumes); ignores purely-reporting objects."""
    if "\n" not in path_or_text:
        if os.path.exists(path_or_text):
            with open(path_or_text) as f:
                text = f.read()
        elif path_or_text.lower().endswith(".idf") or os.sep in path_or_text:
            # Looks like a path: tokenizing a typo'd filename as raw IDF
            # text would "succeed" with an empty model.
            raise FileNotFoundError(path_or_text)
        else:
            text = path_or_text
    else:
        text = path_or_text

    objs = _tokenize(text)
    counts: Dict[str, int] = {}
    by_type: Dict[str, List[List[str]]] = {}
    for o in objs:
        t = o[0].lower()
        counts[t] = counts.get(t, 0) + 1
        by_type.setdefault(t, []).append(o)

    m = BuildingModel()
    out = LoadedIdf(model=m, counts=counts)

    unknown = sorted(
        t for t in by_type
        if t not in _SUPPORTED_TYPES
        and not any(t.startswith(p) for p in _IGNORABLE_PREFIXES)
    )
    if unknown:
        # Honest-degradation notice: these objects may carry thermal content
        # (HVAC systems, shades, ...) that the imported model will NOT have.
        warnings.warn(
            f"IDF objects not imported (no thermal effect in the model): "
            f"{', '.join(unknown)}",
            stacklevel=2,
        )

    for o in by_type.get("timestep", []):
        out.timestep = int(_num(o, 1, 1.0))

    north_axis = 0.0  # building rotation, degrees clockwise from true north
    for o in by_type.get("building", []):
        north_axis = _num(o, 2, 0.0) or 0.0
        terrain = _str(o, 3).lower()
        if terrain in _TERRAINS:
            m.site_details = SiteDetails(terrain=terrain)

    # -- geometry rules ---------------------------------------------------------
    # Starting Vertex Position is irrelevant to area/normal math; the entry
    # direction flips the winding (outward normal), and Relative coordinates
    # rotate by (building north axis + zone relative north) and translate by
    # the zone origin.
    clockwise = False
    relative = False
    for o in by_type.get("globalgeometryrules", []):
        clockwise = _str(o, 2).lower().startswith("clockwise")
        cs = _str(o, 3).lower()
        relative = cs in ("", "relative")  # E+ default is Relative
        if cs not in ("", "relative", "world", "absolute"):
            raise ValueError(
                f"GlobalGeometryRules: unsupported Coordinate System {cs!r}"
            )

    for kind in ("surfaceconvectionalgorithm:inside",
                 "surfaceconvectionalgorithm:outside"):
        for o in by_type.get(kind, []):
            if _str(o, 1).upper() != "TARP":
                warnings.warn(
                    f"{o[0]} {o[1]!r}: heatx implements TARP only (like the "
                    "reference, convection.rs); simulating with TARP",
                    stacklevel=2,
                )

    # -- schedules -> hourly [8760] series -------------------------------------
    start_dow = 0  # Jan 1 weekday; E+ RunPeriod default is Sunday
    for o in by_type.get("runperiod", []):
        if out.run_period is None:
            try:
                bm, bd = int(_num(o, 2, 0)), int(_num(o, 3, 0))
                # End month/day: fields 4/5 in the classic schema; 9.x
                # inserts Begin/End Year fields — collect the numeric
                # values after the begin date, skipping years (>= 1000)
                # and stopping at the weekday string.
                tail = []
                for f in o[4:9]:
                    if not f:
                        continue
                    try:
                        v = float(f)
                    except ValueError:
                        break
                    if v < 1000:
                        tail.append(int(v))
                if bm and bd and len(tail) >= 2:
                    out.run_period = (
                        _parse_md(f"{bm}/{bd}"),
                        _parse_md(f"{tail[0]}/{tail[1]}"),
                    )
            except (ValueError, IndexError):
                pass
        for f in o[2:]:
            if f.lower() in _WEEKDAYS:
                # Day of Week for Start Day names the RUN PERIOD's begin
                # date (fields 2/3 in both schema generations), not Jan 1:
                # anchor the year's weekday cycle so the begin date lands
                # on the declared weekday.
                begin_doy = 0
                bm, bd = _num(o, 2, 1.0), _num(o, 3, 1.0)
                if bm and bd:
                    begin_doy = _parse_md(f"{int(bm)}/{int(bd)}")
                start_dow = (_WEEKDAYS.index(f.lower()) - begin_doy) % 7
                break
    for o in by_type.get("schedule:constant", []):
        out.schedules[o[1].lower()] = np.full(8760, _num(o, 3, 1.0))
    for o in by_type.get("schedule:compact", []):
        out.schedules[o[1].lower()] = _compact_schedule(o, start_dow)
    out.schedules.update(_day_week_year_schedules(by_type, start_dow))

    def _sched_ref(name: str, owner: str) -> Optional[str]:
        """Validate a schedule reference; '' means always-on (None)."""
        if not name:
            return None
        if name.lower() not in out.schedules:
            raise ValueError(
                f"{owner}: schedule {name!r} is not a parsed "
                "Schedule:Constant/Schedule:Compact/Schedule:Year"
            )
        return name.lower()

    # -- materials -> Substance + Material -----------------------------------
    for o in by_type.get("material", []):
        name = o[1]
        # Name, Roughness, Thickness, Conductivity, Density, Specific Heat,
        # Thermal Absorptance, Solar Absorptance, Visible Absorptance.
        if _num(o, 3) is None or _num(o, 4) is None:
            raise ValueError(
                f"Material {name!r}: Thickness and Conductivity are required"
            )
        eps = _num(o, 7, 0.9)
        alpha = _num(o, 8, 0.7)
        m.add_substance(Substance(
            f"{name} substance",
            thermal_conductivity=_num(o, 4),
            density=_num(o, 5),
            specific_heat_capacity=_num(o, 6),
            front_thermal_absorbtance=eps,
            back_thermal_absorbtance=eps,
            front_solar_absorbtance=alpha,
            back_solar_absorbtance=alpha,
            solar_transmittance=0.0,
        ))
        m.add_material(Material(name, f"{name} substance", _num(o, 3)))

    def _pure_r_material(name: str, r_value, eps: float, alpha: float, owner: str):
        """Realize a thermal-resistance-only layer (Material:NoMass /
        Material:AirGap) as the equivalent light slab — see the NoMass note
        in the module docstring."""
        if not r_value or r_value <= 0.0:
            raise ValueError(
                f"{owner}: a positive Thermal Resistance is required"
            )
        m.add_substance(Substance(
            f"{name} substance",
            thermal_conductivity=NOMASS_CONDUCTIVITY,
            density=NOMASS_DENSITY,
            specific_heat_capacity=NOMASS_SPECIFIC_HEAT,
            front_thermal_absorbtance=eps,
            back_thermal_absorbtance=eps,
            front_solar_absorbtance=alpha,
            back_solar_absorbtance=alpha,
            solar_transmittance=0.0,
        ))
        m.add_material(Material(name, f"{name} substance",
                                r_value * NOMASS_CONDUCTIVITY))

    for o in by_type.get("material:nomass", []):
        # Name, Roughness, Thermal Resistance, Thermal Abs, Solar Abs, Vis.
        _pure_r_material(
            o[1], _num(o, 3), _num(o, 4, 0.9), _num(o, 5, 0.7),
            f"Material:NoMass {o[1]!r}",
        )

    for o in by_type.get("windowmaterial:glazing", []):
        name = o[1]
        # Standard schema: Name, Optical Data Type, Spectral Data Set,
        # Thickness, tau_sol, refl_f, refl_b, tau_vis, vrefl_f, vrefl_b,
        # tau_ir, eps_f, eps_b, Conductivity.  The fixtures ship a truncated
        # variant with no Thickness field (field 4 is already tau_sol <= 1
        # and only 9 data fields follow the name) — detect by field count.
        # Plausibility guards: a real Thickness field is metres (< 0.1),
        # AND the standard schema carries emissivity/conductivity content
        # at indices 12-14 — requiring something non-empty there keeps a
        # truncated dark-glass object (tau_sol < 0.1, trailing-comma
        # padded with BLANKS) from masquerading as standard, while a
        # standard object that leaves Conductivity blank (IDD default)
        # still classifies by its emissivity fields.
        t4 = _num(o, 4)
        standard = (
            t4 is not None and t4 < 0.1
            and any(_str(o, i) for i in (12, 13, 14))
        )
        if standard:
            thickness = _num(o, 4, GLAZING_THICKNESS)
            tau = _num(o, 5, 0.0)
            refl_f, refl_b = _num(o, 6, 0.0), _num(o, 7, 0.0)
            eps_f = _num(o, 12, 0.84)
            eps_b = _num(o, 13, 0.84)
            k = _num(o, 14, GLAZING_CONDUCTIVITY)
        else:
            thickness = GLAZING_THICKNESS
            tau = _num(o, 4, 0.0)
            refl_f, refl_b = _num(o, 5, 0.0), _num(o, 6, 0.0)
            eps_f = eps_b = 0.84
            k = GLAZING_CONDUCTIVITY
        m.add_substance(Substance(
            f"{name} substance",
            thermal_conductivity=k,
            density=GLAZING_DENSITY,
            specific_heat_capacity=GLAZING_SPECIFIC_HEAT,
            front_thermal_absorbtance=eps_f,
            back_thermal_absorbtance=eps_b,
            front_solar_absorbtance=max(0.0, 1.0 - tau - refl_f),
            back_solar_absorbtance=max(0.0, 1.0 - tau - refl_b),
            solar_transmittance=tau,
        ))
        m.add_material(Material(name, f"{name} substance", thickness))

    for o in by_type.get("material:airgap", []):
        # Name, Thermal Resistance — an opaque-construction air gap is a
        # pure R like Material:NoMass (an interior layer, so the surface
        # absorptance defaults never apply).
        _pure_r_material(
            o[1], _num(o, 2), 0.9, 0.7, f"Material:AirGap {o[1]!r}"
        )

    for o in by_type.get("windowmaterial:gas", []):
        # Name, Gas Type, Thickness -> an ISO 15099 gas cavity layer (the
        # discretizer lowers it to heatx.physics.cavity, like the
        # reference's UValue::Cavity, discretization.rs:221-285).
        name = o[1]
        gtype = _str(o, 2).lower()
        if gtype not in ("air", "argon", "krypton", "xenon"):
            raise ValueError(
                f"WindowMaterial:Gas {name!r}: unsupported gas {gtype!r} "
                "(Air/Argon/Krypton/Xenon)"
            )
        m.add_substance(GasSubstance(f"{name} substance", gtype))
        m.add_material(Material(name, f"{name} substance", _num(o, 3)))

    for o in by_type.get("windowmaterial:simpleglazingsystem", []):
        # Name, U-Factor, SHGC, [Visible Transmittance] -> equivalent
        # single pane (see module docstring for the approximation).
        name = o[1]
        u = _num(o, 2)
        shgc = _num(o, 3)
        if not u or shgc is None:
            raise ValueError(
                f"WindowMaterial:SimpleGlazingSystem {name!r}: U-Factor and "
                "SHGC are required"
            )
        # NFRC winter rating films: h_out ~ 26 (5.5 m/s), h_in ~ 7.7 W/m2K.
        r_glass = max(1.0 / u - (1.0 / 26.0 + 1.0 / 7.7), 1e-4)
        tau = min(float(shgc), 0.92)
        alpha = min(0.08, 1.0 - tau)
        m.add_substance(Substance(
            f"{name} substance",
            thermal_conductivity=GLAZING_THICKNESS / r_glass,
            density=GLAZING_DENSITY,
            specific_heat_capacity=GLAZING_SPECIFIC_HEAT,
            front_thermal_absorbtance=0.84,
            back_thermal_absorbtance=0.84,
            front_solar_absorbtance=alpha,
            back_solar_absorbtance=alpha,
            solar_transmittance=tau,
        ))
        m.add_material(Material(name, f"{name} substance", GLAZING_THICKNESS))

    for o in by_type.get("construction", []):
        # Name, then layers outside -> inside == heatx front -> back.
        layers = [f for f in o[2:] if f]
        if not layers:
            raise ValueError(f"Construction {o[1]!r} has no layers")
        m.add_construction(Construction(o[1], layers))

    # -- zones ----------------------------------------------------------------
    zone_floor_area: Dict[str, float] = {}
    zone_xform: Dict[str, tuple] = {}  # zone -> (rel. north deg, origin xyz)
    pending_zones: List[tuple] = []  # (name, volume|None, ceiling|None)
    for o in by_type.get("zone", []):
        name = o[1]
        mult = _num(o, 7, 1.0) or 1.0
        if mult != 1.0:
            # EnergyPlus semantics: the multiplier scales the zone's
            # contribution to building totals; the zone itself is
            # simulated once.  Recorded for aggregation (the CLI demand
            # totals apply it; LoadedIdf.multipliers).
            out.zone_multipliers[name] = float(mult)
        vol = _str(o, 9).lower()
        ch = _str(o, 8).lower()
        pending_zones.append((
            name,
            float(vol) if vol not in ("", "autocalculate") else None,
            float(ch) if ch not in ("", "autocalculate") else None,
        ))
        zone_xform[name] = (
            _num(o, 2, 0.0) or 0.0,
            np.array([
                _num(o, 3, 0.0) or 0.0,
                _num(o, 4, 0.0) or 0.0,
                _num(o, 5, 0.0) or 0.0,
            ]),
        )
        fa = _str(o, 10).lower()
        if fa not in ("", "autocalculate"):
            zone_floor_area[name] = float(fa)

    def _to_world(verts: np.ndarray, zone: str) -> np.ndarray:
        """Apply the geometry rules: flip clockwise winding to the CCW the
        normal math assumes, and lower Relative coordinates to world —
        rotate by (building north axis + zone relative north, clockwise
        positive) and add the zone origin.  The origin itself is applied
        untransformed: absolute x/y never enter the physics, and the z
        offset (wind-profile height) is translation only."""
        if clockwise:
            verts = verts[::-1]
        if relative:
            th, origin = zone_xform.get(zone, (0.0, np.zeros(3)))
            b = np.radians(north_axis + th)
            c, s = np.cos(b), np.sin(b)
            x, y = verts[:, 0], verts[:, 1]
            verts = np.column_stack([c * x + s * y, -s * x + c * y, verts[:, 2]])
            verts = verts + origin
        return verts

    # -- surfaces --------------------------------------------------------------
    computed_floor_area: Dict[str, float] = {}  # from Floor-type surfaces
    surf_zone: Dict[str, str] = {}  # surface name -> zone (for OBC=Surface)
    surf_front: Dict[str, Boundary] = {}
    surf_def: Dict[str, SurfaceDef] = {}  # name -> SurfaceDef (host lookups)
    surf_canon: Dict[str, str] = {}  # lower -> declared surface name
    pending = []  # (SurfaceDef, obc_surface_name) resolved after the loop
    known_obc = {"outdoors", "ground", "zone", "surface", "adiabatic",
                 "othersidecoefficients", "othersideconditionsmodel"}
    # EnergyPlus name matching is case-insensitive: canonicalize zone and
    # surface references to the declared spellings.
    zone_decl = {n.lower(): n for (n, _, _) in pending_zones}

    def _zone_decl_ref(nm: str, owner: str) -> str:
        z = zone_decl.get(nm.lower())
        if z is None:
            raise ValueError(f"{owner}: unknown zone {nm!r}")
        return z

    def _host_ref(nm: str, owner: str) -> str:
        h = surf_canon.get(nm.lower())
        if h is None:
            raise ValueError(f"{owner}: host surface {nm!r} not found")
        return h
    for o in by_type.get("buildingsurface:detailed", []):
        # Name, Surface Type, Construction, Zone, [Space — added in E+ 22.1,
        # absent in older IDFs], OBC, OBC Object, Sun Exposure, Wind
        # Exposure, View Factor to Ground, N, coords...
        name, construction, zone = o[1], o[3], o[4]

        def _fits(sh):
            # Does reading N at 10+sh / coords from 11+sh make the declared
            # vertex count match the trailing coordinates?  Tolerates an
            # autocalculated/blank count (coords must then be whole triples).
            nf = _str(o, 10 + sh).lower()
            ncoord = len(o) - (11 + sh)
            if nf in ("", "autocalculate"):
                return ncoord >= 9 and ncoord % 3 == 0
            try:
                n1 = int(float(nf))
            except ValueError:
                return False
            return ncoord == n1 * 3

        in5 = _str(o, 5).lower() in known_obc
        in6 = _str(o, 6).lower() in known_obc
        if in5 != in6:
            shift = 1 if in6 else 0
        else:
            # Ambiguous (an OBC Object literally named 'Ground'/'Zone'...,
            # or unknown keywords both ways): disambiguate by which index
            # makes the vertex count match the trailing coordinates.
            shift = 1 if (_fits(1) and not _fits(0)) else 0
        obc, obc_obj = _str(o, 5 + shift).lower(), _str(o, 6 + shift)
        zone = _zone_decl_ref(zone, f"BuildingSurface {name!r}")
        surf_zone[name] = zone
        surf_canon[name.lower()] = name
        verts = _to_world(_vertices(o, 10 + shift), zone)
        if _str(o, 2).lower() == "floor":
            # (rotation + translation preserve polygon area)
            computed_floor_area[zone] = computed_floor_area.get(
                zone, 0.0
            ) + _polygon_area(verts)
        if obc == "outdoors":
            front: Optional[Boundary] = Boundary.outdoor()
        elif obc == "ground":
            front = Boundary.ground()
        elif obc == "zone":
            # Validate now: deferring leaves an obscure compile-time
            # KeyError with no IDF context.
            front = Boundary.space_(_zone_decl_ref(
                obc_obj,
                f"BuildingSurface {name!r} (Outside Boundary Condition "
                "Object)",
            ))
        elif obc == "surface":
            front = None  # the OBC object is a surface; resolve below
        else:
            raise ValueError(
                f"BuildingSurface {name!r}: unsupported Outside Boundary "
                f"Condition {obc!r} (supported: Outdoors/Ground/Zone/Surface)"
            )
        sd = SurfaceDef(name, construction, front or Boundary.outdoor(),
                        Boundary.space_(zone), vertices=verts)
        # Explicit "View Factor to Ground" (blank/autocalculate = geometric):
        # EnergyPlus honors it even where it disagrees with the tilt, so
        # reproducing a run needs it (the reference fixtures pin 0.5 on
        # tilted/horizontal surfaces).  Feeds heatx.weather.solar only.
        vfg = _str(o, 9 + shift).lower()
        if vfg not in ("", "autocalculate"):
            sd.ground_view_factor = float(vfg)
        if front is None:
            pending.append((sd, obc_obj))
        else:
            surf_front[name] = front
        surf_def[name] = sd
        m.add_surface(sd)
    for sd, other in pending:
        if other.lower() not in surf_canon:
            raise ValueError(
                f"BuildingSurface {sd.name!r}: OBC Object {other!r} names no "
                "parsed surface"
            )
        sd.front_boundary = Boundary.space_(surf_zone[surf_canon[other.lower()]])
        # Keep the front map consistent: a fenestration hosted on this
        # inter-zone wall must face the adjacent zone, not the outdoors.
        surf_front[sd.name] = sd.front_boundary

    # Zone air volumes, resolved now that Floor surfaces are parsed: an
    # autocalculated Volume derives as floor area x ceiling height (E+
    # computes the enclosure polyhedron; the prism product is exact for
    # the flat-floor/flat-ceiling zones that dominate practice).
    for zname, volume, ceiling in pending_zones:
        if volume is None:
            fa = zone_floor_area.get(zname, computed_floor_area.get(zname))
            if fa is None or ceiling is None:
                raise ValueError(
                    f"Zone {zname!r}: Volume is autocalculate and cannot be "
                    "derived — give the zone a Ceiling Height plus a Floor "
                    "surface (or explicit Floor Area), or set the Volume"
                )
            volume = fa * ceiling
        m.add_space(SpaceDef(zname, float(volume)))

    # -- fenestration: a window hosted in a wall ------------------------------
    host_area_cut: Dict[str, float] = {}
    fen_shading_ctl: Dict[str, str] = {}  # pane -> pre-9.0 control name
    rect_win_ctl: List[tuple] = []  # (owner, maybe-control-name) to check
    for o in by_type.get("fenestrationsurface:detailed", []):
        # Name, Surface Type, Construction, Building Surface Name,
        # OBC Object, View Factor, Frame, Multiplier, N, coords...
        # Pre-9.0 IDFs insert a Shading Control Name before Frame, pushing
        # Multiplier/N/coords one field right: disambiguate by which index
        # makes the declared vertex count match the coordinates (like
        # BuildingSurface's Space-field shift).
        name, construction, host = o[1], o[3], o[4]
        host = _host_ref(host, f"FenestrationSurface {name!r}")

        def _fen_fits(sh):
            nf = _str(o, 9 + sh).lower()
            ncoord = len(o) - (10 + sh)
            if nf in ("", "autocalculate"):
                return ncoord >= 9 and ncoord % 3 == 0
            try:
                n1 = int(float(nf))
            except ValueError:
                return False
            return ncoord == n1 * 3

        fshift = 1 if (_fen_fits(1) and not _fen_fits(0)) else 0
        verts = _to_world(_vertices(o, 9 + fshift), surf_zone[host])
        mult = _num(o, 8 + fshift, 1.0) or 1.0
        front = surf_front.get(host, Boundary.outdoor())
        fen = SurfaceDef(
            name, construction, front, Boundary.space_(surf_zone[host]),
            vertices=verts,
        )
        # View Factor to Ground sits before the generation-dependent shift
        # (Name, Type, Construction, Host, OBC Object, VFg, ...).
        fvfg = _str(o, 6).lower()
        if fvfg not in ("", "autocalculate"):
            fen.ground_view_factor = float(fvfg)
        if mult != 1.0:
            # Multiplier = that many identical panes: the fenestration's
            # heat-transfer area AND the host cut both scale (scaling the
            # perimeter too keeps the per-pane P/A characteristic length
            # the TARP forced term uses).
            from heatx_torch.model.geometry import polygon_perimeter

            fen.area = _polygon_area(verts) * mult
            fen.perimeter = polygon_perimeter(verts) * mult
        m.add_fenestration(fen)
        if fshift == 1 and _str(o, 7):
            # Pre-9.0 schema: the window references its
            # WindowProperty:ShadingControl by name (resolved at the end
            # of load_idf, once the control objects are parsed).
            fen_shading_ctl[name] = _str(o, 7).lower()
        host_area_cut[host] = (
            host_area_cut.get(host, 0.0) + _polygon_area(verts) * mult
        )
    for kind in ("window", "glazeddoor"):
        for o in by_type.get(kind, []):
            # Rectangular fenestration on a host wall.  The pane lies in
            # the host's plane: host orientation + the L x H rectangle's
            # area/perimeter; its centroid height = host base + Start Z +
            # H/2 (it feeds the wind profile).  Schema generations differ
            # in the leading optional fields (pre-9.0 has an extra Shading
            # Control), but both END with Start X, Start Z, Length, Height
            # — parse from the tail.
            name, construction, host = o[1], o[2], o[3]
            host = _host_ref(host, f"{o[0]} {name!r}")
            if _str(o, 4):
                # In the pre-9.0 schema field 4 is the Shading Control
                # Name; whether it is one is only knowable once the
                # control objects are parsed (resolved at the end).
                rect_win_ctl.append(
                    (f"{o[0]} {name!r}", name, _str(o, 4).lower())
                )
            last = max(i for i, f in enumerate(o) if f != "")
            if last < 7:
                raise ValueError(
                    f"{o[0]} {name!r}: Starting X/Z, Length and Height are "
                    "required"
                )
            length, height = _num(o, last - 1), _num(o, last)
            start_z = _num(o, last - 2, 0.0) or 0.0
            mult = _num(o, last - 4, 1.0) or 1.0
            if not length or not height:
                raise ValueError(
                    f"{o[0]} {name!r}: Length and Height are required"
                )
            start_x = _num(o, last - 3, 0.0) or 0.0
            host_sd = surf_def[host]
            _, _, normal0, h0 = host_sd.resolved_geometry()
            base_z = (
                float(np.min(host_sd.vertices[:, 2]))
                if host_sd.vertices is not None else h0
            )
            # Reconstruct the pane's vertex loop in the host plane (it
            # feeds the context-shading ray-cast; the area/perimeter
            # overrides below carry the multiplier).  E+ measures Starting
            # X along the wall from the lower-left corner as viewed from
            # outside, Starting Z up the surface.
            verts = None
            n0 = np.asarray(normal0, np.float64)
            frame = _plane_frame(n0)
            if host_sd.vertices is not None and frame is not None:
                u, v_up = frame
                hv = np.asarray(host_sd.vertices, np.float64)
                s, t = hv @ u, hv @ v_up
                origin = hv[np.lexsort((s, t))[0]]  # lowest, then leftmost
                c0 = origin + start_x * u + start_z * v_up
                verts = np.vstack([
                    c0, c0 + length * u,
                    c0 + length * u + height * v_up, c0 + height * v_up,
                ])
            m.add_fenestration(SurfaceDef(
                name, construction, surf_front.get(host, Boundary.outdoor()),
                Boundary.space_(surf_zone[host]),
                vertices=verts,
                area=length * height * mult,
                perimeter=2.0 * (length + height) * mult,
                normal=tuple(float(v) for v in normal0),
                height=base_z + start_z + height / 2.0,
            ))
            host_area_cut[host] = (
                host_area_cut.get(host, 0.0) + length * height * mult
            )

    if host_area_cut:
        # The window is a hole in its host: net the host's heat-transfer
        # area (validate_wall_heat_transfer.rs:106-118 does the same).
        for hname, cut in host_area_cut.items():
            sd = surf_def[hname]
            area, per, normal, height = sd.resolved_geometry()
            sd.area = area - cut
            if sd.area <= 0.0:
                raise ValueError(
                    f"surface {sd.name!r}: fenestration area exceeds "
                    "the host polygon"
                )

    # -- infiltration / ventilation (input channels, not compiled) -------------
    vol_by_zone = {s.name: s.volume for s in m.spaces}

    # Zone lists: a gain/airflow on a list applies per member zone (the E+
    # semantic — one instance per member, sized by that zone's geometry).
    zone_lists: Dict[str, List[str]] = {}
    for o in by_type.get("zonelist", []):
        zone_lists[o[1].lower()] = [f for f in o[2:] if f]

    # EnergyPlus name matching is case-insensitive; references resolve to
    # the declared spelling.
    zone_canon = {n.lower(): n for n in vol_by_zone}

    def _zone_ref(nm: str, owner: str) -> str:
        z = zone_canon.get(nm.lower())
        if z is None:
            raise ValueError(f"{owner}: unknown zone {nm!r}")
        return z

    def _expand_zones(zone: str, owner: str) -> List[str]:
        if zone.lower() in zone_lists:
            members = []
            for z in zone_lists[zone.lower()]:
                zc = zone_canon.get(z.lower())
                if zc is None:
                    raise ValueError(
                        f"{owner}: ZoneList {zone!r} member {z!r} is not a "
                        "parsed zone"
                    )
                members.append(zc)
            return members
        z = zone_canon.get(zone.lower())
        if z is None:
            raise ValueError(f"{owner}: unknown zone or zone list {zone!r}")
        return [z]

    def _airflow(o: List[str], kind: str, totals: Dict[str, float]):
        name = o[1]
        owner = f"Zone{kind.capitalize()} {name!r}"
        sched = _sched_ref(_str(o, 3), owner)  # raises on unknown, like gains
        # Reported design total folds a constant schedule's value; a
        # time-varying schedule reports the design flow itself (the rule
        # carries the full series for airflow_series).
        sched_const = 1.0
        if sched is not None:
            s = out.schedules[sched]
            if s.min() == s.max():
                sched_const = float(s[0])
        method = _str(o, 4).lower()
        for zone in _expand_zones(o[2], owner):
            if method in ("flow/zone", ""):
                flow = _num(o, 5, 0.0)
            elif method == "airchanges/hour":
                flow = _num(o, 8, 0.0) * vol_by_zone[zone] / 3600.0
            elif method == "flow/area":
                if (zone not in zone_floor_area
                        and zone not in computed_floor_area):
                    raise ValueError(
                        f"{owner}: Flow/Area needs the zone's Floor Area"
                    )
                flow = _num(o, 6, 0.0) * zone_floor_area.get(
                    zone, computed_floor_area.get(zone, 0.0)
                )
            else:
                raise ValueError(
                    f"{owner}: unsupported calculation method {method!r}"
                )
            # Design total (schedule folded in as a constant — the
            # historical reporting figure); the rule carries the schedule.
            totals[zone] = totals.get(zone, 0.0) + flow * sched_const
            out.airflows.append(AirflowRule(kind, zone, flow, schedule=sched))

    # -- internal thermal mass --------------------------------------------------
    # -- context shading polygons ---------------------------------------------
    # Shading:Site:Detailed (absolute world), Shading:Building:Detailed
    # (rotates with the building), Shading:Zone:Detailed (base surface's
    # zone frame).  Opaque blockers for the beam ray-cast
    # (heatx.weather.shadow); a Transmittance Schedule is honestly
    # approximated as opaque with a warning when it can be nonzero.
    def _shade_verts(o, first, zone):
        return _to_world(_vertices(o, first), zone)

    def _warn_transmittance(o, sched):
        if sched and out.schedules.get(sched.lower(), np.ones(1)).max() > 0:
            warnings.warn(
                f"{o[0]} {o[1]!r}: Transmittance Schedule {sched!r} "
                "treated as opaque (partial shade transmission is not "
                "imported)",
                stacklevel=3,
            )

    def _north_rot(verts, deg):
        # Clockwise-positive building rotation in the xy plane.
        if deg:
            b = np.radians(deg)
            c, s = np.cos(b), np.sin(b)
            x, y = verts[:, 0], verts[:, 1]
            verts = np.column_stack(
                [c * x + s * y, -s * x + c * y, verts[:, 2]]
            )
        return verts

    def _rotated(verts, deg):
        if clockwise:
            verts = verts[::-1]
        return _north_rot(verts, deg)

    for o in by_type.get("shading:site:detailed", []):
        # Site shading is world-fixed: never rotated by the building
        # north axis (EnergyPlus semantics), whatever the coordinate mode.
        _warn_transmittance(o, _str(o, 2))
        m.add_shade(_rotated(_vertices(o, 3), 0.0))
    for o in by_type.get("shading:building:detailed", []):
        # Building shading rotates WITH the building (north axis), in
        # both World and Relative coordinate modes.
        _warn_transmittance(o, _str(o, 2))
        m.add_shade(_rotated(_vertices(o, 3), north_axis))
    for o in by_type.get("shading:zone:detailed", []):
        base_surf = _str(o, 2)
        host = surf_canon.get(base_surf.lower())
        if host is None:
            # EnergyPlus hard-errors too; a silent world-frame fallback
            # would misplace the fin in Relative-coordinate models.
            raise ValueError(
                f"Shading:Zone:Detailed {o[1]!r}: Base Surface Name "
                f"{base_surf!r} names no parsed surface"
            )
        _warn_transmittance(o, _str(o, 3))
        m.add_shade(_shade_verts(o, 4, surf_zone[host]))

    # -- rectangular shading shortcuts -----------------------------------------
    # Shading:Site / Shading:Building (azimuth/tilt/origin/length/height
    # rectangles) and the window-attached Shading:Overhang[:Projection] /
    # Shading:Fin[:Projection] devices, lowered to the same opaque
    # blocker polygons as the :Detailed forms.
    def _rect_shade(o, owner):
        # Name(1), Azimuth(2), Tilt(3, default 90), Starting X/Y/Z(4-6),
        # Length(7), Height(8).  The starting corner is the lower-left
        # corner viewed from the facing direction; the rectangle spans
        # Length along the horizontal width axis and Height up the slope.
        az, tilt = _num(o, 2, 0.0) or 0.0, _num(o, 3)
        tilt = 90.0 if tilt is None else tilt
        length, height = _num(o, 7), _num(o, 8)
        if not length or not height or length <= 0 or height <= 0:
            raise ValueError(f"{owner}: needs positive Length and Height")
        g, b = np.radians(az), np.radians(tilt)
        n = np.array([np.sin(g) * np.sin(b), np.cos(g) * np.sin(b),
                      np.cos(b)])
        w = np.array([-np.cos(g), np.sin(g), 0.0])  # width axis (horizontal)
        u = np.cross(n, w)  # up-slope axis
        p = np.array([_num(o, k, 0.0) or 0.0 for k in (4, 5, 6)])
        return np.vstack([p, p + length * w,
                          p + length * w + height * u, p + height * u])

    for o in by_type.get("shading:site", []):
        m.add_shade(_rect_shade(o, f"Shading:Site {o[1]!r}"))
    for o in by_type.get("shading:building", []):
        # Rotates with the building north axis, like the :Detailed form.
        m.add_shade(_north_rot(
            _rect_shade(o, f"Shading:Building {o[1]!r}"), north_axis
        ))

    fen_def_by_name = {f.name.lower(): f for f in m.fenestrations}

    def _fen_frame(win_name, owner):
        """The window's in-plane frame for attached shading devices:
        (n, w, u, s0, s1, t0, t1, d) with w the horizontal width axis,
        u the up-slope axis, [s0, s1] x [t0, t1] the vertex extents in
        (w, u) coordinates and d the plane offset along the outward
        normal n (a point is s*w + t*u + d*n)."""
        fd = fen_def_by_name.get(win_name.lower())
        if fd is None:
            raise ValueError(
                f"{owner}: Window or Door Name {win_name!r} names no "
                "parsed fenestration"
            )
        if fd.vertices is None:
            warnings.warn(
                f"{owner}: window {fd.name!r} carries no vertex loop "
                "(rectangular window on a host without vertices) — the "
                "shading device is skipped",
                stacklevel=2,
            )
            return None
        v = np.asarray(fd.vertices, np.float64)
        _, _, n0, _ = fd.resolved_geometry()
        n = np.asarray(n0, np.float64)
        frame = _plane_frame(n)
        if frame is None:
            warnings.warn(
                f"{owner}: window {fd.name!r} is horizontal — "
                "overhang/fin geometry is undefined, skipped",
                stacklevel=2,
            )
            return None
        w, u = frame
        s, t = v @ w, v @ u
        return (n, w, u, float(s.min()), float(s.max()),
                float(t.min()), float(t.max()), float(v[0] @ n))

    for kind in ("shading:overhang", "shading:overhang:projection"):
        for o in by_type.get(kind, []):
            # Name(1), Window or Door(2), Height above Window(3), Tilt
            # Angle from Window(4, default 90 = perpendicular), Left
            # extension(5), Right extension(6), Depth(7) — the
            # :Projection form's field 7 is Depth as a Fraction of
            # Window/Door Height instead of meters.
            owner = f"{o[0]} {o[1]!r}"
            fr = _fen_frame(_str(o, 2), owner)
            if fr is None:
                continue
            n, w, u, s0, s1, t0, t1, d = fr
            above = _num(o, 3, 0.0) or 0.0
            tilt = _num(o, 4)
            tilt = 90.0 if tilt is None else tilt
            left, right = _num(o, 5, 0.0) or 0.0, _num(o, 6, 0.0) or 0.0
            depth = _num(o, 7)
            if kind.endswith("projection") and depth is not None:
                depth *= t1 - t0
            if not depth or depth <= 0:
                raise ValueError(f"{owner}: needs a positive Depth")
            tb = np.radians(tilt)
            dirv = np.cos(tb) * u + np.sin(tb) * n
            a = (s0 - left) * w + (t1 + above) * u + d * n
            b = (s1 + right) * w + (t1 + above) * u + d * n
            m.add_shade(np.vstack(
                [a, b, b + depth * dirv, a + depth * dirv]
            ))

    for kind in ("shading:fin", "shading:fin:projection"):
        for o in by_type.get(kind, []):
            # Name(1), Window or Door(2), then per side {Extension from
            # Window(+0), Distance Above Top(+1), Distance Below
            # Bottom(+2), Tilt Angle from Window(+3, default 90),
            # Depth(+4)}: Left at 3-7, Right at 8-12.  The :Projection
            # form's depths are fractions of the window width.  A side
            # with no positive depth is simply absent (E+ allows
            # left-only / right-only fins).
            owner = f"{o[0]} {o[1]!r}"
            fr = _fen_frame(_str(o, 2), owner)
            if fr is None:
                continue
            n, w, u, s0, s1, t0, t1, d = fr
            added = 0
            for side, base in (("left", 3), ("right", 8)):
                ext = _num(o, base, 0.0) or 0.0
                above = _num(o, base + 1, 0.0) or 0.0
                below = _num(o, base + 2, 0.0) or 0.0
                tilt = _num(o, base + 3)
                tilt = 90.0 if tilt is None else tilt
                depth = _num(o, base + 4)
                if kind.endswith("projection") and depth is not None:
                    depth *= s1 - s0
                if not depth or depth <= 0:
                    continue
                tb = np.radians(tilt)
                out_w = -w if side == "left" else w
                s_att = (s0 - ext) if side == "left" else (s1 + ext)
                dirv = np.cos(tb) * out_w + np.sin(tb) * n
                a = s_att * w + (t0 - below) * u + d * n
                b = s_att * w + (t1 + above) * u + d * n
                m.add_shade(np.vstack(
                    [a, b, b + depth * dirv, a + depth * dirv]
                ))
                added += 1
            if not added:
                warnings.warn(
                    f"{owner}: neither Left nor Right Depth is positive "
                    "— the fin shades nothing",
                    stacklevel=2,
                )

    for o in by_type.get("internalmass", []):
        # Name, Construction, Zone or ZoneList, [Space — 22.1+], Surface
        # Area.  Both faces couple to the SAME zone air (partitions and
        # furniture inside the zone): the batched solver treats it as an
        # ordinary surface whose front and back boundary is that space.
        name, construction = o[1], o[2]
        area = _num(o, 4) if _str(o, 5) == "" else _num(o, 5)
        if not area or area <= 0.0:
            raise ValueError(f"InternalMass {name!r}: a positive Surface Area "
                             "is required")
        im_zones = _expand_zones(o[3], f"InternalMass {name!r}")
        for zone in im_zones:
            m.add_surface(SurfaceDef(
                name if len(im_zones) == 1 else f"{name}:{zone}",
                construction,
                Boundary.space_(zone), Boundary.space_(zone),
                # Nominal vertical-partition geometry: square panel shape
                # factor for the TARP perimeter term, mid-room height.
                area=float(area), perimeter=4.0 * float(area) ** 0.5,
                normal=(0.0, 1.0, 0.0), height=1.5,
            ))

    for o in by_type.get("zoneinfiltration:designflowrate", []):
        _airflow(o, "infiltration", out.infiltration)
    # Numeric temperature/wind limit fields lower to in-run
    # ZoneVentilationControls (the gates read the MARCHING zone
    # temperature, so they compile into the march; building.py
    # ZoneVentilationControl).  The gates are per-OBJECT in EnergyPlus
    # but per-ZONE in heatx (the engine channel is the per-zone
    # vent_vol), so a zone whose ventilation objects disagree on gate
    # values falls back, with a warning, to ungated flow.
    # Schedule-valued gate fields (annual limit series) stay unimported.
    _VENT_GATES = (
        (16, "Minimum Indoor Temperature", -100.0),
        (18, "Maximum Indoor Temperature", 100.0),
        (20, "Delta Temperature", -100.0),
        (22, "Minimum Outdoor Temperature", -100.0),
        (24, "Maximum Outdoor Temperature", 100.0),
        (26, "Maximum Wind Speed", 40.0),
    )
    _VENT_DEFAULTS = tuple(d for _, _, d in _VENT_GATES)
    vent_gates_by_zone: Dict[str, List[tuple]] = {}
    for o in by_type.get("zoneventilation:designflowrate", []):
        # Ventilation Type and the fan pressure/efficiency fields model
        # the fan energy, not the zone heat balance — not imported.
        gates = tuple(_num(o, k, dflt) for k, _, dflt in _VENT_GATES)
        sched_gates = [
            label for k, label in (
                (17, "Minimum Indoor Temperature Schedule"),
                (19, "Maximum Indoor Temperature Schedule"),
                (21, "Delta Temperature Schedule"),
                (23, "Minimum Outdoor Temperature Schedule"),
                (25, "Maximum Outdoor Temperature Schedule"),
            )
            if _str(o, k)
        ]
        if sched_gates:
            warnings.warn(
                f"ZoneVentilation {o[1]!r}: schedule-valued gates "
                f"({', '.join(sched_gates)}) are not imported — only the "
                "constant limit fields gate the flow",
                stacklevel=2,
            )
        for zone in _expand_zones(o[2], f"ZoneVentilation {o[1]!r}"):
            vent_gates_by_zone.setdefault(zone, []).append(gates)
        _airflow(o, "ventilation", out.ventilation)
    for zone, gate_list in vent_gates_by_zone.items():
        if all(g == _VENT_DEFAULTS for g in gate_list):
            continue  # no active gates anywhere in this zone
        if len(set(gate_list)) > 1:
            warnings.warn(
                f"Zone {zone!r}: its ZoneVentilation objects carry "
                "DIFFERENT temperature/wind gates (heatx gates the "
                "per-zone ventilation channel as a whole) — the zone "
                "runs ungated (drive StepInputs.vent_vol with your own "
                "control law to model per-object gates)",
                stacklevel=2,
            )
            continue
        mi, ma, de, mo, xo, mw = gate_list[0]
        m.add_vent_control(ZoneVentilationControl(
            zone, min_indoor=mi, max_indoor=ma, delta=de,
            min_outdoor=mo, max_outdoor=xo, max_wind=mw,
        ))

    # -- internal gains: Lights / ElectricEquipment / People -------------------
    def _floor_area(zone: str, owner: str) -> float:
        a = zone_floor_area.get(zone, computed_floor_area.get(zone))
        if a is None or a <= 0.0:
            raise ValueError(
                f"{owner}: Watts/Area needs zone {zone!r}'s floor area (set "
                "the Zone Floor Area field or give the zone a Floor surface)"
            )
        return a

    def _zone_ref(zone: str, owner: str) -> str:
        if zone not in vol_by_zone:
            raise ValueError(f"{owner}: unknown zone {zone!r}")
        return zone

    def _gain_name(name: str, zone: str, zones: List[str]) -> str:
        return name if len(zones) == 1 else f"{name}:{zone}"

    for o in by_type.get("lights", []):
        name, owner = o[1], f"Lights {o[1]!r}"
        zones = _expand_zones(o[2], owner)
        sched = _sched_ref(_str(o, 3), owner)
        method = _str(o, 4).lower()
        for zone in zones:
            if method in ("lightinglevel", ""):
                level = _num(o, 5, 0.0)
            elif method == "watts/area":
                level = _num(o, 6, 0.0) * _floor_area(zone, owner)
            else:
                raise ValueError(
                    f"{owner}: unsupported Design Level Calculation Method "
                    f"{method!r} (LightingLevel / Watts/Area)"
                )
            # Return-air fraction leaves the zone; radiant/visible fractions
            # all land on the zone air node in heatx's model (luminaire.rs).
            level *= 1.0 - (_num(o, 8, 0.0) or 0.0)
            m.add_luminaire(Luminaire(_gain_name(name, zone, zones), zone))
            out.gains.append(ImportedGain(
                name=_gain_name(name, zone, zones), zone=zone, channel="lum",
                index=len(m.luminaires) - 1, design_w=level,
                schedules=[sched] if sched else [],
            ))

    for o in by_type.get("electricequipment", []):
        name, owner = o[1], f"ElectricEquipment {o[1]!r}"
        zones = _expand_zones(o[2], owner)
        sched = _sched_ref(_str(o, 3), owner)
        method = _str(o, 4).lower()
        for zone in zones:
            if method in ("equipmentlevel", ""):
                level = _num(o, 5, 0.0)
            elif method == "watts/area":
                level = _num(o, 6, 0.0) * _floor_area(zone, owner)
            else:
                raise ValueError(
                    f"{owner}: unsupported Design Level Calculation Method "
                    f"{method!r} (EquipmentLevel / Watts/Area)"
                )
            # Latent and lost fractions never reach the zone air sensibly.
            level *= max(
                0.0, 1.0 - (_num(o, 8, 0.0) or 0.0) - (_num(o, 10, 0.0) or 0.0)
            )
            m.add_hvac(ElectricHeater(_gain_name(name, zone, zones), zone))
            out.gains.append(ImportedGain(
                name=_gain_name(name, zone, zones), zone=zone, channel="hvac",
                index=len(m.hvacs) - 1, design_w=level,
                schedules=[sched] if sched else [],
            ))

    for o in by_type.get("people", []):
        name, owner = o[1], f"People {o[1]!r}"
        zones = _expand_zones(o[2], owner)
        occ = _sched_ref(_str(o, 3), owner)
        method = _str(o, 4).lower()
        s9 = _str(o, 9).lower()  # numeric, '', or 'autocalculate'
        sens = (
            float(s9) if s9 not in ("", "autocalculate")
            else PEOPLE_SENSIBLE_FRACTION
        )
        act = _sched_ref(_str(o, 10), owner)  # W/person metabolic rate
        if act is None:
            raise ValueError(f"{owner}: an Activity Level Schedule is required")
        for zone in zones:
            if method in ("people", ""):
                n_people = _num(o, 5, 0.0)
            elif method == "people/area":
                n_people = _num(o, 6, 0.0) * _floor_area(zone, owner)
            elif method == "area/person":
                per = _num(o, 7, 0.0)
                if not per:
                    raise ValueError(
                        f"{owner}: Area/Person requires a nonzero area"
                    )
                n_people = _floor_area(zone, owner) / per
            else:
                raise ValueError(
                    f"{owner}: unsupported Number of People Calculation "
                    f"Method {method!r}"
                )
            m.add_hvac(ElectricHeater(_gain_name(name, zone, zones), zone))
            out.gains.append(ImportedGain(
                name=_gain_name(name, zone, zones), zone=zone, channel="hvac",
                index=len(m.hvacs) - 1, design_w=n_people * sens,
                schedules=([occ] if occ else []) + [act],
            ))

    # -- thermostats -> setpoint-driven ideal loads ----------------------------
    def _sp0(sched: Optional[str], const: Optional[float], side: str):
        """Compiled (constant) setpoint: the schedule's hour-0 value when
        scheduled (hourly_channels overrides per step), else the constant."""
        if sched is not None:
            return float(out.schedules[sched][0])
        return const

    def _add_tstat(name, zone, hs, hconst, cs, cconst, owner):
        zone = _zone_ref(zone, owner)
        heat0 = _sp0(hs, hconst, "heat")
        cool0 = _sp0(cs, cconst, "cool")
        if heat0 is None and cool0 is None:
            raise ValueError(f"{owner}: neither a heating nor a cooling setpoint")
        m.add_hvac(IdealHeaterCooler(
            name, [zone], heat_setpoint=heat0, cool_setpoint=cool0
        ))
        out.thermostats.append(ImportedThermostat(
            name=name, zone=zone, heat_schedule=hs, cool_schedule=cs
        ))

    tstat_templates: Dict[str, tuple] = {}
    for o in by_type.get("hvactemplate:thermostat", []):
        owner = f"HVACTemplate:Thermostat {o[1]!r}"
        tstat_templates[o[1].lower()] = (
            _sched_ref(_str(o, 2), owner), _num(o, 3),
            _sched_ref(_str(o, 4), owner), _num(o, 5),
        )
    for o in by_type.get("hvactemplate:zone:idealloadsairsystem", []):
        zone = o[1]
        owner = f"HVACTemplate:Zone:IdealLoadsAirSystem ({zone!r})"
        tname = _str(o, 2).lower()
        if tname not in tstat_templates:
            raise ValueError(
                f"{owner}: Template Thermostat {_str(o, 2)!r} not found"
            )
        hs, hconst, cs, cconst = tstat_templates[tname]
        _add_tstat(f"{zone} ideal loads", zone, hs, hconst, cs, cconst, owner)

    sp_objs: Dict[tuple, List[str]] = {}
    for kind in ("thermostatsetpoint:dualsetpoint",
                 "thermostatsetpoint:singleheating",
                 "thermostatsetpoint:singlecooling"):
        for o in by_type.get(kind, []):
            sp_objs[(kind, o[1].lower())] = o
    for o in by_type.get("zonecontrol:thermostat", []):
        name, zone = o[1], o[2]
        owner = f"ZoneControl:Thermostat {name!r}"
        ctype, cname = _str(o, 4).lower(), _str(o, 5).lower()
        sp = sp_objs.get((ctype, cname))
        if sp is None:
            raise ValueError(
                f"{owner}: control object {ctype}/{_str(o, 5)!r} not found "
                "(supported: ThermostatSetpoint:DualSetpoint/SingleHeating/"
                "SingleCooling)"
            )
        hs = cs = None
        if ctype == "thermostatsetpoint:dualsetpoint":
            hs = _sched_ref(_str(sp, 2), owner)
            cs = _sched_ref(_str(sp, 3), owner)
        elif ctype == "thermostatsetpoint:singleheating":
            hs = _sched_ref(_str(sp, 2), owner)
        else:
            cs = _sched_ref(_str(sp, 2), owner)
        zones = _expand_zones(zone, owner)
        for z in zones:
            _add_tstat(
                name if len(zones) == 1 else f"{name}:{z}",
                z, hs, None, cs, None, owner,
            )

    # -- scheduled window shading (subset) ------------------------------------
    # Supported: AlwaysOn / OnIfScheduleAllows / the weather-dependent
    # controls (OnIfHighSolarOnWindow, OnIfHighHorizontalSolar,
    # OnIfHighOutdoorAirTemperature — their deployment reads only the EPW /
    # incident solar, so it evaluates exactly host-side) with a
    # WindowMaterial:Shade/Screen/Blind device (directly named, or found as
    # a layer of the "Construction with Shading"; screens/blinds reduce to
    # effective transmittances, see shade_tau below).  Zone-state-dependent
    # control types
    # (OnIfHighZoneAirTemperature, glare, night/day combinations) need
    # in-run logic and are honestly skipped with a warning.  The rules
    # render to incident-solar multipliers (LoadedIdf.shading_series).
    # Shading device -> effective solar transmittance of the deployed
    # device.  Shade: the material's solar transmittance directly.
    # Screen: the openness area fraction (1 - d/s)^2 — EnergyPlus's own
    # normal-incidence beam transmittance (Engineering Reference,
    # window screens); scattered/reflected transmission is dropped
    # (conservative for gain reduction).  Blind: geometric slat coverage
    # at normal incidence, cover = min(1, (w/s)*|cos(slat angle)|) with
    # the E+ slat-angle convention (0 deg = slat normal parallel to the
    # glazing normal = closed; 90 deg = open), passing the covered
    # fraction at the slat's beam transmittance — a static approximation
    # of E+'s profile-angle-resolved blind model, stated plainly.
    shade_tau: Dict[str, float] = {}

    def _device_tau(owner, tau):
        # A transmittance outside [0, 1] would silently AMPLIFY the
        # controlled panes' incident solar through shading_series.
        if not 0.0 <= tau <= 1.0:
            raise ValueError(
                f"{owner}: solar transmittance {tau} is outside [0, 1]"
            )
        return tau

    for o in by_type.get("windowmaterial:shade", []):
        shade_tau[o[1].lower()] = _device_tau(
            f"WindowMaterial:Shade {o[1]!r}", float(_num(o, 2, 0.0) or 0.0)
        )
    for o in by_type.get("windowmaterial:screen", []):
        # Fields: ..., Screen Material Spacing(7), Diameter(8).
        s, d = _num(o, 7), _num(o, 8)
        if not s or s <= 0 or d is None or d < 0 or d >= s:
            raise ValueError(
                f"WindowMaterial:Screen {o[1]!r}: needs Material Spacing "
                "> Material Diameter >= 0"
            )
        shade_tau[o[1].lower()] = (1.0 - d / s) ** 2
    for o in by_type.get("windowmaterial:blind", []):
        # Fields: ..., Slat Width(3), Separation(4), Thickness(5),
        # Angle(6), Conductivity(7), Beam Solar Transmittance(8).
        w, sep = _num(o, 3), _num(o, 4)
        ang = _num(o, 6)  # 0.0 is a legal (fully closed) slat angle
        ang = 45.0 if ang is None else ang
        tau_slat = _num(o, 8, 0.0) or 0.0
        if not w or w <= 0 or not sep or sep <= 0:
            raise ValueError(
                f"WindowMaterial:Blind {o[1]!r}: needs positive Slat "
                "Width and Slat Separation"
            )
        _device_tau(
            f"WindowMaterial:Blind {o[1]!r} (Beam Solar Transmittance)",
            tau_slat,
        )
        cover = min(1.0, (w / sep) * abs(np.cos(np.radians(ang))))
        shade_tau[o[1].lower()] = (1.0 - cover) + cover * tau_slat
    fen_canon = {f.name.lower(): f.name for f in m.fenestrations}
    # Pane -> its zone (the back boundary's space; in-run zone-state rules
    # default to it when the control carries no Zone Name).
    fen_zone = {
        f.name: f.back_boundary.space
        for f in m.fenestrations
        if f.back_boundary.kind == "space"
    }
    constr_canon = {c.lower(): c for c in m.constructions}

    # Control Type -> (normalized kind, schedule role).  Weather-dependent
    # types evaluate exactly host-side in shading_series (the deployment
    # condition reads only the EPW / incident solar, never zone state);
    # OnIfHighZoneAirTemperature lowers to an IN-RUN ZoneShadingControl on
    # the model (deployment reads the marching zone temperature inside
    # the compiled scan — EnergyPlus's previous-timestep convention; its
    # schedule gate renders through shading_setpoint_series); the
    # remaining zone-state types (glare, OnIfHighZoneCooling, OnNightIf*
    # combined night/day rules) keep the honest skip-with-warning below.
    _CONTROLS = {
        "alwayson": ("always", "none"),
        "onifscheduleallows": ("always", "required"),
        "onifhighsolaronwindow": ("high_solar", "optional"),
        "onifhighhorizontalsolar": ("high_horizontal_solar", "optional"),
        "onifhighoutdoorairtemperature": ("high_outdoor_temp", "optional"),
        "onifhighzoneairtemperature": ("high_zone_temp", "optional"),
        # AND-combinations (weather-only: dry bulb > Setpoint AND the
        # solar condition > Setpoint 2).  EnergyPlus spells these with
        # "Temp"; accept the spelled-out form too.
        "onifhighoutdoorairtempandhighsolaronwindow":
            ("high_outdoor_and_solar", "optional"),
        "onifhighoutdoorairtemperatureandhighsolaronwindow":
            ("high_outdoor_and_solar", "optional"),
        "onifhighoutdoorairtempandhighhorizontalsolar":
            ("high_outdoor_and_horizontal", "optional"),
        "onifhighoutdoorairtemperatureandhighhorizontalsolar":
            ("high_outdoor_and_horizontal", "optional"),
    }

    # One control per pane: EnergyPlus 9.0+ allows several
    # WindowShadingControls to reference the same window (Shading Control
    # Sequence Number orders them; the first whose condition is met
    # deploys).  heatx keeps the first rule per pane in sequence order
    # and honestly skips the rest with a warning — the lowered forms
    # (host-side multiplier / in-run control) cannot express
    # per-timestep fall-through, and letting two rules both shade one
    # pane would double-apply.
    claimed: Dict[str, str] = {}  # pane -> owning rule

    def _system_tau(constr_name, owner):
        """ISO 9050 system solar transmittance of a (glazing)
        construction — the heatx glazing machinery the compiler itself
        uses for the per-node absorbed-solar split."""
        from heatx_torch.build.layout import glazing_system
        from heatx_torch.physics.glazing import combine_layers

        c = m.constructions[constr_canon[constr_name.lower()]]
        try:
            pairs = glazing_system(c, m)
        except ValueError as e:
            raise ValueError(f"{owner}: {e}") from None
        return combine_layers([g for _, g in pairs]).tau

    def _shade_rule(owner, construction_with, control_type, sched,
                    device_material, fen_names, setpoint=None,
                    is_scheduled="", zone="", shading_type="",
                    setpoint2=None):
        ct = control_type.lower().replace(" ", "")
        if ct == "alwaysoff":
            return  # never deployed: running unshaded IS the semantics
        if ct not in _CONTROLS:
            warnings.warn(
                f"{owner}: Shading Control Type {control_type!r} is "
                "state-dependent and not imported (supported: AlwaysOn, "
                "OnIfScheduleAllows, OnIfHighSolarOnWindow, "
                "OnIfHighHorizontalSolar, OnIfHighOutdoorAirTemperature, "
                "their OnIfHighOutdoorAirTempAnd… combinations, and "
                "OnIfHighZoneAirTemperature) — these panes run unshaded",
                stacklevel=3,
            )
            return
        kind, sched_role = _CONTROLS[ct]
        schedule = None
        if sched_role == "required":
            schedule = _sched_ref(sched, owner)
            if schedule is None:
                raise ValueError(
                    f"{owner}: OnIfScheduleAllows needs a Schedule Name"
                )
        elif sched_role == "optional" and sched:
            # EnergyPlus: "and schedule, if specified, allows shading";
            # the schedule only participates when Shading Control Is
            # Scheduled = Yes (E+ errors on Yes without a schedule and
            # ignores a schedule without Yes).
            if is_scheduled.lower() == "yes":
                schedule = _sched_ref(sched, owner)
            else:
                warnings.warn(
                    f"{owner}: Schedule {sched!r} named but Shading "
                    "Control Is Scheduled is not Yes — the schedule is "
                    "ignored (EnergyPlus semantics)",
                    stacklevel=3,
                )
        if kind != "always" and setpoint is None:
            raise ValueError(
                f"{owner}: Control Type {control_type!r} needs a Setpoint"
            )
        if kind.startswith("high_outdoor_and_") and setpoint2 is None:
            raise ValueError(
                f"{owner}: Control Type {control_type!r} needs Setpoint 2 "
                "(the solar condition, W/m2)"
            )
        tau = None
        switchable = shading_type.lower().replace(" ", "") == "switchableglazing"
        if switchable:
            # Electrochromic glazing: deployment switches the pane to the
            # darkened "Construction with Shading".  Thermally the pane
            # keeps its base construction here; the deployed state is
            # approximated as scaling the incident solar by the ratio of
            # the two systems' ISO 9050 solar transmittances (computed
            # per pane below — it depends on each pane's own base
            # construction).
            if not construction_with or construction_with.lower() not in constr_canon:
                raise ValueError(
                    f"{owner}: SwitchableGlazing needs a parsed "
                    "Construction with Shading Name (got "
                    f"{construction_with!r})"
                )
        elif device_material:
            tau = shade_tau.get(device_material.lower())
        elif construction_with and construction_with.lower() in constr_canon:
            c = m.constructions[constr_canon[construction_with.lower()]]
            for layer in c.materials:
                if layer.lower() in shade_tau:
                    tau = shade_tau[layer.lower()]
                    break
        if tau is None and not switchable:
            warnings.warn(
                f"{owner}: no WindowMaterial:Shade/Screen/Blind device "
                "found — these panes run unshaded",
                stacklevel=3,
            )
            return
        fens = []
        for fn in fen_names:
            if fn and fn.lower() in fen_canon:
                fens.append(fen_canon[fn.lower()])
            elif fn:
                raise ValueError(
                    f"{owner}: fenestration {fn!r} names no parsed window"
                )
        if not fens:
            warnings.warn(
                f"{owner}: no fenestration names given — the rule "
                "controls nothing",
                stacklevel=3,
            )
            return
        free = []
        for fn in fens:
            if fn in claimed:
                warnings.warn(
                    f"{owner}: pane {fn!r} is already controlled by "
                    f"{claimed[fn]} (first rule in sequence order wins; "
                    "EnergyPlus's per-timestep control fall-through is "
                    "not modeled) — this rule skips the pane",
                    stacklevel=3,
                )
            else:
                free.append(fn)
        if not free:
            warnings.warn(
                f"{owner}: every named pane is controlled by an earlier "
                "rule — the rule controls nothing",
                stacklevel=3,
            )
            return
        fens = free
        for fn in fens:
            claimed[fn] = owner
        pane_tau = {fn: tau for fn in fens}
        if switchable:
            tau_sw = _system_tau(construction_with, owner)
            for fn in fens:
                base_c = fen_def_by_name[fn.lower()].construction
                tau_base = _system_tau(base_c, f"{owner} (pane {fn!r})")
                if tau_base <= 1e-12:
                    raise ValueError(
                        f"{owner}: pane {fn!r}'s construction {base_c!r} "
                        "is opaque — SwitchableGlazing cannot apply"
                    )
                pane_tau[fn] = min(1.0, tau_sw / tau_base)
        # One rule per distinct transmittance (switchable panes with
        # different base constructions get different ratios; ordinary
        # devices collapse to a single group).
        groups: Dict[float, List[str]] = {}
        for fn in fens:
            groups.setdefault(pane_tau[fn], []).append(fn)
        if kind == "high_zone_temp":
            # Zone-state rule: lower to in-run controls on the model (the
            # deployment condition reads the marching zone temperature).
            # The controlling zone is the control's Zone Name when given
            # (9.0+ schema), else each pane's own zone (pre-9.0 schema has
            # no zone field — EnergyPlus uses the window's zone there).
            ctl_zone = None
            if zone:
                ctl_zone = zone_canon.get(zone.lower())
                if ctl_zone is None:
                    raise ValueError(
                        f"{owner}: Zone Name {zone!r} is not a parsed zone"
                    )
            for fn in fens:
                z = ctl_zone or fen_zone.get(fn)
                if z is None:
                    raise ValueError(
                        f"{owner}: pane {fn!r} has no zone and the "
                        "control names none — OnIfHighZoneAirTemperature "
                        "needs a controlling zone"
                    )
                m.add_zone_shading(ZoneShadingControl(
                    fn, z, pane_tau[fn], float(setpoint)
                ))
            for g_tau, g_fens in groups.items():
                out.zone_shading.append(ShadingRule(
                    owner, g_fens, g_tau, schedule,
                    control=kind, setpoint=float(setpoint), zone=ctl_zone,
                ))
            return
        for g_tau, g_fens in groups.items():
            out.shading.append(ShadingRule(
                owner, g_fens, g_tau, schedule,
                control=kind, setpoint=float(setpoint or 0.0),
                setpoint2=float(setpoint2 or 0.0),
            ))

    for o in sorted(
        by_type.get("windowshadingcontrol", []),
        key=lambda o: _num(o, 3, 1.0) or 1.0,
    ):
        # 9.0+ schema, applied in Shading Control Sequence Number(3)
        # order (the pane-claim rule above keeps the first per pane):
        # ..., Shading Type(4), Construction with Shading(5),
        # Control Type(6), Schedule(7), Setpoint(8), Is Scheduled(9), ...,
        # Device Material(11), ..., Multiple Surface Control Type(16),
        # Fenestration names(17+).
        _shade_rule(
            f"WindowShadingControl {o[1]!r}", _str(o, 5), _str(o, 6),
            _str(o, 7), _str(o, 11), [_str(o, k) for k in range(17, len(o))],
            setpoint=_num(o, 8), is_scheduled=_str(o, 9), zone=_str(o, 2),
            shading_type=_str(o, 4), setpoint2=_num(o, 14),
        )
    pre9_ctls = {
        o[1].lower(): o
        for o in by_type.get("windowproperty:shadingcontrol", [])
    }
    for owner, pane, maybe_ctl in rect_win_ctl:
        if maybe_ctl in pre9_ctls:
            # Pre-9.0 schema confirmed: the rectangular window's field 4
            # names a shading control — attach it like a detailed
            # fenestration's reference.
            fen_shading_ctl[pane] = maybe_ctl
    ctl_fens: Dict[str, List[str]] = {}
    for fname, cname in fen_shading_ctl.items():
        ctl_fens.setdefault(cname, []).append(fname)
    for cname, fens in sorted(ctl_fens.items()):
        o = pre9_ctls.get(cname)
        if o is None:
            warnings.warn(
                f"Shading Control {cname!r} referenced by "
                f"{', '.join(fens)} has no WindowProperty:ShadingControl "
                "object — these panes run unshaded",
                stacklevel=2,
            )
            continue
        # Pre-9.0 schema: Shading Type(2), Construction with Shading(3),
        # Control Type(4), Schedule(5), Setpoint(6), Is Scheduled(7), ...,
        # Device Material(9).
        _shade_rule(
            f"WindowProperty:ShadingControl {o[1]!r}", _str(o, 3),
            _str(o, 4), _str(o, 5), _str(o, 9), fens,
            setpoint=_num(o, 6), is_scheduled=_str(o, 7),
            shading_type=_str(o, 2), setpoint2=_num(o, 12),
        )

    return out

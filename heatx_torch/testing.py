"""The bench workload, rebuilt on ``heatx_torch.model``.

``build_city_model`` and ``synthetic_weather`` reproduce bench.py's
``build_city_model`` (bench.py:20) and its synthetic weather (bench.py:106-113)
without importing bench.py, which reaches jax through ``heatx``.
``bench_inputs`` assembles the bench's hourly input sequence: seeded
per-surface solar factors on the horizontal irradiance, the horizontal IR on
every front face, 500 W per heater and 150 W per luminaire.
``build_demand_city`` and ``demand_inputs`` are the demand rows' workload
(bench.py:116-196, :311-371): the same city with one ideal-loads thermostat
per zone at 20/26 C, luminaires on, heaters off.  ``build_thermostat_model``
is a small building that takes every branch of the thermostat update, and
``BranchCounter`` counts the zone-sub-steps a plain march puts on each.
``build_zone_chain_model`` puts many zones with short walls in one block.
``build_nomass_run_model`` has no-mass runs of 3 and 4 nodes,
``build_two_zone_model`` interior-MRT networks on both faces of a partition, and
``coarse_config`` a discretization whose parity march is short.
``build_glazed_city`` is the city with argon double glazing (a gas cavity in
every window), ``build_cavity_model`` a small building with cavities of every
tilt branch.  ``write_synthetic_epw`` writes a seeded EPW file, and
``office_inputs`` turns it into the office IDF workflow's inputs (bench.py's
``run_office_bench``).  ``build_controlled_city`` and
``controlled_city_inputs`` are the city with in-run window shading and
ventilation gates in every zone, ``controlled_office_idf`` the office IDF
with an ``OnIfHighZoneAirTemperature`` shade on its argon window and
ventilation temperature limits.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from heatx_torch.engine import zone as zone_mod
from heatx_torch.engine.state import StepInputs, default_inputs
from heatx_torch.build.layout import B_GROUND, B_OUTDOOR
from heatx_torch.model import building as building_mod
from heatx_torch.model.building import (
    Boundary,
    BuildingModel,
    Construction,
    ElectricHeater,
    IdealHeaterCooler,
    Luminaire,
    Material,
    SpaceDef,
    Substance,
    SurfaceDef,
)
from heatx_torch.weather.epw import _MONTH_HOURS
from heatx_torch.weather.solar import solar_position, surface_irradiance


def build_city_model(n_zones: int, surfaces_per_zone: int, orientations: bool = False):
    """A synthetic city-block building: per zone, massive concrete walls, one
    mixed (insulated) wall, and a glazed window, all outdoor on the front and
    facing the zone on the back; one electric heater and one luminaire per
    zone.  ``orientations=True`` rotates successive surfaces through the four
    compass facades (the default keeps every facade south-facing)."""
    m = BuildingModel()
    m.add_substance(
        Substance("concrete", thermal_conductivity=0.816, density=1700.0,
                  specific_heat_capacity=800.0, front_thermal_absorbtance=0.9,
                  back_thermal_absorbtance=0.9, front_solar_absorbtance=0.7,
                  back_solar_absorbtance=0.7)
    )
    m.add_substance(
        Substance("poly", thermal_conductivity=0.0252, density=17.5,
                  specific_heat_capacity=2400.0, front_thermal_absorbtance=0.9,
                  back_thermal_absorbtance=0.9, front_solar_absorbtance=0.7,
                  back_solar_absorbtance=0.7)
    )
    m.add_substance(
        Substance("glass", thermal_conductivity=1.0, density=2500.0,
                  specific_heat_capacity=840.0, solar_transmittance=0.8,
                  front_solar_absorbtance=0.1, back_solar_absorbtance=0.1,
                  front_thermal_absorbtance=0.84, back_thermal_absorbtance=0.84)
    )
    m.add_material(Material("c20", "concrete", 0.2))
    m.add_material(Material("p2", "poly", 0.02))
    m.add_material(Material("g6", "glass", 0.006))
    m.add_construction(Construction("massive", ["c20"]))
    m.add_construction(Construction("mixed", ["p2", "c20", "p2"]))
    m.add_construction(Construction("window", ["g6"]))

    base = np.array([[0, 0, 0], [6, 0, 0], [6, 0, 3], [0, 0, 3]], float)
    rots = [base]
    if orientations:
        for _ in range(3):  # rotate 90 deg about z: (x, y) -> (-y, x)
            prev = rots[-1]
            rots.append(np.stack([-prev[:, 1], prev[:, 0], prev[:, 2]], axis=1))
    kinds = ["massive"] * (surfaces_per_zone - 2) + ["mixed", "window"]
    for z in range(n_zones):
        zone = f"z{z}"
        m.add_space(SpaceDef(zone, 200.0))
        for si, kind in enumerate(kinds):
            m.add_surface(
                SurfaceDef(
                    f"s{z}_{si}", kind, Boundary.outdoor(), Boundary.space_(zone),
                    vertices=rots[(z + si) % len(rots)],
                )
            )
        m.add_hvac(ElectricHeater(f"h{z}", zone))
        m.add_luminaire(Luminaire(f"l{z}", zone))
    return m


def build_demand_city(n_zones: int, surfaces_per_zone: int):
    """bench.py's demand workload (bench.py:129-132): the city block with one
    ``IdealHeaterCooler`` thermostat per zone, heating to 20 C and cooling to
    26 C at unlimited capacity."""
    m = build_city_model(n_zones, surfaces_per_zone)
    for z in range(n_zones):
        m.add_hvac(IdealHeaterCooler(f"tstat{z}", [f"z{z}"], heat_setpoint=20.0, cool_setpoint=26.0))
    return m


def build_wide_zone_model(surfaces: int = 256, thermostat: bool = False):
    """The edge of the day march's limits (ROADMAP B1): one zone bounded by
    ``surfaces`` surfaces, the most one block takes
    (``day_march.MAX_BLOCK_LANES``), one of them a 32-node wall (20 mm of
    polystyrene on each side of 265 mm of concrete; ``day_march.MAX_NODES``).
    With ``thermostat`` an ideal heater-cooler holds the zone at 20/26 C (the
    extended kernel kind)."""
    m = build_city_model(1, surfaces)
    m.add_material(Material("c265", "concrete", 0.265))
    m.add_construction(Construction("deep", ["p2", "c265", "p2"]))
    m.surfaces[0] = dataclasses.replace(m.surfaces[0], construction="deep")
    if thermostat:
        m.add_hvac(IdealHeaterCooler("tstat0", ["z0"], heat_setpoint=20.0, cool_setpoint=26.0))
    return m


def build_zone_chain_model(zones: int = 64, thermostat: bool = True):
    """Many zones in one block with a short wall: ``zones`` zones in a row,
    the first behind the city's window (outdoor on its front), each next one
    behind a window onto the one before (``zones - 1`` interior panes), so
    that every zone lies in one zone-closed block of ``zones`` lanes and as
    many zones, each surface a 2-node pane.  With ``thermostat`` an ideal
    heater-cooler holds each zone at 20/26 C.  At many sub-steps an hour its
    block holds the most zone rows of the hour that a block can hold (the
    TR-BDF2 adjoint's shared-memory need grows with zones x sub-steps)."""
    m = build_city_model(zones, 2)
    panes = []
    for s in m.surfaces:
        z, si = (int(x) for x in s.name[1:].split("_"))
        if si == 1:  # the window
            panes.append(s if z == 0 else dataclasses.replace(s, front_boundary=Boundary.space_(f"z{z - 1}")))
    m.surfaces = panes
    if thermostat:
        for z in range(zones):
            m.add_hvac(IdealHeaterCooler(f"tstat{z}", [f"z{z}"], heat_setpoint=20.0, cool_setpoint=26.0))
    return m


def build_controlled_city(n_zones: int, surfaces_per_zone: int, setpoints=(18.0, 30.0),
                          shading: bool = True, gates: bool = True, base=None, classes=building_mod):
    """:func:`build_city_model` with the in-run passive controls in every
    zone.  Every window (``s{z}_{surfaces_per_zone - 1}``) gets a
    ``ZoneShadingControl`` of transmittance 0.3 whose setpoint is spread
    over ``setpoints`` from zone to zone (a golden-ratio sequence), so that
    deployment toggles during a run; the window of every zone ``z`` with ``z
    % 10 == 1`` is controlled by the next zone instead of its own, which
    blocking must place in the pane's block.  Every zone gets a
    ``ZoneVentilationControl(min_indoor=18, delta=2)``; every third zone also
    a ``max_outdoor`` of 15.5 C and every fourth (from zone 1) a ``max_wind``
    of 4 m/s, gates the host applies (off the bench weather's values, so that
    float32 and float64 open them alike).  ``shading``/``gates`` leave either
    kind out; ``base`` is the city to control (default
    ``build_city_model(n_zones, surfaces_per_zone)``) and ``classes`` the
    module of its model classes (heatx's, for the reference's twin)."""
    m = build_city_model(n_zones, surfaces_per_zone) if base is None else base
    lo, hi = setpoints
    for z in range(n_zones):
        if shading:
            ctl_zone = (z + 1) % n_zones if z % 10 == 1 else z
            sp = lo + (hi - lo) * ((z * 0.6180339887498949) % 1.0)
            m.add_zone_shading(classes.ZoneShadingControl(
                f"s{z}_{surfaces_per_zone - 1}", f"z{ctl_zone}", 0.3, sp))
        if gates:
            m.add_vent_control(classes.ZoneVentilationControl(
                f"z{z}", min_indoor=18.0, delta=2.0,
                max_outdoor=15.5 if z % 3 == 0 else 100.0, max_wind=4.0 if z % 4 == 1 else 40.0,
            ))
    return m


def controlled_city_inputs(building, hours: int, dtype=None, device="cpu") -> StepInputs:
    """:func:`bench_inputs` with 0.1 m3/s of ventilation per zone at the
    outdoor temperature (the channel the gates switch)."""
    seq = bench_inputs(building, hours, dtype=dtype, device=device)
    Z = building.n_zones
    return seq.replace(
        vent_vol=torch.full((Z,), 0.1, dtype=seq.t_out.dtype, device=device),
        vent_temp=seq.t_out[:, None].expand(hours, Z).contiguous(),
        vent_mask=torch.ones((Z,), dtype=torch.bool, device=device),
    )


def control_decisions(building, zone_T, t_out, wind_speed, shade_sp=None, zone_T0=22.0) -> dict:
    """The in-run controls' decisions of a run, rebuilt from its hourly zone
    history ``zone_T`` [T, Z] (each main step decides on the zone carry at
    its start: ``zone_T0`` at the first, the previous hour's value after).
    ``shade`` [T, P] is whether each controlled pane's device is deployed
    (``shade_sp``: the run's setpoints, [T, S], [S] or scalar; None: the
    compiled ones), ``vent`` [T, Zc] whether each gated zone's ventilation is
    on (the indoor gates, the delta gate on the hourly ``t_out`` and the
    host's outdoor and wind gates); ``*_margin`` is each decision's distance
    to the nearest threshold it compares the zone temperature with, K."""
    b = building
    zt = np.asarray(zone_T, np.float64)
    T, Z = zt.shape
    start = np.vstack([np.broadcast_to(np.asarray(zone_T0, np.float64), (1, Z)), zt[:-1]])
    out = {}
    if b.has_zone_shading:
        panes = np.nonzero(np.asarray(b.shade_zone) >= 0)[0]
        sp = np.broadcast_to(np.asarray(b.shade_sp if shade_sp is None else shade_sp, np.float64),
                             (T, b.n_surfaces))[:, panes]
        t = start[:, np.asarray(b.shade_zone)[panes]]
        out["shade"], out["shade_margin"] = t > sp, np.abs(t - sp)
    if b.has_vent_gates:
        lim = [np.asarray(v, np.float64) for v in (b.vent_min_tin, b.vent_max_tin, b.vent_delta,
                                                   b.vent_min_tout, b.vent_max_tout, b.vent_max_wind)]
        gated = np.nonzero(np.any([lim[i] != d for i, d in enumerate((-100, 100, -100, -100, 100, 40))],
                                  axis=0))[0]
        lo, hi, delta, lo_o, hi_o, wmax = (v[gated] for v in lim)
        t = start[:, gated]
        t_o = np.broadcast_to(np.asarray(t_out, np.float64), (T,))[:, None]
        w = np.broadcast_to(np.asarray(wind_speed, np.float64), (T,))[:, None]
        thr = delta + t_o
        out["vent"] = (t > lo) & (t < hi) & (t > thr) & (t_o > lo_o) & (t_o < hi_o) & (w < wmax)
        out["vent_margin"] = np.minimum(np.minimum(np.abs(t - lo), np.abs(t - hi)), np.abs(t - thr))
    return out


#: The repository's office IDF, from which :func:`controlled_office_idf` starts.
OFFICE_IDF = Path(__file__).resolve().parent.parent / "examples" / "data" / "office.idf"

#: What :func:`controlled_office_idf` adds to the office: a shade, the hours
#: it may deploy, and an ``OnIfHighZoneAirTemperature`` control of the south
#: zone's argon window (9.0+ schema: zone, sequence, shading type,
#: construction, control type, schedule, setpoint, is scheduled, glare,
#: device, slat angle type and schedule, setpoint 2, daylighting, multiple
#: surface control, fenestrations).
_OFFICE_CONTROLS = """
WindowMaterial:Shade, OfficeShade, 0.3, 0.5, 0.1, 0.1, 0.9, 0.0, 0.003, 0.1;
Schedule:Compact, ShadeAvail, Fraction,
    Through: 12/31,
    For: AllDays,
    Until: 8:00, 0, Until: 18:00, 1, Until: 24:00, 0;
WindowShadingControl, SouthShade, South, 1, InteriorShade, , OnIfHighZoneAirTemperature,
    ShadeAvail, 23.0, Yes, No, OfficeShade, FixedSlatAngle, , , , Sequential, S-Win;
"""


def controlled_office_idf() -> str:
    """The text of ``examples/data/office.idf`` with in-run passive controls
    (read from the repository and changed at run time): a
    ``WindowMaterial:Shade`` of solar transmittance 0.3 deployed on the
    argon window ``S-Win`` while the South zone's air is above 23 C, from
    8:00 to 18:00 (a scheduled control:
    ``LoadedIdf.shading_setpoint_series`` gives the ``shade_sp`` series), and
    the office ventilation's Minimum Indoor Temperature (20 C) and Delta
    Temperature (1.05 K) fields (``ZoneVentilationControl``s of its three
    zones).
    The one building where gas cavities, thermostats and both gates meet
    (and MRT, with ``interior_mrt``).  The delta lies off the weather
    file's 0.1 K grid: with a delta of 1.0, an outdoor 20.0 C puts
    the delta gate's threshold on the 21 C that the thermostat holds the
    zone at, and the decision is a tie that round-off settles either way."""
    text = OFFICE_IDF.read_text()
    vent = "0, 0, 0, 1.5, Natural;"
    if text.count(vent) != 1:
        raise ValueError(f"{OFFICE_IDF}: the ventilation object's flow fields changed")
    return text.replace(vent, "0, 0, 0, 1.5, Natural, 0, 1, 1, 0, 0, 0, 20.0, , 100, , 1.05;") + _OFFICE_CONTROLS


def build_thermostat_model(uncontrolled: bool = True):
    """A 4-zone city block that takes every branch of the thermostat update:
    z0 at 20/26 C with unlimited capacity, z1 at 21/25 C with 300 W of
    heating (a cold start exceeds it: the clamp), z2 at 19/23 C with 100 W of
    cooling, z3 uncontrolled (or, with ``uncontrolled=False``, at 22/24 C);
    z0 and z1 exchange air in both directions at different rates, and z3
    feeds z2 one way."""
    m = build_city_model(4, 4)
    m.add_hvac(IdealHeaterCooler("t0", ["z0"], heat_setpoint=20.0, cool_setpoint=26.0))
    m.add_hvac(IdealHeaterCooler("t1", ["z1"], heat_setpoint=21.0, cool_setpoint=25.0, max_heating=300.0))
    m.add_hvac(IdealHeaterCooler("t2", ["z2"], heat_setpoint=19.0, cool_setpoint=23.0, max_cooling=100.0))
    if not uncontrolled:
        m.add_hvac(IdealHeaterCooler("t3", ["z3"], heat_setpoint=22.0, cool_setpoint=24.0))
    m.add_mixing("z0", "z1", 0.02, bidirectional=False)
    m.add_mixing("z1", "z0", 0.03, bidirectional=False)
    m.add_mixing("z3", "z2", 0.01, bidirectional=False)
    return m


def build_mixed_model():
    """A 2-zone building that takes every boundary branch of the day march:
    outdoor walls, a tilted roof, a floor on the ground (fixed contact h), a
    partition between the zones, a wall with an ambient back face, and a
    window; massive, layered and glazed constructions."""
    m = build_city_model(2, 3)
    walls = {
        "roof": ("mixed", Boundary.outdoor(), Boundary.space_("z0"),
                 [[0, 0, 3], [6, 0, 3], [6, 4, 5], [0, 4, 5]]),
        "floor": ("massive", Boundary.ground(8.0), Boundary.space_("z0"),
                  [[0, 0, 0], [0, 4, 0], [6, 4, 0], [6, 0, 0]]),
        "partition": ("massive", Boundary.space_("z0"), Boundary.space_("z1"),
                      [[0, 0, 0], [0, 4, 0], [0, 4, 3], [0, 0, 3]]),
        "to_plant": ("mixed", Boundary.space_("z1"), Boundary.ambient(30.0),
                     [[0, 0, 0], [4, 0, 0], [4, 0, 2], [0, 0, 2]]),
        "skylight": ("window", Boundary.outdoor(), Boundary.space_("z1"),
                     [[0, 0, 3], [1, 0, 3.2], [1, 1, 3.2], [0, 1, 3]]),
    }
    for name, (kind, front, back, verts) in walls.items():
        m.add_surface(SurfaceDef(name, kind, front, back, vertices=np.asarray(verts, float)))
    return m


def build_nomass_run_model():
    """A 2-zone building whose no-mass runs are longer than 2 nodes, so the
    parity march takes the tridiagonal sweep and not the closed-form pair
    solve: the bench constructions plus three insulation layers in front of
    concrete (a 3-node no-mass run at the front face) and a wall of
    insulation only (a 4-node run from face to face, no massive node)."""
    m = build_city_model(2, 3)
    m.add_construction(Construction("clad", ["p2", "p2", "p2", "c20"]))
    m.add_construction(Construction("light", ["p2", "p2", "p2"]))
    walls = {
        "clad0": ("clad", Boundary.outdoor(), Boundary.space_("z0"),
                  [[0, 0, 0], [6, 0, 0], [6, 0, 3], [0, 0, 3]]),
        "light1": ("light", Boundary.outdoor(), Boundary.space_("z1"),
                   [[0, 0, 0], [0, 4, 0], [0, 4, 3], [0, 0, 3]]),
        "between": ("clad", Boundary.space_("z0"), Boundary.space_("z1"),
                    [[0, 0, 0], [4, 0, 0], [4, 0, 2], [0, 0, 2]]),
    }
    for name, (kind, front, back, verts) in walls.items():
        m.add_surface(SurfaceDef(name, kind, front, back, vertices=np.asarray(verts, float)))
    return m


def glaze_windows(m, classes=building_mod):
    """Give ``m``'s ``window`` construction the office's argon double glazing
    ``Clear3/Argon12/Clear3`` (examples/data/office.idf, as heatx's IDF
    importer realizes it).  ``classes`` is the module whose model classes
    ``m`` uses (heatx's, to build the reference's twin).  Returns ``m``."""
    tau, refl = 0.837, 0.075
    m.add_substance(classes.Substance(
        "Clear3 substance", thermal_conductivity=0.9, density=2500.0,
        specific_heat_capacity=840.0, front_thermal_absorbtance=0.84,
        back_thermal_absorbtance=0.84, front_solar_absorbtance=max(0.0, 1.0 - tau - refl),
        back_solar_absorbtance=max(0.0, 1.0 - tau - refl), solar_transmittance=tau,
    ))
    m.add_substance(classes.GasSubstance("Argon12 substance", "argon"))
    m.add_material(classes.Material("Clear3", "Clear3 substance", 0.003))
    m.add_material(classes.Material("Argon12", "Argon12 substance", 0.012))
    m.add_construction(classes.Construction("window", ["Clear3", "Argon12", "Clear3"]))
    return m


def build_glazed_city(n_zones: int, surfaces_per_zone: int):
    """:func:`build_city_model` with argon double-glazed windows
    (:func:`glaze_windows`): one surface in ``surfaces_per_zone`` carries a
    gas cavity."""
    return glaze_windows(build_city_model(n_zones, surfaces_per_zone))


def build_cavity_model(base=None, classes=building_mod):
    """A 2-zone building whose gas cavities take every branch of the tilt
    correlation: ``base`` (default :func:`build_city_model` (2, 3); the test
    passes bench.py's, built on heatx's classes ``classes``) glazed with
    :func:`glaze_windows` (vertical windows: 90 deg, heat flowing either way
    over a day), a partition between the zones (one zone-closed block, as in
    heatx's test_pallas_hour.py cavity case), panes tilted 20, 60 and 75 deg
    (cavity angles 160, 120 and 105 deg, and their complements when the front
    face is the warmer: the 0-60, 60, 60-90 and 90-180 bands), a glazed panel
    tilted 130 deg over an ambient space (50 deg) and a vertical window with a
    40 mm argon gap, whose Ra passes 1e4 and 5e4 on a cold day (the switches
    of the 90 deg correlation)."""
    m = glaze_windows(build_city_model(2, 3) if base is None else base, classes)
    m.add_material(classes.Material("Argon40", "Argon12 substance", 0.04))
    m.add_construction(classes.Construction("wide", ["Clear3", "Argon40", "Clear3"]))

    def tilted(deg):
        r = np.radians(deg)
        return np.array([[0, 0, 0], [2, 0, 0], [2, -np.cos(r), np.sin(r)],
                         [0, -np.cos(r), np.sin(r)]], float)

    B = classes.Boundary
    walls = {
        "partition": ("massive", B.space_("z0"), "z1", tilted(90.0)),
        "sky20": ("window", B.outdoor(), "z0", tilted(20.0)),
        "pane60": ("window", B.outdoor(), "z0", tilted(60.0)),
        "pane75": ("window", B.outdoor(), "z1", tilted(75.0)),
        "panel130": ("window", B.ambient(5.0), "z1", tilted(130.0)),
        "wide90": ("wide", B.outdoor(), "z1", tilted(90.0)),
    }
    for name, (kind, front, zone, verts) in walls.items():
        m.add_surface(classes.SurfaceDef(name, kind, front, B.space_(zone), vertices=verts))
    return m


def build_two_zone_model(classes=building_mod):
    """heatx tests/test_mrt.py's interior-MRT building (``classes``: the
    building module, the port's or heatx's): two zones of two massive and one
    insulated outdoor wall each (two node heights), and a massive partition
    between them, which takes part in both zones' MRT networks."""
    m = classes.BuildingModel()
    m.add_substance(classes.Substance("concrete", thermal_conductivity=0.816, density=1700.0,
                                      specific_heat_capacity=800.0))
    m.add_substance(classes.Substance("poly", thermal_conductivity=0.0252, density=17.5,
                                      specific_heat_capacity=2400.0))
    m.add_material(classes.Material("c15", "concrete", 0.15))
    m.add_material(classes.Material("p2", "poly", 0.02))
    m.add_construction(classes.Construction("wall", ["c15"]))
    m.add_construction(classes.Construction("mixed", ["p2", "c15"]))
    verts = np.array([[0, 0, 0], [5, 0, 0], [5, 0, 3], [0, 0, 3]], float)
    B = classes.Boundary
    for z in range(2):
        m.add_space(classes.SpaceDef(f"z{z}", 200.0 + 50.0 * z))
        for i, kind in enumerate(("wall", "wall", "mixed")):
            m.add_surface(classes.SurfaceDef(f"s{z}_{i}", kind, B.outdoor(), B.space_(f"z{z}"),
                                             vertices=verts))
    m.add_surface(classes.SurfaceDef("partition", "wall", B.space_("z0"), B.space_("z1"),
                                     vertices=verts))
    return m


def coarse_config(dtype=torch.float64, nomass_fixed_iters: int = 2, min_dt: float = 900.0, **kw):
    """A coarse discretization for tests of the parity march: 6 stability
    sub-steps per hour on the bench constructions instead of the default
    discretization's 118 (the ``min_dt`` floor drives that count: 1200 s
    gives 4, 1800 s gives 2)."""
    from heatx_torch.config import SimConfig

    return SimConfig(dtype=dtype, max_dx=0.5, min_dt=min_dt,
                     nomass_fixed_iters=nomass_fixed_iters, **kw)


def synthetic_weather(hours: int):
    """bench.py's synthetic hourly weather: (dry bulb C, wind m/s, wind
    direction rad, global horizontal W/m2, horizontal IR W/m2), each [hours]."""
    t = np.arange(hours)
    return (
        10.0 + 10.0 * np.sin(2 * np.pi * t / 24.0),
        3.0 + 2.0 * np.sin(2 * np.pi * t / 17.0),
        np.radians((t * 7.0) % 360.0),
        np.maximum(0.0, 600.0 * np.sin(2 * np.pi * (t % 24) / 24.0 - np.pi / 2)),
        np.full(hours, 350.0),
    )


def solar_factors(n_surfaces: int, seed: int = 0) -> np.ndarray:
    """bench.py's static per-surface solar scale factors, U(0.2, 1)."""
    return np.random.default_rng(seed).uniform(0.2, 1.0, n_surfaces)


def bench_inputs(building, hours: int, dtype=None, device="cpu", seed: int = 0) -> StepInputs:
    """The bench's [hours]-long input sequence for ``FastRunner.run``."""
    dry, wind, wdir, ghi, ir = synthetic_weather(hours)
    S = building.n_surfaces
    base = default_inputs(building, dtype=dtype, device=device)
    dtype = base.t_out.dtype

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype, device=device)

    return base.replace(
        t_out=t(dry),
        wind_speed=t(wind),
        wind_direction=t(wdir),
        sol_front=t(ghi[:, None] * solar_factors(S, seed)[None, :]),
        ir_front=t(ir),
        hvac_power=t(np.full(building.n_hvacs, 500.0)),
        lum_power=t(np.full(building.n_luminaires, 150.0)),
    )


def demand_inputs(building, hours: int, dtype=None, device="cpu", seed: int = 0) -> StepInputs:
    """The demand rows' [hours]-long input sequence (bench.py:152-160,
    :339-349): the bench weather and solar factors, 150 W per luminaire, and
    every scheduled HVAC unit at its default 0 W (the thermostats act)."""
    seq = bench_inputs(building, hours, dtype=dtype, device=device, seed=seed)
    return seq.replace(hvac_power=torch.zeros_like(seq.hvac_power))


def branch_counts(zone_T, a, b, c, dt, heat_sp, cool_sp, max_heat, max_cool, load=None) -> dict:
    """How many zones of one sub-step take each branch of
    ``engine.zone.zone_update`` (``smallb``, ``heating``, ``cooling``,
    ``clamped`` (a subset of the two), ``deadband``) and how many sit on a
    tie, where subgradient conventions differ (``ties``: the load exactly 0
    inside an active branch, or the free-float temperature exactly on a
    setpoint).  ``load`` is the update's load where the caller has it."""
    smallb = torch.abs(b) <= zone_mod.SMALL_B
    t_free = zone_mod.future_zone_temperatures(zone_T, a, b, c, dt)
    if load is None:
        load = zone_mod.zone_update(zone_T, a, b, c, dt, heat_sp, cool_sp, max_heat, max_cool)[1]
    heating = ~smallb & (t_free < heat_sp)
    cooling = ~smallb & ~heating & (t_free > cool_sp)
    clamped = (heating & (load == max_heat)) | (cooling & (load == -max_cool))
    act = (heating & (max_heat > 0)) | (cooling & (max_cool > 0))
    ties = (act & (load == 0)) | (~smallb & ((t_free == heat_sp) | (t_free == cool_sp)))
    return dict(
        smallb=int(smallb.sum()), heating=int(heating.sum()), cooling=int(cooling.sum()),
        clamped=int(clamped.sum()), deadband=int((~smallb & ~heating & ~cooling).sum()),
        ties=int(ties.sum()),
    )


class BranchCounter:
    """Counts, over every ``engine.zone.zone_update`` call made while it is
    installed (``with BranchCounter() as c:`` around a plain day march), the
    zone-sub-steps on each branch of the thermostat update: ``c.counts`` sums
    :func:`branch_counts`, and ``c.masks`` lists, per call, the load's sign
    and whether it sits on a capacity: two marches took the same branches
    iff their masks are equal."""

    def __init__(self):
        self.counts = dict.fromkeys(("heating", "cooling", "clamped", "deadband", "smallb", "ties"), 0)
        self.masks = []

    def __enter__(self):
        orig = self._orig = zone_mod.zone_update

        def counted(zone_T, a, b, c, dt, heat_sp, cool_sp, max_heat, max_cool):
            args = (zone_T, a, b, c, dt, heat_sp, cool_sp, max_heat, max_cool)
            new_T, load = orig(*args)
            with torch.no_grad():
                for k, v in branch_counts(*args, load=load).items():
                    self.counts[k] += v
                self.masks.append(torch.stack([
                    torch.sign(load), ((load == max_heat) | (load == -max_cool)).to(load.dtype),
                ]))
            return new_T, load

        zone_mod.zone_update = counted
        return self

    def __exit__(self, *exc):
        zone_mod.zone_update = self._orig

    def same_branches(self, other: "BranchCounter") -> bool:
        return len(self.masks) == len(other.masks) and all(
            torch.equal(a, b) for a, b in zip(self.masks, other.masks)
        )


#: Santiago de Chile (the IWEC file the repository's goldens were made from):
#: latitude, longitude, time zone, elevation.
SANTIAGO = (-33.38, -70.78, -4.0, 474.0)


def write_synthetic_epw(path, seed: int = 0) -> str:
    """Write a valid EPW file of 8,760 seeded hourly records at Santiago's
    location (8 header lines: LOCATION, DESIGN CONDITIONS, TYPICAL/EXTREME
    PERIODS, GROUND TEMPERATURES with one set of monthly soil temperatures,
    HOLIDAYS/DAYLIGHT SAVINGS, two COMMENTS, DATA PERIODS).  Southern
    seasons: warm Januaries, diurnal swings, clear-sky-shaped radiation from
    the sun's altitude with seeded cloudiness, wind speed and direction (to a
    tenth of a degree, off the multiples of 90 deg).
    Returns ``path``."""
    rng = np.random.default_rng(seed)
    lat, lon, tz, elev = SANTIAGO
    hours = np.arange(8760)
    doy = hours // 24 + 1
    hod = hours % 24
    season = np.cos(2.0 * np.pi * (doy - 15) / 365.0)  # +1 mid-January
    daily_cloud = np.repeat(rng.uniform(0.0, 0.7, 365), 24)
    dry = (14.0 + 7.0 * season + 7.0 * np.sin(2.0 * np.pi * (hod - 9) / 24.0)
           + rng.normal(0.0, 1.0, 8760))
    dew = dry - 6.0 - 3.0 * rng.uniform(size=8760)
    rh = np.clip(100.0 * np.exp(0.06 * (dew - dry)), 5.0, 100.0)
    alt, _ = solar_position(lat, lon, tz, doy, hod + 0.5)
    sin_alt = np.clip(np.sin(alt), 0.0, None)
    clear = 1.0 - daily_cloud
    dni = np.where(sin_alt > 0.02, 900.0 * clear * sin_alt**0.3, 0.0)
    dhi = np.where(sin_alt > 0.0, (60.0 + 180.0 * daily_cloud) * sin_alt, 0.0)
    ghi = dni * sin_alt + dhi
    sky_ir = 5.670374419e-8 * (dry + 273.15) ** 4 * (0.75 + 0.2 * daily_cloud)
    wind = np.clip(3.0 + 1.5 * np.sin(2.0 * np.pi * (hod - 14) / 24.0)
                   + rng.normal(0.0, 0.8, 8760), 0.0, None)
    # Wind directions to a tenth of a degree, never on a multiple of 90: wind
    # along a facade of a rectangular building is the windward test's tie,
    # where float32 and float64 take opposite sides (PERF.md, ROADMAP C).
    wdir = np.round((200.0 + 60.0 * rng.normal(size=8760)) % 360.0, 1)
    wdir = np.where(wdir % 90.0 == 0.0, wdir + 0.1, wdir)
    ground = 16.0 + 5.0 * np.cos(2.0 * np.pi * (np.arange(12) - 1.0) / 12.0)
    month = np.repeat(np.arange(1, 13), [d * 24 for d in (31, 28, 31, 30, 31, 30, 31, 31, 30,
                                                            31, 30, 31)])
    day = np.concatenate([np.repeat(np.arange(1, d + 1), 24)
                          for d in (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)])
    head = [
        f"LOCATION,Santiago (synthetic),-,CHL,seed {seed},855740,{lat},{lon},{tz},{elev}",
        "DESIGN CONDITIONS,0",
        "TYPICAL/EXTREME PERIODS,0",
        "GROUND TEMPERATURES,1,.5,,,," + ",".join(f"{g:.2f}" for g in ground),
        "HOLIDAYS/DAYLIGHT SAVINGS,No,0,0,0",
        "COMMENTS 1,synthetic weather written by heatx_torch.testing.write_synthetic_epw",
        "COMMENTS 2,",
        "DATA PERIODS,1,1,Data,Sunday, 1/ 1,12/31",
    ]
    rows = []
    for i in range(8760):
        rows.append(",".join([
            "1999", str(month[i]), str(day[i]), str(hod[i] + 1), "60", "?9?9?9?9E0?9?9?9",
            f"{dry[i]:.1f}", f"{dew[i]:.1f}", f"{rh[i]:.0f}", "95000", "0", "1415",
            f"{sky_ir[i]:.0f}", f"{ghi[i]:.0f}", f"{dni[i]:.0f}", f"{dhi[i]:.0f}",
            "0", "0", "0", "0", f"{wdir[i]:.1f}", f"{wind[i]:.1f}",
            "5", "5", "9999", "99999", "9", "999999999", "0", "0.1", "0", "88", "0.2", "0", "0",
        ]))
    with open(path, "w") as f:
        f.write("\n".join(head + rows) + "\n")
    return str(path)


def office_inputs(loaded, tm, epw, hours: int):
    """The office IDF workflow's inputs, as bench.py's ``run_office_bench``
    builds them (bench.py:430-461): EPW weather tiled to ``hours``, computed
    solar on the outdoor front faces, the horizontal IR, the IDF's scheduled
    infiltration and ventilation at outdoor temperature and its hourly
    channels (gains, setpoint schedules).  ``loaded`` is
    :func:`heatx_torch.model.idf.load_idf`'s result, ``tm`` the
    ``ThermalModel`` of ``loaded.model``, ``epw`` an ``EPWData``.  Returns
    ``(StepInputs, ground_hourly)``, the latter the monthly soil temperature
    per hour (None where the building has no ground face or the file no
    ground temperatures)."""
    b = tm.building
    T = min(hours, 8760)
    reps = -(-T // epw.n_hours)

    def tile(v):
        return np.tile(np.asarray(v, np.float64), reps)[:T]

    sb = b.surfaces
    out_f = np.asarray(sb.front_code) == B_OUTDOOR
    sol_f = surface_irradiance(epw, b, hours=T) * out_f
    ch = loaded.hourly_channels(T)
    air = loaded.airflow_series(T)
    dry = tile(epw.dry_bulb)
    t_in = np.repeat(dry[:, None], b.n_zones, axis=1)
    kw = dict(dtype=b.config.dtype, device=tm.device)

    def t(v):
        return torch.as_tensor(np.asarray(v, np.float64), **kw)

    seq = tm.inputs().replace(
        t_out=t(dry), wind_speed=t(tile(epw.wind_speed)),
        wind_direction=t(tile(np.radians(epw.wind_direction_deg))),
        sol_front=t(sol_f), ir_front=t(tile(epw.horizontal_ir)),
        inf_vol=t(air["inf_vol"]), inf_mask=torch.as_tensor(air["inf_vol"] > 0, device=tm.device),
        inf_temp=t(t_in), vent_vol=t(air["vent_vol"]),
        vent_mask=torch.as_tensor(air["vent_vol"] > 0, device=tm.device), vent_temp=t(t_in),
        **{k: t(v) for k, v in ch.items()},
    )
    ground = None
    has_ground = (np.asarray(sb.front_code) == B_GROUND).any() or (
        np.asarray(sb.back_code) == B_GROUND).any()
    if has_ground and epw.ground_temps:
        ground = epw.ground_temperature(None)[_MONTH_HOURS[np.arange(T) % 8760]]
    return seq, ground

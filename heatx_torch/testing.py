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
``build_nomass_run_model`` has no-mass runs of 3 and 4 nodes and
``coarse_config`` a discretization whose parity march is short.
"""

from __future__ import annotations

import numpy as np
import torch

from heatx_torch.engine import zone as zone_mod
from heatx_torch.engine.state import StepInputs, default_inputs
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

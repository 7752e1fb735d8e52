"""Thermal comfort: operative temperature with interior radiant exchange.

heatx_torch's counterpart of examples/comfort.py.  Air temperature alone
misstates comfort next to a cold window: ASHRAE 55 rates spaces by OPERATIVE
temperature, the mean of the air and mean-radiant temperatures.  The
interior longwave exchange is Carroll's MRT network
(``SimConfig(interior_mrt=True)``), and the day march reports the per-hour
operative temperature (``FastRunner(collect_operative=True)``: the CUDA day
kernel's MRT kind on the card, its plain version on the CPU).

The experiment: a winter week for two otherwise-identical offices, one with
double glazing, one with a much larger single pane.  Their AIR temperatures
are held identical by an ideal heater at 21 C; the radiant environment is
what differs.  Each run starts from an EnergyPlus-style warm-up of its first
day (``ThermalModel.warmup`` with ``FastRunner.run``), and the history is
scored with Fanger's PMV/PPD (``heatx_torch.comfort.zone_comfort_history``).

Deliberate difference from heatx: without the EPW file (``--epw`` or
``HEATX_EPW``) the week comes from ``testing.write_synthetic_epw(<tmp>,
seed=0)`` (Santiago's location, seeded weather), labelled synthetic; heatx
falls back to a sine day.

Run:  python examples_torch/comfort.py [--platform gpu|cpu] [--epw path.epw]
      (HEATX_EXAMPLE_FAST=1: 48 h)
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

START = 150 * 24  # a winter week (southern hemisphere EPW)


def office(glazing: str, classes=None):
    """A mid-floor corner office with double (``"igu"``) or a floor-to-
    ceiling single (``"single"``) glazing.  ``classes``: the module of the
    model classes (default ``heatx_torch.model.building``; heatx's has the
    same names)."""
    if classes is None:
        from heatx_torch.model import building as classes
    c = classes
    m = c.BuildingModel()
    m.add_substance(c.Substance(
        "concrete", thermal_conductivity=0.816, density=1700.0, specific_heat_capacity=800.0,
        front_thermal_absorbtance=0.9, back_thermal_absorbtance=0.9, front_solar_absorbtance=0.7,
        back_solar_absorbtance=0.7,
    ))
    m.add_substance(c.Substance(
        "glass", thermal_conductivity=1.0, density=2500.0, specific_heat_capacity=840.0,
        solar_transmittance=0.7, front_solar_absorbtance=0.1, back_solar_absorbtance=0.1,
        front_thermal_absorbtance=0.84, back_thermal_absorbtance=0.84,
    ))
    m.add_substance(c.GasSubstance("argon", "argon"))
    m.add_material(c.Material("c15", "concrete", 0.15))
    m.add_material(c.Material("pane", "glass", 0.006))
    m.add_material(c.Material("gap", "argon", 0.012))
    m.add_construction(c.Construction("wall", ["c15"]))
    m.add_construction(c.Construction("igu", ["pane", "gap", "pane"]))
    m.add_construction(c.Construction("single", ["pane"]))

    m.add_space(c.SpaceDef("office", 150.0))
    wall = np.array([[0, 0, 0], [5, 0, 0], [5, 0, 3], [0, 0, 3]], float)
    slab = np.array([[0, 0, 0], [5, 0, 0], [5, 5, 0], [0, 5, 0]], float)
    # One exterior facade; the other partitions/slabs face conditioned
    # neighbors (21 C ambient), like a real mid-floor corner office.
    m.add_surface(c.SurfaceDef("facade", "wall", c.Boundary.outdoor(), c.Boundary.space_("office"),
                               vertices=wall))
    for i in range(2):
        m.add_surface(c.SurfaceDef(f"part{i}", "wall", c.Boundary.ambient(21.0), c.Boundary.space_("office"),
                                   vertices=wall))
    for nm in ("floor", "ceiling"):
        m.add_surface(c.SurfaceDef(nm, "wall", c.Boundary.ambient(21.0), c.Boundary.space_("office"),
                                   vertices=slab))
    if glazing == "igu":
        win = np.array([[1, 0, 1], [4, 0, 1], [4, 0, 2], [1, 0, 2]], float)
        m.add_fenestration(c.SurfaceDef("win", "igu", c.Boundary.outdoor(), c.Boundary.space_("office"),
                                        vertices=win))
    else:  # a floor-to-ceiling single pane
        win = np.array([[0.5, 0, 0.2], [4.5, 0, 0.2], [4.5, 0, 2.8], [0.5, 0, 2.8]], float)
        m.add_fenestration(c.SurfaceDef("win", "single", c.Boundary.outdoor(), c.Boundary.space_("office"),
                                        vertices=win))
    # Ideal heater pins the AIR temperature; comfort differences are radiant.
    m.add_hvac(c.IdealHeaterCooler("t", ["office"], heat_setpoint=21.0, cool_setpoint=27.0))
    return m


def week(epw_path, T):
    """(dry bulb, wind speed, horizontal IR) of the winter week, and whether
    they come from a synthetic EPW file."""
    from heatx_torch.weather.epw import read_epw

    synthetic = not (epw_path and os.path.isfile(epw_path))
    if synthetic:
        from heatx_torch import testing

        epw_path = testing.write_synthetic_epw(
            os.path.join(tempfile.mkdtemp(prefix="heatx_torch_"), "synthetic.epw"), seed=0)
    w = read_epw(epw_path)
    sl = slice(START, START + T)
    return w.dry_bulb[sl], w.wind_speed[sl], w.horizontal_ir[sl], synthetic


def run_office(kind, dry, wind, ir, device, config=None):
    """One office's week on the day march after a warm-up of its first day:
    returns (zone air [T], operative [T], warm-up repeats, seconds)."""
    from heatx_torch import SimConfig, ThermalModel

    cfg = SimConfig(interior_mrt=True, nomass_fixed_iters=1) if config is None else config
    T = len(dry)
    tm = ThermalModel(office(kind), n=1, config=cfg, device=device)
    fr = tm.fast_runner(mode="trbdf2", substeps=8, hours=24, collect_operative=True)
    seq = tm.inputs_sequence(T, t_out=dry, wind_speed=wind, ir_front=ir)
    # EnergyPlus-style warm-up: repeat the first day until the envelope
    # converges, so the stats below are weather, not the 22 C init.
    day = tm.inputs_sequence(24, t_out=dry[:24], wind_speed=wind[:24], ir_front=ir[:24])
    st, reps = tm.warmup(tm.initial_state(), day, run=lambda s: fr.run(s, day, collect_zone_T=False)[0])
    t0 = time.time()
    final, zt, top = fr.run(st, seq, collect_operative=True)
    zt, top = zt[:, 0].cpu().numpy().astype(np.float64), top[:, 0].cpu().numpy().astype(np.float64)
    return zt, top, reps, time.time() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--platform", choices=("gpu", "cpu"), default="gpu")
    ap.add_argument("--epw", default=os.environ.get("HEATX_EPW", ""))
    ap.add_argument("--hours", type=int, default=168)
    args = ap.parse_args(argv)
    if os.environ.get("HEATX_EXAMPLE_FAST") == "1":  # smoke-test settings
        args.hours = min(args.hours, 48)
    device = torch.device("cuda" if args.platform == "gpu" else "cpu")

    from heatx_torch.comfort import zone_comfort_history

    T = args.hours
    dry, wind, ir, synthetic = week(args.epw, T)
    if synthetic:
        print("# weather: synthetic EPW (testing.write_synthetic_epw, seed 0)")
    for label, kind in (("double glazing", "igu"), ("single pane", "single")):
        zt, top, reps, wall = run_office(kind, dry, wind, ir, device)
        gap = zt - top  # air minus operative: the radiant comfort deficit
        # Fanger PMV/PPD over the same history (office occupant: 1.2 met,
        # winter clothing 1.0 clo; indoor RH assumed 40 %: no moisture
        # model).  operative = (air + MRT)/2, so MRT = 2*op - air.
        pmv, ppd = zone_comfort_history(zt, 2.0 * top - zt, 40.0, met=1.2, clo=1.0)
        work = slice(8, 18)  # working hours of each day
        pmv_w = pmv.reshape(-1, 24)[:, work]
        ppd_w = ppd.reshape(-1, 24)[:, work]
        print(
            f"{label:>15}: air {zt.min():.1f}..{zt.max():.1f} C held by the "
            f"heater; operative {top.min():.1f}..{top.max():.1f} C; worst "
            f"radiant deficit {gap.max():.2f} K; working-hours PMV "
            f"{pmv_w.mean():+.2f} (worst {pmv_w.min():+.2f}), PPD "
            f"{ppd_w.mean():.0f}% ({wall:.2f}s for {T} h after a warm-up of {reps} days, kernel engine on "
            f"{device.type})"
        )


if __name__ == "__main__":
    main()

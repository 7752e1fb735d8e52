"""Passive cooling with in-run zone-state controls: night ventilation +
dynamic window shading, compiled INTO the march.

heatx_torch's counterpart of examples/passive_controls.py.  The two
workhorses of passive summer comfort both depend on the marching zone
temperature, so a pre-rendered schedule cannot express them:

* **night ventilation**: open the vents only while the room is warmer than
  outside by a margin, and never chill it below a floor
  (``ZoneVentilationControl``: EnergyPlus's ZoneVentilation Delta
  Temperature / Minimum Indoor Temperature limit fields);
* **dynamic shading**: drop the exterior blind while the room is above a
  comfort threshold (``ZoneShadingControl``: EnergyPlus's
  OnIfHighZoneAirTemperature).

Each main step reads the previous step's zone temperature (EnergyPlus's own
control convention) and masks the ventilation channel / scales the incident
solar.  On the card the week runs through the TR-BDF2 day kernel, whose
``kExt`` instantiations carry these gates; on the CPU through heatx's XLA
path (``ThermalModel.run(mode="trbdf2")``, plain PyTorch).

The experiment: a heavy-weight west-facing room through a hot EPW week,
free-running, uncontrolled against controlled.

Deliberate differences from heatx: on the card ``ThermalModel.run`` (plain
PyTorch, one small launch per operation: minutes a simulated day there)
becomes ``fast_runner(mode="trbdf2", substeps=8, hours=24).run``, the same
TR-BDF2 scheme at 8 sub-steps an hour on the day kernel.  Without the EPW
file (``--epw`` or ``HEATX_EPW``) the week comes from
``testing.write_synthetic_epw(<tmp>, seed=0)`` (Santiago's location, warm
Januaries), labelled synthetic; heatx needs the file.

Run:  python examples_torch/passive_controls.py [--platform gpu|cpu] [--epw path.epw]
      (HEATX_EXAMPLE_FAST=1: 2 days)
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

START = 24 * 14  # mid-January (southern-hemisphere summer for Santiago)


def room(controlled: bool, classes=None):
    """heatx's west-facing concrete room, with or without the two controls.
    ``classes``: the module of the model classes (default
    ``heatx_torch.model.building``; heatx's has the same names)."""
    if classes is None:
        from heatx_torch.model import building as classes
    c = classes
    m = c.BuildingModel()
    m.add_substance(c.Substance("concrete", thermal_conductivity=0.816, density=1700.0,
                                specific_heat_capacity=800.0))
    m.add_material(c.Material("c20", "concrete", 0.2))
    m.add_construction(c.Construction("wall", ["c20"]))
    m.add_space(c.SpaceDef("room", 120.0))
    # West wall (the afternoon solar collector) + a north wall.
    m.add_surface(c.SurfaceDef("west", "wall", c.Boundary.outdoor(), c.Boundary.space_("room"),
                               vertices=np.array([[0, 0, 0], [0, 6, 0], [0, 6, 3], [0, 0, 3]], float)))
    m.add_surface(c.SurfaceDef("north", "wall", c.Boundary.outdoor(), c.Boundary.space_("room"),
                               vertices=np.array([[0, 6, 0], [8, 6, 0], [8, 6, 3], [0, 6, 3]], float)))
    if controlled:
        # Blind drops (30 % transmittance) while the room is above 24 C.
        m.add_zone_shading(c.ZoneShadingControl("west", "room", 0.30, 24.0))
        # Night-vent: flow only while the room is >= 2 K warmer than outside
        # AND still above 18 C (never chill below the floor).
        m.add_vent_control(c.ZoneVentilationControl("room", min_indoor=18.0, delta=2.0))
    return m


def epw_data(path):
    """The EPW record at ``path`` where the file exists, else a synthetic
    one (seed 0); and whether it is synthetic."""
    from heatx_torch.weather.epw import read_epw

    if path and os.path.isfile(path):
        return read_epw(path), False
    from heatx_torch import testing

    tmp = os.path.join(tempfile.mkdtemp(prefix="heatx_torch_"), "synthetic.epw")
    return read_epw(testing.write_synthetic_epw(tmp, seed=0)), True


def inputs(tm, epw, T, controlled):
    """The week's inputs: Perez solar and tilted longwave per surface, 0.12
    m3/s of outdoor air where the vent control allows it (the uncontrolled
    room keeps its windows shut), 0.01 m3/s of infiltration."""
    from heatx_torch.weather.solar import surface_irradiance, surface_longwave

    b = tm.building
    sl = slice(START, START + T)
    sol = surface_irradiance(epw, b, start_hour=START, hours=T, sky="perez")
    ir = surface_longwave(epw, b, start_hour=START, hours=T)
    dry = np.asarray(epw.dry_bulb[sl])
    return tm.inputs_sequence(
        T, t_out=dry, wind_speed=np.asarray(epw.wind_speed[sl]),
        wind_direction=np.asarray(epw.wind_direction_deg[sl]),
        sol_front=sol, ir_front=ir,
        vent_vol=np.full(1, 0.12 if controlled else 0.0), vent_temp=dry[:, None],
        vent_mask=np.full(1, controlled), inf_vol=np.full(1, 0.01), inf_temp=dry[:, None],
        inf_mask=np.ones(1, bool),
    )


def week(name, epw, T, device, config=None, engine=None):
    """One room's week: its zone temperature [T] (float64 numpy) and the
    engine that ran (``"kernel"``: the day march; ``"xla"``:
    ``ThermalModel.run``; default: the kernel on the card, xla on the CPU)."""
    from heatx_torch import SimConfig, ThermalModel

    cfg = SimConfig(dtype=torch.float64, nomass_fixed_iters=1) if config is None else config
    engine = engine or ("kernel" if torch.device(device).type == "cuda" else "xla")
    tm = ThermalModel(room(name == "controlled"), n=1, config=cfg, device=device)
    seq = inputs(tm, epw, T, name == "controlled")
    if engine == "kernel":
        _, hist = tm.fast_runner(mode="trbdf2", substeps=8, hours=24).run(tm.initial_state(), seq)
    else:
        _, hist = tm.run(tm.initial_state(), seq, mode="trbdf2", substeps=8)
    return hist[:, 0].cpu().numpy().astype(np.float64), engine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--platform", choices=("gpu", "cpu"), default="gpu")
    ap.add_argument("--epw", default=os.environ.get("HEATX_EPW", ""))
    ap.add_argument("--days", type=int, default=7)
    args = ap.parse_args(argv)
    fast = os.environ.get("HEATX_EXAMPLE_FAST") == "1"
    if fast:  # smoke-test settings
        args.days = min(args.days, 2)
    device = torch.device("cuda" if args.platform == "gpu" else "cpu")

    epw, synthetic = epw_data(args.epw)
    if synthetic:
        print("# weather: synthetic EPW (testing.write_synthetic_epw, seed 0)")
    T = 24 * args.days
    results = {}
    for name in ("free", "controlled"):
        t0 = time.time()
        z, engine = week(name, epw, T, device)
        results[name] = z
        print(f"{name:>11}: peak {z.max():.2f} C  mean {z.mean():.2f} C  "
              f"hours>27C {(z > 27.0).sum():3d}   ({time.time()-t0:.2f}s, {engine} engine)")

    dmean = results["free"].mean() - results["controlled"].mean()
    hot_f = int((results["free"] > 27.0).sum())
    hot_c = int((results["controlled"] > 27.0).sum())
    print(f"\ncontrols shave {dmean:.2f} K off the weekly mean and cut "
          f"hours above 27 C from {hot_f} to {hot_c} (shading clips the "
          "afternoon spike; the delta-gated night vent dumps the stored "
          "heat without ever under-cooling the slab).")
    assert np.isfinite(dmean)
    if not fast:  # 2 smoke days carry too much of the shared 22C init
        assert dmean > 1.0 and hot_c < hot_f, "controls should visibly cool"
    return 0


if __name__ == "__main__":
    sys.exit(main())

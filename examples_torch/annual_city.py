"""End-to-end example: annual simulation of a city block on one GPU.

heatx_torch's counterpart of examples/annual_city.py.  Builds a district of
``--zones`` zones (massive walls, an insulated wall, glazing, heaters,
lighting, inter-zone mixing, a ground slab per zone; 9 surfaces a zone),
loads EPW weather (``HEATX_EPW``/``--epw`` where the file exists, else
heatx's synthetic sine weather), and marches a full year through the TR-BDF2
day march (``FastRunner.run``: one CUDA day-kernel launch a simulated day on
the card, 365 a year; its plain version on the CPU) with the weather
interpolated to the sub-steps, then prints per-zone statistics and saves a
checkpoint (``heatx_torch.io.checkpoint.save_state``).

Deliberate difference from heatx: the checkpoint goes to the temporary
directory (``tempfile.gettempdir()``) unless ``--out`` names a path.

Run:  python examples_torch/annual_city.py [--platform gpu|cpu] [--zones 100] [--epw path.epw]
      (HEATX_EXAMPLE_FAST=1: 4 zones, 48 h)
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch


def build_district(n_zones: int, classes=None):
    """heatx's district.  ``classes``: the module of the model classes
    (default ``heatx_torch.model.building``; heatx's has the same names)."""
    if classes is None:
        from heatx_torch.model import building as classes
    c = classes
    m = c.BuildingModel()
    m.add_substance(c.Substance("concrete", thermal_conductivity=0.816, density=1700.0,
                                specific_heat_capacity=800.0, front_solar_absorbtance=0.7,
                                back_solar_absorbtance=0.7))
    m.add_substance(c.Substance("poly", thermal_conductivity=0.0252, density=17.5,
                                specific_heat_capacity=2400.0))
    m.add_substance(c.Substance("glass", thermal_conductivity=1.0, density=2500.0,
                                specific_heat_capacity=840.0, solar_transmittance=0.8,
                                front_solar_absorbtance=0.1, back_solar_absorbtance=0.1))
    m.add_material(c.Material("c20", "concrete", 0.2))
    m.add_material(c.Material("slab", "concrete", 0.15))
    m.add_material(c.Material("p2", "poly", 0.02))
    m.add_material(c.Material("g6", "glass", 0.006))
    m.add_construction(c.Construction("massive", ["c20"]))
    m.add_construction(c.Construction("mixed", ["p2", "c20", "p2"]))
    m.add_construction(c.Construction("window", ["g6"]))
    m.add_construction(c.Construction("floor", ["slab"]))

    wall = np.array([[0, 0, 0], [6, 0, 0], [6, 0, 3], [0, 0, 3]], float)
    slab = np.array([[0, 0, 0], [6, 0, 0], [6, 6, 0], [0, 6, 0]], float)
    for z in range(n_zones):
        zone = f"z{z}"
        m.add_space(c.SpaceDef(zone, 108.0))
        for si in range(6):
            m.add_surface(c.SurfaceDef(f"w{z}_{si}", "massive", c.Boundary.outdoor(),
                                       c.Boundary.space_(zone), vertices=wall))
        m.add_surface(c.SurfaceDef(f"i{z}", "mixed", c.Boundary.outdoor(),
                                   c.Boundary.space_(zone), vertices=wall))
        m.add_fenestration(c.SurfaceDef(f"g{z}", "window", c.Boundary.outdoor(),
                                        c.Boundary.space_(zone), vertices=wall))
        m.add_surface(c.SurfaceDef(f"f{z}", "floor", c.Boundary.ground(temperature=12.0),
                                   c.Boundary.space_(zone), vertices=slab))
        m.add_hvac(c.ElectricHeater(f"h{z}", zone))
        m.add_luminaire(c.Luminaire(f"l{z}", zone))
        if z > 0 and z % 2 == 1:
            m.add_mixing(f"z{z-1}", zone, 0.03)  # paired zones share air
    return m


def weather(hours, epw_path):
    """Hourly (dry bulb, wind speed, wind direction rad, GHI, horizontal IR)
    from the EPW file, tiled to ``hours``, or heatx's sine weather."""
    if epw_path and os.path.isfile(epw_path):
        from heatx_torch.weather.epw import read_epw

        w = read_epw(epw_path)
        reps = -(-hours // w.n_hours)
        return tuple(np.tile(v, reps)[:hours] for v in (
            w.dry_bulb, w.wind_speed, w.wind_direction_rad, w.global_horizontal, w.horizontal_ir))
    t = np.arange(hours)
    return (10 + 10 * np.sin(2 * np.pi * t / 24), np.full(hours, 3.0), np.zeros(hours),
            np.maximum(0, 600 * np.sin(2 * np.pi * (t % 24) / 24 - np.pi / 2)), np.full(hours, 350.0))


def inputs(tm, hours, epw_path):
    """The year's input sequence: the weather, seeded per-surface solar
    factors, 400 W of heating and 120 W of lighting a zone."""
    b = tm.building
    dry, wind, wdir, ghi, ir = weather(hours, epw_path)
    S = b.n_surfaces
    rng = np.random.default_rng(0)
    sol_factor = rng.uniform(0.2, 1.0, S)
    kw = dict(dtype=b.config.dtype, device=tm.device)
    return tm.inputs().replace(
        t_out=torch.as_tensor(dry, **kw), wind_speed=torch.as_tensor(wind, **kw),
        wind_direction=torch.as_tensor(wdir, **kw),
        sol_front=torch.as_tensor(ghi[:, None] * sol_factor[None, :], **kw),
        ir_front=torch.as_tensor(np.repeat(ir[:, None], S, axis=1), **kw),
        hvac_power=torch.full((hours, b.n_hvacs), 400.0, **kw),
        lum_power=torch.full((hours, b.n_luminaires), 120.0, **kw),
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--platform", choices=("gpu", "cpu"), default="gpu")
    ap.add_argument("--zones", type=int, default=100)
    ap.add_argument("--hours", type=int, default=8760)
    ap.add_argument("--epw", default=os.environ.get("HEATX_EPW", ""))
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "heatx_torch_city_checkpoint.npz"))
    args = ap.parse_args(argv)
    if os.environ.get("HEATX_EXAMPLE_FAST") == "1":  # smoke-test settings
        args.zones, args.hours = min(args.zones, 4), min(args.hours, 48)
    device = torch.device("cuda" if args.platform == "gpu" else "cpu")

    from heatx_torch import ThermalModel
    from heatx_torch.io.checkpoint import save_state

    t0 = time.time()
    tm = ThermalModel(build_district(args.zones), n=1, device=device)
    b = tm.building
    print(f"compiled {b.n_surfaces} surfaces / {b.n_zones} zones in {time.time()-t0:.1f}s")
    seq = inputs(tm, args.hours, args.epw)

    runner = tm.fast_runner(mode="trbdf2", substeps=8, hours=24)
    state = tm.initial_state()
    t0 = time.time()
    final, zone_hist = runner.run(state, seq, assert_finite=True, interp_weather=True)
    zone_hist = zone_hist.cpu().numpy()
    print(f"marched {args.hours} h x {b.n_surfaces} surfaces in {time.time()-t0:.1f}s "
          f"(incl. the kernel build; kernel engine on {device.type})")
    print(f"zone temperatures: mean {zone_hist.mean():.2f}C  min {zone_hist.min():.2f}C  "
          f"max {zone_hist.max():.2f}C")
    coldest = np.unravel_index(zone_hist.argmin(), zone_hist.shape)
    print(f"coldest hour: h={coldest[0]} zone={coldest[1]}")
    path = save_state(args.out, final)
    print(f"checkpoint saved to {path}")


if __name__ == "__main__":
    main()

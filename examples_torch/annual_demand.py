"""Annual heating/cooling demand of a city block, computed in the kernel.

heatx_torch's counterpart of examples/annual_demand.py.  Every zone of the
bench city (``testing.build_city_model(zones, 10, orientations=True)``: real
compass facades) gets a thermostatic ideal heater-cooler (20 C / 26 C).  The
TR-BDF2 day march computes the setpoint-landing power each sub-step and
accumulates the per-hour demand history (one CUDA day-kernel launch a
simulated day on the card, its plain version on the CPU), so a year of load
calculation costs about what the free-float simulation does.  The incident
solar is orientation-resolved from the EPW file where there is one
(``heatx_torch.weather.solar.surface_irradiance``), else seeded factors on
the synthetic weather.  The year runs twice, as heatx's does; the second run
is timed.

Deliberate differences from heatx: ``--block-size`` defaults to the fewest
lanes that hold the largest zone-connected component (the day kernel takes
at most 256 a block; heatx's default of 2048 lanes is a TPU tile);
the annual sums are reduced on the device as heatx's are.

Run:  python examples_torch/annual_demand.py [--platform gpu|cpu] [--zones 1000] [--hours 8760]
      (HEATX_EXAMPLE_FAST=1: 4 zones, 48 h)
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch


def build(zones, classes=None, city=None):
    """The bench city with compass orientations and a thermostat per zone
    (the electric heaters stay, at 0 W).  ``classes``/``city``: the model
    classes and the city builder (default heatx_torch's; heatx's
    ``heatx.model.building`` and bench.py's ``build_city_model`` build the
    same model)."""
    if classes is None:
        from heatx_torch.model import building as classes
    if city is None:
        from heatx_torch.testing import build_city_model as city
    model = city(zones, 10, orientations=True)
    for z in range(zones):
        model.add_hvac(classes.IdealHeaterCooler(f"tstat{z}", [f"z{z}"], heat_setpoint=20.0, cool_setpoint=26.0))
    return model


def inputs(tm, T, epw_path):
    """bench.py's synthetic weather with orientation-resolved solar from the
    EPW file where there is one (seeded factors on GHI otherwise)."""
    from heatx_torch.testing import synthetic_weather

    b = tm.building
    S = b.n_surfaces
    dry, wind, wdir, ghi, ir = synthetic_weather(T)
    if epw_path and os.path.isfile(epw_path):
        from heatx_torch.weather.epw import read_epw
        from heatx_torch.weather.solar import surface_irradiance

        sol = surface_irradiance(read_epw(epw_path), b, hours=T)
    else:
        rng = np.random.default_rng(0)
        sol = ghi[:, None] * rng.uniform(0.2, 1.0, S)[None, :]
    kw = dict(dtype=b.config.dtype, device=tm.device)
    # Channels without a time axis pass through as they are: FastRunner
    # broadcasts them per dispatch chunk.
    return tm.inputs(lum_power=np.full(b.n_luminaires, 150.0)).replace(
        t_out=torch.as_tensor(dry, **kw), wind_speed=torch.as_tensor(wind, **kw),
        wind_direction=torch.as_tensor(wdir, **kw), sol_front=torch.as_tensor(sol, **kw),
        ir_front=torch.as_tensor(ir, **kw),  # [T] per-hour scalar
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--platform", choices=("gpu", "cpu"), default="gpu")
    ap.add_argument("--zones", type=int, default=1000)
    ap.add_argument("--hours", type=int, default=8760)
    ap.add_argument("--block-size", type=int, default=None,
                    help="surface lanes per block (default: the fewest; at most 256)")
    args = ap.parse_args(argv)
    if os.environ.get("HEATX_EXAMPLE_FAST") == "1":  # smoke-test settings
        args.zones = min(args.zones, 4)
        args.hours = min(args.hours, 48)
    device = torch.device("cuda" if args.platform == "gpu" else "cpu")

    from heatx_torch import SimConfig, ThermalModel

    tm = ThermalModel(build(args.zones), n=1, config=SimConfig(dtype=torch.float32, nomass_fixed_iters=1),
                      device=device)
    b = tm.building
    S = b.n_surfaces
    print(f"# {S} surfaces, {b.n_zones} zones, thermostats in-kernel", file=sys.stderr)
    T = args.hours
    seq = inputs(tm, T, os.environ.get("HEATX_EPW", ""))

    fr = tm.fast_runner(block_size=args.block_size, mode="trbdf2", substeps=8, hours=24)
    st = tm.initial_state()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.time()
    final, zt, loads = fr.run(st, seq, dispatch_days=37, collect_loads=True)
    sync()
    print(f"# build+run: {time.time() - t0:.1f}s", file=sys.stderr)

    t0 = time.time()
    final, zt, loads = fr.run(st, seq, dispatch_days=37, collect_loads=True)
    # Device-side annual reduction; only [Z] summaries cross to the host.
    heat = (loads.clamp(min=0).sum(dim=0) / 1000.0).cpu().numpy()  # kWh
    cool = (-loads.clamp(max=0).sum(dim=0) / 1000.0).cpu().numpy()
    wall = time.time() - t0
    print(f"annual demand of {b.n_zones} zones ({S} surfaces) in {wall:.2f}s on one {device.type} "
          f"(kernel engine)")
    loads_np = loads.cpu().numpy()
    print(f"heating: mean {heat.mean():.0f} kWh/zone "
          f"(p5 {np.percentile(heat, 5):.0f}, p95 {np.percentile(heat, 95):.0f})")
    print(f"cooling: mean {cool.mean():.0f} kWh/zone "
          f"(p5 {np.percentile(cool, 5):.0f}, p95 {np.percentile(cool, 95):.0f})")
    zt_np = zt.cpu().numpy()
    inband = ((zt_np > 19.99) & (zt_np < 26.01)).mean()
    print(f"zone-hours inside the 20-26 C band: {inband * 100:.1f}%")
    assert np.isfinite(loads_np).all() and np.isfinite(zt_np).all()
    print("demand OK")


if __name__ == "__main__":
    main()

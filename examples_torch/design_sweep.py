"""Design-space sweep: simulate a whole grid of building variants at once.

heatx_torch's counterpart of examples/design_sweep.py.  A 7x7 grid of
(insulation conductance, solar absorptance) variants of a single-zone
building marches a winter week at once (``heatx_torch.ensemble``), and the
best passive design (closest to a 21 C comfort target on a fixed 300 W
heating budget) is read off the batch.  On the card the 49 members run as
blocks of one day-march launch a day; on the CPU they run the XLA-path
integrators, folded into one building.

Run:  python examples_torch/design_sweep.py [--platform gpu|cpu]
      (HEATX_EXAMPLE_FAST=1: a 3x3 grid)
"""

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch


def build():
    from heatx_torch.model.building import (
        Boundary, BuildingModel, Construction, ElectricHeater, Material, SpaceDef, Substance,
        SurfaceDef,
    )

    m = BuildingModel()
    m.add_substance(
        Substance("concrete", thermal_conductivity=0.816, density=1700.0,
                  specific_heat_capacity=800.0, front_solar_absorbtance=0.7,
                  back_solar_absorbtance=0.7)
    )
    m.add_substance(
        Substance("poly", thermal_conductivity=0.0252, density=17.5,
                  specific_heat_capacity=2400.0)
    )
    m.add_substance(
        Substance("glass", thermal_conductivity=1.0, density=2500.0,
                  specific_heat_capacity=840.0, solar_transmittance=0.8,
                  front_solar_absorbtance=0.1, back_solar_absorbtance=0.1)
    )
    m.add_material(Material("p5", "poly", 0.05))
    m.add_material(Material("c15", "concrete", 0.15))
    m.add_material(Material("g6", "glass", 0.006))
    m.add_construction(Construction("wall", ["p5", "c15"]))
    m.add_construction(Construction("window", ["g6"]))
    m.add_space(SpaceDef("room", 120.0))
    verts = np.array([[0, 0, 0], [5, 0, 0], [5, 0, 3], [0, 0, 3]], float)
    m.add_surface(SurfaceDef("south", "wall", Boundary.outdoor(),
                             Boundary.space_("room"), vertices=verts))
    m.add_fenestration(SurfaceDef("win", "window", Boundary.outdoor(),
                                  Boundary.space_("room"),
                                  vertices=0.4 * verts + np.array([1, 0, 1])))
    m.add_hvac(ElectricHeater("h", "room"))
    return m


def week_weather(hours=168):
    epw = os.environ.get("HEATX_EPW", "")  # the Santiago EPW file, where a user has it
    if os.path.isfile(epw):
        from heatx_torch.weather.epw import read_epw

        w = read_epw(epw)
        # A winter week (Santiago: July).
        s = 24 * 190
        sl = slice(s, s + hours)
        return w.dry_bulb[sl], w.wind_speed[sl], w.wind_direction_rad[sl], \
            w.global_horizontal[sl], w.horizontal_ir[sl]
    t = np.arange(hours)
    return (
        4.0 + 7.0 * np.sin(2 * np.pi * (t - 14) / 24.0),
        3.0 + np.zeros(hours),
        np.radians((t * 11.0) % 360.0),
        np.maximum(0.0, 500.0 * np.sin(2 * np.pi * (t - 6) / 24.0)),
        np.full(hours, 330.0),
    )


def main(argv=None):
    from heatx_torch import SimConfig, ThermalModel, ensemble

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--platform", choices=("gpu", "cpu"), default="gpu")
    args = ap.parse_args(argv)
    device = "cuda" if args.platform == "gpu" else "cpu"

    tm = ThermalModel(build(), config=SimConfig(dtype=torch.float32, nomass_fixed_iters=1),
                      device=device)
    building = tm.building
    dry, wind, wdir, ghi, ir = week_weather()
    T = len(dry)
    S = building.n_surfaces
    # 300 W of heating plus ~0.25 ACH infiltration of outdoor air.
    seq = tm.inputs_sequence(
        T, t_out=dry, wind_speed=wind, wind_direction=wdir,
        sol_front=np.asarray(ghi)[:, None] * np.ones(S), ir_front=np.asarray(ir)[:, None] * np.ones(S),
        hvac_power=np.full(building.n_hvacs, 300.0), inf_vol=np.full(building.n_zones, 0.008),
        inf_mask=np.ones(building.n_zones, bool), inf_temp=np.asarray(dry)[:, None],
    )
    st = tm.initial_state()

    # 7x7 grid: insulation conductance scale x wall solar absorptance scale.
    grid = 3 if os.environ.get("HEATX_EXAMPLE_FAST") == "1" else 7
    uu, aa = np.meshgrid(np.linspace(0.4, 2.0, grid), np.linspace(0.3, 1.3, grid), indexing="ij")
    params_e = {"u_scale": torch.as_tensor(uu.ravel(), dtype=torch.float32),
                "alpha_scale": torch.as_tensor(aa.ravel(), dtype=torch.float32)}
    E = params_e["u_scale"].shape[0]
    u0 = torch.as_tensor(building.surfaces.seg_u)
    a0 = torch.as_tensor(building.surfaces.front_alphas)

    def apply_fn(b, p):
        sb = dataclasses.replace(b.surfaces, seg_u=u0 * p["u_scale"],
                                 front_alphas=a0 * p["alpha_scale"])
        return dataclasses.replace(b, surfaces=sb)

    def sweep():
        out = ensemble.run_param_ensemble(building, apply_fn, params_e, st, seq, mode="trbdf2",
                                          substeps=4, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        return out

    t0 = time.time()
    sweep()  # the first call builds the kernels on the card
    print(f"first sweep {E} variants x {T} h: {time.time() - t0:.1f}s "
          f"({ensemble.last_engine} engine)")
    t0 = time.time()
    _, hist = sweep()  # [E, T, Z]
    wall = time.time() - t0
    zt = hist.cpu().numpy()[:, 24:, 0]  # skip 1-day warm-up
    print(f"steady-state sweep: {E} one-week simulations in {wall:.2f}s "
          f"({wall / E * 1e3:.1f} ms per variant)")

    # Comfort objective at the fixed 300 W heating budget: squared deviation
    # from 21 C; insulation and solar gain have to do the rest.
    score = ((zt - 21.0) ** 2).mean(axis=1)
    best = int(np.argmin(score))
    bu, ba = float(params_e["u_scale"][best]), float(params_e["alpha_scale"][best])
    print(f"zone-T ranges: coldest variant {zt.min():.1f}C, hottest {zt.max():.1f}C")
    print(f"best passive design: u_scale={bu:.2f} alpha_scale={ba:.2f} "
          f"(rms deviation {np.sqrt(score[best]):.2f} K; "
          f"worst design {np.sqrt(score.max()):.2f} K)")
    assert np.all(np.isfinite(zt))
    print("sweep OK")


if __name__ == "__main__":
    main()

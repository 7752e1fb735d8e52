"""Monte-Carlo uncertainty quantification of heating demand.

heatx_torch's counterpart of examples/uncertainty.py.  Insulation
conductivity, solar absorptance and infiltration all carry
construction-quality uncertainty; a 128-sample Monte-Carlo over them is one
batched march (``heatx_torch.ensemble.run_param_ensemble`` with a per-member
input axis for infiltration): demand percentiles and sensitivities in one
call.  On the card the members run as blocks of one day-march launch a day;
on the CPU they run the XLA-path integrators, folded into one building.

Run:  python examples_torch/uncertainty.py [--platform gpu|cpu]
      (HEATX_EXAMPLE_FAST=1: 16 members, 48 h)
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
        Boundary, BuildingModel, Construction, IdealHeaterCooler, Material,
        SpaceDef, Substance, SurfaceDef,
    )

    m = BuildingModel()
    m.add_substance(Substance("concrete", thermal_conductivity=0.816,
                              density=1700.0, specific_heat_capacity=800.0,
                              front_solar_absorbtance=0.7,
                              back_solar_absorbtance=0.7))
    m.add_substance(Substance("poly", thermal_conductivity=0.0252, density=17.5,
                              specific_heat_capacity=2400.0))
    m.add_material(Material("p5", "poly", 0.05))
    m.add_material(Material("c15", "concrete", 0.15))
    m.add_construction(Construction("wall", ["p5", "c15"]))
    m.add_space(SpaceDef("room", 120.0))
    verts = np.array([[0, 0, 0], [5, 0, 0], [5, 0, 3], [0, 0, 3]], float)
    m.add_surface(SurfaceDef("south", "wall", Boundary.outdoor(),
                             Boundary.space_("room"), vertices=verts))
    m.add_hvac(IdealHeaterCooler("tstat", ["room"], heat_setpoint=20.0,
                                 cool_setpoint=26.0))
    return m


def main(argv=None):
    from heatx_torch import SimConfig, ThermalModel, ensemble

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--platform", choices=("gpu", "cpu"), default="gpu")
    args = ap.parse_args(argv)
    device = "cuda" if args.platform == "gpu" else "cpu"

    fast = os.environ.get("HEATX_EXAMPLE_FAST") == "1"
    E = 16 if fast else 128
    T = 48 if fast else 168  # one winter week
    tm = ThermalModel(build(), config=SimConfig(dtype=torch.float32, nomass_fixed_iters=1),
                      device=device)
    b = tm.building
    st = tm.initial_state()

    # Winter-week weather (EPW if present, synthetic otherwise).
    epw_path = os.environ.get("HEATX_EPW", "")  # the Santiago EPW file, where a user has it
    if os.path.isfile(epw_path):
        from heatx_torch.weather.epw import read_epw
        from heatx_torch.weather.solar import surface_irradiance

        w = read_epw(epw_path)
        s = 24 * 190
        dry = w.dry_bulb[s: s + T]
        wind = w.wind_speed[s: s + T]
        sol = surface_irradiance(w, b)[s: s + T]
    else:
        t = np.arange(T)
        dry = 4.0 + 7.0 * np.sin(2 * np.pi * (t - 14) / 24.0)
        wind = np.full(T, 3.0)
        sol = np.maximum(0.0, 400.0 * np.sin(2 * np.pi * (t - 6) / 24.0))[:, None]

    seq = tm.inputs_sequence(
        T, t_out=dry, wind_speed=wind, sol_front=np.broadcast_to(sol, (T, b.n_surfaces)).copy(),
        inf_mask=np.ones(b.n_zones, bool), inf_temp=np.asarray(dry)[:, None],
    )

    # Parameter uncertainty: conductivity x1.0 +-15% (lognormal), absorptance
    # +-20% (uniform), infiltration 0.003-0.015 m3/s (lognormal around 0.007).
    rng = np.random.default_rng(42)
    u_scale = torch.as_tensor(np.exp(rng.normal(0.0, 0.15, E)), dtype=torch.float32)
    a_scale = torch.as_tensor(rng.uniform(0.8, 1.2, E), dtype=torch.float32)
    inf_vol = np.clip(0.007 * np.exp(rng.normal(0.0, 0.4, E)), 0.003, 0.015)
    # Infiltration is an exogenous input: give it a member axis [E, T, Z].
    seq_e = seq.replace(inf_vol=torch.as_tensor(inf_vol, dtype=torch.float32, device=device)[:, None, None]
                        .expand(E, T, b.n_zones))
    u0 = torch.as_tensor(b.surfaces.seg_u)
    a0 = torch.as_tensor(b.surfaces.front_alphas)

    def apply_fn(bld, p):
        sb = dataclasses.replace(bld.surfaces, seg_u=u0 * p["u"], front_alphas=a0 * p["a"])
        return dataclasses.replace(bld, surfaces=sb)

    params_e = {"u": u_scale, "a": a_scale}

    def sample():
        out = ensemble.run_param_ensemble(
            b, apply_fn, params_e, st, seq_e, mode="trbdf2", substeps=4, collect_loads=True,
            inputs_axes={"inf_vol": 0}, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        return out

    t0 = time.time()
    sample()  # the first call builds the kernels on the card
    print(f"first run {E} Monte-Carlo members x {T} h: {time.time() - t0:.1f}s "
          f"({ensemble.last_engine} engine)")
    t0 = time.time()
    _, (zt, loads) = sample()
    weekly = loads.clamp_min(0).sum(dim=(1, 2)).cpu().numpy() / 1000.0  # kWh
    print(f"sampled {E} buildings in {time.time() - t0:.2f}s")

    print(f"weekly heating demand: mean {weekly.mean():.1f} kWh, "
          f"p5 {np.percentile(weekly, 5):.1f}, "
          f"p50 {np.percentile(weekly, 50):.1f}, "
          f"p95 {np.percentile(weekly, 95):.1f}")
    for name, v in [("conductivity", u_scale.numpy()), ("absorptance", a_scale.numpy()),
                    ("infiltration", inf_vol)]:
        r = np.corrcoef(np.asarray(v), weekly)[0, 1]
        print(f"  demand sensitivity to {name}: r = {r:+.2f}")
    assert np.isfinite(weekly).all() and weekly.min() > 0
    print("UQ OK")


if __name__ == "__main__":
    main()

"""Ensemble throughput against the ensemble size on one card.

heatx_torch's counterpart of scripts/ensemble_sweep.py: a single-zone
thermostatic room marched through one winter week (168 h, TR-BDF2 at 4
sub-steps an hour, the ideal loads collected) for E parameter variants at
once, E = 16, 64, ... up to ``--max-e`` (x4 each).  On the card
(``--platform gpu``, the default) the members run as blocks of the day
march, one launch a day for the whole population (``--engine kernel``);
``--platform cpu`` runs the XLA-path integrators.

    python3 scripts/torch_ensemble_sweep.py [--max-e 4096] [--hours 168]

Prints the card's name and power limit, then one line per E: the wall
clock of a second call (the first builds the kernels and warms up), ended
by a synchronize, the launches of that call and the one-week members a
second.
"""

import argparse
import dataclasses
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch


def build_room():
    """The sweep's room: one 5 x 3 m polyurethane-on-concrete wall to
    outdoors, 120 m3 of air, an ideal heater at 20 C."""
    from heatx_torch.model.building import (
        Boundary, BuildingModel, Construction, IdealHeaterCooler, Material,
        SpaceDef, Substance, SurfaceDef,
    )

    m = BuildingModel()
    m.add_substance(Substance("concrete", thermal_conductivity=0.816,
                              density=1700.0, specific_heat_capacity=800.0))
    m.add_substance(Substance("poly", thermal_conductivity=0.0252, density=17.5,
                              specific_heat_capacity=2400.0))
    m.add_material(Material("p5", "poly", 0.05))
    m.add_material(Material("c15", "concrete", 0.15))
    m.add_construction(Construction("wall", ["p5", "c15"]))
    m.add_space(SpaceDef("room", 120.0))
    verts = np.array([[0, 0, 0], [5, 0, 0], [5, 0, 3], [0, 0, 3]], float)
    m.add_surface(SurfaceDef("s", "wall", Boundary.outdoor(),
                             Boundary.space_("room"), vertices=verts))
    m.add_hvac(IdealHeaterCooler("t", ["room"], heat_setpoint=20.0))
    return m


def sweep_case(hours: int, dtype=torch.float32, device="cuda"):
    """``(tm, inputs, apply_fn)`` of the sweep: the room, a winter week of
    synthetic weather and the ``seg_u`` scale of each member."""
    from heatx_torch import SimConfig, ThermalModel

    tm = ThermalModel(build_room(), config=SimConfig(dtype=dtype, nomass_fixed_iters=1),
                      device=device)
    b = tm.building
    t = np.arange(hours)
    seq = tm.inputs_sequence(
        hours, t_out=2.0 + 6.0 * np.sin(2 * np.pi * (t - 14) / 24.0), wind_speed=np.full(hours, 3.0),
        sol_front=np.maximum(0.0, 400.0 * np.sin(2 * np.pi * (t - 6) / 24.0))[:, None]
        * np.ones((1, b.n_surfaces)),
    )
    u0 = torch.as_tensor(b.surfaces.seg_u)

    def apply_fn(bld, u):
        return dataclasses.replace(bld, surfaces=dataclasses.replace(bld.surfaces, seg_u=u0 * u))

    return tm, seq, apply_fn


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def main(argv=None):
    from heatx_torch import ensemble
    from heatx_torch.ops import day_march

    ap = argparse.ArgumentParser()
    ap.add_argument("--max-e", type=int, default=4096)
    ap.add_argument("--hours", type=int, default=168)
    ap.add_argument("--platform", choices=("gpu", "cpu"), default="gpu")
    ap.add_argument("--engine", choices=ensemble.ENGINES, default="auto")
    args = ap.parse_args(argv)
    device = "cuda" if args.platform == "gpu" else "cpu"
    if device == "cuda":
        print("card:", card_line())
    tm, seq, apply_fn = sweep_case(args.hours, device=device)
    st = tm.initial_state()

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    rng = np.random.default_rng(0)
    E = 16
    while E <= args.max_e:
        pe = torch.as_tensor(np.exp(rng.normal(0.0, 0.15, E)), dtype=torch.float32)
        run = lambda: ensemble.run_param_ensemble(  # noqa: E731
            tm.building, apply_fn, pe, st, seq, mode="trbdf2", substeps=4, collect_loads=True,
            engine=args.engine, device=device)
        run()  # builds the kernels at first use, warms up
        sync()
        day_march.day_march_kernel.launches = 0
        t0 = time.time()
        _, (zt, loads) = run()
        total = float(loads.sum())  # forces completion
        sync()
        wall = time.time() - t0
        assert np.isfinite(total)
        print(f"E={E:5d}: {wall:6.3f}s  ({E / wall:8.0f} one-week members/s; "
              f"{ensemble.last_engine}, {day_march.day_march_kernel.launches} launches)")
        E *= 4


if __name__ == "__main__":
    main()

"""Calibrate a building to METERED ENERGY: gradients of a kWh objective.

heatx_torch's counterpart of examples/calibrate_demand.py.  The most common
real calibration target is a metered heating/cooling energy series (utility
bills, submeter logs).  The thermostatic zone update computes the per-hour
mean ideal-load power (in the day kernel: its thermostat rows), so a demand
objective is a loss on that history, differentiable through the
setpoint-landing power formula, the zone balance and the wall conduction.

This example "meters" two days of hourly heating energy from a 4-zone block
with known envelope conductance, perturbs it, and recovers it with Adam by
fitting the simulated ideal-load series to the metered one.  On the card
both sweeps run through the CUDA kernels:
``FastRunner.chunk_forward(collect_loads=True)`` marches the day kernel and
``FastRunner.chunk_grad(collect_loads=True)`` seeds the per-hour ideal-load
cotangent into the adjoint day kernel, over 4 chunks.  With ``--platform
cpu`` it runs heatx's CPU route: autograd through a loop of
``engine.implicit.imp_march`` (``chunk_fn``), float64.

Deliberate differences from heatx: the card runs heatx's kernel route in
float64 at heatx's float64 settings (80 iterations, the 5 % bound; heatx
takes the kernel route only on a TPU, in float32); ``--f32`` runs it in
float32.  The optimizer is ``torch.optim.Adam`` with optax's defaults
(betas 0.9/0.999, eps 1e-8 outside the square root).

Run:  python examples_torch/calibrate_demand.py [--platform gpu|cpu] [--f32]
      (HEATX_EXAMPLE_FAST=1: 12 h in 2 chunks, 8 iterations)
"""

import argparse
import dataclasses
import os
import sys
import time
from types import SimpleNamespace

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

SUBS = 6


def build(n_zones=4, classes=None):
    """heatx's 4-zone block with a thermostat (ideal loads, 21/27 C) a zone.
    ``classes``: the module of the model classes (default
    ``heatx_torch.model.building``; heatx's has the same names)."""
    if classes is None:
        from heatx_torch.model import building as classes
    m = classes.BuildingModel()
    m.add_substance(classes.Substance("concrete", thermal_conductivity=0.816, density=1700.0,
                                      specific_heat_capacity=800.0, front_solar_absorbtance=0.7,
                                      back_solar_absorbtance=0.6))
    m.add_substance(classes.Substance("poly", thermal_conductivity=0.0252, density=17.5,
                                      specific_heat_capacity=2400.0))
    m.add_material(classes.Material("c10", "concrete", 0.1))
    m.add_material(classes.Material("p5", "poly", 0.05))
    m.add_construction(classes.Construction("wall", ["p5", "c10"]))
    verts = np.array([[0, 0, 0], [6, 0, 0], [6, 0, 3], [0, 0, 3]], float)
    for z in range(n_zones):
        m.add_space(classes.SpaceDef(f"room{z}", 150.0))
        for s in range(3):
            m.add_surface(classes.SurfaceDef(f"w{z}_{s}", "wall", classes.Boundary.outdoor(),
                                             classes.Boundary.space_(f"room{z}"), vertices=verts))
        # Thermostatic ideal loads: the demand channel being metered.
        m.add_hvac(classes.IdealHeaterCooler(f"h{z}", [f"room{z}"], heat_setpoint=21.0, cool_setpoint=27.0,
                                             max_heating=1e5, max_cooling=1e5))
    return m


def horizon(fast):
    """Horizon hours and adjoint chunks."""
    return (12, 2) if fast else (48, 4)


def weather(T):
    """Two cold days: the thermostats heat most hours, so the metered series
    carries conductance signal every hour."""
    hours = np.arange(T)
    t_out = -2.0 + 6.0 * np.sin((hours - 8) / 24 * 2 * np.pi)
    sol = np.maximum(0.0, 400.0 * np.sin((hours % 24 - 6) / 12 * np.pi))
    return t_out, sol


def chunked(tree, T, C):
    """Every leaf of an input tree as [C, T // C, ...] chunks."""
    from heatx_torch.engine.adjoint import tree_map

    return tree_map(lambda v: (v.reshape((C, T // C) + tuple(v.shape[1:])) if v.ndim and v.shape[0] == T
                               else torch.broadcast_to(v, (C, T // C) + tuple(v.shape))), tree)


def numpy_building(building):
    """``building`` with its surface rows as numpy arrays (the front end's
    form, which ``FastRunner.update_building`` blocks)."""
    sb = building.surfaces
    rows = {f.name: getattr(sb, f.name).detach().cpu().numpy() for f in dataclasses.fields(sb)
            if isinstance(getattr(sb, f.name), torch.Tensor)}
    return dataclasses.replace(building, surfaces=dataclasses.replace(sb, **rows))


def problem(fast, device, dtype=torch.float64, route="kernel", use_kernel=True):
    """The calibration problem on ``route="kernel"`` (the day march's
    chunk_forward/chunk_grad with ``collect_loads``: the CUDA kernels on the
    card, their plain versions on the CPU or with ``use_kernel=False``) or
    ``"xla"`` (autograd through ``imp_march``, heatx's CPU route).  Returns
    its ``value_and_grad(params)`` and the starting guess."""
    from heatx_torch import SimConfig, ThermalModel
    from heatx_torch.engine import implicit as imp_mod
    from heatx_torch.engine import step as step_mod
    from heatx_torch.engine.adjoint import chunked_value_and_grad, tree_map

    cfg = SimConfig(dtype=dtype, nomass_fixed_iters=1)
    tm = ThermalModel(build(), n=1, config=cfg, device=device)
    building = tm.building
    st = tm.initial_state()
    T, C = horizon(fast)
    t_out, sol = weather(T)
    Z, S = building.n_zones, building.n_surfaces
    seq = tm.inputs_sequence(T, t_out=t_out, wind_speed=3.0, wind_direction=45.0, inf_vol=np.full((Z,), 0.02),
                             inf_temp=t_out, inf_mask=np.ones((Z,)))
    sol_t = torch.as_tensor(sol, dtype=dtype, device=device)[:, None].expand(T, S)
    seq = seq.replace(sol_front=sol_t, sol_back=0.3 * sol_t)
    xs_chunks = chunked(seq, T, C)

    sb0 = building.surfaces
    u0 = torch.as_tensor(sb0.seg_u, device=device)

    def with_params(params):
        sb = dataclasses.replace(sb0, seg_u=u0 * params["u_scale"])
        return dataclasses.replace(building, surfaces=sb)

    def hist_fn(params, state, xs):
        b = step_mod.device_building(with_params(params), device=device)
        zt, ld = [], []
        for h in range(xs.t_out.shape[0]):
            state = imp_mod.imp_march(b, state, tree_map(lambda v: v[h], xs), substeps=SUBS)
            zt.append(state.zone_T)
            ld.append(state.ideal_load)
        return state, (torch.stack(zt), torch.stack(ld))

    true_params = {"u_scale": torch.tensor(1.0, dtype=dtype, device=device)}
    guess = {"u_scale": torch.tensor(1.6, dtype=dtype, device=device)}
    fr = None
    if route == "kernel":
        # Meter with the same day march the optimization marches (float32
        # kernel and XLA trajectories differ at round-off; see calibrate.py).
        fr = tm.fast_runner(block_size=16, mode="trbdf2", substeps=SUBS, hours=min(T // C, 24),
                            use_kernel=use_kernel)
        fr.update_building(numpy_building(with_params({"u_scale": 1.0})))
        _, _, ld = fr.run(st, seq, collect_loads=True)
        metered = ld.reshape(C, T // C, -1)
    else:
        with torch.no_grad():
            s, chunks = st, []
            for i in range(C):
                s, (_, ld) = hist_fn(true_params, s, tree_map(lambda x: x[i], xs_chunks))
                chunks.append(ld)
        metered = torch.cat(chunks).reshape(C, T // C, -1)

    def score(ld, target):
        # kW-scaled squared error on the hourly mean power series (the
        # per-hour metered kWh, up to the constant 1 h factor).
        d = (ld - target) / 1000.0
        return (d * d).mean() / C

    def chunk_fn(params, state, xs):
        xs, target = xs
        state, (_, ld) = hist_fn(params, state, xs)
        return state, score(ld, target)

    forward_fn = backward_fn = None
    if route == "kernel":
        cell = {}

        def loss_fn(zt, ld, xs):
            return score(ld, cell["t"])

        kf = fr.chunk_forward(with_params, loss_fn, collect_loads=True)
        kb = fr.chunk_grad(with_params, loss_fn, collect_loads=True)

        def forward_fn(params, state, xs):
            inner, target = xs
            cell["t"] = target
            return kf(params, state, inner)

        def backward_fn(params, state, xs, state_cot, loss_cot):
            inner, target = xs
            cell["t"] = target
            return kb(params, state, inner, state_cot, loss_cot)

    def value_and_grad(params):
        return chunked_value_and_grad(chunk_fn, params, st, (xs_chunks, metered), forward_fn=forward_fn,
                                      backward_fn=backward_fn)

    return SimpleNamespace(value_and_grad=value_and_grad, guess=guess)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--platform", choices=("gpu", "cpu"), default="gpu")
    ap.add_argument("--f32", action="store_true", help="float32 (heatx's accelerator type)")
    args = ap.parse_args(argv)
    device = torch.device("cuda" if args.platform == "gpu" else "cpu")
    fast = os.environ.get("HEATX_EXAMPLE_FAST") == "1"
    dtype = torch.float32 if args.f32 else torch.float64
    route = "kernel" if device.type == "cuda" else "xla"

    t0 = time.time()
    pb = problem(fast, device, dtype, route)
    iters = 8 if fast else 80
    u = pb.guess["u_scale"].clone().requires_grad_()
    opt = torch.optim.Adam([u], lr=5e-2)
    for i in range(iters):
        val, g = pb.value_and_grad({"u_scale": u.detach()})
        u.grad = g["u_scale"]
        opt.step()
        if i % 10 == 0 or i == iters - 1:
            print(f"iter {i:3d}  loss {float(val):.3e}  u_scale {u.item():.4f}")

    err = abs(u.item() - 1.0)
    print(f"u_scale: recovered to {err * 100:.2f}% of truth from metered kWh")
    if not fast:
        assert err < 0.05, u.item()
    assert np.isfinite(float(val))
    print(f"{iters} iterations in {time.time() - t0:.2f}s ({route} engine, {str(dtype)[6:]})")
    print("demand calibration OK")
    return 0


if __name__ == "__main__":
    main()

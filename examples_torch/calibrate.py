"""Gradient-based model calibration: recover wall properties from data.

heatx_torch's counterpart of examples/calibrate.py.  The simulator is a
differentiable function of the compiled building, so unknown physical
parameters can be fitted to measured zone temperatures by reverse-mode
differentiation straight through the marching engine.

This example "measures" two days of zone temperatures from a 4-zone block
whose insulation conductance and wall solar absorptance are known, perturbs
both, and recovers them with Adam.

On the card the optimization runs through the chunked kernel adjoint
(``heatx_torch.engine.adjoint.chunked_value_and_grad``): the forward sweep
marches the CUDA day kernel (``FastRunner.chunk_forward``) and the backward
sweep the CUDA adjoint day kernel (``FastRunner.chunk_grad``), heatx's
kernel route.  With ``--platform cpu`` it runs heatx's CPU route: autograd
through a loop of ``engine.implicit.imp_march`` (``chunk_fn``), float64.

Deliberate differences from heatx: the card runs heatx's kernel route in
float64 at heatx's float64 settings (120 iterations at lr 5e-2, the 5 %
bound; heatx takes the kernel route only on a TPU, in float32); ``--f32``
selects heatx's accelerator settings (float32, 300 iterations, lr
``5e-2 * 0.1**(k / iters)``, the 8 % bound).  The optimizer is
``torch.optim.Adam`` with optax's defaults (betas 0.9/0.999, eps 1e-8
outside the square root); optax's ``exponential_decay`` is the un-staircased
``LambdaLR`` above.

Run:  python examples_torch/calibrate.py [--platform gpu|cpu] [--f32]
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
    """heatx's 4-zone block: three walls of polyurethane on concrete a zone,
    an electric heater each.  ``classes``: the module of the model classes
    (default ``heatx_torch.model.building``; heatx's has the same names)."""
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
        m.add_hvac(classes.ElectricHeater(f"h{z}", f"room{z}"))
    return m


def horizon(fast):
    """Horizon hours and adjoint chunks."""
    return (12, 2) if fast else (48, 4)


def weather(T):
    """Two synthetic days: cold mornings, sunny noons."""
    hours = np.arange(T)
    t_out = 5.0 + 8.0 * np.sin((hours - 8) / 24 * 2 * np.pi)
    sol = np.maximum(0.0, 600.0 * np.sin((hours % 24 - 6) / 12 * np.pi))
    return t_out, sol


def chunked(tree, T, C):
    """Every leaf of an input tree as [C, T // C, ...] chunks."""
    from heatx_torch.engine.adjoint import tree_map

    return tree_map(lambda v: (v.reshape((C, T // C) + tuple(v.shape[1:])) if v.ndim and v.shape[0] == T
                               else torch.broadcast_to(v, (C, T // C) + tuple(v.shape))), tree)


def problem(fast, device, dtype=torch.float64, route="kernel", use_kernel=True):
    """The calibration problem: ``route="kernel"`` (the day march's
    chunk_forward/chunk_grad: the CUDA kernels on the card, their plain
    versions on the CPU or with ``use_kernel=False``) or ``"xla"`` (autograd
    through ``imp_march``, heatx's CPU route).  Returns its
    ``value_and_grad(params)`` and the starting guess."""
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
    S = building.n_surfaces
    seq = tm.inputs_sequence(T, t_out=t_out, wind_speed=3.0, wind_direction=45.0,
                             hvac_power=np.full((building.n_hvacs,), 800.0))
    # Direct solar on the facades plus transmitted solar striking interior
    # faces (as through windows): interior absorption is what makes the
    # absorptance parameter strongly identified from zone T.
    sol_t = torch.as_tensor(sol, dtype=dtype, device=device)[:, None].expand(T, S)
    seq = seq.replace(sol_front=sol_t, sol_back=0.3 * sol_t)
    xs_chunks = chunked(seq, T, C)

    sb0 = building.surfaces
    u0 = torch.as_tensor(sb0.seg_u, device=device)
    a0 = torch.as_tensor(sb0.back_alphas, device=device)

    def with_params(params):
        sb = dataclasses.replace(sb0, seg_u=u0 * params["u_scale"], back_alphas=a0 * params["alpha_scale"])
        return dataclasses.replace(building, surfaces=sb)

    def hist_fn(params, state, xs):
        b = step_mod.device_building(with_params(params), device=device)
        hist = []
        for h in range(xs.t_out.shape[0]):
            state = imp_mod.imp_march(b, state, tree_map(lambda v: v[h], xs), substeps=SUBS)
            hist.append(state.zone_T)
        return state, torch.stack(hist)

    def scalar(v):
        return torch.tensor(v, dtype=dtype, device=device)

    true_params = {"u_scale": scalar(1.0), "alpha_scale": scalar(1.0)}
    guess = {"u_scale": scalar(1.5), "alpha_scale": scalar(0.6)}
    fr = None
    if route == "kernel":
        # Measure with the same day march the optimization marches: in
        # float32 the kernel and XLA trajectories differ at round-off, and
        # fitting one against the other's data floors the loss at that
        # mismatch instead of zero.
        fr = tm.fast_runner(block_size=16, mode="trbdf2", substeps=SUBS, hours=min(T // C, 24),
                            use_kernel=use_kernel)
        fr.update_building(numpy_building(with_params({k: float(v) for k, v in true_params.items()})))
        _, zt = fr.run(st, seq)
        measured = zt.reshape(C, T // C, -1)
    else:
        with torch.no_grad():
            s, chunks = st, []
            for i in range(C):
                s, h = hist_fn(true_params, s, tree_map(lambda x: x[i], xs_chunks))
                chunks.append(h)
        measured = torch.cat(chunks).reshape(C, T // C, -1)

    def chunk_fn(params, state, xs):
        """Advance one chunk + its additive squared-error contribution.  The
        `measured` slice rides inside xs (threaded per chunk)."""
        xs, target = xs
        state, hist = hist_fn(params, state, xs)
        d = hist - target
        return state, (d * d).mean() / C

    forward_fn = backward_fn = None
    if route == "kernel":
        # chunk_forward takes plain StepInputs; the per-chunk `measured`
        # target rides to its loss_fn through a closure cell.
        cell = {}

        def loss_fn(zt, xs):
            d = zt - cell["t"]
            return (d * d).mean() / C

        kf = fr.chunk_forward(with_params, loss_fn)
        kb = fr.chunk_grad(with_params, loss_fn)

        def forward_fn(params, state, xs):
            inner, target = xs
            cell["t"] = target
            return kf(params, state, inner)

        def backward_fn(params, state, xs, state_cot, loss_cot):
            inner, target = xs
            cell["t"] = target
            return kb(params, state, inner, state_cot, loss_cot)

    def value_and_grad(params):
        return chunked_value_and_grad(chunk_fn, params, st, (xs_chunks, measured), forward_fn=forward_fn,
                                      backward_fn=backward_fn)

    return SimpleNamespace(value_and_grad=value_and_grad, guess=guess)


def numpy_building(building):
    """``building`` with its surface rows as numpy arrays (the front end's
    form, which ``FastRunner.update_building`` blocks)."""
    sb = building.surfaces
    rows = {f.name: getattr(sb, f.name).detach().cpu().numpy() for f in dataclasses.fields(sb)
            if isinstance(getattr(sb, f.name), torch.Tensor)}
    return dataclasses.replace(building, surfaces=dataclasses.replace(sb, **rows))


def settings(fast, f32):
    """Iterations, the learning rate's schedule factor and the recovery
    bound: heatx's float64 settings, or with ``f32`` its accelerator's."""
    iters = 8 if fast else (300 if f32 else 120)
    decay = (lambda k: 0.1 ** (k / iters)) if f32 else (lambda k: 1.0)
    return iters, decay, (0.08 if f32 else 0.05)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--platform", choices=("gpu", "cpu"), default="gpu")
    ap.add_argument("--f32", action="store_true", help="float32 with heatx's accelerator settings")
    args = ap.parse_args(argv)
    device = torch.device("cuda" if args.platform == "gpu" else "cpu")
    fast = os.environ.get("HEATX_EXAMPLE_FAST") == "1"
    dtype = torch.float32 if args.f32 else torch.float64
    route = "kernel" if device.type == "cuda" else "xla"

    t0 = time.time()
    pb = problem(fast, device, dtype, route)
    iters, decay, bound = settings(fast, args.f32)
    leaves = {k: v.clone().requires_grad_() for k, v in pb.guess.items()}
    opt = torch.optim.Adam(list(leaves.values()), lr=5e-2)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, decay)
    for i in range(iters):
        val, g = pb.value_and_grad({k: v.detach() for k, v in leaves.items()})
        for k, v in leaves.items():
            v.grad = g[k]
        opt.step()
        sched.step()
        if i % 20 == 0 or i == iters - 1:
            print(f"iter {i:3d}  loss {float(val):.3e}  u_scale {leaves['u_scale'].item():.4f}  "
                  f"alpha_scale {leaves['alpha_scale'].item():.4f}")

    for k in ("u_scale", "alpha_scale"):
        err = abs(leaves[k].item() - 1.0)
        print(f"{k}: recovered to {err * 100:.2f}% of truth")
        if not fast:
            # f32: the u/alpha valley's along-floor gradient signal sits near
            # the float32 noise floor, so Adam walks it slowly.
            assert err < bound, (k, leaves[k].item())
    assert np.isfinite(float(val))
    print(f"{iters} iterations in {time.time() - t0:.2f}s ({route} engine, {str(dtype)[6:]})")
    print("calibration OK")


if __name__ == "__main__":
    main()

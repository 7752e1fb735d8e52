"""Shared set-up of the tests that hold examples_torch/ against heatx: the
example modules, loaded from their files, heatx's models built from the
same numbers, and the relative gap."""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch_reference import unoptimized

import heatx
from heatx.engine import implicit as hx_imp
from heatx.engine.adjoint import chunked_value_and_grad as hx_chunked
from heatx.model import building as hx_classes

ROOT = os.path.join(os.path.dirname(__file__), "..")
RTOL = 1e-9
CPU = torch.device("cpu")


def example(name):
    """examples_torch/<name>.py as a module."""
    spec = importlib.util.spec_from_file_location(f"example_torch_{name}",
                                                  os.path.join(ROOT, "examples_torch", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rel(got, ref):
    """max |got - ref| / max |ref|."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-300))


def hx_model(build, *args, config=None, **kw):
    """heatx's ThermalModel of an example's builder (``classes=`` heatx's),
    f64 with one no-mass iteration unless ``config`` is given."""
    cfg = heatx.SimConfig(dtype=jnp.float64, nomass_fixed_iters=1) if config is None else config
    return heatx.ThermalModel(build(*args, classes=hx_classes, **kw), n=1, config=cfg)


def hx_calibration(mod, demand):
    """heatx's CPU route of the calibration example: the first value and
    gradient of ``chunked_value_and_grad`` with its ``chunk_fn``."""
    T, C = mod.horizon(True)
    htm = hx_model(mod.build)
    hb, hst = htm._device(), htm.initial_state()
    t_out, sol = mod.weather(T)
    Z, S = hb.n_zones, hb.n_surfaces
    if demand:
        seq = htm.inputs_sequence(T, t_out=jnp.asarray(t_out), wind_speed=3.0, wind_direction=45.0,
                                  inf_vol=jnp.full((Z,), 0.02), inf_temp=jnp.asarray(t_out), inf_mask=jnp.ones((Z,)))
    else:
        seq = htm.inputs_sequence(T, t_out=jnp.asarray(t_out), wind_speed=3.0, wind_direction=45.0,
                                  hvac_power=jnp.full((hb.n_hvacs,), 800.0))
    sol_b = jnp.broadcast_to(jnp.asarray(sol)[:, None], (T, S))
    seq = seq._replace(sol_front=sol_b, sol_back=0.3 * sol_b)
    xs_chunks = jax.tree.map(lambda v: v.reshape((C, T // C) + v.shape[1:]) if v.ndim and v.shape[0] == T
                             else jnp.broadcast_to(v, (C, T // C) + v.shape), seq)
    sb0 = hb.surfaces

    def with_params(p):
        upd = dict(seg_u=sb0.seg_u * p["u_scale"])
        if not demand:
            upd["back_alphas"] = sb0.back_alphas * p["alpha_scale"]
        return dataclasses.replace(hb, surfaces=dataclasses.replace(sb0, **upd))

    def chunk_hist(p, s, xs):
        """One chunk's march, its history and its additive loss."""
        xs, tgt = xs
        b = with_params(p)

        def hour(s, x):
            s = hx_imp.imp_march(b, s, x, substeps=mod.SUBS)
            return s, (s.ideal_load if demand else s.zone_T)

        s, h = jax.lax.scan(hour, s, xs)
        d = (h - tgt) / (1000.0 if demand else 1.0)
        return s, h, jnp.mean(d * d) / C

    def chunk_fn(p, s, xs):
        s, _, loss = chunk_hist(p, s, xs)
        return s, loss

    # heatx's sweeps, compiled without XLA's backend optimizations
    # (torch_reference.unoptimized): the forward is chunk_fn, the backward
    # jax.vjp of it, as chunked_value_and_grad's defaults.  The measured
    # target comes from the forward's own compile.
    run = unoptimized(chunk_hist)
    keys = ("u_scale",) if demand else ("u_scale", "alpha_scale")
    zero = jnp.zeros((T // C, Z))
    s, chunks = hst, []
    for i in range(C):
        s, h, _ = run({k: jnp.asarray(1.0) for k in keys}, s, (jax.tree.map(lambda x: x[i], xs_chunks), zero))
        chunks.append(h)
    target = jnp.concatenate(chunks).reshape(C, T // C, -1)

    def forward(p, s, xs):
        s, _, loss = run(p, s, xs)
        return s, loss

    def bwd(p, s, xs, s_cot, l_cot):
        _, vjp = jax.vjp(lambda p_, s_: chunk_fn(p_, s_, xs), p, s)
        return vjp((s_cot, l_cot))

    guess = {"u_scale": jnp.asarray(1.6 if demand else 1.5)}
    if not demand:
        guess["alpha_scale"] = jnp.asarray(0.6)
    return hx_chunked(chunk_fn, guess, hst, (xs_chunks, target), forward_fn=forward, backward_fn=unoptimized(bwd))


def check_calibration(name):
    """The calibration example ``name``'s first value and gradient on both
    of its routes against :func:`hx_calibration`, within RTOL."""
    mod = example(name)
    hval, hg = hx_calibration(mod, demand=name == "calibrate_demand")
    for route in ("xla", "kernel"):
        pb = mod.problem(True, CPU, route=route)
        val, g = pb.value_and_grad(pb.guess)
        assert rel(float(val), float(hval)) <= RTOL, route
        assert set(g) == set(hg)
        for k in g:
            assert rel(float(g[k]), float(hg[k])) <= RTOL, (route, k)

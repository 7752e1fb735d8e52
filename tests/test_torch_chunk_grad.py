"""The port's calibration gradient against heatx's, f64, CPU.

bench.py's ``run_grad_bench`` workload (bench.py:252-261: a conductance
scale and a solar-absorptance scale, ``mean((zt - 21)^2) / C``) on a small
city, on the grad row's inputs (bench weather, 500 W HVAC, luminaires
off), 2 chunks of one 2-hour dispatch each, trbdf2_refresh k=1 at 2
sub-steps (two refresh groups per hour; two sub-steps keep heatx's
interpret-mode compiles short): the port's ``chunked_value_and_grad`` through
``FastRunner.chunk_forward``/``chunk_grad`` (plain day march and plain day
adjoint on the CPU) against heatx's same call with interpret-mode kernels.
Loss and both gradients agree within rtol 1e-8 (round-off: ~1e-14
measured).  Also: the guards of chunk_grad, the scope check on every call,
the autograd path of ``chunked_value_and_grad``, and a gradcheck of
``DayMarchFn``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import heatx
from heatx.engine.adjoint import chunked_value_and_grad as hx_chunked_value_and_grad
from heatx_torch import SimConfig, ThermalModel, testing
from heatx_torch.engine.adjoint import chunked_value_and_grad, tree_map
from heatx_torch.ops import day_adjoint, day_march

torch.set_num_threads(1)

RTOL = 1e-8
ZONES, SURFACES = 2, 3
HOURS, SUB, CHUNKS = 2, 2, 2
T_STEPS = HOURS * CHUNKS
KW = dict(mode="trbdf2_refresh", substeps=SUB, hours=HOURS, refresh_every=1)
START = 8  # the inputs start at 08:00, so the sun is up


def _weather():
    dry, wind, wdir, ghi, ir = (w[START:START + T_STEPS] for w in testing.synthetic_weather(START + T_STEPS))
    return dict(t_out=dry, wind_speed=wind, wind_direction=wdir, ghi=ghi, ir_front=ir)


def _chunk(v, xp):
    if v.ndim and v.shape[0] == T_STEPS:
        return v.reshape((CHUNKS, T_STEPS // CHUNKS) + tuple(v.shape[1:]))
    return xp.broadcast_to(v, (CHUNKS,) + tuple(v.shape))


@pytest.fixture(scope="module")
def heatx_result():
    tm = heatx.ThermalModel(
        bench.build_city_model(ZONES, SURFACES), n=1, config=heatx.SimConfig(dtype=jnp.float64)
    )
    b = tm.building
    w = _weather()
    seq = tm.inputs_sequence(
        T_STEPS, t_out=w["t_out"], wind_speed=w["wind_speed"],
        wind_direction=w["wind_direction"],
        sol_front=w["ghi"][:, None] * testing.solar_factors(b.n_surfaces)[None, :],
        ir_front=w["ir_front"], hvac_power=np.full(b.n_hvacs, 500.0),
    )
    xs = jax.tree.map(lambda v: _chunk(jnp.asarray(v), jnp), seq)
    building = tm._device()
    sb0 = building.surfaces

    def with_params(p):
        sb = dataclasses.replace(
            sb0, seg_u=sb0.seg_u * p["u_scale"], front_alphas=sb0.front_alphas * p["alpha_scale"]
        )
        return dataclasses.replace(building, surfaces=sb)

    def loss_fn(zt, xs):
        return jnp.mean((zt - 21.0) ** 2) / CHUNKS

    fr = tm.fast_runner(block_size=16, interpret=True, **KW)
    params = {"u_scale": jnp.asarray(1.2), "alpha_scale": jnp.asarray(0.8)}
    val, g = hx_chunked_value_and_grad(
        None, params, tm.initial_state(), xs,
        forward_fn=fr.chunk_forward(with_params, loss_fn),
        backward_fn=fr.chunk_grad(with_params, loss_fn),
    )
    return float(val), float(g["u_scale"]), float(g["alpha_scale"])


def _port(device="cpu", use_kernel=True):
    """The port's bench grad workload: (runner, with_params, loss_fn, params, state, xs)."""
    tm = ThermalModel(
        testing.build_city_model(ZONES, SURFACES), n=1, config=SimConfig(dtype=torch.float64),
        device=device,
    )
    b = tm.building
    w = _weather()
    seq = tm.inputs(
        t_out=w["t_out"], wind_speed=w["wind_speed"], wind_direction=w["wind_direction"],
        sol_front=w["ghi"][:, None] * testing.solar_factors(b.n_surfaces)[None, :],
        ir_front=w["ir_front"], hvac_power=np.full(b.n_hvacs, 500.0),
    )
    xs = tree_map(lambda v: _chunk(v, torch), seq)
    sb0 = b.surfaces
    seg_u0 = torch.as_tensor(sb0.seg_u, device=device)
    alphas0 = torch.as_tensor(sb0.front_alphas, device=device)

    def with_params(p):
        sb = dataclasses.replace(sb0, seg_u=seg_u0 * p["u_scale"], front_alphas=alphas0 * p["alpha_scale"])
        return dataclasses.replace(b, surfaces=sb)

    def loss_fn(zt, xs):
        return torch.mean((zt - 21.0) ** 2) / CHUNKS

    runner = tm.fast_runner(block_size=16, use_kernel=use_kernel, **KW)
    kw = dict(dtype=torch.float64, device=device)
    params = {"u_scale": torch.tensor(1.2, **kw), "alpha_scale": torch.tensor(0.8, **kw)}
    return runner, with_params, loss_fn, params, tm.initial_state(), xs


def _value_and_grad(runner, with_params, loss_fn, params, state, xs):
    val, g = chunked_value_and_grad(
        None, params, state, xs,
        forward_fn=runner.chunk_forward(with_params, loss_fn),
        backward_fn=runner.chunk_grad(with_params, loss_fn),
    )
    return float(val), float(g["u_scale"]), float(g["alpha_scale"])


def test_chunk_grad_matches_heatx(heatx_result):
    got = _value_and_grad(*_port())
    np.testing.assert_allclose(got, heatx_result, rtol=RTOL)
    assert all(abs(x) > 0 for x in got)  # the sun is up: d/dalpha is not trivially 0


def test_chunk_grad_autograd_backward_agrees():
    """chunked_value_and_grad without backward_fn (torch.autograd over a
    chunk_fn built on DayMarchFn) gives the chunk_grad gradient."""
    runner, with_params, loss_fn, params, state, xs = _port()
    ref = _value_and_grad(runner, with_params, loss_fn, params, state, xs)
    adj = day_adjoint.make_day_adjoint(runner._bb, device="cpu", **KW)

    def chunk_fn(p, st, xs):
        P = runner._blocked_params(with_params(p))
        T, zT = runner._blocked_state(st.node_T, st.zone_T)
        prep = runner._prepare(xs, False)
        hist = []
        for hi in runner._day_inputs(prep, 0, prep.D):
            T, zT, zt = day_adjoint.DayMarchFn.apply(
                runner.hour_march, adj.raw, runner.params, P.node, P.surf, P.zone_volume, T, zT, *hi
            )[:3]
            hist.append(zt)
        zt = torch.cat(hist).reshape(prep.T_steps, -1)[:, runner._zinv]
        new = dataclasses.replace(st, node_T=T[:, runner._inv], zone_T=zT.reshape(-1)[runner._zinv])
        return new, loss_fn(zt, xs)

    val, g = chunked_value_and_grad(chunk_fn, params, state, xs)
    np.testing.assert_allclose((float(val), float(g["u_scale"]), float(g["alpha_scale"])), ref, rtol=1e-12)


def test_chunked_value_and_grad_matches_monolithic_autograd():
    """The chunked sweep equals torch.autograd over the whole horizon."""
    rng = np.random.default_rng(0)
    A = torch.as_tensor(rng.normal(size=(3, 3)) * 0.3)
    xs = {"u": torch.as_tensor(rng.normal(size=(4, 5, 3)))}

    def chunk_fn(p, s, xs):
        loss = 0.0
        for u in xs["u"]:
            s = {"x": torch.tanh(A @ s["x"] * p["a"] + u * p["b"])}
            loss = loss + (s["x"] ** 2).sum()
        return s, loss

    params = {"a": torch.tensor(0.7, dtype=torch.float64), "b": torch.tensor(1.3, dtype=torch.float64)}
    s0 = {"x": torch.ones(3, dtype=torch.float64)}
    val, g = chunked_value_and_grad(chunk_fn, params, s0, xs)
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    s, total = s0, 0.0
    for i in range(4):
        s, loss = chunk_fn(leaves, s, {"u": xs["u"][i]})
        total = total + loss
    ref = torch.autograd.grad(total, list(leaves.values()))
    torch.testing.assert_close(val, total.detach(), rtol=1e-14, atol=0)
    for k, r in zip(leaves, ref):
        torch.testing.assert_close(g[k], r, rtol=1e-12, atol=0)


@pytest.mark.parametrize(
    "make, exc",
    [
        (lambda r, f, l: r.chunk_grad(f, l, ground_hourly=np.zeros(4)), ValueError),
        (lambda r, f, l: (r.chunk_forward(f, l, interp_weather=True), r.chunk_grad(f, l)), ValueError),
        (lambda r, f, l: (r.chunk_forward(f, l, ground_hourly=np.zeros(4)), r.chunk_grad(f, l)), ValueError),
        # Demand objectives and schedules need thermostats (heatx's ValueErrors).
        (lambda r, f, l: r.chunk_grad(f, l, collect_loads=True), ValueError),
        (lambda r, f, l: r.chunk_forward(f, l, schedule_fn=lambda p, xs: {}), ValueError),
    ],
    ids=["trajectory_option", "contract_interp_weather", "contract_forward_option",
         "collect_loads", "schedule_fn"],
)
def test_chunk_grad_guards_raise(make, exc):
    runner, with_params, loss_fn, *_ = _port()
    with pytest.raises(exc, match="chunk_grad|chunk_forward|ROADMAP"):
        make(runner, with_params, loss_fn)


def test_scope_check_runs_on_every_call():
    """A map that feeds a non-differentiated field only at some parameter
    values is caught when it does, not only at the first values (heatx
    caches its probe, ROADMAP C api.py:825)."""
    runner, with_params, loss_fn, params, state, xs = _port()
    normal0 = torch.as_tensor(runner._tm.building.surfaces.normal)

    def apply_params(p):
        b = with_params(p)
        if float(p["u_scale"].detach()) > 1.5:  # only out here does it touch the normals
            b = dataclasses.replace(b, surfaces=dataclasses.replace(b.surfaces, normal=normal0 * p["u_scale"] / p["u_scale"].detach()))
        return b

    bwd = runner.chunk_grad(apply_params, loss_fn)
    x0 = tree_map(lambda v: v[0], xs)
    cot = tree_map(torch.zeros_like, state)
    one = torch.tensor(1.0, dtype=torch.float64)
    bwd(params, state, x0, cot, one)
    with pytest.raises(ValueError, match="does not differentiate.*surfaces.normal"):
        bwd(dict(params, u_scale=torch.tensor(2.0, dtype=torch.float64)), state, x0, cot, one)


def test_changed_fixed_field_raises():
    runner, with_params, loss_fn, params, state, xs = _port()

    def apply_params(p):
        b = with_params(p)
        return dataclasses.replace(b, surfaces=dataclasses.replace(b.surfaces, rf=b.surfaces.rf, normal=-b.surfaces.normal))

    fwd = runner.chunk_forward(apply_params, loss_fn)
    with pytest.raises(ValueError, match="holds fixed.*surfaces.normal"):
        fwd(params, state, tree_map(lambda v: v[0], xs))


def test_day_march_fn_gradcheck():
    """DayMarchFn's backward (the plain day adjoint) against central
    differences of its forward, on a 1-zone, 3-surface building, 1 hour of 2
    sub-steps, from a random state (away from the |dT| = 0 kinks)."""
    b = ThermalModel(testing.build_city_model(1, 3), config=SimConfig(dtype=torch.float64), device="cpu").building
    bb = day_march.block_building(b)
    hm, params = day_march.make_hour_march(bb, substeps=2, mode="trbdf2_refresh", hours=1, refresh_every=1, device="cpu")
    adj = day_adjoint.make_day_adjoint(bb, substeps=2, mode="trbdf2_refresh", hours=1, refresh_every=1, device="cpu")
    lay, SP, NB, ZB = bb.layout, bb.layout.padded_surfaces, bb.n_blocks, bb.zones_per_block
    rng = np.random.default_rng(5)

    def t(a, grad=True):
        return torch.as_tensor(np.asarray(a, np.float64)).requires_grad_(grad)

    T0 = t(lay.surfaces_to_blocked(np.where(b.surfaces.node_mask, rng.uniform(12, 30, b.surfaces.node_mask.shape), 0.0)))
    zT0 = t(lay.zones_to_blocked(np.array([19.0])))
    hi = (t([3.0, 4.0], False), t([4.0, 5.0], False), t([0.3, 0.4], False),
          t(rng.uniform(50, 400, (1, SP))), t(rng.uniform(0, 50, (1, SP))),
          t(rng.uniform(250, 400, (1, SP))), t(rng.uniform(250, 400, (1, SP))),
          t(np.full((1, NB, ZB), 300.0)), t(np.full((1, NB, ZB), 20.0)))
    node, surf, zv = (x.detach().clone().requires_grad_() for x in (params.node, params.surf, params.zone_volume))

    def fn(node, surf, zv, T, zT, *hi):
        return day_adjoint.DayMarchFn.apply(hm.plain, functools.partial(adj.raw, plain=True), params, node, surf, zv, T, zT, *hi)[:3]

    assert torch.autograd.gradcheck(fn, (node, surf, zv, T0, zT0) + hi, eps=1e-6, atol=1e-6, rtol=1e-5, fast_mode=True)

"""The parity-mode gradient of the port against heatx, f64, CPU.

* the plain parity day adjoint (autograd through the plain parity march)
  against heatx's adjoint kernel in interpret mode (``mode="parity"``, the
  unrolled ``_hour_body`` under ``jax.vjp``): every output within 1e-9 of
  max |ref|, free-float and with thermostats, mixing and a load cotangent;
* the same adjoint on heatx's own kernel operands through
  ``heatx_torch.convert``;
* ``chunked_value_and_grad`` through ``FastRunner.chunk_forward``/
  ``chunk_grad(mode="parity")`` against heatx's same call, rtol 1e-8;
* the plain parity adjoint against central differences of the plain parity
  march on buildings that take every boundary branch and the long no-mass
  runs, 1e-5 relative;
* the rules ``make_day_adjoint(mode="parity")`` enforces.

heatx's parity adjoint unrolls the sub-steps, so its interpret-mode trace
grows with them: the comparisons with heatx run at a discretization of 4
sub-steps per hour (``min_dt=1200``) over 2 hours, and the heatx results are
computed once per module; the port's own checks run at 6 sub-steps.
"""

import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import heatx
from heatx.engine.adjoint import chunked_value_and_grad as hx_chunked_value_and_grad
from heatx.ops import pallas_adjoint, pallas_step
from heatx_torch import SimConfig, ThermalModel, convert, testing
from heatx_torch.engine.adjoint import chunked_value_and_grad, tree_map
from heatx_torch.ops import day_adjoint, day_march
from torch_reference import unoptimized

torch.set_num_threads(1)

RTOL = 1e-9  # of max |ref|, per output
HOURS = 2
ITERS = 2


MIN_DT = 1200.0  # 4 stability sub-steps per hour


def hx_coarse(**kw):
    return heatx.SimConfig(dtype=jnp.float64, max_dx=0.5, min_dt=MIN_DT, nomass_fixed_iters=ITERS, **kw)


def port_coarse():
    return testing.coarse_config(nomass_fixed_iters=ITERS, min_dt=MIN_DT)


def _hx_thermostat_model():
    m = bench.build_city_model(4, 4)
    H = heatx.IdealHeaterCooler
    m.add_hvac(H("t0", ["z0"], heat_setpoint=20.0, cool_setpoint=26.0))
    m.add_hvac(H("t1", ["z1"], heat_setpoint=21.0, cool_setpoint=25.0, max_heating=300.0))
    m.add_hvac(H("t2", ["z2"], heat_setpoint=19.0, cool_setpoint=23.0, max_cooling=100.0))
    m.add_mixing("z0", "z1", 0.02, bidirectional=False)
    m.add_mixing("z1", "z0", 0.03, bidirectional=False)
    m.add_mixing("z3", "z2", 0.01, bidirectional=False)
    return m


MODELS = {
    "city": (lambda: bench.build_city_model(4, 10), lambda: testing.build_city_model(4, 10)),
    "thermostats_mixing": (_hx_thermostat_model, testing.build_thermostat_model),
}


def _inputs(S, Z, N, sub):
    """Seeded inputs and cotangents in surface/zone order.  The zones start
    apart, so the thermostat model heats one zone, clamps one, cools one."""
    rng = np.random.default_rng(0)
    return dict(
        weather=[np.repeat(np.asarray(v), sub) for v in ([2.0, 5.0], [3.0, 4.0], [0.7, 0.1])],
        sol_front=rng.uniform(0, 500, (HOURS, S)),
        sol_back=rng.uniform(0, 50, (HOURS, S)),
        ir_front=np.full((HOURS, S), 320.0),
        a_gain=np.full(Z, 500.0),
        T0=rng.uniform(14.0, 27.0, (N, S)),
        zT0=np.resize([18.5, 20.0, 26.5, 22.0], Z),
        dT=rng.normal(size=(N, S)),
        d_zT=rng.normal(size=Z),
        d_hist=rng.normal(size=(HOURS, Z)),
        d_ld=rng.normal(size=(HOURS, Z)) * 1e-2,
    )


def _blocked(lay, n_blocks, zones_per_block, building, inp, has_loads):
    SP = lay.padded_surfaces

    def lanes(a):
        return np.stack([lay.surfaces_to_blocked(x) for x in a])

    def zones(a):
        return np.stack([lay.zones_to_blocked(x) for x in a])

    hour_inputs = tuple(inp["weather"]) + (
        lanes(inp["sol_front"]), lanes(inp["sol_back"]), lanes(inp["ir_front"]),
        np.zeros((HOURS, SP)), zones([inp["a_gain"]] * HOURS),
        np.zeros((HOURS, n_blocks, zones_per_block)),
    )
    mask = np.asarray(building.surfaces.node_mask)
    cots = (lay.surfaces_to_blocked(np.where(mask, inp["dT"], 0.0)), lay.zones_to_blocked(inp["d_zT"]),
            zones(inp["d_hist"]), zones(inp["d_ld"]) if has_loads else None)
    T0 = lay.surfaces_to_blocked(np.where(mask, inp["T0"], 0.0))
    return hour_inputs, cots, T0, lay.zones_to_blocked(inp["zT0"])


def _flat(g):
    out = {k: v for k, v in g.items() if k != "d_params"}
    out.update({"p:" + k: v for k, v in g["d_params"].items()})
    return out


def _unblock(lay, S, Z, g):
    out = {}
    for k, v in g.items():
        if k in ("d_zT0", "d_zone_volume", "d_ctl_heat", "d_ctl_cool"):
            out[k] = lay.zones_from_blocked(v, Z)
        elif k in ("d_a_extra", "d_b_extra"):
            out[k] = np.stack([lay.zones_from_blocked(x, Z) for x in v])
        else:
            out[k] = lay.surfaces_from_blocked(v, S)
    return out


@pytest.fixture(scope="module")
def heatx_side():
    """Per model: heatx's compiled building, its node_split=None blocking and
    kernel operands, and its interpret-mode parity adjoint, computed once."""
    cache = {}

    def get(model):
        if model not in cache:
            hb = heatx.build.layout.compile_building(MODELS[model][0](), n=1, config=hx_coarse())
            sub = hb.dt_subdivisions
            assert sub == 4
            bb = pallas_step.block_building(hb, block_size=32, node_split=None)
            has_loads = bb.ctl is not None
            inp = _inputs(hb.n_surfaces, hb.n_zones, bb.max_nodes, sub)
            hi, cots, T0, zT0 = _blocked(bb.layout, bb.n_blocks, bb.zones_per_block, hb, inp, has_loads)
            _, params = pallas_step.make_hour_march(bb, interpret=True, mode="parity", hours=HOURS)
            adj = pallas_adjoint.make_day_adjoint(bb, substeps=sub, mode="parity", hours=HOURS, interpret=True)
            g = unoptimized(adj)(params, jnp.asarray(T0), jnp.asarray(zT0), tuple(jnp.asarray(x) for x in hi),
                    tuple(None if c is None else jnp.asarray(c) for c in cots))
            g = {name: np.asarray(v) for name, v in _flat(g).items()}
            cache[model] = SimpleNamespace(
                hb=hb, bb=bb, params=params, sub=sub, has_loads=has_loads,
                grads=_unblock(bb.layout, hb.n_surfaces, hb.n_zones, g),
            )
        return cache[model]

    return get


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _port_adjoint(pb, params=None, block_size=16):
    bb = day_march.block_building(pb, block_size=block_size)
    sub = pb.dt_subdivisions
    has_loads = bb.ctl is not None
    inp = _inputs(pb.n_surfaces, pb.n_zones, bb.max_nodes, sub)
    hi, cots, T0, zT0 = _blocked(bb.layout, bb.n_blocks, bb.zones_per_block, pb, inp, has_loads)
    _, own = day_march.make_hour_march(bb, mode="parity", hours=HOURS, device="cpu")
    adj = day_adjoint.make_day_adjoint(bb, substeps=sub, mode="parity", hours=HOURS, device="cpu")
    g = adj(own if params is None else params, _t(T0), _t(zT0), tuple(_t(x) for x in hi),
            tuple(None if c is None else _t(c) for c in cots))
    return bb, {name: v.numpy() for name, v in _flat(g).items()}


def _compare(bb, pb, got, ref):
    got_sf = _unblock(bb.layout, pb.n_surfaces, pb.n_zones, got)
    assert sorted(got_sf) == sorted(ref)
    for name, r in ref.items():
        np.testing.assert_allclose(got_sf[name], r, rtol=0, atol=RTOL * np.abs(r).max(), err_msg=name)


@pytest.mark.parametrize("model", list(MODELS))
def test_plain_parity_adjoint_matches_heatx_kernel(heatx_side, model):
    hx = heatx_side(model)
    pb = ThermalModel(MODELS[model][1](), config=port_coarse(), device="cpu").building
    bb, got = _port_adjoint(pb)
    _compare(bb, pb, got, hx.grads)
    live = ["dT0", "d_zT0", "d_zone_volume", "d_sol_front", "d_sol_back", "d_ir_front", "d_a_extra",
            "d_b_extra", "p:mass", "p:seg_u", "p:front_alphas", "p:back_alphas", "p:area",
            "p:perimeter", "p:wind_mod", "p:eps_front", "p:eps_back", "p:rf"]
    if hx.has_loads:
        live += ["d_ctl_heat", "d_ctl_cool"]
    for name in live:
        assert np.abs(hx.grads[name]).max() > 0, name
    pad = ~bb.layout.surf_valid
    for name, v in got.items():
        assert np.isfinite(v).all(), name
        if name.startswith("p:") or name.startswith("d_sol") or name.startswith("d_ir"):
            assert (v[..., pad] == 0).all(), name


def _operand_dict(bb, params):
    aux = (["front_oh", "front_ohT"] if bb.front_oh.any() else []) + (
        ["back_oh", "back_ohT"] if bb.back_oh.any() else []
    )
    names = pallas_step._NODE_NAMES + pallas_step._SURF_NAMES + ["chunk_count"] + aux + ["zone_volume"]
    names += ["mix_wt"] if bb.mix_wt is not None else []
    names += list(convert.CTL_NAMES) if bb.ctl is not None else []
    assert len(names) == len(params)
    return {n: np.asarray(p) for n, p in zip(names, params)}


@pytest.mark.parametrize("model", list(MODELS))
def test_parity_adjoint_on_heatx_operands(heatx_side, model):
    """The plain parity adjoint on heatx's own kernel operands, carried
    across by heatx_torch.convert, gives heatx's cotangents."""
    hx = heatx_side(model)
    pb = ThermalModel(MODELS[model][1](), config=port_coarse(), device="cpu").building
    params = convert.params_from_kernel_operands(
        _operand_dict(hx.bb, hx.params), hx.bb.n_blocks, dtype=torch.float64
    )
    bb, got = _port_adjoint(pb, params=params, block_size=32)
    _compare(bb, pb, got, hx.grads)


# ---------------------------------------------------------------------------
# chunked_value_and_grad in parity mode
# ---------------------------------------------------------------------------

ZONES, SURFACES, CHUNKS = 2, 3, 2
T_STEPS = HOURS * CHUNKS
START = 8  # the inputs start at 08:00, so the sun is up


def _weather():
    dry, wind, wdir, ghi, ir = (w[START:START + T_STEPS] for w in testing.synthetic_weather(START + T_STEPS))
    return dict(t_out=dry, wind_speed=wind, wind_direction=wdir, ghi=ghi, ir_front=ir)


def _chunk(v, xp):
    if v.ndim and v.shape[0] == T_STEPS:
        return v.reshape((CHUNKS, T_STEPS // CHUNKS) + tuple(v.shape[1:]))
    return xp.broadcast_to(v, (CHUNKS,) + tuple(v.shape))


@pytest.fixture(scope="module")
def heatx_value_and_grad():
    tm = heatx.ThermalModel(bench.build_city_model(ZONES, SURFACES), n=1, config=hx_coarse())
    b = tm.building
    w = _weather()
    seq = tm.inputs_sequence(
        T_STEPS, t_out=w["t_out"], wind_speed=w["wind_speed"], wind_direction=w["wind_direction"],
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

    fr = tm.fast_runner(block_size=16, interpret=True, mode="parity", hours=HOURS)
    params = {"u_scale": jnp.asarray(1.2), "alpha_scale": jnp.asarray(0.8)}
    val, g = hx_chunked_value_and_grad(
        None, params, tm.initial_state(), xs,
        forward_fn=fr.chunk_forward(with_params, loss_fn),
        backward_fn=fr.chunk_grad(with_params, loss_fn),
    )
    return float(val), float(g["u_scale"]), float(g["alpha_scale"])


def _port_grad_workload(model=None, config=None):
    tm = ThermalModel(model or testing.build_city_model(ZONES, SURFACES),
                      config=config or port_coarse(), device="cpu")
    b = tm.building
    w = _weather()
    seq = tm.inputs(
        t_out=w["t_out"], wind_speed=w["wind_speed"], wind_direction=w["wind_direction"],
        sol_front=w["ghi"][:, None] * testing.solar_factors(b.n_surfaces)[None, :],
        ir_front=w["ir_front"], hvac_power=np.full(b.n_hvacs, 500.0),
    )
    xs = tree_map(lambda v: _chunk(v, torch), seq)
    sb0 = b.surfaces
    seg_u0, alphas0 = torch.as_tensor(sb0.seg_u), torch.as_tensor(sb0.front_alphas)

    def with_params(p):
        sb = dataclasses.replace(sb0, seg_u=seg_u0 * p["u_scale"], front_alphas=alphas0 * p["alpha_scale"])
        return dataclasses.replace(b, surfaces=sb)

    def loss_fn(zt, xs):
        return torch.mean((zt - 21.0) ** 2) / CHUNKS

    runner = tm.fast_runner(mode="parity", hours=HOURS)
    params = {"u_scale": torch.tensor(1.2, dtype=torch.float64),
              "alpha_scale": torch.tensor(0.8, dtype=torch.float64)}
    return runner, with_params, loss_fn, params, tm.initial_state(), xs


def _value_and_grad(runner, with_params, loss_fn, params, state, xs):
    val, g = chunked_value_and_grad(
        None, params, state, xs,
        forward_fn=runner.chunk_forward(with_params, loss_fn),
        backward_fn=runner.chunk_grad(with_params, loss_fn),
    )
    return float(val), float(g["u_scale"]), float(g["alpha_scale"])


def test_chunk_grad_parity_matches_heatx(heatx_value_and_grad):
    got = _value_and_grad(*_port_grad_workload())
    np.testing.assert_allclose(got, heatx_value_and_grad, rtol=1e-8)
    assert all(abs(x) > 0 for x in got)


@pytest.mark.parametrize("model", ["mixed", "nomass_runs"])
def test_chunk_grad_parity_matches_finite_differences(model):
    """The chunked parity gradient against central differences of the
    chunked forward value, on buildings heatx's bench city does not cover."""
    build = {"mixed": testing.build_mixed_model, "nomass_runs": testing.build_nomass_run_model}[model]
    runner, with_params, loss_fn, params, state, xs = _port_grad_workload(build(), testing.coarse_config(nomass_fixed_iters=3))
    val, gu, ga = _value_and_grad(runner, with_params, loss_fn, params, state, xs)
    fwd = runner.chunk_forward(with_params, loss_fn)

    def value(p):
        st, total = state, 0.0
        for c in range(CHUNKS):
            st, loss = fwd(p, st, tree_map(lambda v: v[c], xs))
            total += float(loss)
        return total

    assert abs(value(params) - val) <= 1e-12 * abs(val)
    for name, an in (("u_scale", gu), ("alpha_scale", ga)):
        eps = 1e-6
        fd = (value({**params, name: params[name] + eps}) - value({**params, name: params[name] - eps})) / (2 * eps)
        assert abs(an) > 0
        assert abs(fd - an) <= 1e-5 * abs(an), (name, fd, an)


def _bench_day_gradients(iters, u_scale, days=2):
    """bench.py's gradient objective over ``days`` on the 4-zone bench city at
    the default discretization (118 sub-steps per hour): (loss, dL/du,
    dL/dalpha) from heatx (``jax.value_and_grad`` through ``engine.step.run``,
    its reference-parity march) and from the port (``chunk_forward``/
    ``chunk_grad`` on the plain versions)."""
    from heatx.engine import step as hx_step

    T = 24 * days
    dry, wind, wdir, ghi, ir = testing.synthetic_weather(T)
    hx = heatx.ThermalModel(bench.build_city_model(4, 10), n=1,
                            config=heatx.SimConfig(dtype=jnp.float64, nomass_fixed_iters=iters))
    hb = hx.building
    seq = hx.inputs_sequence(
        T, t_out=dry, wind_speed=wind, wind_direction=wdir, ir_front=ir,
        sol_front=ghi[:, None] * testing.solar_factors(hb.n_surfaces)[None, :],
        hvac_power=np.full(hb.n_hvacs, 500.0), lum_power=np.zeros(hb.n_luminaires),
    )
    building, st = hx._device(), hx.initial_state()
    sb0 = building.surfaces

    def hx_loss(p):
        sb = dataclasses.replace(sb0, seg_u=sb0.seg_u * p[0], front_alphas=sb0.front_alphas * p[1])
        _, hist = hx_step.run(dataclasses.replace(building, surfaces=sb), st, seq, collect_zone_T=True)
        return jnp.mean((hist - 21.0) ** 2)

    v, g = jax.value_and_grad(hx_loss)(jnp.asarray([u_scale, 0.8]))
    ref = (float(v), float(g[0]), float(g[1]))

    tm = ThermalModel(testing.build_city_model(4, 10), device="cpu",
                      config=SimConfig(dtype=torch.float64, nomass_fixed_iters=iters))
    b = tm.building
    pseq = testing.bench_inputs(b, T)
    pseq = pseq.replace(lum_power=torch.zeros_like(pseq.lum_power))
    xs = tree_map(lambda x: x.reshape((1, T) + tuple(x.shape[1:])) if x.ndim and x.shape[0] == T
                  else torch.broadcast_to(x, (1,) + tuple(x.shape)), pseq)
    u0, a0 = torch.as_tensor(b.surfaces.seg_u), torch.as_tensor(b.surfaces.front_alphas)

    def with_params(p):
        return dataclasses.replace(b, surfaces=dataclasses.replace(
            b.surfaces, seg_u=u0 * p["u_scale"], front_alphas=a0 * p["alpha_scale"]))

    params = {"u_scale": torch.tensor(u_scale, dtype=torch.float64),
              "alpha_scale": torch.tensor(0.8, dtype=torch.float64)}
    got = _value_and_grad(tm.fast_runner(mode="parity", hours=24), with_params,
                          lambda zt, xs: torch.mean((zt - 21.0) ** 2), params, tm.initial_state(), xs)
    return ref, got


@pytest.mark.slow
@pytest.mark.parametrize("iters,u_scale,sound", [(1, 1.2, True), (1, 1.0, False), (2, 1.0, True)])
def test_parity_gradient_through_two_cycles_in_both_packages(iters, u_scale, sound):
    """With one relaxed no-mass iteration per sub-step the inner faces of the
    bench city's insulated walls 2-cycle from hour 19 of the bench day
    (tests/test_torch_parity.py), and the derivative through such an episode
    grows without bound: in heatx's own autodiff as in the port's adjoint.
    At the conductance scale bench.py's gradient row starts from (1.2) no face
    settles on the cycle and the two packages agree; at 1.0 both return
    astronomically large derivatives of a loss that they agree on to 1e-5;
    with two iterations per sub-step the cycle is gone and they agree again.
    ``pytest -s`` prints the values (~2-3 min per case on one core)."""
    ref, got = _bench_day_gradients(iters, u_scale)
    print(f"nomass_fixed_iters={iters}, u_scale {u_scale}: loss, dL/du, dL/dalpha heatx {ref}, heatx_torch {got}")
    if sound:
        np.testing.assert_allclose(got, ref, rtol=1e-6)
        assert 1.0 < abs(ref[1]) < 100.0
    else:
        np.testing.assert_allclose(got[0], ref[0], rtol=1e-5)
        assert abs(ref[1]) > 1e9 and abs(got[1]) > 1e9


@pytest.mark.parametrize("model", ["mixed", "nomass_runs", "thermostats"])
def test_plain_parity_adjoint_matches_finite_differences(model):
    """Per-parameter cotangents of the plain parity adjoint against central
    differences of the plain parity march, from a random state."""
    build = {"mixed": testing.build_mixed_model, "nomass_runs": testing.build_nomass_run_model,
             "thermostats": testing.build_thermostat_model}[model]
    b = ThermalModel(build(), config=testing.coarse_config(nomass_fixed_iters=3), device="cpu").building
    bb = day_march.block_building(b)
    sub = b.dt_subdivisions
    hm, params = day_march.make_hour_march(bb, mode="parity", hours=HOURS, device="cpu")
    adj = day_adjoint.make_day_adjoint(bb, substeps=sub, mode="parity", hours=HOURS, device="cpu")
    lay, SP, NB, ZB = bb.layout, bb.layout.padded_surfaces, bb.n_blocks, bb.zones_per_block
    rng = np.random.default_rng(11)
    mask = b.surfaces.node_mask
    hi = tuple(_t(rng.uniform(lo, hi, HOURS * sub)) for lo, hi in ((-5, 15), (0, 8), (0, 6.28))) + (
        _t(rng.uniform(0, 400, (HOURS, SP))), _t(rng.uniform(0, 50, (HOURS, SP))),
        _t(rng.uniform(250, 400, (HOURS, SP))), _t(rng.uniform(250, 400, (HOURS, SP))),
        _t(rng.uniform(0, 900, (HOURS, NB, ZB))), _t(rng.uniform(0, 50, (HOURS, NB, ZB))),
    )
    T0 = _t(lay.surfaces_to_blocked(np.where(mask, rng.uniform(15, 25, mask.shape), 0.0)))
    zT0 = _t(lay.zones_to_blocked(rng.uniform(18, 24, b.n_zones)))
    W = [_t(rng.normal(size=T0.shape)), _t(rng.normal(size=zT0.shape)), _t(rng.normal(size=(HOURS, NB, ZB)))]
    if hm.collect_loads:
        W.append(_t(rng.normal(size=(HOURS, NB, ZB)) * 1e-2))
    g = adj(params, T0, zT0, hi, W)["d_params"]

    def loss(p):
        out = hm(p, T0, zT0, hi)
        total = (out[0] * W[0]).sum() + (out[1] * W[1]).sum() + (out[3] * W[2]).sum()
        if hm.collect_loads:
            total = total + (out[-1] * W[3]).sum()
        return float(total)

    eps = 1e-6
    names = ["seg_u", "mass", "front_alphas", "area", "eps_front", "eps_back", "wind_mod"]
    names += ["cos_tilt", "front_temp", "back_temp", "fixed_h_front"] if model == "mixed" else []
    for name in names:
        is_node = name in day_adjoint.NODE_ROW
        row = params.node[day_adjoint.NODE_ROW[name]] if is_node else params.field(name)
        D = torch.nan_to_num(_t(rng.normal(size=row.shape)) * row.abs())

        def moved(e):
            node, surf = params.node.clone(), params.surf.clone()
            if is_node:
                node[day_adjoint.NODE_ROW[name]] += e * D
            else:
                surf[day_march.SURF_FIELDS.index(name)] += e * D
            return dataclasses.replace(params, node=node, surf=surf)

        fd = (loss(moved(eps)) - loss(moved(-eps))) / (2 * eps)
        an = float((torch.nan_to_num(g[name]) * D).sum())
        assert abs(an) > 0, name
        assert abs(fd - an) <= 1e-5 * abs(an), (name, fd, an)


def test_parity_day_march_fn_gradcheck():
    b = ThermalModel(testing.build_city_model(1, 3), config=testing.coarse_config(), device="cpu").building
    bb = day_march.block_building(b)
    sub = b.dt_subdivisions
    hm, params = day_march.make_hour_march(bb, mode="parity", hours=1, device="cpu")
    adj = day_adjoint.make_day_adjoint(bb, substeps=sub, mode="parity", hours=1, device="cpu")
    lay, SP, NB, ZB = bb.layout, bb.layout.padded_surfaces, bb.n_blocks, bb.zones_per_block
    rng = np.random.default_rng(5)

    def t(a, grad=True):
        return torch.as_tensor(np.asarray(a, np.float64)).requires_grad_(grad)

    mask = b.surfaces.node_mask
    T0 = t(lay.surfaces_to_blocked(np.where(mask, rng.uniform(12, 30, mask.shape), 0.0)))
    zT0 = t(lay.zones_to_blocked(np.array([19.0])))
    hi = tuple(t(rng.uniform(lo, hi_, sub), False) for lo, hi_ in ((2, 5), (3, 6), (0.2, 0.5))) + (
        t(rng.uniform(50, 400, (1, SP))), t(rng.uniform(0, 50, (1, SP))),
        t(rng.uniform(250, 400, (1, SP))), t(rng.uniform(250, 400, (1, SP))),
        t(np.full((1, NB, ZB), 300.0)), t(np.full((1, NB, ZB), 20.0)))
    node, surf, zv = (x.detach().clone().requires_grad_() for x in (params.node, params.surf, params.zone_volume))

    def fn(node, surf, zv, T, zT, *hi):
        return day_adjoint.DayMarchFn.apply(
            hm.plain, functools.partial(adj.raw, plain=True), params, node, surf, zv, T, zT, *hi)[:3]

    assert torch.autograd.gradcheck(fn, (node, surf, zv, T0, zT0) + hi, eps=1e-6, atol=1e-6, rtol=1e-5,
                                    fast_mode=True)


def test_make_parity_adjoint_rules():
    """heatx's checks (pallas_adjoint.py:150-161), and the port's own: the
    adjoint's sub-step length follows from the count, so the count must be
    the building's."""
    tm = ThermalModel(testing.build_city_model(2, 3), config=testing.coarse_config(), device="cpu")
    bb = day_march.block_building(tm.building)
    with pytest.raises(ValueError, match="dt_subdivisions"):
        day_adjoint.make_day_adjoint(bb, mode="parity", device="cpu")
    with pytest.raises(ValueError, match="not the building's dt_subdivisions"):
        day_adjoint.make_day_adjoint(bb, substeps=tm.dt_subdivisions + 1, mode="parity", device="cpu")
    with pytest.raises(ValueError, match="refresh_every"):
        day_adjoint.make_day_adjoint(bb, substeps=tm.dt_subdivisions, mode="parity", refresh_every=1, device="cpu")
    adaptive = ThermalModel(testing.build_city_model(2, 3), device="cpu",
                            config=testing.coarse_config(nomass_fixed_iters=None))
    with pytest.raises(ValueError, match="nomass_fixed_iters"):
        day_adjoint.make_day_adjoint(day_march.block_building(adaptive.building),
                                     substeps=adaptive.dt_subdivisions, mode="parity", device="cpu")
    adj = day_adjoint.make_day_adjoint(bb, substeps=tm.dt_subdivisions, mode="parity", device="cpu")
    assert adj._hm.parity and adj._hm.dt == tm.dt


@pytest.mark.cuda
@pytest.mark.parametrize("model", list(MODELS))
def test_cuda_parity_adjoint_kernel_matches_plain(model):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    tm = ThermalModel(MODELS[model][1](), config=testing.coarse_config(), device="cuda")
    r = tm.fast_runner(mode="parity", hours=HOURS)
    hi = r.kernel_inputs(testing.demand_inputs(tm.building, HOURS, device="cuda"))[0]
    T0, zT0 = r.to_blocked(tm.initial_state())
    adj = day_adjoint.make_day_adjoint(r._bb, substeps=r._substeps, mode="parity", hours=HOURS)
    cots = (torch.ones_like(T0), torch.ones_like(zT0), None) + ((None,) if r._has_loads else ())
    got, ref = adj.raw(r.params, T0, zT0, hi, cots), adj.raw(r.params, T0, zT0, hi, cots, plain=True)
    for a, b in zip(got, ref):
        if b is not None:
            torch.testing.assert_close(a, b, rtol=0, atol=RTOL * float(b.abs().max()))

"""The demand-objective gradient: the port's ``chunked_value_and_grad`` through
``FastRunner.chunk_forward``/``chunk_grad(collect_loads=True)`` against
heatx's, f64, CPU.

bench.py's ``_grad_demand_variant`` (bench.py:352-371) on a small city: 2
zones x 3 surfaces with a thermostat per zone at 20/26 C, a conductance scale
on ``seg_u`` and a shift of the compiled heating setpoint, the metered-energy
loss ``mean((ld / 1e3)^2) / C + 1e-4 mean(zt) / C``, trbdf2_refresh k=2, 2
chunks of one 2-hour dispatch at 2 sub-steps (short, to keep heatx's
interpret-mode compiles short).  The zones start just below the shifted
setpoint on a night without sun, so both thermostats heat (asserted) and the
setpoint gradient carries signal.  Loss and both gradients agree with heatx's
within rtol 1e-8 (round-off; ~1e-13 measured).

The schedule path is checked against monolithic torch autograd over the
whole horizon (rtol 1e-10), with a ``schedule_fn`` that scales the schedule
carried in ``xs``: heatx pulls the schedule cotangents back through a second
linearization of ``schedule_fn`` around the ``xs`` it has already replaced
(heatx/api.py:1173), which squares that scale's effect; the port
differentiates the one call it made.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import heatx
from heatx.engine.adjoint import chunked_value_and_grad as hx_chunked_value_and_grad
from heatx.model.building import IdealHeaterCooler as HxIdealHeaterCooler
from heatx_torch import SimConfig, ThermalModel, testing
from heatx_torch.engine.adjoint import chunked_value_and_grad, tree_map

torch.set_num_threads(1)

RTOL = 1e-8
ZONES, SURFACES = 2, 3
HOURS, SUB, CHUNKS = 2, 2, 2
T_STEPS = HOURS * CHUNKS
KW = dict(mode="trbdf2_refresh", substeps=SUB, hours=HOURS, refresh_every=2)
ZONE_T0 = np.array([19.5, 19.8])  # below the heating setpoint
P0 = dict(u_scale=1.2, sp_shift=0.5)


def _weather():
    dry, wind, wdir, ghi, ir = testing.synthetic_weather(T_STEPS)  # from midnight
    return dict(t_out=dry, wind_speed=wind, wind_direction=wdir, ghi=ghi, ir_front=ir)


#: The channels that carry a leading hour axis here (the 4 HVAC units' powers
#: have length T_STEPS too, so the shape alone cannot tell).
TIME_FIELDS = ("t_out", "wind_speed", "wind_direction", "sol_front", "ir_front", "heat_sp")


def _port_chunks(seq):
    """[T]-leading channels -> [C, T/C, ...]; the rest broadcast to [C, ...];
    absent optional channels stay None."""
    out = {}
    for f in dataclasses.fields(seq):
        v = getattr(seq, f.name)
        if v is None:
            continue
        if f.name in TIME_FIELDS:
            out[f.name] = v.reshape((CHUNKS, HOURS) + tuple(v.shape[1:]))
        else:
            out[f.name] = torch.broadcast_to(v, (CHUNKS,) + tuple(v.shape))
    return seq.replace(**out)


@pytest.fixture(scope="module")
def heatx_result():
    model = bench.build_city_model(ZONES, SURFACES)
    for z in range(ZONES):
        model.add_hvac(HxIdealHeaterCooler(f"tstat{z}", [f"z{z}"], heat_setpoint=20.0, cool_setpoint=26.0))
    tm = heatx.ThermalModel(model, n=1, config=heatx.SimConfig(dtype=jnp.float64))
    w = _weather()
    building = tm._device()
    seq = tm.inputs_sequence(
        T_STEPS, t_out=w["t_out"], wind_speed=w["wind_speed"], wind_direction=w["wind_direction"],
        sol_front=w["ghi"][:, None] * testing.solar_factors(building.n_surfaces)[None, :],
        ir_front=w["ir_front"], lum_power=np.full(building.n_luminaires, 150.0),
    )
    def chunk(v):  # inputs_sequence gave every non-empty channel a leading [T] axis
        v = jnp.asarray(v)
        if v.ndim and v.shape[0] == T_STEPS:
            return v.reshape((CHUNKS, HOURS) + tuple(v.shape[1:]))
        return jnp.broadcast_to(v, (CHUNKS,) + tuple(v.shape))

    xs = jax.tree.map(chunk, seq)
    sb0 = building.surfaces

    def with_params(p):
        sb = dataclasses.replace(sb0, seg_u=sb0.seg_u * p["u_scale"])
        return dataclasses.replace(building, surfaces=sb, ctl_heat_sp=building.ctl_heat_sp + p["sp_shift"])

    def loss_fn(zt, ld, xs):
        return jnp.mean((ld / 1e3) ** 2) / CHUNKS + 1e-4 * jnp.mean(zt) / CHUNKS

    fr = tm.fast_runner(block_size=16, interpret=True, **KW)
    st = tm.initial_state()._replace(zone_T=jnp.asarray(ZONE_T0))
    val, g = hx_chunked_value_and_grad(
        None, {k: jnp.asarray(v) for k, v in P0.items()}, st, xs,
        forward_fn=fr.chunk_forward(with_params, loss_fn, collect_loads=True),
        backward_fn=fr.chunk_grad(with_params, loss_fn, collect_loads=True),
    )
    return float(val), float(g["u_scale"]), float(g["sp_shift"])


def _port(device="cpu", scheduled=False):
    """The port's demand-gradient workload: (tm, runner, with_params,
    loss_fn, params, state, the [T] input sequence)."""
    tm = ThermalModel(
        testing.build_demand_city(ZONES, SURFACES), n=1, config=SimConfig(dtype=torch.float64),
        device=device,
    )
    b = tm.building
    w = _weather()
    seq = tm.inputs(
        t_out=w["t_out"], wind_speed=w["wind_speed"], wind_direction=w["wind_direction"],
        sol_front=w["ghi"][:, None] * testing.solar_factors(b.n_surfaces)[None, :],
        ir_front=w["ir_front"], lum_power=np.full(b.n_luminaires, 150.0),
    )
    seg_u0 = torch.as_tensor(b.surfaces.seg_u, device=device)
    heat0 = torch.as_tensor(b.ctl_heat_sp, device=device)

    def with_params(p):
        sb = dataclasses.replace(b.surfaces, seg_u=seg_u0 * p["u_scale"])
        return dataclasses.replace(b, surfaces=sb, ctl_heat_sp=heat0 + p["sp_shift"])

    def loss_fn(zt, ld, xs):
        return torch.mean((ld / 1e3) ** 2) / CHUNKS + 1e-4 * torch.mean(zt) / CHUNKS

    runner = tm.fast_runner(block_size=16, scheduled_setpoints=scheduled, **KW)
    params = {k: torch.tensor(v, dtype=torch.float64, device=device) for k, v in P0.items()}
    state = dataclasses.replace(tm.initial_state(), zone_T=torch.as_tensor(ZONE_T0, device=device))
    return tm, runner, with_params, loss_fn, params, state, seq


def test_demand_gradient_matches_heatx(heatx_result):
    tm, runner, with_params, loss_fn, params, state, seq = _port()
    _, _, loads = runner.run(state, seq, collect_loads=True)
    assert (loads[0] > 0).all()  # both thermostats heat in the first hour
    val, g = chunked_value_and_grad(
        None, params, state, _port_chunks(seq),
        forward_fn=runner.chunk_forward(with_params, loss_fn, collect_loads=True),
        backward_fn=runner.chunk_grad(with_params, loss_fn, collect_loads=True),
    )
    got = (float(val), float(g["u_scale"]), float(g["sp_shift"]))
    np.testing.assert_allclose(got, heatx_result, rtol=RTOL)
    assert got[2] != 0.0  # the setpoint gradient carries signal


def _monolithic(runner, with_params, loss_of_chunks, params, state, seq, schedule_fn=None):
    """Loss and gradients by torch autograd through the plain day march over
    the whole horizon: no chunk sweep, no DayMarchFn, no day adjoint."""
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    P = runner._blocked_params(with_params(p))
    T, zT = runner._blocked_state(state.node_T, state.zone_T)
    if schedule_fn is not None:
        seq = seq.replace(**schedule_fn(p, seq))
    prep = runner._prepare(seq, False)
    hist, loads = [], []
    for hi in runner._day_inputs(prep, 0, prep.D):
        out = runner.hour_march.plain(P, T, zT, hi)
        T, zT = out[0], out[1]
        hist.append(out[3])
        loads.append(out[-1])

    def zone_order(rows):
        return torch.cat(rows).reshape(prep.T_steps, -1)[:, runner._zinv]

    loss = loss_of_chunks(zone_order(hist), zone_order(loads))
    grads = torch.autograd.grad(loss, list(p.values()))
    return float(loss.detach()), {k: float(g) for k, g in zip(p, grads)}


def test_demand_gradient_matches_monolithic_autograd():
    tm, runner, with_params, loss_fn, params, state, seq = _port()

    def loss_of_chunks(zt, ld):
        return sum(loss_fn(zt[c * HOURS:(c + 1) * HOURS], ld[c * HOURS:(c + 1) * HOURS], None)
                   for c in range(CHUNKS))

    ref_val, ref_g = _monolithic(runner, with_params, loss_of_chunks, params, state, seq)
    val, g = chunked_value_and_grad(
        None, params, state, _port_chunks(seq),
        forward_fn=runner.chunk_forward(with_params, loss_fn, collect_loads=True),
        backward_fn=runner.chunk_grad(with_params, loss_fn, collect_loads=True),
    )
    np.testing.assert_allclose(float(val), ref_val, rtol=1e-12)
    for k in ref_g:
        np.testing.assert_allclose(float(g[k]), ref_g[k], rtol=1e-10, err_msg=k)


def test_schedule_gradient_differentiates_schedule_fn_once():
    """``schedule_fn`` scales the heating schedule carried in ``xs`` by a
    parameter.  The port's gradient equals monolithic autograd (rtol 1e-10);
    a second linearization around the replaced ``xs`` (heatx/api.py:1173)
    would scale the schedule's part of it by that parameter again."""
    tm, runner, with_params, loss_fn, params, state, seq = _port(scheduled=True)
    Z = tm.building.n_zones
    base = torch.as_tensor(np.array([[20.3, 20.6], [20.8, 20.4], [20.5, 21.0], [20.9, 20.7]]))
    assert base.shape == (T_STEPS, Z)
    seq = seq.replace(heat_sp=base)
    params = {"u_scale": params["u_scale"], "sp_scale": torch.tensor(1.02, dtype=torch.float64)}

    def apply_params(p):
        return with_params(dict(p, sp_shift=torch.zeros((), dtype=torch.float64)))

    def schedule_fn(p, xs):
        return {"heat_sp": xs.heat_sp * p["sp_scale"]}

    def loss_of_chunks(zt, ld):
        return sum(loss_fn(zt[c * HOURS:(c + 1) * HOURS], ld[c * HOURS:(c + 1) * HOURS], None)
                   for c in range(CHUNKS))

    ref_val, ref_g = _monolithic(runner, apply_params, loss_of_chunks, params, state, seq, schedule_fn)
    val, g = chunked_value_and_grad(
        None, params, state, _port_chunks(seq),
        forward_fn=runner.chunk_forward(apply_params, loss_fn, collect_loads=True, schedule_fn=schedule_fn),
        backward_fn=runner.chunk_grad(apply_params, loss_fn, collect_loads=True, schedule_fn=schedule_fn),
    )
    np.testing.assert_allclose(float(val), ref_val, rtol=1e-12)
    assert ref_g["sp_scale"] != 0.0
    for k in ref_g:
        np.testing.assert_allclose(float(g[k]), ref_g[k], rtol=1e-10, err_msg=k)
    # The faulty pull-back's answer is measurably different: the test can tell.
    assert abs(ref_g["sp_scale"] * float(params["sp_scale"]) - ref_g["sp_scale"]) > 1e-6 * abs(ref_g["sp_scale"])


@pytest.mark.parametrize(
    "make, match",
    [
        # the pair must agree on collect_loads and on the presence of a schedule_fn
        (lambda r, f, l: (r.chunk_forward(f, l, collect_loads=True), r.chunk_grad(f, l)), "collect_loads"),
        (lambda r, f, l: (r.chunk_forward(f, l, collect_loads=True),
                          r.chunk_grad(f, l, collect_loads=True, schedule_fn=lambda p, xs: {})),
         "schedule_fn"),
    ],
    ids=["contract_collect_loads", "schedule_fn_needs_scheduled_runner"],
)
def test_demand_chunk_guards_raise(make, match):
    _, runner, with_params, loss_fn, *_ = _port()
    with pytest.raises(ValueError, match=match):
        make(runner, with_params, loss_fn)


def test_setpoints_differentiate_only_with_thermostats():
    """``ctl_heat_sp`` may require grad on a building with thermostats; on a
    free-float building the scope check names it."""
    tm = ThermalModel(testing.build_city_model(ZONES, SURFACES), n=1,
                      config=SimConfig(dtype=torch.float64), device="cpu")
    b = tm.building
    runner = tm.fast_runner(block_size=16, **KW)

    def apply_params(p):
        return dataclasses.replace(b, ctl_heat_sp=torch.as_tensor(b.ctl_heat_sp) + p["sp_shift"])

    bwd = runner.chunk_grad(apply_params, lambda zt, xs: zt.mean())
    seq = testing.demand_inputs(b, HOURS)
    state = tm.initial_state()
    cot = tree_map(torch.zeros_like, state)
    with pytest.raises(ValueError, match="does not differentiate.*ctl_heat_sp"):
        bwd({"sp_shift": torch.tensor(0.5, dtype=torch.float64)}, state, seq, cot,
            torch.tensor(1.0, dtype=torch.float64))


@pytest.mark.cuda
def test_demand_gradient_on_cuda_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    out = []
    for use_kernel in (True, False):
        tm, _, with_params, loss_fn, params, state, seq = _port(device="cuda")
        runner = tm.fast_runner(block_size=16, use_kernel=use_kernel, **KW)
        val, g = chunked_value_and_grad(
            None, params, state, _port_chunks(seq),
            forward_fn=runner.chunk_forward(with_params, loss_fn, collect_loads=True),
            backward_fn=runner.chunk_grad(with_params, loss_fn, collect_loads=True),
        )
        out.append((float(val), float(g["u_scale"]), float(g["sp_shift"])))
    np.testing.assert_allclose(out[0], out[1], rtol=1e-9)

"""FastRunner's one-hour entry points and ``update_building`` against heatx,
f64, CPU.

On bench.py's 4-zone demand city (a thermostat per zone; trbdf2 at 4
sub-steps) and on ``examples/data/office.idf`` (argon glazing, ground slabs,
scheduled setpoints; trbdf2_refresh k=2 at 4 sub-steps with the h/q and
operative histories), one hour of seeded inputs:

* ``hour_inputs`` equals heatx's ``FastRunner.hour_inputs`` entry by entry
  (the port's entries carry ``run``'s leading one-hour axis), 1e-12;
* ``march_blocked`` on the same blocked state equals heatx's (its kernel in
  interpret mode) output by output, 1e-9 K (loads 1e-9 of max |load|), in
  heatx's order;
* ``march`` equals heatx's ``march``, ``ideal_load`` included.

* ``update_building`` with ``seg_u`` x 1.2 on both runners, then ``march``:
  equal to heatx's, 1e-9 K.

Then: 24 ``march`` calls on a one-hour runner equal one ``run`` of the day on
a 24-hour runner; ``update_building`` with a scaled ``seg_u`` equals a runner
built on the scaled building (1e-12) and refuses a layout or operand-shape
change with heatx's exact messages; after a swap ``chunk_forward``/
``chunk_grad`` give a fresh runner's value and gradient.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import heatx
import heatx.model.building as hmb
from heatx.model.idf import load_idf as hx_load_idf
from heatx_torch import SimConfig, ThermalModel, testing
from heatx_torch.engine.adjoint import chunked_value_and_grad, tree_map
from heatx_torch.model.idf import load_idf
from heatx_torch.ops import day_march
from test_torch_cli import IDF

torch.set_num_threads(1)

ATOL = 1e-9
CASES = {
    "city": dict(mode="trbdf2", substeps=4),
    "office": dict(mode="trbdf2_refresh", substeps=4, refresh_every=2, scheduled_setpoints=True,
                   collect_fluxes=True, collect_operative=True),
}


def _hx_demand_city(n_zones, per_zone):
    """heatx's copy of ``testing.build_demand_city``: bench.py's city with a
    thermostat in every zone."""
    hm = bench.build_city_model(n_zones, per_zone)
    for z in range(n_zones):
        hm.add_hvac(hmb.IdealHeaterCooler(f"tstat{z}", [f"z{z}"], heat_setpoint=20.0, cool_setpoint=26.0))
    return hm


def _models(case):
    if case == "city":
        return _hx_demand_city(4, 10), testing.build_demand_city(4, 10)
    return hx_load_idf(IDF).model, load_idf(IDF).model


def _hour(b, case, seed=5):
    """One hour of seeded inputs as numpy arrays, by StepInputs field."""
    rng = np.random.default_rng(seed)
    S, Z = b.n_surfaces, b.n_zones
    out = dict(
        t_out=rng.uniform(-5, 30), wind_speed=rng.uniform(0, 8), wind_direction=rng.uniform(0, 6.28),
        sol_front=rng.uniform(0, 500, S), sol_back=rng.uniform(0, 40, S),
        ir_front=rng.uniform(250, 400, S), ir_back=rng.uniform(250, 400, S),
        hvac_power=rng.uniform(0, 300, b.n_hvacs), lum_power=rng.uniform(0, 200, b.n_luminaires),
        inf_vol=rng.uniform(0, 0.05, Z), inf_temp=rng.uniform(-5, 30, Z), inf_mask=rng.uniform(size=Z) > 0.3,
        vent_vol=rng.uniform(0, 0.2, Z), vent_temp=rng.uniform(-5, 30, Z), vent_mask=rng.uniform(size=Z) > 0.3,
    )
    if case == "office":
        out.update(heat_sp=rng.uniform(22, 23, Z), cool_sp=rng.uniform(25, 27, Z))
    return out


def _start(b, seed=6):
    rng = np.random.default_rng(seed)
    mask = np.asarray(b.surfaces.node_mask)
    return np.where(mask, rng.uniform(15, 25, mask.shape), 0.0), rng.uniform(18, 24, b.n_zones)


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    """(case, heatx runner, port runner, the hour's inputs, the start state)
    on the same blocked layout."""
    case = request.param
    hm, pm = _models(case)
    kw = CASES[case]
    tp = ThermalModel(pm, n=1, config=SimConfig(dtype=torch.float64), device="cpu")
    rp = tp.fast_runner(hours=1, **kw)
    th = heatx.ThermalModel(hm, n=1, config=heatx.SimConfig(dtype=jnp.float64))
    rh = th.fast_runner(hours=1, block_size=day_march.min_block_lanes(tp.building), interpret=True, **kw)
    np.testing.assert_array_equal(np.asarray(rh.layout.surf_perm), np.asarray(rp.layout.surf_perm))
    return case, (th, rh), (tp, rp), _hour(tp.building, case), _start(tp.building)


def _port_inputs(tm, raw):
    return tm.inputs(**raw)


def _heatx_inputs(tm, raw):
    return tm.inputs(**{k: v for k, v in raw.items() if k not in ("heat_sp", "cool_sp")})._replace(
        **{k: raw[k] for k in ("heat_sp", "cool_sp") if k in raw}
    )


def test_hour_inputs_match_heatx(pair):
    case, (th, rh), (tp, rp), raw, _ = pair
    ref = rh.hour_inputs(_heatx_inputs(th, raw))
    got = rp.hour_inputs(_port_inputs(tp, raw))
    assert len(got) == len(ref) == (11 if case == "office" else 9)
    for i, (g, r) in enumerate(zip(got, ref)):
        r = np.asarray(r)
        g = g.numpy()
        assert g.size == r.size, i
        np.testing.assert_allclose(g.reshape(r.shape), r, rtol=1e-12, atol=1e-12, err_msg=str(i))


def _blocked_start(runner, b, start, to_tensor):
    T0, zT0 = start
    lay = runner.layout
    return (to_tensor(lay.surfaces_to_blocked(T0[: runner._bb.max_nodes])),
            to_tensor(lay.zones_to_blocked(zT0)))


def test_march_blocked_matches_heatx(pair):
    case, (th, rh), (tp, rp), raw, start = pair
    T, zT = _blocked_start(rh, th.building, start, jnp.asarray)
    ref = rh.march_blocked(T, zT, rh.hour_inputs(_heatx_inputs(th, raw)))
    T, zT = _blocked_start(rp, tp.building, start, torch.as_tensor)
    got = rp.march_blocked(T, zT, rp.hour_inputs(_port_inputs(tp, raw)))
    # (T, zT, hq, zt_hist[, hq_hist], bad, ld_hist[, top]): both have loads.
    assert len(got) == len(ref) == (8 if case == "office" else 6)
    flat = [jax.tree.leaves(x) for x in ref]
    for i, (g, r) in enumerate(zip(got, flat)):
        g = list(g) if isinstance(g, tuple) else [g]
        assert len(g) == len(r), i
        for gg, rr in zip(g, r):
            rr = np.asarray(rr)
            scale = max(1.0, np.abs(rr).max())
            np.testing.assert_allclose(gg.numpy().reshape(rr.shape), rr, rtol=0, atol=ATOL * scale,
                                       err_msg=f"output {i}")


def test_march_matches_heatx(pair):
    case, (th, rh), (tp, rp), raw, start = pair
    T0, zT0 = start
    sh = th.initial_state()._replace(node_T=jnp.asarray(T0), zone_T=jnp.asarray(zT0))
    sp = tp.initial_state()
    sp.node_T, sp.zone_T = torch.as_tensor(T0), torch.as_tensor(zT0)
    ref = rh.march(sh, _heatx_inputs(th, raw))
    got = rp.march(sp, _port_inputs(tp, raw))
    for name in ("node_T", "zone_T", "h_front", "h_back", "q_front", "q_back"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)), rtol=0,
                                   atol=ATOL, err_msg=name)
    load = np.asarray(ref.ideal_load)
    assert np.abs(load).max() > 10.0
    np.testing.assert_allclose(got.ideal_load.numpy(), load, rtol=0, atol=ATOL * np.abs(load).max())


def _scaled(b, u=1.2):
    return dataclasses.replace(b, surfaces=dataclasses.replace(b.surfaces, seg_u=b.surfaces.seg_u * u))


def test_update_building_matches_heatx(pair):
    """Both runners swap in the building with seg_u x 1.2 and march the same
    hour: the port equals heatx's runner after its own update_building."""
    case, (th, rh), (tp, rp), raw, start = pair
    T0, zT0 = start
    sh = th.initial_state()._replace(node_T=jnp.asarray(T0), zone_T=jnp.asarray(zT0))
    sp = tp.initial_state()
    sp.node_T, sp.zone_T = torch.as_tensor(T0), torch.as_tensor(zT0)
    before = rp.march(sp, _port_inputs(tp, raw))
    try:
        rh.update_building(_scaled(th.building))
        rp.update_building(_scaled(tp.building))
        ref = rh.march(sh, _heatx_inputs(th, raw))
        got = rp.march(sp, _port_inputs(tp, raw))
    finally:
        # The runners are the module's: put the compiled buildings back.
        rh.update_building(th.building)
        rp.update_building(tp.building)
    for name in ("node_T", "zone_T", "h_front", "h_back", "q_front", "q_back"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)), rtol=0,
                                   atol=ATOL, err_msg=name)
    load = np.asarray(ref.ideal_load)
    np.testing.assert_allclose(got.ideal_load.numpy(), load, rtol=0, atol=ATOL * np.abs(load).max())
    assert float((got.node_T - before.node_T).abs().max()) > 1e-6  # the swap reached the march


@pytest.fixture(scope="module")
def city():
    tm = ThermalModel(testing.build_demand_city(4, 10), config=SimConfig(dtype=torch.float64), device="cpu")
    return tm, testing.demand_inputs(tm.building, 24)


def test_24_marches_equal_one_run_day(city):
    tm, seq = city
    final, zt, loads = tm.fast_runner(mode="trbdf2", substeps=4, hours=24).run(
        tm.initial_state(), seq, collect_loads=True)
    r1 = tm.fast_runner(mode="trbdf2", substeps=4, hours=1)
    st, rows = tm.initial_state(), []
    for h in range(24):
        st = r1.march(st, tree_map(lambda v: v[h] if v.ndim and v.shape[0] == 24 else v, seq))
        rows.append(st.zone_T)
    np.testing.assert_allclose(torch.stack(rows).numpy(), zt.numpy(), rtol=0, atol=1e-12)
    for name in ("node_T", "zone_T", "h_front", "q_back"):
        np.testing.assert_allclose(getattr(st, name).numpy(), getattr(final, name).numpy(), rtol=0,
                                   atol=1e-12, err_msg=name)
    np.testing.assert_allclose(st.ideal_load.numpy(), loads[-1].numpy(), rtol=0, atol=1e-9)


def test_update_building_equals_a_fresh_runner(city):
    tm, seq = city
    kw = dict(mode="trbdf2", substeps=4, hours=24)
    runner = tm.fast_runner(**kw)
    _, zt0 = runner.run(tm.initial_state(), seq)[:2]
    b2 = _scaled(tm.building)
    runner.update_building(b2)
    final, zt = runner.run(tm.initial_state(), seq)[:2]
    t2 = ThermalModel.from_building(b2, device="cpu")
    ref_final, ref_zt = t2.fast_runner(**kw).run(t2.initial_state(), seq)[:2]
    np.testing.assert_allclose(zt.numpy(), ref_zt.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(final.node_T.numpy(), ref_final.node_T.numpy(), rtol=0, atol=1e-12)
    assert float((zt - zt0).abs().max()) > 1e-3  # the swap reached the march


def test_update_building_refuses_structure_changes(city):
    """A layout change and an operand-shape change raise heatx's ValueErrors,
    message for message."""
    tm, _ = city
    runner = tm.fast_runner(mode="trbdf2", substeps=4, hours=1)
    th = heatx.ThermalModel(_hx_demand_city(4, 10), n=1, config=heatx.SimConfig(dtype=jnp.float64))
    rh = th.fast_runner(mode="trbdf2", substeps=4, hours=1, interpret=True,
                        block_size=day_march.min_block_lanes(tm.building))

    def compiled(model, hx_model):
        return (ThermalModel(model, config=SimConfig(dtype=torch.float64), device="cpu").building,
                heatx.ThermalModel(hx_model, n=1, config=heatx.SimConfig(dtype=jnp.float64)).building)

    cases = (
        ("identical blocked layout", compiled(testing.build_demand_city(4, 11), _hx_demand_city(4, 11))),
        ("different operand shapes", compiled(testing.build_city_model(4, 10), bench.build_city_model(4, 10))),
    )
    for what, (port_b, hx_b) in cases:
        with pytest.raises(ValueError, match=what) as ref:
            rh.update_building(hx_b)
        with pytest.raises(ValueError, match=what) as got:
            runner.update_building(port_b)
        assert str(got.value) == str(ref.value)


def test_chunk_grad_after_a_swap_equals_a_fresh_runner():
    tm = ThermalModel(testing.build_city_model(4, 10), config=SimConfig(dtype=torch.float64), device="cpu")
    seq = testing.bench_inputs(tm.building, 48)
    xs = tree_map(lambda v: v.reshape((2, 24) + v.shape[1:]) if v.ndim and v.shape[0] == 48
                  else torch.broadcast_to(v, (2,) + v.shape), seq)
    kw = dict(mode="trbdf2_refresh", substeps=4, hours=24, refresh_every=2)

    def loss(zt, xs):
        return torch.mean((zt - 21.0) ** 2)

    out = []
    for swap in (True, False):
        b2 = _scaled(tm.building, 0.8)
        if swap:
            model, runner = tm, tm.fast_runner(**kw)
            runner.update_building(b2)
        else:
            model = ThermalModel.from_building(b2, device="cpu")
            runner = model.fast_runner(**kw)
        base, u0 = b2, torch.as_tensor(b2.surfaces.seg_u)

        def apply_params(p, base=base, u0=u0):
            return dataclasses.replace(base, surfaces=dataclasses.replace(base.surfaces, seg_u=u0 * p["u"]))

        val, g = chunked_value_and_grad(
            None, {"u": torch.tensor(1.1, dtype=torch.float64)}, model.initial_state(), xs,
            forward_fn=runner.chunk_forward(apply_params, loss),
            backward_fn=runner.chunk_grad(apply_params, loss),
        )
        out.append((float(val), float(g["u"])))
    assert out[0][1] != 0.0
    np.testing.assert_allclose(out[0], out[1], rtol=1e-12)

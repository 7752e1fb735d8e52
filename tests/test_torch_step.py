"""The port's XLA-path parity integrator (``engine.step``) against heatx's,
f64, CPU.

heatx's ``step.substep``/``march``/``run`` (one ``lax.scan`` per run) and
the port's (Python loops over tensor operations) take the same buildings and
seeded inputs, at the coarse discretization (6 stability sub-steps per
hour), and agree to 1e-9 K on node and zone temperatures:

* the 4-zone city, parity with 1, 2 and the adaptive number of no-mass
  iterations: one sub-step, then a 6-hour run;
* thermostats with inter-zone mixing: ``collect_loads`` (loads within 1e-9
  of their largest), with the compiled flows and with a ``mix_vol``
  schedule;
* interior MRT with the operative-temperature history;
* the controlled city (in-run shading, with a ``shade_sp`` schedule, and
  ventilation gates).
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
from heatx.engine import step as hx_step
from heatx_torch import SimConfig, ThermalModel, testing
from heatx_torch.engine import step as step_mod

torch.set_num_threads(1)

ATOL_K = 1e-9
HOURS = 6
COARSE = dict(max_dx=0.5, min_dt=900.0)


def _models(hx_model, port_model, **cfg):
    """heatx's ThermalModel and the port's (CPU) of one building, f64."""
    htm = heatx.ThermalModel(hx_model, config=heatx.SimConfig(dtype=jnp.float64, **COARSE, **cfg))
    ptm = ThermalModel(port_model, config=SimConfig(dtype=torch.float64, **COARSE, **cfg), device="cpu")
    assert htm.dt_subdivisions == ptm.dt_subdivisions <= 8
    return htm, ptm


def _weather(S, hours=HOURS, seed=5):
    rng = np.random.default_rng(seed)
    return dict(
        t_out=rng.uniform(-5.0, 12.0, hours), wind_speed=rng.uniform(0.0, 6.0, hours),
        wind_direction=rng.uniform(0.0, 6.28, hours), sol_front=rng.uniform(0.0, 500.0, (hours, S)),
        ir_front=rng.uniform(260.0, 380.0, (hours, S)),
    )


def _sequences(htm, ptm, **kw):
    T = len(kw["t_out"])
    return htm.inputs_sequence(T, **kw), ptm.inputs_sequence(T, **kw)


def _close(got, ref, atol=ATOL_K, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0, atol=atol, err_msg=what)


def _check_state(got, ref, mask):
    _close(got.zone_T, ref.zone_T, what="zone_T")
    _close(got.node_T.numpy() * mask, np.asarray(ref.node_T) * mask, what="node_T")
    for name in ("h_front", "h_back", "q_front", "q_back"):
        _close(getattr(got, name), getattr(ref, name), atol=1e-8, what=name)


@pytest.mark.parametrize("iters", [1, 2, None], ids=["iters1", "iters2", "adaptive"])
def test_parity_substep_and_run_match_heatx(iters):
    htm, ptm = _models(bench.build_city_model(4, 4), testing.build_city_model(4, 4),
                       nomass_fixed_iters=iters)
    S = htm.building.n_surfaces
    w = _weather(S)
    hseq, pseq = _sequences(htm, ptm, **w)
    mask = np.asarray(htm.building.surfaces.node_mask)

    # one sub-step from a scattered state
    rng = np.random.default_rng(1)
    node_T = np.where(mask, rng.uniform(5.0, 30.0, mask.shape), 0.0)
    zone_T = rng.uniform(16.0, 26.0, htm.building.n_zones)
    hs = htm.initial_state()._replace(node_T=jnp.asarray(node_T), zone_T=jnp.asarray(zone_T))
    ps = dataclasses.replace(ptm.initial_state(), node_T=torch.as_tensor(node_T),
                             zone_T=torch.as_tensor(zone_T))
    hi = jax.tree_util.tree_map(lambda v: v[0], hx_step._with_time_axis_mix(hseq))
    pi = step_mod._step(step_mod._with_time_axis_mix(pseq), 0)
    ref = jax.jit(hx_step.substep)(htm._device(), hs, w["t_out"][0], w["wind_speed"][0],
                                   w["wind_direction"][0], hi)
    got = step_mod.substep(ptm._device(), ps, w["t_out"][0], w["wind_speed"][0],
                           w["wind_direction"][0], pi)
    _check_state(got, ref, mask)

    # a run: every main step's zone temperatures and the final state
    ref_final, ref_hist = htm.run(htm.initial_state(), hseq)
    final, hist = ptm.run(ptm.initial_state(), pseq)
    assert tuple(hist.shape) == (HOURS, 4)
    _close(hist, ref_hist, what="zone_T history")
    _check_state(final, ref_final, mask)
    assert np.ptp(hist.numpy()) > 1.0


def _hx_thermostat_model():
    """testing.build_thermostat_model on heatx's classes."""
    m = bench.build_city_model(4, 4)
    H = heatx.IdealHeaterCooler
    m.add_hvac(H("t0", ["z0"], heat_setpoint=20.0, cool_setpoint=26.0))
    m.add_hvac(H("t1", ["z1"], heat_setpoint=21.0, cool_setpoint=25.0, max_heating=300.0))
    m.add_hvac(H("t2", ["z2"], heat_setpoint=19.0, cool_setpoint=23.0, max_cooling=100.0))
    m.add_mixing("z0", "z1", 0.02, bidirectional=False)
    m.add_mixing("z1", "z0", 0.03, bidirectional=False)
    m.add_mixing("z3", "z2", 0.01, bidirectional=False)
    return m


@pytest.mark.parametrize("schedule", [False, True], ids=["compiled_flows", "mix_vol_schedule"])
def test_run_loads_and_mixing_match_heatx(schedule):
    htm, ptm = _models(_hx_thermostat_model(), testing.build_thermostat_model(), nomass_fixed_iters=2)
    b = ptm.building
    assert b.has_ideal_hvac and b.mix_src.size == 3
    w = _weather(b.n_surfaces, seed=6)
    w["lum_power"] = np.full(b.n_luminaires, 150.0)
    if schedule:  # per-step flows, off at hour 2
        w["mix_vol"] = np.outer(np.linspace(0.5, 3.0, HOURS), b.mix_vol) * (np.arange(HOURS) != 2)[:, None]
    hseq, pseq = _sequences(htm, ptm, **w)
    assert tuple(pseq.mix_vol.shape) == ((HOURS, 3) if schedule else (3,))
    ref_final, (ref_zt, ref_ld) = htm.run(htm.initial_state(), hseq, collect_loads=True)
    final, (zt, ld) = ptm.run(ptm.initial_state(), pseq, collect_loads=True)
    _close(zt, ref_zt, what="zone_T history")
    scale = float(np.abs(np.asarray(ref_ld)).max())
    assert scale > 10.0  # the thermostats act
    _close(ld, ref_ld, atol=1e-9 * scale, what="loads")
    _check_state(final, ref_final, np.asarray(htm.building.surfaces.node_mask))


def test_run_interior_mrt_and_operative_match_heatx():
    htm, ptm = _models(testing.build_two_zone_model(hmb), testing.build_two_zone_model(),
                       nomass_fixed_iters=None, interior_mrt=True)
    w = _weather(ptm.building.n_surfaces, seed=7)
    hseq, pseq = _sequences(htm, ptm, **w)
    ref_final, (ref_zt, ref_top) = htm.run(htm.initial_state(), hseq, collect_operative=True)
    final, (zt, top) = ptm.run(ptm.initial_state(), pseq, collect_operative=True)
    _close(zt, ref_zt, what="zone_T history")
    _close(top, ref_top, what="operative history")
    assert np.abs(top.numpy() - zt.numpy()).max() > 0.05  # the MRT is not the air
    _check_state(final, ref_final, np.asarray(htm.building.surfaces.node_mask))


def test_run_controlled_city_matches_heatx():
    htm, ptm = _models(
        testing.build_controlled_city(2, 3, base=bench.build_city_model(2, 3), classes=hmb),
        testing.build_controlled_city(2, 3), nomass_fixed_iters=2,
    )
    b = ptm.building
    assert b.has_zone_shading and b.has_vent_gates
    seq = testing.controlled_city_inputs(b, 12)
    sp = np.where(np.arange(12)[:, None] % 4 == 3, 1e9, 20.0) * np.ones((12, b.n_surfaces))
    kw = {f.name: getattr(seq, f.name).numpy() for f in dataclasses.fields(seq)
          if getattr(seq, f.name) is not None}
    kw["shade_sp"] = sp
    hseq, pseq = _sequences(htm, ptm, **kw)
    ref_final, ref_zt = htm.run(htm.initial_state(), hseq)
    final, zt = ptm.run(ptm.initial_state(), pseq)
    _close(zt, ref_zt, what="zone_T history")
    _check_state(final, ref_final, np.asarray(htm.building.surfaces.node_mask))
    # both controls toggle on this run
    d = testing.control_decisions(b, zt.numpy(), seq.t_out.numpy(), seq.wind_speed.numpy(), shade_sp=sp)
    assert 0 < d["shade"].sum() < d["shade"].size and 0 < d["vent"].sum() < d["vent"].size


def test_make_run_and_march_fns():
    """``make_march_fn``/``make_run_fn`` are ``march``/``run`` of the building."""
    tm = ThermalModel(testing.build_city_model(2, 3), config=testing.coarse_config(nomass_fixed_iters=2),
                      device="cpu")
    b = tm._device()
    seq = tm.inputs_sequence(3, **_weather(tm.building.n_surfaces, hours=3))
    s = tm.initial_state()
    for t in range(3):
        s = step_mod.make_march_fn(b)(s, step_mod._step(step_mod._with_time_axis_mix(seq), t))
    final, hist = step_mod.make_run_fn(b)(tm.initial_state(), seq)
    assert torch.equal(final.node_T, s.node_T) and torch.equal(hist[-1], s.zone_T)

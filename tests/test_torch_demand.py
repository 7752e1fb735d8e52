"""Thermostats, demand, setpoint schedules and inter-zone mixing: the port's
plain day march, its plain day adjoint and ``FastRunner.run(collect_loads=
True)`` against heatx's Pallas kernels in interpret mode, f64, CPU.

ONE heatx kernel configuration serves the march and the adjoint:
``testing.build_thermostat_model`` (4 zones x 4 surfaces; thermostats on
three zones, one with 300 W of heating that a cold start exceeds, one with
100 W of cooling; an uncontrolled zone; a bidirectional mixing pair and a
one-way flow) with ``scheduled_setpoints=True``, 2 hours of 2 sub-steps,
trbdf2_refresh k=1.  The seeded start state and the per-hour setpoint rows
put zone-sub-steps on every branch (heating and cooling, free and clamped,
deadband; counted and printed, none on a tie).

Tolerances: temperatures 1e-9 K; loads and every adjoint output 1e-9 of max
|ref| (the port uses expm1 and lane-order sums where heatx uses a series and
one-hot matmuls: round-off, ~1e-13 measured).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heatx
from heatx.build.layout import compile_building as hx_compile
from heatx.ops import pallas_adjoint, pallas_step
from heatx_torch import SimConfig, ThermalModel, convert, testing
from heatx_torch.build.layout import compile_building
from heatx_torch.ops import day_adjoint, day_march
from torch_thermostat_case import heatx_thermostat_model, lanes, unzones, zones
from torch_reference import unoptimized

torch.set_num_threads(1)

ATOL = 1e-9  # K
RTOL = 1e-9  # of max |ref|: loads and adjoint outputs
HOURS, SUB = 2, 2
KW = dict(substeps=SUB, mode="trbdf2_refresh", hours=HOURS, refresh_every=1, scheduled_setpoints=True)
ZONE_T0 = np.array([18.0, 19.0, 27.0, 21.0])
# Per-hour setpoints [hours, Z]: hour 0 the compiled ones; hour 1 moves z0's
# band far below its landed 20 C (cooling, unclamped) and opens z1's (deadband).
SP_HEAT = np.array([[20.0, 21.0, 19.0, 22.0], [5.0, 10.0, 19.0, 22.0]])
SP_COOL = np.array([[26.0, 25.0, 23.0, 24.0], [12.0, 30.0, 23.0, 24.0]])


def _case(b, N):
    """Seeded inputs and cotangents in surface/zone order."""
    rng = np.random.default_rng(21)
    S, Z = b.n_surfaces, b.n_zones
    mask = np.asarray(b.surfaces.node_mask)
    return dict(
        weather=[rng.uniform(lo, hi, HOURS * SUB) for lo, hi in ((-5, 10), (0, 8), (0, 6.28))],
        sol_front=rng.uniform(0, 400, (HOURS, S)), sol_back=rng.uniform(0, 50, (HOURS, S)),
        ir_front=rng.uniform(250, 400, (HOURS, S)), ir_back=rng.uniform(250, 400, (HOURS, S)),
        a_gain=rng.uniform(0, 600, (HOURS, Z)), b_gain=rng.uniform(0, 30, (HOURS, Z)),
        T0=np.where(mask, rng.uniform(12, 28, mask.shape), 0.0), zT0=ZONE_T0,
        dT=rng.normal(size=(N, S)), d_zT=rng.normal(size=Z), d_hist=rng.normal(size=(HOURS, Z)),
        d_ld=rng.normal(size=(HOURS, Z)) * 1e-2,
    )


def _blocked(lay, c):
    hi = tuple(c["weather"]) + (
        lanes(lay, c["sol_front"]), lanes(lay, c["sol_back"]), lanes(lay, c["ir_front"]),
        lanes(lay, c["ir_back"]), zones(lay, c["a_gain"]), zones(lay, c["b_gain"]),
        zones(lay, SP_HEAT), zones(lay, SP_COOL),
    )
    cots = (lay.surfaces_to_blocked(c["dT"]), lay.zones_to_blocked(c["d_zT"]),
            zones(lay, c["d_hist"]), zones(lay, c["d_ld"]))
    return lay.surfaces_to_blocked(c["T0"]), lay.zones_to_blocked(c["zT0"]), hi, cots


def _operand_dict(bb, params):
    """heatx make_hour_march operands by name (one node-height part), with
    the mixing matrix and the four thermostat rows after the zone volumes."""
    aux = (["front_oh", "front_ohT"] if bb.front_oh.any() else []) + (
        ["back_oh", "back_ohT"] if bb.back_oh.any() else []
    )
    names = (pallas_step._NODE_NAMES + pallas_step._SURF_NAMES + ["chunk_count"] + aux
             + ["zone_volume", "mix_wt"] + list(convert.CTL_NAMES))
    assert len(names) == len(params)
    return {n: np.asarray(p) for n, p in zip(names, params)}


@pytest.fixture(scope="module")
def heatx_case():
    """heatx's blocked building, kernel operands and forward outputs."""
    hb = hx_compile(heatx_thermostat_model(), n=1, config=heatx.SimConfig(dtype=jnp.float64))
    bb = pallas_step.block_building(hb, block_size=16, node_split=None)
    hm, params = pallas_step.make_hour_march(bb, interpret=True, **KW)
    c = _case(hb, bb.max_nodes)
    T0, zT0, hi, cots = _blocked(bb.layout, c)
    j = jnp.asarray
    out = unoptimized(hm)(params, j(T0), j(zT0), tuple(j(x) for x in hi))
    assert hm.collect_loads and hm.scheduled_setpoints
    T, zT, hq, hist, ld = (np.asarray(out[0]), np.asarray(out[1]).reshape(bb.n_blocks, -1),
                           [np.asarray(x) for x in out[2]], np.asarray(out[3]), np.asarray(out[4]))
    return dict(hb=hb, bb=bb, params=params, case=c, operands=(T0, zT0, hi, cots),
                blocked=dict(T=T, zT=zT, hist=hist, ld=ld))


def _unblock_fwd(lay, S, Z, T, zT, hist, ld):
    return dict(T=lay.surfaces_from_blocked(np.asarray(T), S), zT=unzones(lay, Z, zT),
                hist=unzones(lay, Z, hist), ld=unzones(lay, Z, ld))


def _port_building():
    return compile_building(testing.build_thermostat_model(), n=1, config=SimConfig(dtype=torch.float64))


def _port_march(pb, c, device="cpu", plain=False):
    bb = day_march.block_building(pb, block_size=16)
    hm, params = day_march.make_hour_march(bb, collect_bad=True, device=device, **KW)
    T0, zT0, hi, _ = _blocked(bb.layout, c)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device)

    out = (hm.plain if plain else hm)(params, t(T0), t(zT0), tuple(t(x) for x in hi))
    assert float(out[4].sum()) == 0.0
    assert hm.collect_loads and hm.scheduled_setpoints and len(out) == 6
    return bb, [x.cpu() if torch.is_tensor(x) else x for x in out]


def _check_fwd(got, ref):
    for name in ("T", "zT", "hist"):
        np.testing.assert_allclose(got[name], ref[name], rtol=0, atol=ATOL, err_msg=name)
    np.testing.assert_allclose(got["ld"], ref["ld"], rtol=0, atol=RTOL * np.abs(ref["ld"]).max())


def test_day_march_with_thermostats_schedule_and_mixing_matches_heatx(heatx_case):
    hb, hbb = heatx_case["hb"], heatx_case["bb"]
    ref = _unblock_fwd(hbb.layout, hb.n_surfaces, hb.n_zones, **heatx_case["blocked"])
    pb = _port_building()
    with testing.BranchCounter() as counter:
        bb, out = _port_march(pb, heatx_case["case"])
    print("zone-sub-steps per branch:", counter.counts)
    for name in ("heating", "cooling", "clamped", "deadband"):
        assert counter.counts[name] > 0, counter.counts
    assert counter.counts["ties"] == 0, counter.counts
    got = _unblock_fwd(bb.layout, pb.n_surfaces, pb.n_zones, out[0], out[1], out[3], out[5])
    _check_fwd(got, ref)
    ld = ref["ld"]
    assert ld[:, 1].max() == pytest.approx(300.0, abs=1e-9)  # z1 sat on its capacity
    assert ld[:, 2].min() == pytest.approx(-100.0, abs=1e-9)  # z2 on its cooling capacity
    assert ld[0, 0] > 0.0 and ld[1, 0] < 0.0  # z0 heated freely, then cooled freely:
    np.testing.assert_allclose(ref["hist"][:, 0], [20.0, 12.0], rtol=0, atol=1e-9)  # it landed twice
    assert (ld[:, 3] == 0).all() and (got["ld"][:, 3] == 0).all()  # the uncontrolled zone
    assert np.abs(got["hist"][-1] - ZONE_T0).max() > 0.5  # the march moved the zones


def test_day_march_falls_back_to_compiled_setpoints(heatx_case):
    """A 9-leaf hour-input tuple on a scheduled march reads the compiled rows
    (heatx pallas_step.py:2019-2035): the result of the unscheduled march."""
    pb = _port_building()
    bb = day_march.block_building(pb, block_size=16)
    kw = dict(KW, device="cpu")
    hm_s, params = day_march.make_hour_march(bb, **kw)
    hm_c, _ = day_march.make_hour_march(bb, **dict(kw, scheduled_setpoints=False))
    T0, zT0, hi, _ = (heatx_case["operands"][0], heatx_case["operands"][1],
                      heatx_case["operands"][2], None)
    t = torch.as_tensor
    a = hm_s(params, t(T0), t(zT0), tuple(t(x) for x in hi[:9]))
    b = hm_c(params, t(T0), t(zT0), tuple(t(x) for x in hi[:9]))
    for x, y in zip((a[0], a[1], a[3], a[4]), (b[0], b[1], b[3], b[4])):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="setpoint-driven HVAC"):
        free = compile_building(testing.build_city_model(2, 3), n=1, config=SimConfig(dtype=torch.float64))
        day_march.make_hour_march(day_march.block_building(free), **kw)


def test_convert_runs_port_on_heatx_thermostat_operands(heatx_case):
    """heatx's own operands (``ctl`` rows, dense ``mix_wt``) through
    heatx_torch.convert: the port marches them to heatx's blocked outputs."""
    hbb = heatx_case["bb"]
    params = convert.params_from_kernel_operands(
        _operand_dict(hbb, heatx_case["params"]), hbb.n_blocks, dtype=torch.float64
    )
    assert params.ctl.shape == (4, hbb.n_blocks, hbb.zones_per_block) and params.mix.src.numel() == 3
    hm = day_march.hour_march_for(_port_bb_like(hbb), **KW)
    T0, zT0, hi, _ = heatx_case["operands"]
    t = torch.as_tensor
    out = hm(params, t(T0), t(zT0), tuple(t(x) for x in hi))
    ref = heatx_case["blocked"]
    for name, got in (("T", out[0]), ("zT", out[1]), ("hist", out[3])):
        np.testing.assert_allclose(got.numpy(), ref[name], rtol=0, atol=ATOL, err_msg=name)
    np.testing.assert_allclose(out[-1].numpy(), ref["ld"], rtol=0, atol=RTOL * np.abs(ref["ld"]).max())


def _port_bb_like(hbb):
    """The port's blocked building of the same model and block size (its
    layout equals heatx's, tests/test_torch_zone.py)."""
    bb = day_march.block_building(_port_building(), block_size=hbb.block_size)
    np.testing.assert_array_equal(bb.layout.surf_perm, hbb.layout.surf_perm)
    return bb


# -- the adjoint ---------------------------------------------------------------


def _flat(g):
    out = {k: v for k, v in g.items() if k != "d_params"}
    out.update({"p:" + k: v for k, v in g["d_params"].items()})
    return out


ZONE_KEYS = ("d_zT0", "d_zone_volume", "d_a_extra", "d_b_extra", "d_ctl_heat", "d_ctl_cool",
             "d_sp_heat", "d_sp_cool")


def _unblock_grads(lay, S, Z, g):
    return {k: unzones(lay, Z, v) if k in ZONE_KEYS else lay.surfaces_from_blocked(np.asarray(v), S)
            for k, v in g.items()}


@pytest.fixture(scope="module")
def heatx_grads(heatx_case):
    hb, bb = heatx_case["hb"], heatx_case["bb"]
    adj = pallas_adjoint.make_day_adjoint(bb, interpret=True, **KW)
    T0, zT0, hi, cots = heatx_case["operands"]
    j = jnp.asarray
    g = unoptimized(adj)(heatx_case["params"], j(T0), j(zT0), tuple(j(x) for x in hi), tuple(j(c) for c in cots))
    g = {k: np.asarray(v) for k, v in _flat(g).items()}
    return _unblock_grads(bb.layout, hb.n_surfaces, hb.n_zones, g)


def _port_adjoint(pb, c, device="cpu", plain=False):
    bb = day_march.block_building(pb, block_size=16)
    _, params = day_march.make_hour_march(bb, device=device, **KW)
    adj = day_adjoint.make_day_adjoint(bb, device=device, **KW)
    T0, zT0, hi, cots = _blocked(bb.layout, c)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device)

    g = (adj.plain if plain else adj)(params, t(T0), t(zT0), tuple(t(x) for x in hi), tuple(t(x) for x in cots))
    return bb, {k: v.cpu().numpy() for k, v in _flat(g).items()}


def test_day_adjoint_with_load_cotangent_matches_heatx(heatx_case, heatx_grads):
    pb = _port_building()
    bb, got_b = _port_adjoint(pb, heatx_case["case"])
    got = _unblock_grads(bb.layout, pb.n_surfaces, pb.n_zones, got_b)
    assert sorted(got) == sorted(heatx_grads)
    for name, r in heatx_grads.items():
        scale = np.abs(r).max()
        np.testing.assert_allclose(got[name], r, rtol=0, atol=RTOL * scale, err_msg=name)
    # The thermostat and mixing cotangents are live, and the march read the
    # schedule: the compiled rows get nothing.
    for name in ("d_sp_heat", "d_sp_cool", "d_a_extra", "d_b_extra", "d_zone_volume", "p:seg_u"):
        assert np.abs(heatx_grads[name]).max() > 0, name
    assert (got["d_ctl_heat"] == 0).all() and (got["d_ctl_cool"] == 0).all()
    # Exact zeros, nothing non-finite, on padded slots and the uncontrolled
    # zone (z3); a clamped zone-hour is a constant of the setpoint.
    pad = ~bb.zone_valid
    assert pad.any()
    for name, v in got_b.items():
        assert np.isfinite(v).all(), name
    for name in ("d_sp_heat", "d_sp_cool"):
        assert (got_b[name][:, pad] == 0).all(), name
        assert (got[name][:, 3] == 0).all(), name
    assert (got["d_sp_heat"][:, 1] == 0).all()  # z1: clamped in hour 0, deadband in hour 1
    assert got["d_sp_heat"][0, 0] != 0 and got["d_sp_cool"][1, 0] != 0  # z0 landed on both


def test_day_adjoint_compiled_setpoints_get_the_cotangent():
    """Without a schedule the compiled rows take what the schedule rows took:
    d_ctl_* of the unscheduled adjoint equal the sum over hours of d_sp_* of a
    scheduled one fed the compiled setpoints every hour."""
    pb = _port_building()
    bb = day_march.block_building(pb, block_size=16)
    c = _case(pb, bb.max_nodes)
    T0, zT0, hi, cots = (
        [torch.as_tensor(x) for x in part] if isinstance(part, tuple) else torch.as_tensor(part)
        for part in _blocked(bb.layout, c)
    )
    kw = dict(KW, device="cpu")
    _, params = day_march.make_hour_march(bb, **kw)
    sched = day_adjoint.make_day_adjoint(bb, **kw)(params, T0, zT0, hi[:9], cots)
    comp = day_adjoint.make_day_adjoint(bb, **dict(kw, scheduled_setpoints=False))(params, T0, zT0, hi[:9], cots)
    assert "d_sp_heat" not in comp and float(comp["d_ctl_heat"].abs().max()) > 0
    torch.testing.assert_close(comp["d_ctl_heat"], sched["d_sp_heat"].sum(0), rtol=1e-12, atol=0)
    torch.testing.assert_close(comp["d_ctl_cool"], sched["d_sp_cool"].sum(0), rtol=1e-12, atol=0)
    torch.testing.assert_close(comp["dT0"], sched["dT0"], rtol=0, atol=0)


# -- FastRunner.run -------------------------------------------------------------

RUN_KW = dict(mode="trbdf2_refresh", substeps=SUB, hours=2, refresh_every=1, scheduled_setpoints=True)
T_RUN = 4
# A [T, Z] heating schedule that steps up, so zones heat (z1 beyond its 300 W)
# and z2, cooled to 23 C at 100 W at most, drifts.
RUN_HEAT = np.array([[21.0, 22.0, 19.0, 22.0], [22.5, 24.5, 19.0, 22.0],
                     [22.5, 24.5, 20.0, 22.0], [20.0, 21.0, 19.0, 22.0]])


def _run_weather():
    dry, wind, wdir, ghi, ir = testing.synthetic_weather(T_RUN)  # from midnight: no sun
    return dict(t_out=dry, wind_speed=wind, wind_direction=wdir, ghi=ghi, ir_front=ir)


@pytest.fixture(scope="module")
def heatx_run():
    tm = heatx.ThermalModel(heatx_thermostat_model(), n=1, config=heatx.SimConfig(dtype=jnp.float64))
    b = tm.building
    w = _run_weather()
    seq = tm.inputs_sequence(
        T_RUN, t_out=w["t_out"], wind_speed=w["wind_speed"], wind_direction=w["wind_direction"],
        sol_front=w["ghi"][:, None] * testing.solar_factors(b.n_surfaces)[None, :],
        ir_front=w["ir_front"], lum_power=np.full(b.n_luminaires, 150.0),
    )._replace(heat_sp=jnp.asarray(RUN_HEAT))
    runner = tm.fast_runner(block_size=16, interpret=True, **RUN_KW)
    final, zt, loads = runner.run(tm.initial_state(), seq, interp_weather=True, collect_loads=True)
    return final, np.asarray(zt), np.asarray(loads)


def _port_runner(scheduled=True, device="cpu"):
    tm = ThermalModel(testing.build_thermostat_model(), n=1, config=SimConfig(dtype=torch.float64),
                      device=device)
    w = _run_weather()
    seq = tm.inputs(
        t_out=w["t_out"], wind_speed=w["wind_speed"], wind_direction=w["wind_direction"],
        sol_front=w["ghi"][:, None] * testing.solar_factors(tm.building.n_surfaces)[None, :],
        ir_front=w["ir_front"], lum_power=np.full(tm.building.n_luminaires, 150.0),
    )
    return tm, tm.fast_runner(block_size=16, **dict(RUN_KW, scheduled_setpoints=scheduled)), seq


@pytest.mark.parametrize("dispatch_days", [None, 1])
def test_run_collect_loads_matches_heatx(heatx_run, dispatch_days):
    ref_final, ref_zt, ref_loads = heatx_run
    tm, runner, seq = _port_runner()
    final, zt, loads = runner.run(
        tm.initial_state(), seq.replace(heat_sp=torch.as_tensor(RUN_HEAT)), interp_weather=True,
        collect_loads=True, dispatch_days=dispatch_days,
    )
    assert tuple(zt.shape) == (T_RUN, 4) and tuple(loads.shape) == (T_RUN, 4)
    np.testing.assert_allclose(zt.numpy(), ref_zt, rtol=0, atol=ATOL)
    np.testing.assert_allclose(loads.numpy(), ref_loads, rtol=0, atol=RTOL * np.abs(ref_loads).max())
    np.testing.assert_allclose(final.node_T.numpy(), np.asarray(ref_final.node_T), rtol=0, atol=ATOL)
    np.testing.assert_allclose(final.zone_T.numpy(), np.asarray(ref_final.zone_T), rtol=0, atol=ATOL)
    # The final state carries the last hour's load, with or without collect_loads.
    np.testing.assert_allclose(final.ideal_load.numpy(), np.asarray(ref_final.ideal_load), rtol=0,
                               atol=RTOL * np.abs(ref_loads).max())
    assert torch.equal(final.ideal_load, loads[-1])
    assert torch.equal(runner.run(tm.initial_state(), seq.replace(heat_sp=torch.as_tensor(RUN_HEAT)),
                                  interp_weather=True)[0].ideal_load, final.ideal_load)
    assert float(tm.initial_state().ideal_load.abs().max()) == 0.0
    assert ref_loads[:, 1].max() == pytest.approx(300.0, abs=1e-9) and ref_loads[:, 0].max() > 0
    assert (ref_loads[:, 3] == 0).all()
    # Without collect_loads the same march returns the pair.
    assert len(runner.run(tm.initial_state(), seq)) == 2


def test_run_setpoint_schedule_shapes():
    """scalar, [Z] and [1, Z] are constants; [T] is a per-hour schedule for
    every zone, [T, Z] per zone (heatx api.py:1885-1900); None is the
    compiled setpoints, on a scheduled runner as on a plain one."""
    tm, runner, seq = _port_runner()
    st = tm.initial_state()

    def loads(**sp):
        return runner.run(st, seq.replace(**{k: torch.as_tensor(v) for k, v in sp.items()}),
                          collect_loads=True)[2]

    Z = tm.building.n_zones
    const = loads(heat_sp=22.5)
    assert torch.equal(const, loads(heat_sp=np.full(Z, 22.5)))
    assert torch.equal(const, loads(heat_sp=np.full((1, Z), 22.5)))
    assert torch.equal(const, loads(heat_sp=np.full(T_RUN, 22.5)))
    series = np.array([21.0, 22.0, 22.5, 20.0])
    by_hour = loads(heat_sp=series)
    assert torch.equal(by_hour, loads(heat_sp=np.repeat(series[:, None], Z, axis=1)))
    assert not torch.equal(by_hour, const) and float(const[:, 0].max()) > 0
    assert (const[:, 3] == 0).all()  # a schedule on the uncontrolled zone does nothing
    _, plain_runner, _ = _port_runner(scheduled=False)
    assert torch.equal(runner.run(st, seq, collect_loads=True)[2],
                       plain_runner.run(st, seq, collect_loads=True)[2])
    assert torch.equal(loads(cool_sp=24.5, heat_sp=22.5)[:, 3], const[:, 3])


@pytest.mark.parametrize(
    "make, match",
    [
        (lambda tm, r, seq: _port_runner(scheduled=False)[1].run(
            tm.initial_state(), seq.replace(heat_sp=torch.tensor(21.0))), "scheduled_setpoints=True"),
        (lambda tm, r, seq: r.run(tm.initial_state(), seq.replace(
            heat_sp=torch.tensor(27.0), cool_sp=torch.tensor(23.0))), "heating setpoint >= cooling"),
        (lambda tm, r, seq: r.run(tm.initial_state(), seq.replace(heat_sp=torch.full((3, 4), 21.0))),
         "not understood"),
        (lambda tm, r, seq: ThermalModel(
            testing.build_city_model(2, 3), config=SimConfig(dtype=torch.float64), device="cpu"
        ).fast_runner(**RUN_KW), "setpoint-driven HVAC"),
    ],
    ids=["runner_not_scheduled", "order", "shape", "no_thermostats"],
)
def test_run_schedule_errors(make, match):
    tm, runner, seq = _port_runner()
    with pytest.raises(ValueError, match=match):
        make(tm, runner, seq)


# -- on the card ----------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_thermostat_kernel_matches_plain_twin():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    pb = _port_building()
    c = _case(pb, day_march.block_building(pb, block_size=16).max_nodes)
    _, got = _port_march(pb, c, device="cuda")
    _, ref = _port_march(pb, c, device="cuda", plain=True)
    for i in (0, 1, 3):
        np.testing.assert_allclose(got[i].numpy(), ref[i].numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got[5].numpy(), ref[5].numpy(), rtol=0,
                               atol=RTOL * float(ref[5].abs().max()))


@pytest.mark.cuda
def test_cuda_thermostat_adjoint_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    pb = _port_building()
    c = _case(pb, day_march.block_building(pb, block_size=16).max_nodes)
    _, got = _port_adjoint(pb, c, device="cuda")
    _, ref = _port_adjoint(pb, c, device="cuda", plain=True)
    for name, r in ref.items():
        np.testing.assert_allclose(got[name], r, rtol=0, atol=RTOL * np.abs(r).max(), err_msg=name)

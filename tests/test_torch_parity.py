"""Parity mode of the port against heatx, f64, CPU.

The reference-parity integrator (RK4 on the massive nodes, the relaxed
fixed-iteration no-mass solve) goes through both packages on the same seeded
numpy inputs:

* ``ops.tridiag``: the Thomas solve, parallel cyclic reduction and the
  closed-form pair solve, rtol 1e-12;
* ``engine.surface``: ``assemble_K``/``assemble_q``, ``march_nomass`` (1 and
  2 iterations, runs of at most 2 nodes and longer runs), ``rk4_apply``/
  ``march_massive`` and ``march_surfaces``, rtol 1e-12;
* the plain parity day march against heatx's Pallas kernel in interpret
  mode (``mode="parity"``), 1e-9 K: free-float, with thermostats and mixing,
  and on a building with 3- and 4-node no-mass runs;
* ``FastRunner.run(mode="parity")`` against heatx's over 48 h (two 24-hour
  day-kernel calls), 1e-9 K and loads within 1e-9 of max |load|, and the same
  run on heatx's own operands carried across by ``heatx_torch.convert``.

All buildings use the coarse discretization ``testing.coarse_config`` (6
stability sub-steps per hour instead of 118), but for one run of 18 h at the
default discretization.  Tolerances are round-off: the
port's zone update uses expm1 where heatx uses a series below x = 1e-2, and
its zone sums run in lane order where heatx's are one-hot matmuls (~1e-14
measured).
"""

import copy
import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import heatx
from heatx.engine import surface as hx_surf
from heatx.ops import pallas_step
from heatx.ops import tridiag as hx_tridiag
from heatx_torch import SimConfig, ThermalModel, convert, testing
from heatx_torch.engine import surface as surf
from heatx_torch.model.building import Construction as PConstruction
from heatx_torch.ops import day_march, tridiag
from torch_reference import unoptimized

torch.set_num_threads(1)

RTOL = 1e-12
ATOL_K = 1e-9
N, S = 7, 40


def t(a):
    return torch.as_tensor(np.asarray(a))


def close(got, ref, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol, atol=atol)


def hx_coarse(iters=2, **kw):
    return heatx.SimConfig(dtype=jnp.float64, max_dx=0.5, min_dt=900.0, nomass_fixed_iters=iters, **kw)


# ---------------------------------------------------------------------------
# ops.tridiag
# ---------------------------------------------------------------------------


def _system(seed, pairs=False):
    """A seeded diagonally dominant system [N, S]; with ``pairs`` its
    couplings sit only inside disjoint 2-node runs."""
    rng = np.random.default_rng(seed)
    lower, upper = rng.uniform(0.1, 2.0, (2, N, S))
    head = np.zeros((N, S), bool)
    if pairs:
        head[0::3] = rng.uniform(size=head[0::3].shape) < 0.6
        head[N - 1] = False
        tail = np.roll(head, 1, axis=0)
        upper = np.where(head, upper, 0.0)
        lower = np.where(tail, lower, 0.0)
    else:
        tail = head
    diag = -(lower + upper + rng.uniform(0.5, 3.0, (N, S)))
    return lower, diag, upper, rng.normal(size=(N, S)), head, tail


@pytest.mark.parametrize("name", ["solve", "solve_pcr", "solve_runs2"])
def test_tridiag_solvers(name):
    lower, diag, upper, rhs, head, tail = _system(0, pairs=name == "solve_runs2")
    kw = dict(pair_head=head, pair_tail=tail) if name == "solve_runs2" else {}
    ref = getattr(hx_tridiag, name)(lower, diag, upper, rhs, **kw)
    got = getattr(tridiag, name)(t(lower), t(diag), t(upper), t(rhs), **{k: t(v) for k, v in kw.items()})
    close(got, ref)
    # and it solves the system
    x = got.numpy()
    res = diag * x + lower * np.roll(x, 1, 0) * (np.arange(N)[:, None] > 0) \
        + upper * np.roll(x, -1, 0) * (np.arange(N)[:, None] < N - 1)
    np.testing.assert_allclose(res, rhs, rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# engine.surface: the parity integrator on random chunked batches
# ---------------------------------------------------------------------------


def _chunked_batch(seed, long_runs):
    """A random surface batch with its chunk structure, in both packages'
    forms.  ``long_runs`` allows no-mass runs of any length (the sweep
    solver); otherwise at most 2 nodes (the closed-form pair solve)."""
    rng = np.random.default_rng(seed)
    n_nodes = rng.integers(1, N + 1, S)
    node_mask = np.arange(N)[:, None] < n_nodes[None, :]
    massive = node_mask & (rng.uniform(size=(N, S)) < (0.45 if long_runs else 0.7))
    if not long_runs:  # break every third no-mass node of a run
        run = np.zeros(S, int)
        for i in range(N):
            nm = node_mask[i] & ~massive[i]
            run = np.where(nm, run + 1, 0)
            force = run > 2
            massive[i] |= force
            run = np.where(force, 0, run)
    same_chunk = np.zeros((N, S), bool)
    same_chunk[:-1] = node_mask[:-1] & node_mask[1:] & (massive[:-1] == massive[1:])
    nomass = node_mask & ~massive
    starts = nomass & ~np.vstack([np.zeros((1, S), bool), nomass[:-1]])
    cid = np.where(nomass, np.cumsum(starts, axis=0) - 1, -1).astype(np.int32)
    C = max(int(cid.max()) + 1, 1)
    count = np.stack([(cid == c).sum(axis=0) for c in range(C)]).astype(np.float64)
    fields = dict(
        node_mask=node_mask, massive=massive,
        mass=np.where(massive, rng.uniform(2e4, 3e5, (N, S)), 0.0),
        seg_u=np.where(node_mask, rng.uniform(0.5, 20.0, (N, S)), 0.0),
        same_chunk=same_chunk, nomass_chunk_id=cid, nomass_chunk_count=count,
        front_alphas=np.where(node_mask, rng.uniform(0, 0.5, (N, S)), 0.0),
        back_alphas=np.where(node_mask, rng.uniform(0, 0.2, (N, S)), 0.0),
        area=rng.uniform(1, 40, S), perimeter=rng.uniform(0, 30, S),
        cos_tilt=rng.choice([0.0, 1.0, -1.0, 0.2], S), wind_mod=rng.uniform(0.5, 1.5, S),
        eps_front=rng.uniform(0.1, 0.95, S), eps_back=rng.uniform(0.1, 0.95, S),
        rf=np.full(S, 1.67),
        front_code=rng.integers(0, 3, S).astype(np.int32),
        back_code=rng.integers(0, 3, S).astype(np.int32),
        front_temp=rng.uniform(0, 30, S), back_temp=rng.uniform(0, 30, S),
        fixed_h_front=np.where(rng.uniform(size=S) < 0.15, 20.0, np.nan),
        fixed_h_back=np.where(rng.uniform(size=S) < 0.15, 5.0, np.nan),
    )
    static = dict(
        has_cavity=False, has_nomass=bool(nomass.any()), has_massive=bool(massive.any()),
        max_nomass_run=int(count.max()),
    )
    nx, ny = rng.uniform(-1, 1, S), rng.uniform(-1, 1, S)
    hx = SimpleNamespace(**fields, normal=(nx, ny), **static)
    port = SimpleNamespace(**{k: t(v) for k, v in fields.items()}, normal=(t(nx), t(ny)), **static)
    assert (static["max_nomass_run"] > 2) == long_runs
    T = np.where(node_mask, rng.uniform(-5, 35, (N, S)), 0.0)
    return hx, port, T, rng


def _envs(hx, port, T, rng):
    """Both packages' statics, border conditions, radiation coefficients and
    solar forcing of one state."""
    hst, pst = hx_surf.compute_statics(hx), surf.compute_statics(port)
    t_front, t_back = rng.uniform(-10, 30, S), rng.uniform(15, 25, S)
    ir = rng.uniform(250, 400, S)
    h_cfg = heatx.SimConfig(dtype=jnp.float64, kernel_mode=True)
    h_env = hx_surf.border_conditions(hx, T, t_front, t_back, 0.4, 3.0, ir, ir, h_cfg, statics=hst)
    p_env = surf.border_conditions(port, t(T), t(t_front), t(t_back), 0.4, 3.0, t(ir), t(ir),
                                   SimConfig(dtype=torch.float64), statics=pst)
    h_rad = (hx_surf.linearized_rad_coefficient(hx.eps_front, h_env[0]),
             hx_surf.linearized_rad_coefficient(hx.eps_back, h_env[1]))
    p_rad = (surf.linearized_rad_coefficient(port.eps_front, p_env[0]),
             surf.linearized_rad_coefficient(port.eps_back, p_env[1]))
    sol_f, sol_b = rng.uniform(0, 600, S), rng.uniform(0, 100, S)
    h_sq = hx_surf.absorbed_solar_q(hx, sol_f, sol_b)
    p_sq = surf.absorbed_solar_q(port, t(sol_f), t(sol_b))
    weather = dict(t_front=t_front, t_back=t_back, ir=ir, sol_f=sol_f, sol_b=sol_b)
    return SimpleNamespace(hst=hst, pst=pst, h_env=h_env, p_env=p_env, h_rad=h_rad, p_rad=p_rad,
                           h_sq=h_sq, p_sq=p_sq, **weather)


@pytest.mark.parametrize("long_runs", [False, True], ids=["pairs", "long"])
def test_statics_and_assembly(long_runs):
    hx, port, T, rng = _chunked_batch(1, long_runs)
    e = _envs(hx, port, T, rng)
    for name in ("couple_left", "couple_right", "dirichlet_left", "dirichlet_right",
                 "nomass_sel", "pair_head", "pair_tail"):
        np.testing.assert_array_equal(getattr(e.pst, name).numpy(), np.asarray(getattr(e.hst, name)), name)
    assert len(e.pst.chunk_masks) == len(e.hst.chunk_masks)
    for a, b in zip(e.pst.chunk_masks, e.hst.chunk_masks):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    K_h = hx_surf.assemble_K(hx, hx.seg_u, *e.h_env, e.hst)
    K_p = surf.assemble_K(port, port.seg_u, *e.p_env, e.pst)
    for a, b in zip(K_p, K_h):
        close(a, b)
    close(surf.assemble_q(port, t(T), port.seg_u, *e.p_env, *e.p_rad, e.p_sq, e.pst),
          hx_surf.assemble_q(hx, T, hx.seg_u, *e.h_env, *e.h_rad, e.h_sq, e.hst))
    for a, b in zip(surf.assemble_k_q(port, t(T), port.seg_u, *e.p_env, *e.p_rad, e.p_sq, e.pst),
                    hx_surf.assemble_k_q(hx, T, hx.seg_u, *e.h_env, *e.h_rad, e.h_sq, e.hst)):
        close(a, b)


@pytest.mark.parametrize("iters", [1, 2, 4])
@pytest.mark.parametrize("long_runs", [False, True], ids=["pairs", "long"])
def test_march_nomass(long_runs, iters):
    hx, port, T, rng = _chunked_batch(2, long_runs)
    e = _envs(hx, port, T, rng)
    # A loose tolerance makes some chunks converge and stop before the others.
    kw = dict(nomass_fixed_iters=iters, nomass_tol=0.5)
    ref = hx_surf.march_nomass(hx, T, *e.h_env, *e.h_rad, e.h_sq,
                               heatx.SimConfig(dtype=jnp.float64, **kw), statics=e.hst)
    got = surf.march_nomass(port, t(T), *e.p_env, *e.p_rad, e.p_sq,
                            SimConfig(dtype=torch.float64, **kw), statics=e.pst)
    close(got, ref)
    moved = np.abs(np.asarray(ref) - T)
    assert moved[np.asarray(e.hst.nomass_sel)].max() > 0.1
    assert moved[~np.asarray(e.hst.nomass_sel)].max() == 0.0


@pytest.mark.parametrize("flush", [True, False])
def test_march_massive_and_rk4(flush):
    hx, port, T, rng = _chunked_batch(3, True)
    e = _envs(hx, port, T, rng)
    dt = 30.0
    ref = hx_surf.march_massive(hx, T, *e.h_env, *e.h_rad, e.h_sq, dt, statics=e.hst, flush_tiny=flush)
    got = surf.march_massive(port, t(T), *e.p_env, *e.p_rad, e.p_sq, dt, statics=e.pst, flush_tiny=flush)
    close(got, ref)
    assert np.abs(np.asarray(ref) - T)[hx.massive].max() > 1e-3
    lower, diag, upper, q = (rng.normal(size=(N, S)) * s for s in (0.01, 0.02, 0.01, 1e-26 if flush else 1.0))
    x = rng.normal(size=(N, S)) * (1e-24 if flush else 1.0)
    close(surf.rk4_apply(t(lower), t(diag), t(upper), t(q), t(x), flush_tiny=flush),
          hx_surf.rk4_apply(lower, diag, upper, q, x, flush_tiny=flush))


@pytest.mark.parametrize("long_runs,iters", [(False, 1), (True, 2)], ids=["pairs-1", "long-2"])
def test_march_surfaces(long_runs, iters):
    hx, port, T, rng = _chunked_batch(4, long_runs)
    e = _envs(hx, port, T, rng)
    args = (e.t_front, e.t_back, 0.4, 3.0, e.sol_f, e.sol_b, e.ir, e.ir, 30.0)
    ref = hx_surf.march_surfaces(
        hx, T, *args, heatx.SimConfig(dtype=jnp.float64, kernel_mode=True, nomass_fixed_iters=iters),
        solver=hx_tridiag.solve, statics=e.hst,
    )
    got = surf.march_surfaces(
        port, t(T), *(t(a) if isinstance(a, np.ndarray) else a for a in args),
        SimConfig(dtype=torch.float64, nomass_fixed_iters=iters), statics=e.pst,
    )
    close(got, ref)


# ---------------------------------------------------------------------------
# The plain parity day march against heatx's kernel in interpret mode
# ---------------------------------------------------------------------------

HOURS = 3


def _nomass_run(model, mod):
    """testing.build_nomass_run_model's additions, on either package's model."""
    model.add_construction(mod.Construction("clad", ["p2", "p2", "p2", "c20"]))
    model.add_construction(mod.Construction("light", ["p2", "p2", "p2"]))
    walls = {
        "clad0": ("clad", mod.Boundary.outdoor(), mod.Boundary.space_("z0"),
                  [[0, 0, 0], [6, 0, 0], [6, 0, 3], [0, 0, 3]]),
        "light1": ("light", mod.Boundary.outdoor(), mod.Boundary.space_("z1"),
                   [[0, 0, 0], [0, 4, 0], [0, 4, 3], [0, 0, 3]]),
        "between": ("clad", mod.Boundary.space_("z0"), mod.Boundary.space_("z1"),
                    [[0, 0, 0], [4, 0, 0], [4, 0, 2], [0, 0, 2]]),
    }
    for name, (kind, front, back, verts) in walls.items():
        model.add_surface(mod.SurfaceDef(name, kind, front, back, vertices=np.asarray(verts, float)))
    return model


def _hx_thermostat_model():
    """testing.build_thermostat_model on heatx's model classes."""
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
    "nomass_runs": (lambda: _nomass_run(bench.build_city_model(2, 3), heatx),
                    testing.build_nomass_run_model),
}


def _day_inputs(S_, Z, sub, hours=HOURS):
    rng = np.random.default_rng(7)
    return dict(
        weather=[rng.uniform(lo, hi, hours * sub) for lo, hi in ((-5, 15), (0, 8), (0, 6.28))],
        sol_front=rng.uniform(0.0, 500.0, (hours, S_)),
        ir_front=rng.uniform(250.0, 400.0, (hours, S_)),
        a_gain=rng.uniform(100.0, 900.0, Z),
        T0=rng.uniform(12.0, 28.0, (32, S_)),
        zT0=rng.uniform(17.0, 27.0, Z),
    )


def _blocked_inputs(lay, bb, building, inp, hours=HOURS):
    SP = lay.padded_surfaces
    N_ = building.max_nodes
    hi = tuple(inp["weather"]) + (
        np.stack([lay.surfaces_to_blocked(inp["sol_front"][h]) for h in range(hours)]),
        np.zeros((hours, SP)),
        np.stack([lay.surfaces_to_blocked(inp["ir_front"][h]) for h in range(hours)]),
        np.zeros((hours, SP)),
        np.stack([lay.zones_to_blocked(inp["a_gain"])] * hours),
        np.zeros((hours, bb.n_blocks, bb.zones_per_block)),
    )
    T0 = lay.surfaces_to_blocked(np.where(building.surfaces.node_mask, inp["T0"][:N_], 0.0))
    return hi, T0, lay.zones_to_blocked(inp["zT0"])


def _unblock(lay, S_, Z, out, has_loads):
    res = dict(
        T=lay.surfaces_from_blocked(np.asarray(out[0]), S_),
        zT=lay.zones_from_blocked(np.asarray(out[1]), Z),
        hq=np.stack([lay.surfaces_from_blocked(np.asarray(x), S_) for x in out[2]]),
        hist=np.stack([lay.zones_from_blocked(np.asarray(h), Z) for h in out[3]]),
    )
    if has_loads:
        res["loads"] = np.stack([lay.zones_from_blocked(np.asarray(h), Z) for h in out[-1]])
    return res


@pytest.mark.parametrize("iters", [1, 2])
@pytest.mark.parametrize("model", list(MODELS))
def test_plain_parity_day_march_matches_heatx_kernel(model, iters):
    hx_model, port_model = MODELS[model]
    hb = heatx.build.layout.compile_building(hx_model(), n=1, config=hx_coarse(iters))
    pb = ThermalModel(port_model(), config=testing.coarse_config(nomass_fixed_iters=iters),
                      device="cpu").building
    sub = hb.dt_subdivisions
    assert sub == pb.dt_subdivisions <= 8 and hb.dt == pb.dt
    assert hb.surfaces.max_nomass_run == pb.surfaces.max_nomass_run
    assert (pb.surfaces.max_nomass_run > 2) == (model == "nomass_runs")
    inp = _day_inputs(hb.n_surfaces, hb.n_zones, sub)
    has_loads = model == "thermostats_mixing"

    hbb = pallas_step.block_building(hb, block_size=16)
    hm, params = pallas_step.make_hour_march(hbb, interpret=True, mode="parity", hours=HOURS)
    hi, T0, zT0 = _blocked_inputs(hbb.layout, hbb, hb, inp)
    ref = unoptimized(hm)(params, jnp.asarray(T0), jnp.asarray(zT0), tuple(jnp.asarray(x) for x in hi))
    ref = _unblock(hbb.layout, hb.n_surfaces, hb.n_zones, ref, has_loads)

    pbb = day_march.block_building(pb, block_size=32)
    pm, pparams = day_march.make_hour_march(pbb, mode="parity", hours=HOURS, device="cpu")
    assert pm.substeps == sub and pm.dt == pb.dt and pm.parity
    hi, T0, zT0 = _blocked_inputs(pbb.layout, pbb, pb, inp)
    got = pm(pparams, t(T0), t(zT0), tuple(t(x) for x in hi))
    got = _unblock(pbb.layout, pb.n_surfaces, pb.n_zones, got, has_loads)

    for name in ("T", "zT", "hq", "hist"):
        np.testing.assert_allclose(got[name], ref[name], rtol=0, atol=ATOL_K, err_msg=name)
    if has_loads:
        scale = np.abs(ref["loads"]).max()
        assert scale > 10.0  # the thermostats act
        np.testing.assert_allclose(got["loads"], ref["loads"], rtol=0, atol=1e-9 * scale)
    assert np.abs(got["zT"] - inp["zT0"]).max() > 0.1


# ---------------------------------------------------------------------------
# FastRunner.run(mode="parity")
# ---------------------------------------------------------------------------

RUN_HOURS = 48
RUN_KW = dict(mode="parity", hours=24)


def _heatx_seq(tm, hours, demand):
    b = tm.building
    dry, wind, wdir, ghi, ir = testing.synthetic_weather(hours)
    sol = ghi[:, None] * testing.solar_factors(b.n_surfaces)[None, :]
    return tm.inputs_sequence(
        hours, t_out=dry, wind_speed=wind, wind_direction=wdir, sol_front=sol, ir_front=ir,
        hvac_power=np.full(b.n_hvacs, 0.0 if demand else 500.0),
        lum_power=np.full(b.n_luminaires, 150.0),
    )


@pytest.fixture(scope="module")
def heatx_run():
    tm = heatx.ThermalModel(bench.build_city_model(4, 10), n=1, config=hx_coarse(1))
    runner = tm.fast_runner(block_size=16, interpret=True, **RUN_KW)
    final, zone_T = runner.run(tm.initial_state(), _heatx_seq(tm, RUN_HOURS, False), interp_weather=True)
    return tm, final, np.asarray(zone_T)


def _check_run(final, zone_T, ref_final, ref_zone_T):
    np.testing.assert_allclose(zone_T.numpy(), ref_zone_T, rtol=0, atol=ATOL_K)
    for name in ("node_T", "zone_T", "h_front", "h_back", "q_front", "q_back"):
        np.testing.assert_allclose(
            getattr(final, name).numpy(), np.asarray(getattr(ref_final, name)),
            rtol=0, atol=ATOL_K, err_msg=name,
        )


def test_fast_runner_parity_matches_heatx(heatx_run):
    _, ref_final, ref_zone_T = heatx_run
    tm = ThermalModel(testing.build_city_model(4, 10), config=testing.coarse_config(nomass_fixed_iters=1),
                      device="cpu")
    runner = tm.fast_runner(**RUN_KW)
    assert runner._substeps == tm.dt_subdivisions
    final, zone_T = runner.run(tm.initial_state(), testing.bench_inputs(tm.building, RUN_HOURS),
                               interp_weather=True)
    assert tuple(zone_T.shape) == (RUN_HOURS, 4)
    _check_run(final, zone_T, ref_final, ref_zone_T)
    assert np.ptp(zone_T.numpy()) > 1.0


def test_fast_runner_parity_default_discretization_matches_heatx():
    """At the default discretization (118 stability sub-steps per hour, one
    relaxed no-mass iteration: bench.py's parity row) the port follows heatx
    over the first 18 h to 1e-9 K.  The horizon stops there on purpose: from
    hour 19 of the bench day the relaxed no-mass iteration 2-cycles on the
    inner faces of the insulated walls and amplifies round-off in either
    package (heatx started 1e-13 apart from itself parts by 4e-4 K at hour
    25), so later hours cannot be held to round-off."""
    hours = 18
    hx = heatx.ThermalModel(bench.build_city_model(4, 10), n=1,
                            config=heatx.SimConfig(dtype=jnp.float64, nomass_fixed_iters=1))
    _, ref = hx.fast_runner(block_size=16, interpret=True, mode="parity", hours=6).run(
        hx.initial_state(), _heatx_seq(hx, hours, False), interp_weather=True)
    tm = ThermalModel(testing.build_city_model(4, 10), config=SimConfig(dtype=torch.float64, nomass_fixed_iters=1),
                      device="cpu")
    runner = tm.fast_runner(mode="parity", hours=6)
    assert runner._substeps == tm.dt_subdivisions == hx.building.dt_subdivisions == 118
    _, zone_T = runner.run(tm.initial_state(), testing.bench_inputs(tm.building, hours), interp_weather=True)
    np.testing.assert_allclose(zone_T.numpy(), np.asarray(ref), rtol=0, atol=ATOL_K)
    assert np.ptp(zone_T.numpy()) > 1.0


def test_parity_two_cycles_amplify_roundoff_in_both_packages():
    """Why the test above stops at 18 h.  With one relaxed no-mass iteration
    per sub-step the iteration carries on from sub-step to sub-step with the
    factor 1/2 - rad / (2 (U + h)) (K's diagonal has no radiation term), which
    is below -1 on the inner face of the insulated walls once the film
    coefficient falls low: the face 2-cycles and round-off picks the phase.
    Either package, started 1e-13 (relative) apart from itself, stays within
    1e-9 K for 18 h and parts by orders of magnitude more in the hours after;
    the port follows heatx the same way.  ``pytest -s`` prints the gaps."""
    hours, eps = 30, 1e-13
    hx = heatx.ThermalModel(bench.build_city_model(4, 10), n=1,
                            config=heatx.SimConfig(dtype=jnp.float64, nomass_fixed_iters=1))
    hx_runner = hx.fast_runner(block_size=16, interpret=True, mode="parity", hours=6)
    hx_seq, st = _heatx_seq(hx, hours, False), hx.initial_state()
    _, hx_base = hx_runner.run(st, hx_seq, interp_weather=True)
    _, hx_moved = hx_runner.run(st._replace(node_T=st.node_T * (1 + eps)), hx_seq, interp_weather=True)
    tm = ThermalModel(testing.build_city_model(4, 10), config=SimConfig(dtype=torch.float64, nomass_fixed_iters=1),
                      device="cpu")
    runner = tm.fast_runner(mode="parity", hours=6)
    seq, st = testing.bench_inputs(tm.building, hours), tm.initial_state()
    _, base = runner.run(st, seq, interp_weather=True)
    _, moved = runner.run(dataclasses.replace(st, node_T=st.node_T * (1 + eps)), seq, interp_weather=True)
    gaps = {
        "heatx vs heatx started 1e-13 apart": np.abs(np.asarray(hx_base) - np.asarray(hx_moved)).max(axis=1),
        "heatx_torch vs itself started 1e-13 apart": (base - moved).abs().amax(dim=1).numpy(),
        "heatx_torch vs heatx": np.abs(base.numpy() - np.asarray(hx_base)).max(axis=1),
    }
    for name, g in gaps.items():
        print(f"{name}, zone T max |d| per hour: " + " ".join(f"{x:.1e}" for x in g))
        assert g[:18].max() <= ATOL_K, name
        assert g[18:].max() > 100 * g[:18].max(), name


def test_fast_runner_parity_loads_and_schedule_match_heatx():
    """A demand run in parity mode with a scheduled night setback: zone
    temperatures, the per-hour mean loads and the final state's load."""
    hours = 24
    Z = 4
    heat = np.where((np.arange(hours) % 24 < 6)[:, None], 16.0, np.array([20.0, 21.0, 19.0, 22.0]))
    htm = heatx.ThermalModel(_hx_thermostat_model(), n=1, config=hx_coarse(2))
    hr = htm.fast_runner(block_size=16, interpret=True, scheduled_setpoints=True, **RUN_KW)
    hseq = _heatx_seq(htm, hours, True)._replace(heat_sp=jnp.asarray(heat))
    hf, hz, hl = hr.run(htm.initial_state(), hseq, collect_loads=True)

    tm = ThermalModel(testing.build_thermostat_model(), config=testing.coarse_config(), device="cpu")
    seq = testing.demand_inputs(tm.building, hours).replace(heat_sp=t(heat))
    f, z, ld = tm.fast_runner(scheduled_setpoints=True, **RUN_KW).run(
        tm.initial_state(), seq, collect_loads=True)
    assert tuple(ld.shape) == (hours, Z)
    np.testing.assert_allclose(z.numpy(), np.asarray(hz), rtol=0, atol=ATOL_K)
    scale = np.abs(np.asarray(hl)).max()
    assert scale > 100.0
    np.testing.assert_allclose(ld.numpy(), np.asarray(hl), rtol=0, atol=1e-9 * scale)
    np.testing.assert_allclose(f.ideal_load.numpy(), np.asarray(hf.ideal_load), rtol=0, atol=1e-9 * scale)
    assert (np.asarray(hl)[:, 3] == 0).all()  # the uncontrolled zone


def _operand_dict(bb, params):
    """heatx make_hour_march operands by name (one node-height part)."""
    aux = (["front_oh", "front_ohT"] if bb.front_oh.any() else []) + (
        ["back_oh", "back_ohT"] if bb.back_oh.any() else []
    )
    names = pallas_step._NODE_NAMES + pallas_step._SURF_NAMES + ["chunk_count"] + aux + ["zone_volume"]
    assert len(names) == len(params)
    return {n: np.asarray(p) for n, p in zip(names, params)}


def _building_dict(b):
    sb = {f.name: getattr(b.surfaces, f.name) for f in dataclasses.fields(b.surfaces)}
    sb["cav_gas"] = tuple(np.asarray(x) for x in sb["cav_gas"])
    fields = {
        f.name: getattr(b, f.name) for f in dataclasses.fields(b)
        if f.name not in ("surfaces", "discretizations")
    }
    cfg = dataclasses.asdict(b.config)
    cfg["dtype"] = np.dtype(cfg["dtype"])
    return dict(fields, surfaces=sb, config=cfg)


def test_convert_runs_parity_on_heatx_operands(heatx_run):
    """The port marches heatx's own compiled building, SimConfig and kernel
    operands (chunk words from heatx's ``same_chunk``) to heatx's result."""
    tm_hx, ref_final, ref_zone_T = heatx_run
    hb = tm_hx.building
    bb = pallas_step.block_building(hb, block_size=32, node_split=None)
    _, params = pallas_step.make_hour_march(bb, interpret=True, collect_bad=True, **RUN_KW)
    building = convert.building_from_arrays(_building_dict(hb))
    assert building.config.nomass_fixed_iters == 1 and building.config.min_dt == 900.0
    assert building.dt_subdivisions == hb.dt_subdivisions
    tm = ThermalModel.from_building(building, device="cpu")
    runner = tm.fast_runner(block_size=32, **RUN_KW)
    own = runner.params
    runner.params = convert.params_from_kernel_operands(
        _operand_dict(bb, params), bb.n_blocks, dtype=torch.float64
    )
    assert torch.equal(runner.params.lane, own.lane)  # chunk words included
    final, zone_T = runner.run(tm.initial_state(), testing.bench_inputs(building, RUN_HOURS),
                               interp_weather=True)
    _check_run(final, zone_T, ref_final, ref_zone_T)


# ---------------------------------------------------------------------------
# What parity mode refuses
# ---------------------------------------------------------------------------


def _model(config=None, model=None):
    return ThermalModel(model or testing.build_city_model(2, 3),
                        config=config or testing.coarse_config(), device="cpu")


def _cavity_model():
    from heatx_torch.model.building import GasSubstance, Material

    m = testing.build_city_model(1, 3)
    m.add_substance(GasSubstance("gap_air", gas="air"))
    m.add_material(Material("gap", "gap_air", 0.012))
    m.add_construction(PConstruction("double", ["g6", "gap", "g6"]))
    m.surfaces[-1].construction = "double"
    return m


def _shaded_model():
    from heatx_torch.model.building import ZoneShadingControl

    m = testing.build_city_model(2, 3)
    m.add_zone_shading(ZoneShadingControl("s0_2", "z0", transmittance=0.3, setpoint=24.0))
    return m


def _gated_model():
    from heatx_torch.model.building import ZoneVentilationControl

    m = testing.build_city_model(2, 3)
    m.add_vent_control(ZoneVentilationControl("z0", min_indoor=18.0))
    return m


@pytest.mark.parametrize(
    "make, exc, match",
    [
        # The adaptive no-mass loop without HEATX_KERNEL_WHILE=1: heatx's
        # kernel refuses it too.
        (lambda: _model(SimConfig(dtype=torch.float64)).fast_runner(mode="parity"),
         ValueError, "nomass_fixed_iters"),
        (lambda: _model().fast_runner(mode="parity", refresh_every=2), ValueError, "refresh_every"),
        # Interior MRT and in-run shading march in parity mode; the shading's
        # gradient is refused, as in heatx.
        (lambda: _model(testing.coarse_config(interior_mrt=True), model=_shaded_model()).fast_runner(
            mode="parity").chunk_grad(lambda p: None, lambda zt, xs: zt.sum()), ValueError,
         "chunk_grad: in-run zone shading"),
        # Gas cavities march in parity mode; the adaptive loop is refused
        # without HEATX_KERNEL_WHILE=1.
        (lambda: _model(SimConfig(dtype=torch.float64), model=_cavity_model()).fast_runner(
            mode="parity"), ValueError, "nomass_fixed_iters"),
        # The h/q history and the ventilation gates march in parity mode; the
        # gates' gradient is refused, as in heatx.
        (lambda: _model(model=_gated_model()).fast_runner(mode="parity", collect_fluxes=True).chunk_grad(
            lambda p: None, lambda zt, xs: zt.sum()), ValueError, "in-run ventilation gates are not supported"),
        (lambda: _model().fast_runner(mode="exponential"), ValueError, "unknown hour-kernel mode"),
    ],
    ids=["adaptive_loop", "refresh_every", "interior_mrt", "cavities", "collect_fluxes", "unknown_mode"],
)
def test_parity_refusals(make, exc, match):
    with pytest.raises(exc, match=match):
        make()


def test_engine_refuses_adaptive_loop_and_mrt():
    hx, port, T, rng = _chunked_batch(5, False)
    e = _envs(hx, port, T, rng)
    # The adaptive no-mass loop (the default config) is heatx's, and has no
    # gradient, as heatx's while_loop has none.
    ref = hx_surf.march_nomass(hx, T, *e.h_env, *e.h_rad, e.h_sq, heatx.SimConfig(dtype=jnp.float64),
                               statics=e.hst)
    got = surf.march_nomass(port, t(T), *e.p_env, *e.p_rad, e.p_sq, SimConfig(dtype=torch.float64),
                            statics=e.pst)
    close(got, ref)
    with pytest.raises(ValueError, match="no reverse-mode rule"):
        surf.march_nomass(port, t(T).requires_grad_(), *e.p_env, *e.p_rad, e.p_sq,
                          SimConfig(dtype=torch.float64), statics=e.pst)
    # The interior-MRT merge is ported (tests/test_torch_mrt.py holds the
    # network): on a seeded context it gives heatx's environments and
    # emissivities, and None is the identity.
    mf, mb = rng.uniform(size=S) < 0.5, rng.uniform(size=S) < 0.5
    ctx = (mf, rng.uniform(10, 30, S), rng.uniform(0.3, 0.9, S),
           mb, rng.uniform(10, 30, S), rng.uniform(0.3, 0.9, S))
    ref = hx_surf.apply_interior_mrt(hx, *e.h_env, tuple(jnp.asarray(x) for x in ctx))
    got = surf.apply_interior_mrt(port, *e.p_env, tuple(t(x) for x in ctx))
    for r, g in zip((ref[0].rad, ref[1].rad, ref[2], ref[3]), (got[0].rad, got[1].rad, got[2], got[3])):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL)
    assert surf.apply_interior_mrt(port, *e.p_env, None)[2] is port.eps_front


def test_parity_substep_rules():
    """heatx's rules (pallas_step.py:1354-1355): the sub-step count defaults
    to the building's own, and the sub-step length is the building's dt
    whatever the count."""
    tm = _model()
    bb = day_march.block_building(tm.building)
    hm = day_march.hour_march_for(bb, mode="parity")
    assert (hm.substeps, hm.dt) == (tm.dt_subdivisions, tm.dt)
    hm = day_march.hour_march_for(bb, substeps=4, mode="parity")
    assert (hm.substeps, hm.dt) == (4, tm.dt)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            day_march.make_hour_march(bb, mode="parity")


def test_parity_twin_flushes_only_where_its_config_says(monkeypatch):
    """The kernel never flushes tiny RK4 stage values, so ``HourMarch`` turns
    ``flush_tiny`` off in the config its twin reads, whatever the building's
    says; a twin handed a config that flushes does flush."""
    tm = _model()
    assert tm.building.config.flush_tiny
    r = tm.fast_runner(mode="parity", hours=2)
    assert not r.hour_march.config.flush_tiny
    T, zT = r.to_blocked(tm.initial_state())
    hi = r.kernel_inputs(testing.bench_inputs(tm.building, 2), interp_weather=True)[0]
    calls, ftz = [], surf._ftz
    monkeypatch.setattr(surf, "_ftz", lambda x: calls.append(1) or ftz(x))
    keep = r.hour_march.plain(r.params, T, zT, hi)
    kept = len(calls)
    flushing = copy.copy(r.hour_march)
    flushing.config = flushing.config.replace(flush_tiny=True)
    flushed = flushing.plain(r.params, T, zT, hi)
    assert len(calls) - kept == kept + 4 * 2 * r._substeps  # four RK4 stages per sub-step more
    for a, b in zip((keep[0], keep[1], keep[3]), (flushed[0], flushed[1], flushed[3])):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("model", list(MODELS))
def test_cuda_parity_kernel_matches_plain_twin(model):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    tm = ThermalModel(MODELS[model][1](), config=testing.coarse_config(), device="cuda")
    seq = testing.demand_inputs(tm.building, 4, device="cuda")
    outs = [tm.fast_runner(mode="parity", hours=2, use_kernel=uk).run(tm.initial_state(), seq)
            for uk in (True, False)]
    np.testing.assert_allclose(outs[0][1].cpu().numpy(), outs[1][1].cpu().numpy(), rtol=0, atol=ATOL_K)

"""The adaptive no-mass loop of the port against heatx, f64, CPU.

heatx's default no-mass solve (``SimConfig.nomass_fixed_iters=None``)
iterates each run's relaxed fixed point until it converges (mean |dT| below
0.01 K, 0.5 K after 100 iterations), its error grows (the update is
discarded) or 500 iterations have run.  The same seeded inputs go through
both packages:

* ``engine.surface.march_nomass`` on three buildings (runs longer than 2
  nodes, the 9-zone city, gas cavities) from scattered node temperatures,
  with heatx's tolerances and with the escalation after 4 iterations; the
  iteration counts show the escalation and the increase-break acting,
  1e-9 K;
* the plain adaptive parity day march (``HEATX_KERNEL_WHILE=1``) against
  heatx's XLA ``step.march``, one hour and three, 1e-9 K (heatx holds its
  kernel to 5e-8 K there);
* the refusals: the kernel route without ``HEATX_KERNEL_WHILE``, and every
  gradient route through the loop (heatx has no reverse rule for it).

heatx's interpret-mode kernel with the loop is the reference of one
``slow`` test only (at heatx's own 5e-8 K for that kernel): it is too slow
for the default run.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import heatx
import heatx.model.building as hmb
from heatx.engine import state as hx_state
from heatx.engine import step as hx_step
from heatx.engine import surface as hx_surf
from heatx.ops import pallas_step
from heatx_torch import SimConfig, ThermalModel, testing
from heatx_torch.build.layout import compile_building
from heatx_torch.engine import state as state_mod
from heatx_torch.engine import step as step_mod
from heatx_torch.engine import surface as surf
from heatx_torch.ops import day_adjoint, day_march

torch.set_num_threads(1)

ATOL_K = 1e-9
KERNEL_ATOL_K = 5e-8  # heatx's in-kernel loop against its own XLA path (tests/test_pallas_hour.py:167-173)


def _nomass_run_hx():
    """testing.build_nomass_run_model on heatx's classes."""
    m = bench.build_city_model(2, 3)
    m.add_construction(hmb.Construction("clad", ["p2", "p2", "p2", "c20"]))
    m.add_construction(hmb.Construction("light", ["p2", "p2", "p2"]))
    B = hmb.Boundary
    walls = {
        "clad0": ("clad", B.outdoor(), B.space_("z0"), [[0, 0, 0], [6, 0, 0], [6, 0, 3], [0, 0, 3]]),
        "light1": ("light", B.outdoor(), B.space_("z1"), [[0, 0, 0], [0, 4, 0], [0, 4, 3], [0, 0, 3]]),
        "between": ("clad", B.space_("z0"), B.space_("z1"), [[0, 0, 0], [4, 0, 0], [4, 0, 2], [0, 0, 2]]),
    }
    for name, (kind, front, back, verts) in walls.items():
        m.add_surface(hmb.SurfaceDef(name, kind, front, back, vertices=np.asarray(verts, float)))
    return m


MODELS = {
    "nomass_runs": (_nomass_run_hx, testing.build_nomass_run_model),
    "city": (lambda: bench.build_city_model(3, 3), lambda: testing.build_city_model(3, 3)),
    "cavity": (lambda: testing.build_cavity_model(bench.build_city_model(2, 3), hmb),
               testing.build_cavity_model),
}


def _buildings(model, n=1, **cfg):
    hx_model, port_model = MODELS[model]
    hb = heatx.build.layout.compile_building(
        hx_model(), n=n, config=heatx.SimConfig(dtype=jnp.float64, **cfg)
    ).astype(np.float64)
    pb = compile_building(port_model(), n=n, config=SimConfig(dtype=torch.float64, **cfg))
    assert hb.n_surfaces == pb.n_surfaces and hb.max_nodes == pb.max_nodes
    return hb, pb


def _nomass(mod, sb, T, zT, sol, ir, cfg):
    """One sub-step's no-mass solve from the state (T, zT), in either package."""
    st = mod.compute_statics(sb)
    t_front, t_back = mod.boundary_temperatures(sb, zT, -3.0)
    env_f, env_b = mod.border_conditions(sb, T, t_front, t_back, 0.3, 4.0, ir, ir, cfg, statics=st)
    rad_f = mod.linearized_rad_coefficient(sb.eps_front, env_f)
    rad_b = mod.linearized_rad_coefficient(sb.eps_back, env_b)
    q = mod.absorbed_solar_q(sb, sol, sol * 0.0)
    K = None if sb.has_cavity else mod.assemble_K(sb, sb.seg_u, env_f, env_b, st)
    return mod.march_nomass(sb, T, env_f, env_b, rad_f, rad_b, q, cfg, statics=st, K=K)


@pytest.mark.parametrize("escalate", [None, 4], ids=["tolerances", "escalate4"])
@pytest.mark.parametrize("model", list(MODELS))
def test_march_nomass_adaptive_matches_heatx(model, escalate):
    cfg = {} if escalate is None else dict(nomass_escalate_after=escalate)
    hb, pb = _buildings(model, **cfg)
    assert hb.config.nomass_fixed_iters is None and pb.config.nomass_fixed_iters is None
    rng = np.random.default_rng(3)
    S, N = hb.n_surfaces, hb.max_nodes
    T = np.where(hb.surfaces.node_mask, rng.uniform(-5.0, 35.0, (N, S)), 0.0)
    zT, sol, ir = rng.uniform(15, 25, hb.n_zones), rng.uniform(0, 600, S), rng.uniform(250, 400, S)
    ref = jax.jit(functools.partial(_nomass, hx_surf, cfg=hb.config))(hb.surfaces, T, zT, sol, ir)
    db = step_mod.device_building(pb)
    with surf.record_nomass_stops() as rec:
        got = _nomass(surf, db.surfaces, *(torch.as_tensor(a) for a in (T, zT, sol, ir)), pb.config)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL_K)
    iters, present, broke, closest = rec.stacked()
    it = iters[present]
    # Every run takes a stop decision (at its first iteration), an absent one none.
    assert np.isfinite(closest[present]).all() and np.isinf(closest[~present]).all()
    assert (closest[present] >= 0).all()
    assert it.min() >= 1 and rec.loops[0] == it.max() < pb.config.nomass_max_iter
    if escalate is None:
        assert it.max() > 5  # runs that converge slowly, and at different iterations
        assert len(np.unique(it)) > 2
    else:
        # The escalated tolerance (0.5 K) stops most runs still active after
        # 4 iterations at the iteration after.
        assert np.argmax(np.bincount(it.astype(int))) == escalate + 1
    if model == "cavity":  # the cavity U moves with the temperatures: error growth
        assert broke[present].sum() > 0


def _hour_rows(lay, v, hours):
    return torch.as_tensor(np.stack([lay.surfaces_to_blocked(v)] * hours))


@pytest.fixture(scope="module")
def city_hours():
    """heatx's XLA march of the 9-zone city at 4 main steps per hour (as
    heatx's own adaptive-kernel test), three steps from the initial state."""
    hb, pb = _buildings("city", n=4)
    S = hb.n_surfaces
    kw = dict(t_out=-2.0, wind_speed=2.0, sol_front=np.full(S, 200.0), ir_front=np.full(S, 320.0))
    march = jax.jit(hx_step.march)
    state, refs = hx_state.initial_state(hb), []
    for _ in range(3):
        state = march(hb, state, hx_state.default_inputs(hb, **kw))
        refs.append(state)
    return hb, pb, kw, refs


@pytest.mark.parametrize("hours", [1, 3])
def test_plain_adaptive_day_march_matches_heatx_step(city_hours, hours, monkeypatch):
    hb, pb, kw, refs = city_hours
    monkeypatch.setenv("HEATX_KERNEL_WHILE", "1")
    bb = day_march.block_building(pb, block_size=32)
    hm, params = day_march.make_hour_march(bb, mode="parity", hours=hours, device="cpu")
    assert hm.adaptive and hm.substeps == hb.dt_subdivisions
    lay = bb.layout
    S, sub, Z = hb.n_surfaces, hb.dt_subdivisions, hb.n_zones
    s0 = state_mod.initial_state(pb)
    zeros = torch.zeros((hours, bb.n_blocks, bb.zones_per_block), dtype=torch.float64)
    hour_inputs = (
        torch.full((hours * sub,), kw["t_out"], dtype=torch.float64),
        torch.full((hours * sub,), kw["wind_speed"], dtype=torch.float64),
        torch.zeros(hours * sub, dtype=torch.float64),
        _hour_rows(lay, kw["sol_front"], hours), _hour_rows(lay, np.zeros(S), hours),
        _hour_rows(lay, kw["ir_front"], hours), _hour_rows(lay, np.zeros(S), hours), zeros, zeros,
    )
    T0 = torch.as_tensor(lay.surfaces_to_blocked(s0.node_T.numpy()))
    zT0 = torch.as_tensor(lay.zones_to_blocked(s0.zone_T.numpy()))
    with surf.record_nomass_stops() as rec:
        T1, zT1, _, hist = hm(params, T0, zT0, hour_inputs)
    mask = hb.surfaces.node_mask
    ref = refs[hours - 1]
    np.testing.assert_allclose(lay.surfaces_from_blocked(T1.numpy(), S) * mask,
                               np.asarray(ref.node_T) * mask, rtol=0, atol=ATOL_K)
    for h in range(hours):
        np.testing.assert_allclose(lay.zones_from_blocked(hist[h].numpy(), Z),
                                   np.asarray(refs[h].zone_T), rtol=0, atol=ATOL_K)
    assert len(rec.loops) == hours * sub and max(rec.loops) > 10


# ---------------------------------------------------------------------------
# The refusals
# ---------------------------------------------------------------------------


def _adaptive_model(device="cpu"):
    return ThermalModel(testing.build_city_model(2, 3), config=testing.coarse_config(nomass_fixed_iters=None),
                        device=device)


def test_kernel_route_needs_heatx_kernel_while(monkeypatch):
    monkeypatch.delenv("HEATX_KERNEL_WHILE", raising=False)
    tm = _adaptive_model()
    with pytest.raises(ValueError, match="HEATX_KERNEL_WHILE=1"):
        tm.fast_runner(mode="parity", hours=2)
    with pytest.raises(ValueError, match="HEATX_KERNEL_WHILE=1"):
        day_march.make_hour_march(day_march.block_building(tm.building), mode="parity", device="cpu")
    # heatx's gate is the same
    hb, _ = _buildings("city", n=4)
    with pytest.raises(ValueError, match="HEATX_KERNEL_WHILE=1"):
        pallas_step.make_hour_march(pallas_step.block_building(hb, block_size=16), mode="parity",
                                    interpret=True)


def test_gradient_routes_refuse_the_adaptive_loop(monkeypatch):
    monkeypatch.setenv("HEATX_KERNEL_WHILE", "1")
    tm = _adaptive_model()
    runner = tm.fast_runner(mode="parity", hours=2)
    assert runner.hour_march.adaptive
    final, zone_T = runner.run(tm.initial_state(), testing.bench_inputs(tm.building, 2))  # forward runs
    assert torch.isfinite(zone_T).all()
    b = tm.building

    def apply(p):
        return b

    def loss(zt, xs):
        return zt.mean()

    # chunk_forward is a forward sweep and runs, as heatx's does; its paired
    # backward refuses.
    fwd = runner.chunk_forward(apply, loss)
    assert torch.isfinite(fwd(torch.zeros(()), tm.initial_state(), testing.bench_inputs(b, 2))[1])
    with pytest.raises(ValueError, match="no reverse-mode rule"):
        runner.chunk_grad(apply, loss)
    with pytest.raises(ValueError, match="no reverse-mode rule"):
        day_adjoint.make_day_adjoint(runner._bb, substeps=tm.dt_subdivisions, mode="parity", hours=2,
                                     device="cpu")
    # DayMarchFn, and autograd through the plain march and the XLA path
    p = runner.params
    T, zT = runner.to_blocked(tm.initial_state())
    xs = testing.bench_inputs(b, 2)
    hi = next(iter(runner._day_inputs(runner._prepare(xs, False), 0, 1)))
    with pytest.raises(ValueError, match="no reverse-mode rule"):
        day_adjoint.DayMarchFn.apply(runner._grad_march, None, p, p.node, p.surf, p.zone_volume, T, zT, *hi)
    with pytest.raises(ValueError, match="no reverse-mode rule"):
        runner.hour_march.plain(p, T.clone().requires_grad_(), zT, hi)
    state = tm.initial_state()
    state.node_T.requires_grad_()
    seq = tm.inputs_sequence(1, t_out=-2.0)
    with pytest.raises(ValueError, match="no reverse-mode rule"):
        tm.run(state, seq)
    # ... while the fixed-iteration march differentiates
    tf = ThermalModel(testing.build_city_model(2, 3), config=testing.coarse_config(nomass_fixed_iters=2),
                      device="cpu")
    s = tf.initial_state()
    s.node_T.requires_grad_()
    _, hist = tf.run(s, tf.inputs_sequence(1, t_out=-2.0))
    (g,) = torch.autograd.grad(hist.sum(), s.node_T)
    assert torch.isfinite(g).all() and g.abs().max() > 0


@pytest.mark.slow
def test_plain_adaptive_day_march_matches_heatx_interpret_kernel(city_hours, monkeypatch):
    """heatx's in-kernel adaptive loop (interpret mode) against the port's
    plain march, one main step, to heatx's own bound for that kernel against
    its XLA path, 5e-8 K (tests/test_pallas_hour.py; the kernel's
    Mosaic-lowerable op forms part from the XLA path by ~5e-9 K here)."""
    hb, pb, kw, _ = city_hours
    monkeypatch.setenv("HEATX_KERNEL_WHILE", "1")
    hbb = pallas_step.block_building(hb, block_size=16)
    hm, hparams = pallas_step.make_hour_march(hbb, interpret=True)
    S, sub = hb.n_surfaces, hb.dt_subdivisions
    hl = hbb.layout
    s0 = hx_state.initial_state(hb)
    az = jnp.zeros((hbb.n_blocks, hbb.zones_per_block))
    hi = (jnp.full((sub,), -2.0), jnp.full((sub,), 2.0), jnp.zeros((sub,)),
          jnp.asarray(hl.surfaces_to_blocked(kw["sol_front"])), jnp.asarray(hl.surfaces_to_blocked(np.zeros(S))),
          jnp.asarray(hl.surfaces_to_blocked(kw["ir_front"])), jnp.asarray(hl.surfaces_to_blocked(np.zeros(S))),
          az, az)
    T1, zT1, _, _ = hm(hparams, jnp.asarray(hl.surfaces_to_blocked(np.asarray(s0.node_T))),
                       jnp.asarray(hl.zones_to_blocked(np.asarray(s0.zone_T))), hi)
    ref_T = hl.surfaces_from_blocked(np.asarray(T1), S)
    pm = ThermalModel.from_building(pb, device="cpu").fast_runner(mode="parity", hours=1)
    seq = state_mod.default_inputs(pb).replace(
        t_out=torch.full((1,), -2.0, dtype=torch.float64), wind_speed=torch.full((1,), 2.0, dtype=torch.float64),
        wind_direction=torch.zeros(1, dtype=torch.float64),
        sol_front=torch.as_tensor(kw["sol_front"][None]), ir_front=torch.as_tensor(kw["ir_front"][None]),
    )
    final, _ = pm.run(state_mod.initial_state(pb), seq)
    mask = hb.surfaces.node_mask
    np.testing.assert_allclose(final.node_T.numpy() * mask, ref_T * mask, rtol=0, atol=KERNEL_ATOL_K)
    np.testing.assert_allclose(final.zone_T.numpy(), hl.zones_from_blocked(np.asarray(zT1), hb.n_zones),
                               rtol=0, atol=KERNEL_ATOL_K)

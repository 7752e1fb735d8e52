"""The port's ensembles (``heatx_torch.ensemble``) against heatx's, f64, CPU.

heatx's own sizes (tests/test_ensemble.py): three members of
``single_zone_building``, 4-6 main steps.  On both engines (``"xla"``, the
XLA-path integrators on the members laid end to end; ``"kernel"``, the day
march, its plain version here, on the blocks of the members laid end to
end); heatx's runs are compiled once each through
``torch_reference.unoptimized`` and shared by both engines' cases:

* the stacked run matches each member run alone and heatx's ``make_run``,
  parity and TR-BDF2, within 1e-12 K;
* ``run_param_ensemble`` and the population gradient (``autograd.grad`` of
  the members' summed losses) against heatx's ``run_param_ensemble`` and
  ``jax.vmap(jax.grad)``, within 1e-12 K and 1e-9 relative;
* the demand sweep of the heating setpoint: monotone, each member pinned at
  its setpoint, the loads as heatx's; stacked members whose heater capacity
  differs, one clamped;
* per-member inputs (``inputs_axes``): infiltration per member, and outdoor
  air per member, which the kernel route marches in one launch a day per
  weather group;
* heatx's adaptive no-mass loop: each member equal to its solo run;
  the gradient and this case at the coarse discretization of
  ``testing.coarse_config`` (6 parity sub-steps an hour, 118 by default);
* a building of two main steps an hour on the kernel route;
* members wired differently (one member's wall sees outdoor air on both
  faces): the kernel route as the XLA route;
* the refusals: a mismatched layout, ``shard_ensemble`` (ROADMAP A12),
  what the kernel route does not take, and heatx's refusal of a gradient
  through the adaptive no-mass loop on both engines.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_reference import unoptimized

import heatx
from heatx import ensemble as hx_ens
from heatx.build.layout import compile_building as hx_compile
from heatx.engine import state as hx_state
from heatx.model.building import IdealHeaterCooler as HxIdeal
from heatx.testing import SingleZoneOptions as HxOpts
from heatx.testing import TestMat as HxMat
from heatx.testing import single_zone_building as hx_single_zone
from heatx_torch import SimConfig, ThermalModel, ensemble, testing
from heatx_torch.build.layout import B_OUTDOOR, compile_building
from heatx_torch.engine import state as state_mod
from heatx_torch.model.building import IdealHeaterCooler

torch.set_num_threads(1)

ALPHAS = [0.45, 0.7, 0.9]
ENGINES = ["xla", "kernel"]


def _models(alpha=0.7, thermostat=False, construction=None):
    hx_c = [HxMat.polyurethane(0.02), HxMat.concrete(0.1)] if construction is None else construction[0]
    c = ([testing.TestMat.polyurethane(0.02), testing.TestMat.concrete(0.1)]
         if construction is None else construction[1])
    hm = hx_single_zone(HxOpts(construction=hx_c, heating_power=300.0, solar_absorbtance=alpha))
    m = testing.single_zone_building(testing.SingleZoneOptions(
        construction=c, heating_power=300.0, solar_absorbtance=alpha))
    if thermostat:
        hm.add_hvac(HxIdeal("t", ["Space"], heat_setpoint=20.0))
        m.add_hvac(IdealHeaterCooler("t", ["Space"], heat_setpoint=20.0))
    return hm, m


def _compile(models, iters=1, n=1, coarse=False):
    """Both packages' compiles; ``coarse``: ``testing.coarse_config``'s
    discretization (6 parity sub-steps an hour here, 118 at the default)."""
    hm, m = models
    grid = dict(max_dx=0.5, min_dt=900.0) if coarse else {}
    hb = hx_compile(hm, n=n, config=heatx.SimConfig(dtype=jnp.float64, nomass_fixed_iters=iters, **grid))
    return hb.astype(jnp.float64), compile_building(
        m, n=n, config=SimConfig(dtype=torch.float64, nomass_fixed_iters=iters, **grid))


def _channels(b, T):
    return dict(t_out=2.0, wind_speed=3.0, wind_direction=0.7,
                sol_front=np.full(b.n_surfaces, 180.0), ir_front=np.full(b.n_surfaces, 320.0),
                hvac_power=np.full(b.n_hvacs, 300.0))


def _hx_seq(b, T=4, **over):
    one = hx_state.default_inputs(b, **_channels(b, T))
    seq = jax.tree.map(lambda x: jnp.broadcast_to(x, (T,) + jnp.shape(x)), one)
    seq = seq._replace(t_out=jnp.asarray(2.0 + 3.0 * np.sin(np.arange(T)), jnp.float64))
    return seq._replace(**{k: jnp.asarray(v) for k, v in over.items()})


def _seq(b, T=4, **over):
    one = state_mod.default_inputs(b, dtype=torch.float64, **_channels(b, T))
    seq = one.replace(**{
        f.name: getattr(one, f.name)[None].expand((T,) + tuple(getattr(one, f.name).shape))
        for f in dataclasses.fields(one) if getattr(one, f.name) is not None
    })
    seq = seq.replace(t_out=torch.as_tensor(2.0 + 3.0 * np.sin(np.arange(T))))
    return seq.replace(**{k: torch.as_tensor(np.asarray(v)) for k, v in over.items()})


def _close(got, ref, atol=1e-12):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=0, atol=atol)


_HX = {}


def _hx_once(key, fn):
    """heatx's result for ``key``, computed once for both engines' cases."""
    if key not in _HX:
        _HX[key] = fn()
    return _HX[key]


@pytest.fixture(scope="module")
def stacked():
    pairs = [_compile(_models(a)) for a in ALPHAS]
    hx_b = [p[0] for p in pairs]
    b = [p[1] for p in pairs]
    return hx_b, b, hx_ens.stack_pytrees(hx_b), ensemble.stack_pytrees(b)


def _solo(b, mode, sub, engine, seq, T):
    """A member run alone: ThermalModel.run (xla) or a FastRunner (kernel)."""
    tm = ThermalModel.from_building(b, device="cpu")
    if engine == "xla":
        st, hist = tm.run(tm.initial_state(), seq, mode=mode, substeps=sub)
        return st, hist
    fr = tm.fast_runner(mode=mode, substeps=sub, hours=T, adaptive_nomass=True)
    st, hist = fr.run(tm.initial_state(), seq, assert_finite=False)
    return st, hist


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("mode", ["parity", "trbdf2"])
def test_stacked_matches_individual_and_heatx(stacked, mode, engine):
    hx_b, b, hx_be, be = stacked
    sub = None if mode == "parity" else 2
    ref_state, ref_hist = _hx_once(("stacked", mode), lambda: unoptimized(hx_ens.make_run(
        mode=mode, substeps=sub, jit=False))(hx_be, hx_ens.ensemble_initial_state(hx_be, 3), _hx_seq(hx_b[0])))
    st_e = ensemble.ensemble_initial_state(be, 3, device="cpu")
    state, hist = ensemble.make_run(mode=mode, substeps=sub, engine=engine, device="cpu")(
        be, st_e, _seq(b[0]))
    assert ensemble.last_engine == engine
    assert hist.shape == (3, 4, b[0].n_zones)
    _close(hist, ref_hist)
    _close(state.node_T, ref_state.node_T)
    _close(state.zone_T, ref_state.zone_T)
    for i, bi in enumerate(b):
        solo_state, solo_hist = _solo(bi, mode, sub, engine, _seq(bi), 4)
        _close(hist[i], solo_hist.numpy())
        _close(state.node_T[i], solo_state.node_T.numpy())
    assert float((hist[0, -1] - hist[-1, -1]).abs().max()) > 1e-3  # the variants differ


def _u_apply(sb0, xp):
    """Scale seg_u by params["u_scale"] (``xp`` is jnp for heatx's building,
    torch for the port's)."""
    u0 = xp.asarray(sb0.seg_u) if xp is jnp else torch.as_tensor(sb0.seg_u)

    def apply_fn(building, params):
        sb = dataclasses.replace(sb0, seg_u=u0 * params["u_scale"])
        return dataclasses.replace(building, surfaces=sb)
    return apply_fn


@pytest.fixture(scope="module")
def param_case():
    hx_b, b = _compile(_models(), coarse=True)
    scales = np.array([0.8, 1.0, 1.25])

    def hx_loss(u):
        bb = _u_apply(hx_b.surfaces, jnp)(hx_b, {"u_scale": u})
        return jnp.mean(hx_ens._seq_run("parity", None, True)(bb, hx_state.initial_state(hx_b),
                                                              _hx_seq(hx_b))[1])

    ref_hist = unoptimized(lambda u: hx_ens.run_param_ensemble(
        hx_b, _u_apply(hx_b.surfaces, jnp), {"u_scale": u},
        hx_state.initial_state(hx_b), _hx_seq(hx_b))[1])(jnp.asarray(scales))
    return hx_b, b, scales, ref_hist, unoptimized(jax.vmap(jax.grad(hx_loss)))(jnp.asarray(scales))


@pytest.mark.parametrize("engine", ENGINES)
def test_param_ensemble_and_gradient_match_heatx(param_case, engine):
    _, b, scales, ref_hist, ref_grad = param_case
    u = torch.tensor(scales, requires_grad=True)
    st = state_mod.initial_state(b, device="cpu")
    _, hist = ensemble.run_param_ensemble(b, _u_apply(b.surfaces, torch), {"u_scale": u}, st, _seq(b),
                                          engine=engine, device="cpu")
    _close(hist, ref_hist)
    assert float(hist[0, -1, 0].detach()) > float(hist[2, -1, 0].detach())  # more insulation, warmer
    (g,) = torch.autograd.grad(hist.mean(dim=(1, 2)).sum(), u)
    assert float(np.abs(np.asarray(ref_grad)).min()) > 0.0
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_grad), rtol=1e-9, atol=0)


@pytest.mark.parametrize("engine", ENGINES)
def test_demand_sweep_matches_heatx(engine):
    hx_b, b = _compile(_models(thermostat=True))
    T = 6
    over = dict(t_out=np.full(T, -5.0), hvac_power=np.zeros((T, b.n_hvacs)))
    sps = np.array([23.0, 24.0, 25.0])

    def hx_apply(bld, sp):
        return dataclasses.replace(bld, ctl_heat_sp=jnp.full_like(bld.ctl_heat_sp, sp))

    def apply(bld, sp):
        return dataclasses.replace(bld, ctl_heat_sp=torch.as_tensor(bld.ctl_heat_sp) * 0 + sp)

    _, (ref_zt, ref_ld) = _hx_once("demand", lambda: unoptimized(lambda sp: hx_ens.run_param_ensemble(
        hx_b, hx_apply, sp, hx_state.initial_state(hx_b), _hx_seq(hx_b, T, **over),
        mode="trbdf2", substeps=2, collect_loads=True))(jnp.asarray(sps)))
    _, (zt, loads) = ensemble.run_param_ensemble(
        b, apply, torch.as_tensor(sps), state_mod.initial_state(b, device="cpu"), _seq(b, T, **over),
        mode="trbdf2", substeps=2, collect_loads=True, engine=engine, device="cpu")
    assert loads.shape == (3, T, 1)
    totals = loads.sum(dim=(1, 2)).numpy()
    assert totals[0] < totals[1] < totals[2]
    for i, sp in enumerate(sps):
        assert abs(float(zt[i, -1, 0]) - sp) < 1e-6
    scale = float(np.abs(np.asarray(ref_ld)).max())
    _close(loads, ref_ld, atol=1e-12 * scale)
    _close(zt, ref_zt)


@pytest.mark.parametrize("engine", ENGINES)
def test_members_differing_in_heater_capacity_match_heatx(engine):
    """Stacked members whose thermostat capacity (a field the parameter
    blocking does not carry) differs: one member clamps at 5 W, the other
    lands on its setpoint."""
    pairs = [_compile(_models(thermostat=True)) for _ in range(2)]
    for (hb, b), cap in zip(pairs, (5.0, 5000.0)):
        for x in (hb, b):
            x.ctl_max_heat[:] = cap
            x.ctl_heat_sp[:] = 24.0
    T = 6
    over = dict(t_out=np.full(T, -5.0), hvac_power=np.zeros((T, pairs[0][1].n_hvacs)))
    hx_be = hx_ens.stack_pytrees([p[0] for p in pairs])
    be = ensemble.stack_pytrees([p[1] for p in pairs])
    _, (ref_zt, ref_ld) = _hx_once("capacity", lambda: unoptimized(hx_ens.make_run(
        mode="trbdf2", substeps=2, collect_loads=True, jit=False))(
            hx_be, hx_ens.ensemble_initial_state(hx_be, 2), _hx_seq(pairs[0][0], T, **over)))
    _, (zt, loads) = ensemble.ensemble_run(be, ensemble.ensemble_initial_state(be, 2, device="cpu"),
                                           _seq(pairs[0][1], T, **over), mode="trbdf2", substeps=2,
                                           collect_loads=True, engine=engine, device="cpu")
    _close(zt, ref_zt)
    _close(loads, ref_ld, atol=1e-12 * float(np.abs(np.asarray(ref_ld)).max()))
    assert float(loads[0].max()) <= 5.0 + 1e-9 < float(loads[1].max())


@pytest.mark.parametrize("engine", ENGINES)
def test_per_member_inputs_match_heatx(engine):
    """Infiltration [E, T, Z] per member and outdoor air [E, T] per member
    (members 0 and 2 share theirs): the kernel route marches two weather
    groups, each one launch a day."""
    hx_b, b = _compile(_models())
    T, E = 4, 3
    inf = np.array([0.004, 0.01, 0.02])[:, None, None] * np.ones((E, T, b.n_zones))
    t_out = np.stack([2.0 + 3.0 * np.sin(np.arange(T)), np.linspace(-8.0, 0.0, T),
                      2.0 + 3.0 * np.sin(np.arange(T))])
    mask = np.ones((T, b.n_zones), bool)
    temp = np.full((T, b.n_zones), 1.0)
    hx_seq = _hx_seq(hx_b, T, inf_mask=mask, inf_temp=temp)._replace(
        inf_vol=jnp.asarray(inf), t_out=jnp.asarray(t_out))
    hx_axes = jax.tree.map(lambda _: None, _hx_seq(hx_b, T))._replace(inf_vol=0, t_out=0)
    scales = np.array([0.9, 1.0, 1.1])
    ref = _hx_once("per-member", lambda: unoptimized(lambda u, xs: hx_ens.run_param_ensemble(
        hx_b, _u_apply(hx_b.surfaces, jnp), {"u_scale": u},
        hx_state.initial_state(hx_b), xs, inputs_axes=hx_axes)[1])(jnp.asarray(scales), hx_seq))
    seq = _seq(b, T, inf_mask=mask, inf_temp=temp).replace(
        inf_vol=torch.as_tensor(inf), t_out=torch.as_tensor(t_out))
    _, hist = ensemble.run_param_ensemble(
        b, _u_apply(b.surfaces, torch), {"u_scale": torch.as_tensor(scales)},
        state_mod.initial_state(b, device="cpu"), seq, inputs_axes={"inf_vol": 0, "t_out": 0},
        engine=engine, device="cpu")
    _close(hist, ref)
    assert ensemble.last_groups == ([[0, 2], [1]] if engine == "kernel" else None)


@pytest.mark.parametrize("engine", ENGINES)
def test_adaptive_parity_members_match_solo(engine):
    """heatx's default nomass_fixed_iters=None: the loop runs while any member
    is active; each member equals its solo run and heatx's ensemble."""
    pairs = [_compile(_models(a), iters=None, coarse=True) for a in ALPHAS]
    hx_be = hx_ens.stack_pytrees([p[0] for p in pairs])
    be = ensemble.stack_pytrees([p[1] for p in pairs])
    _, ref = _hx_once("adaptive", lambda: unoptimized(hx_ens.make_run(mode="parity", jit=False))(
        hx_be, hx_ens.ensemble_initial_state(hx_be, 3), _hx_seq(pairs[0][0])))
    _, hist = ensemble.ensemble_run(be, ensemble.ensemble_initial_state(be, 3, device="cpu"),
                                    _seq(pairs[0][1]), engine=engine, device="cpu")
    _close(hist, ref)
    for i, (_, bi) in enumerate(pairs):
        _close(hist[i], _solo(bi, "parity", None, engine, _seq(bi), 4)[1].numpy())


def test_two_steps_an_hour_on_the_kernel():
    """n_steps_per_hour = 2: a day-march "hour" is one main step, so the
    kernel route marches such a building as the XLA route does."""
    _, b = _compile(_models(), n=2)
    be = ensemble.stack_pytrees([b, b])
    st = ensemble.ensemble_initial_state(be, 2, device="cpu")
    runs = [ensemble.ensemble_run(be, st, _seq(b, 6), mode="trbdf2", substeps=2, engine=e, device="cpu")[1]
            for e in ENGINES]
    _close(runs[1], runs[0].numpy())


def test_members_wired_differently():
    """Member 1's wall sees outdoor air on both faces, so its zone has no
    surface: the folded building's blocks hold both members, and the kernel
    route marches them as the XLA route does."""
    _, b = _compile(_models())
    be = ensemble.stack_pytrees([b, b])
    outdoor = np.full_like(b.surfaces.back_code, B_OUTDOOR)
    be = dataclasses.replace(be, surfaces=dataclasses.replace(
        be.surfaces, back_code=np.stack([b.surfaces.back_code, outdoor])))
    st = ensemble.ensemble_initial_state(be, 2, device="cpu")
    runs = [ensemble.ensemble_run(be, st, _seq(b), mode="trbdf2", substeps=2, engine=e, device="cpu")[1]
            for e in ENGINES]
    _close(runs[1], runs[0].numpy())
    assert float((runs[0][0] - runs[0][1]).abs().max()) > 1e-3  # the wiring matters


def test_refusals():
    hx_b1, b1 = _compile(_models())
    hx_b2, b2 = _compile(_models(construction=([HxMat.concrete(0.2)], [testing.TestMat.concrete(0.2)])))
    with pytest.raises(ValueError):
        hx_ens.stack_pytrees([hx_b1, hx_b2])
    with pytest.raises(ValueError, match="different compiled structure|leaf shape"):
        ensemble.stack_pytrees([b1, b2])
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        ensemble.shard_ensemble(ensemble.stack_pytrees([b1, b1]), mesh=None)
    be = ensemble.stack_pytrees([b1, b1])
    st = ensemble.ensemble_initial_state(be, 2, device="cpu")
    seq = _seq(b1)
    with pytest.raises(ValueError, match="exponential"):
        ensemble.ensemble_run(be, st, seq, mode="exponential", engine="kernel", device="cpu")
    ensemble.ensemble_run(be, st, seq, mode="exponential", device="cpu")  # auto: the XLA route
    assert ensemble.last_engine == "xla"
    sub = seq.replace(t_out=torch.zeros((4, b1.dt_subdivisions), dtype=torch.float64))
    with pytest.raises(ValueError, match="weather channel t_out"):
        ensemble.ensemble_run(be, st, sub, engine="kernel", device="cpu")
    with pytest.raises(ValueError, match="substeps"):
        ensemble.make_run(mode="parity", substeps=4)
    cap = torch.tensor([1.0, 2.0], dtype=torch.float64, requires_grad=True)

    def apply_cap(bld, c):
        return dataclasses.replace(bld, ctl_max_heat=torch.as_tensor(bld.ctl_max_heat) * c)

    with pytest.raises(ValueError, match="does not differentiate.*ctl_max_heat"):
        ensemble.run_param_ensemble(b1, apply_cap, cap, state_mod.initial_state(b1, device="cpu"), seq,
                                    engine="kernel", device="cpu")
    # heatx's refusal: no gradient through the adaptive no-mass loop, on either engine
    _, ba = _compile(_models(), iters=None, coarse=True)
    u = torch.tensor([1.0, 1.1], dtype=torch.float64, requires_grad=True)
    for engine in ENGINES:
        with pytest.raises(ValueError, match="nomass_fixed_iters"):
            _, hist = ensemble.run_param_ensemble(ba, _u_apply(ba.surfaces, torch), {"u_scale": u},
                                                  state_mod.initial_state(ba, device="cpu"), _seq(ba, 2),
                                                  engine=engine, device="cpu")
            hist.sum().backward()

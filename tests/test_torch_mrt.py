"""Interior MRT in the port against heatx, f64, CPU: the forward path.

* ``engine.surface``: ``carroll_view_factors``, ``mrt_statics``,
  ``interior_mrt``, ``zone_mrt`` and ``apply_interior_mrt`` at rtol 1e-12 on
  seeded states of a two-zone building (a partition that takes part on both
  faces) and the 4-zone city.
* The blocked statics: ``day_march._mrt_static_blocked`` equal to heatx's bit
  for bit (numpy), ``mrt_eps_blocked`` in torch at rtol 1e-12, value and
  vector-Jacobian product against heatx's jnp path.
* The plain day march with ``interior_mrt`` against heatx's XLA integrators,
  as heatx's own tests/test_mrt.py holds its kernel to them: trbdf2 (frozen)
  and trbdf2_refresh k=1 and k=2 at 2 sub-steps against ``imp_march``,
  parity with 1 and 2 no-mass iterations at the coarse discretization
  against ``step.march``, 1e-9 K; and once against heatx's kernel in
  interpret mode with both histories (``collect_hq``, ``collect_operative``),
  on the port's operands and on heatx's carried across by ``convert``.
* ``FastRunner.run(collect_operative=True, collect_fluxes=True)`` against
  heatx's XLA run (zone and operative temperatures, ``ThermalModel.run``)
  and its hour-by-hour march (h/q), with and without MRT physics, 1e-9;
  ``ThermalModel.zone_mrt``; the construction-flag checks.
* The office IDF with ``interior_mrt``: gas cavities and the network in one
  building, the plain day march against heatx's ``imp_march``.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heatx
import heatx.model.building as hmb
from heatx.build.layout import compile_building as hx_compile
from heatx.constants import KELVIN, SIGMA
from heatx.engine import implicit as hx_imp
from heatx.engine import state as hx_state
from heatx.engine import step as hx_step
from heatx.engine import surface as hx_surf
from heatx.model.idf import load_idf as hx_load_idf
from heatx.ops import pallas_step
from heatx_torch import SimConfig, ThermalModel, convert, testing
from heatx_torch.build.layout import compile_building
from heatx_torch.engine import surface as surf
from heatx_torch.engine.state import initial_state
from heatx_torch.model import building as pmb
from heatx_torch.model.idf import load_idf
from heatx_torch.ops import day_march
from torch_reference import unoptimized

torch.set_num_threads(1)

RTOL = 1e-12
ATOL_K = 1e-9
HOURS = 2
IDF = os.path.join(os.path.dirname(__file__), os.pardir, "examples", "data", "office.idf")


def t(a):
    return torch.as_tensor(np.asarray(a))


def _city(mod):
    import bench

    return bench.build_city_model(4, 10) if mod is hmb else testing.build_city_model(4, 10)


MODELS = {"two_zone": testing.build_two_zone_model, "city": _city}


def _pair(name, hx_cfg=None, port_cfg=None):
    hb = hx_compile(MODELS[name](hmb), n=1,
                    config=hx_cfg or heatx.SimConfig(dtype=jnp.float64, interior_mrt=True))
    pb = compile_building(MODELS[name](pmb), n=1,
                          config=port_cfg or SimConfig(dtype=torch.float64, interior_mrt=True))
    return hb, pb


def _surf_view(sb):
    return dataclasses.replace(sb, **{
        f.name: t(getattr(sb, f.name)) for f in dataclasses.fields(sb)
        if isinstance(getattr(sb, f.name), np.ndarray)
    })


def _state(b, seed):
    rng = np.random.default_rng(seed)
    mask = np.asarray(b.surfaces.node_mask)
    return np.where(mask, rng.uniform(5.0, 30.0, mask.shape), 0.0), rng.uniform(15.0, 25.0, b.n_zones)


# ---------------------------------------------------------------------------
# engine.surface
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(MODELS))
def test_network_functions_match_heatx(name):
    hb, pb = _pair(name)
    T, zT = _state(hb, 3)
    Z = hb.n_zones

    @jax.jit
    def ref_fn(T, zT):
        part, idx, eps = hx_surf.mrt_statics(hb.surfaces, Z)
        area2 = jnp.concatenate([hb.surfaces.area, hb.surfaces.area])
        space = jnp.concatenate([hb.surfaces.front_space, hb.surfaces.back_space])
        return dict(
            part=part, idx=idx, eps=eps, F=hx_surf.carroll_view_factors(area2, space, part, Z),
            ctx=hx_surf.interior_mrt(hb.surfaces, T, zT, Z), zone_mrt=hx_surf.zone_mrt(hb.surfaces, T, zT, Z),
        )

    ref = ref_fn(jnp.asarray(T), jnp.asarray(zT))
    sb = _surf_view(pb.surfaces)
    part, idx, eps = surf.mrt_statics(sb, Z)
    np.testing.assert_array_equal(part.numpy(), np.asarray(ref["part"]))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref["idx"]))
    np.testing.assert_allclose(eps.numpy(), np.asarray(ref["eps"]), rtol=RTOL)
    F = surf.carroll_view_factors(torch.cat([sb.area, sb.area]), torch.cat([sb.front_space, sb.back_space]), part, Z)
    np.testing.assert_allclose(F.numpy(), np.asarray(ref["F"]), rtol=RTOL)
    ctx = surf.interior_mrt(sb, t(T), t(zT), Z)
    for got, r in zip(ctx, ref["ctx"]):
        np.testing.assert_allclose(got.numpy(), np.asarray(r), rtol=RTOL)
    zm = surf.zone_mrt(sb, t(T), t(zT), Z)
    np.testing.assert_allclose(zm.numpy(), np.asarray(ref["zone_mrt"]), rtol=RTOL)
    assert np.abs(zm.numpy() - zT).max() > 0.1  # the walls are not at the air temperature
    assert int(part.sum()) >= 2 * Z
    tm = ThermalModel.from_building(pb, device="cpu")
    st = tm.initial_state()
    st.node_T, st.zone_T = t(T), t(zT)
    np.testing.assert_allclose(tm.zone_mrt(st).numpy(), np.asarray(ref["zone_mrt"]), rtol=RTOL)


# ---------------------------------------------------------------------------
# The blocked statics
# ---------------------------------------------------------------------------


def test_blocked_statics_match_heatx():
    hb, pb = _pair("two_zone")
    hbb = pallas_step.block_building(hb, block_size=8, node_split=None)
    pbb = day_march.block_building(pb, block_size=8)
    assert np.array_equal(np.asarray(hbb.layout.surf_perm), np.asarray(pbb.layout.surf_perm))
    for a, b in zip(pbb.mrt_eps, hbb.mrt_eps):
        np.testing.assert_array_equal(a, np.asarray(b))
    NB, ZB = pbb.n_blocks, pbb.zones_per_block
    np.testing.assert_array_equal(
        pbb.mrt_part,
        pallas_step._mrt_part_mask(hbb.surfaces, hbb.front_oh, hbb.back_oh, NB, ZB))
    assert (pbb.mrt_eps[1] > 0).sum() == hb.n_surfaces and (pbb.mrt_eps[0] > 0).sum() == 1

    rng = np.random.default_rng(5)
    sb = pbb.surfaces
    area, ef, eb = (np.asarray(a, np.float64) * rng.uniform(0.8, 1.2, a.shape)
                    for a in (sb.area, sb.eps_front, sb.eps_back))
    oh = [np.asarray(o, np.float64) for o in (pbb.front_oh, pbb.back_oh)]
    W = rng.normal(size=(2, area.size))

    def ref_fn(area, ef, eb):
        out = pallas_step.mrt_eps_blocked_jnp(area, ef, eb, pbb.mrt_part, *oh, NB, ZB)
        return jnp.sum(out[0] * W[0]) + jnp.sum(out[1] * W[1]), out

    (_, ref), g_ref = jax.jit(jax.value_and_grad(ref_fn, argnums=(0, 1, 2), has_aux=True))(area, ef, eb)
    xs = [t(a).requires_grad_() for a in (area, ef, eb)]
    got = day_march.mrt_eps_blocked(*xs, t(pbb.mrt_part), *(t(o) for o in oh), NB, ZB)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), rtol=RTOL, atol=1e-15)
    (got[0] * t(W[0]) + got[1] * t(W[1])).sum().backward()
    for x, r in zip(xs, g_ref):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(r), rtol=1e-10, atol=1e-15)
    assert all(float(x.grad.abs().max()) > 0 for x in xs)


# ---------------------------------------------------------------------------
# The plain day march against heatx's XLA integrators and kernel
# ---------------------------------------------------------------------------


def _hour_inputs(lay, b, sub, hours=HOURS, seed=7):
    """heatx tests/test_mrt.py's inputs: hourly outdoor air and wind, seeded
    sun on the fronts, a cold sky, no gains."""
    S = b.n_surfaces
    t_out = np.array([-3.0, 2.0, 6.0])[:hours]
    ws = np.array([3.0, 1.0, 5.0])[:hours]
    solf = np.random.default_rng(seed).uniform(0.0, 1.0, (hours, S)) * 350.0
    ir = SIGMA * (KELVIN + t_out - 15.0) ** 4
    SP = lay.padded_surfaces
    NB, ZB = lay.n_blocks, lay.zones_per_block
    hi = (
        np.repeat(t_out, sub), np.repeat(ws, sub), np.zeros(hours * sub),
        np.stack([lay.surfaces_to_blocked(solf[h]) for h in range(hours)]), np.zeros((hours, SP)),
        np.repeat(ir[:, None], SP, 1), np.zeros((hours, SP)),
        np.zeros((hours, NB, ZB)), np.zeros((hours, NB, ZB)),
    )
    return hi, dict(t_out=t_out, ws=ws, solf=solf, ir=ir)


def _xla_march(hb, march, raw, hours=HOURS):
    st = hx_state.initial_state(hb)
    base = hx_state.default_inputs(hb)
    f = jax.jit(march)
    for h in range(hours):
        inp = base._replace(t_out=jnp.asarray(raw["t_out"][h]), wind_speed=jnp.asarray(raw["ws"][h]),
                            sol_front=jnp.asarray(raw["solf"][h]),
                            ir_front=jnp.full((hb.n_surfaces,), raw["ir"][h]))
        st = f(hb, st, inp)
    return st


def _port_march(pb, mode, sub, k, **kw):
    bb = day_march.block_building(pb)
    hm, params = day_march.make_hour_march(bb, substeps=sub, mode=mode, hours=HOURS, refresh_every=k,
                                           device="cpu", **kw)
    lay = bb.layout
    T0 = t(lay.surfaces_to_blocked(initial_state(pb).node_T.numpy()))
    zT0 = t(lay.zones_to_blocked(np.full(pb.n_zones, 22.0)))
    hi, raw = _hour_inputs(lay, pb, hm.substeps)
    return hm(params, T0, zT0, tuple(t(x) for x in hi)), lay, raw


XLA_CASES = {
    "trbdf2": ("trbdf2", None, None),
    "refresh_k1": ("trbdf2_refresh", 1, None),
    "refresh_k2": ("trbdf2_refresh", 2, None),
    "parity_1": ("parity", None, 1),
    "parity_2": ("parity", None, 2),
}


@pytest.mark.parametrize("case", sorted(XLA_CASES))
def test_plain_day_march_with_mrt_matches_heatx_xla(case):
    mode, k, iters = XLA_CASES[case]
    if iters is None:
        hx_cfg = heatx.SimConfig(dtype=jnp.float64, interior_mrt=True)
        port_cfg = SimConfig(dtype=torch.float64, interior_mrt=True)
        sub = 2
        xla = lambda b, s, i: hx_imp.imp_march(b, s, i, substeps=sub, refresh_every=k or sub)  # noqa: E731
    else:
        hx_cfg = heatx.SimConfig(dtype=jnp.float64, interior_mrt=True, max_dx=0.5, min_dt=900.0,
                                 nomass_fixed_iters=iters)
        port_cfg = testing.coarse_config(nomass_fixed_iters=iters, interior_mrt=True)
        sub, xla = None, hx_step.march
    hb, pb = _pair("two_zone", hx_cfg, port_cfg)
    out, lay, raw = _port_march(pb, mode, sub, k)
    ref = _xla_march(hb, xla, raw)
    S, Z = pb.n_surfaces, pb.n_zones
    np.testing.assert_allclose(lay.zones_from_blocked(out[1].numpy(), Z), np.asarray(ref.zone_T),
                               rtol=0, atol=ATOL_K)
    np.testing.assert_allclose(lay.surfaces_from_blocked(out[0].numpy(), S), np.asarray(ref.node_T),
                               rtol=0, atol=ATOL_K)
    # The network moves the march: the same building without it parts by more.
    off, _, _ = _port_march(dataclasses.replace(pb, config=pb.config.replace(interior_mrt=False)),
                            mode, sub, k)
    assert float((off[1] - out[1]).abs().max()) > 1e-3


def _hx_operands(hm, bb, params):
    names = pallas_step._NODE_NAMES + pallas_step._SURF_NAMES + ["chunk_count"]
    ops = {n: np.asarray(params[hm.param_index[(0, n)]]) for n in names}
    for n in ("mrt_eps_f", "mrt_eps_b"):
        if (0, n) in hm.param_index:
            ops[n] = np.asarray(params[hm.param_index[(0, n)]])
    for n in ("front_oh", "back_oh"):
        if getattr(bb, n).any():
            ops[n] = np.asarray(getattr(bb, n))
    ops["zone_volume"] = np.asarray(params[-1])
    return ops


def test_plain_day_march_with_mrt_and_histories_matches_heatx_kernel():
    """trbdf2_refresh k=2 at 2 sub-steps over 2 h, with the h/q and
    operative histories, against heatx's kernel in interpret mode; then the
    port on heatx's operands (``convert``, the front side carried as heatx
    gives it)."""
    hb, pb = _pair("two_zone")
    kw = dict(substeps=2, mode="trbdf2_refresh", hours=HOURS, refresh_every=2, collect_hq=True,
              collect_operative=True)
    hbb = pallas_step.block_building(hb, block_size=8, node_split=None)
    hm, params = pallas_step.make_hour_march(hbb, interpret=True, **kw)
    lay = hbb.layout
    hi, _ = _hour_inputs(lay, hb, 2)
    T0 = lay.surfaces_to_blocked(np.asarray(hx_state.initial_state(hb).node_T))
    zT0 = lay.zones_to_blocked(np.full(hb.n_zones, 22.0))
    ref = unoptimized(hm)(params, jnp.asarray(T0), jnp.asarray(zT0), tuple(jnp.asarray(x) for x in hi))
    ref = [np.asarray(x) if not isinstance(x, tuple) else np.stack([np.asarray(y) for y in x]) for x in ref]

    pbb = day_march.block_building(pb, block_size=8)
    pm, pparams = day_march.make_hour_march(pbb, device="cpu", **kw)
    ops = _hx_operands(hm, hbb, params)
    assert "mrt_eps_f" in ops and "mrt_eps_b" in ops
    carried = convert.params_from_kernel_operands(ops, hbb.n_blocks, dtype=torch.float64)
    assert torch.equal(carried.lane, pparams.lane) and torch.equal(carried.mrt_faces, pparams.mrt_faces)
    for p in (pparams, carried):
        got = pm(p, t(T0), t(zT0), tuple(t(x) for x in hi))
        got = [x.numpy() if not isinstance(x, tuple) else torch.stack(x).numpy() for x in got]
        assert len(got) == len(ref) == 6  # T, zT, hq, zt_hist, hq_hist, top
        for name, g, r in zip(("T", "zT", "hq", "zt_hist", "hq_hist", "top"), got, ref):
            np.testing.assert_allclose(g, r, rtol=0, atol=ATOL_K, err_msg=name)
    top, zt = got[5], got[3]
    assert np.abs(top - zt)[..., :2].max() > 0.05  # the walls are colder than the air


# ---------------------------------------------------------------------------
# FastRunner.run with the histories, against heatx's XLA run
# ---------------------------------------------------------------------------

RUN_HOURS = 6


@pytest.mark.parametrize("physics", [True, False], ids=["mrt", "observable_only"])
def test_fast_runner_operative_and_fluxes_match_heatx(physics):
    """heatx tests/test_mrt.py:423's comparison (its kernel against
    ``ThermalModel.run(collect_operative=True)``) for the port, in parity mode
    at the coarse discretization, plus the h/q history against heatx's march
    hour by hour; with MRT physics and as an observable alone."""
    hx_cfg = heatx.SimConfig(dtype=jnp.float64, interior_mrt=physics, max_dx=0.5, min_dt=900.0,
                             nomass_fixed_iters=2)
    port_cfg = testing.coarse_config(nomass_fixed_iters=2, interior_mrt=physics)
    tmh = heatx.ThermalModel(testing.build_two_zone_model(hmb), n=1, config=hx_cfg)
    rng = np.random.default_rng(3)
    S = tmh.building.n_surfaces
    raw = dict(t_out=np.linspace(-5.0, 5.0, RUN_HOURS), wind_speed=np.full(RUN_HOURS, 3.0),
               sol_front=rng.uniform(0.0, 1.0, (RUN_HOURS, S)) * 300.0, ir_front=np.full(RUN_HOURS, 320.0))
    seq = tmh.inputs_sequence(RUN_HOURS, **raw)
    _, (zt_ref, top_ref) = tmh.run(tmh.initial_state(), seq, collect_operative=True)
    march = jax.jit(hx_step.march)
    st, fluxes = tmh.initial_state(), {k: [] for k in ("h_front", "h_back", "q_front", "q_back")}
    base = hx_state.default_inputs(tmh._device())
    for h in range(RUN_HOURS):
        inp = base._replace(t_out=jnp.asarray(raw["t_out"][h]), wind_speed=jnp.asarray(raw["wind_speed"][h]),
                            sol_front=jnp.asarray(raw["sol_front"][h]), ir_front=jnp.full((S,), 320.0))
        st = march(tmh._device(), st, inp)
        for k in fluxes:
            fluxes[k].append(np.asarray(getattr(st, k)))

    tm = ThermalModel(testing.build_two_zone_model(pmb), n=1, config=port_cfg, device="cpu")
    runner = tm.fast_runner(mode="parity", hours=3, collect_operative=True, collect_fluxes=True)
    assert (runner.params.mrt is not None) and runner._bb.mrt_eps is not None
    final, zt, flux, top = runner.run(tm.initial_state(), tm.inputs(**raw), collect_operative=True,
                                      collect_fluxes=True)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zt_ref), rtol=0, atol=ATOL_K)
    np.testing.assert_allclose(top.numpy(), np.asarray(top_ref), rtol=0, atol=ATOL_K)
    for k, r in fluxes.items():
        np.testing.assert_allclose(flux[k].numpy(), np.stack(r), rtol=0, atol=ATOL_K, err_msg=k)
    assert np.abs(top.numpy() - zt.numpy()).max() > 0.01
    # Order and the flags: (final, zone_T, fluxes, operative); fluxes only.
    out = runner.run(tm.initial_state(), tm.inputs(**raw), collect_fluxes=True)
    assert len(out) == 3 and torch.equal(out[2]["q_back"], flux["q_back"])
    with pytest.raises(ValueError, match="collect_operative=True"):
        tm.fast_runner(mode="parity", hours=3).run(tm.initial_state(), tm.inputs(**raw),
                                                   collect_operative=True)
    with pytest.raises(ValueError, match="collect_fluxes=True"):
        tm.fast_runner(mode="parity", hours=3).run(tm.initial_state(), tm.inputs(**raw),
                                                   collect_fluxes=True)


# ---------------------------------------------------------------------------
# The office IDF with interior MRT: gas cavities and the network together
# ---------------------------------------------------------------------------


def test_office_with_mrt_matches_heatx_xla():
    hb = hx_compile(hx_load_idf(IDF).model, n=1, config=heatx.SimConfig(dtype=jnp.float64, interior_mrt=True))
    pb = compile_building(load_idf(IDF).model, n=1, config=SimConfig(dtype=torch.float64, interior_mrt=True))
    assert pb.surfaces.has_cavity
    sub = 2
    out, lay, raw = _port_march(pb, "trbdf2_refresh", sub, 1)
    ref = _xla_march(hb, lambda b, s, i: hx_imp.imp_march(b, s, i, substeps=sub, refresh_h=True), raw)
    np.testing.assert_allclose(lay.zones_from_blocked(out[1].numpy(), pb.n_zones), np.asarray(ref.zone_T),
                               rtol=0, atol=ATOL_K)
    np.testing.assert_allclose(lay.surfaces_from_blocked(out[0].numpy(), pb.n_surfaces),
                               np.asarray(ref.node_T), rtol=0, atol=ATOL_K)
    bb = day_march.block_building(pb)
    assert (bb.mrt_eps[0] > 0).any() and (bb.mrt_eps[1] > 0).any()

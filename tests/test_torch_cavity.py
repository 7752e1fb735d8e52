"""Gas cavities in the port against heatx, f64, CPU.

* ``physics.gas`` and ``physics.cavity``: the gas properties, ``rayleigh``,
  ``nusselt``, ``cavity_convection`` and ``cavity_u_value`` at rtol 1e-12 on
  seeded temperatures, gaps and tilts that reach every branch: the 0-60 deg,
  60 deg, 60-90 deg, 90 deg and 90-180 deg correlations, Ra below 1e4,
  between 1e4 and 5e4 and above 5e4, isothermal faces, and the front face
  warmer (the tilt's complement).  Test points sit away from the ties of
  ``maximum`` (whose subgradient heatx and torch split alike, but a seeded
  test need not rely on it).
* ``engine.surface.segment_u`` with cavities, and its gradient.
* The plain day march against heatx's Pallas kernel in interpret mode on
  ``testing.build_cavity_model`` (cavities of every tilt branch): trbdf2
  (frozen) and trbdf2_refresh k=2, and parity at ``testing.coarse_config``
  with 1 and 2 no-mass iterations, 1e-9 K.
* The plain day adjoint against heatx's adjoint kernel in interpret mode
  (trbdf2, one operator over both sub-steps of the hour), 1e-9 of max |ref|,
  with an exact zero ``seg_u`` cotangent on every cavity segment; the parity
  adjoint against central differences of the parity march.
* ``chunked_value_and_grad`` (trbdf2_refresh k=1) against heatx's, rtol 1e-8.

Two properties of the reference, each shown by a test (ROADMAP C): heatx
evaluates the cavity U on every segment and selects, and on segments without
a cavity (all-zero gas operands) that evaluation is 0/0, so every heatx
gradient through a building with a gas cavity is NaN; the comparisons give
heatx's building benign gas operands off the cavities (which changes none of
its values).  And in float32 heatx's 60 deg correlation overflows above Ra
~2.3e5, where its gradient is 0 x inf = NaN; the port's stays finite.
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
import heatx.model.building as hmb
from heatx.build.layout import compile_building as hx_compile
from heatx.engine import surface as hx_surf
from heatx.engine.adjoint import chunked_value_and_grad as hx_chunked_value_and_grad
from heatx.ops import pallas_adjoint, pallas_step
from heatx.physics import cavity as hx_cavity
from heatx.physics import gas as hx_gas
from heatx_torch import SimConfig, ThermalModel, testing
from heatx_torch.build.layout import compile_building
from heatx_torch.engine import surface as surf
from heatx_torch.engine.adjoint import chunked_value_and_grad, tree_map
from heatx_torch.ops import day_adjoint, day_march
from heatx_torch.physics import cavity, gas
from torch_reference import unoptimized

torch.set_num_threads(1)

RTOL = 1e-12
ATOL_K = 1e-9
ADJ_RTOL = 1e-9  # of max |ref|, per output
GRAD_RTOL = 1e-8
FD_RTOL = 1e-5  # central differences, eps 1e-6, of the f64 march


def t(a):
    return torch.as_tensor(np.asarray(a))


def _models():
    hx = testing.build_cavity_model(bench.build_city_model(2, 3), hmb)
    return hx, testing.build_cavity_model()


def _fill(sb):
    """heatx's surface batch with AIR in a 12 mm vertical gap of emissivity
    0.84 where there is no cavity: the cavity U evaluated there is finite,
    and ``where(seg_is_cavity, ...)`` keeps it out of every value."""
    m = np.asarray(sb.seg_is_cavity)

    def fill(a, v):
        return np.where(m, np.asarray(a), v)

    return dataclasses.replace(
        sb, cav_gas=hx_gas.GasProps(*[fill(f, v) for f, v in zip(sb.cav_gas, hx_gas.AIR)]),
        cav_thickness=fill(sb.cav_thickness, 0.012), cav_height=fill(sb.cav_height, 1.0),
        cav_angle=fill(sb.cav_angle, np.pi / 2), cav_ein=fill(sb.cav_ein, 0.84),
        cav_eout=fill(sb.cav_eout, 0.84),
    )


# ---------------------------------------------------------------------------
# physics.gas, physics.cavity
# ---------------------------------------------------------------------------

# Tilts (deg) in every band of the correlation: 0-60, 60 +- 0.5, 60-90,
# 90 +- 0.5, 90-180; the faces' temperature differences (front minus back,
# K) take both signs and 0; the gaps span Ra from ~1 to ~1e6.
TILTS = (10.0, 45.0, 59.8, 60.3, 75.0, 89.7, 90.2, 120.0, 170.0)
DELTAS = (-20.0, -5.0, -0.5, 0.0, 0.5, 5.0, 20.0)
GAPS = (0.006, 0.012, 0.04, 0.1)


def _grid(gas_name):
    rng = np.random.default_rng(3)
    tilt, dt, gap = (a.ravel() for a in np.meshgrid(TILTS, DELTAS, GAPS, indexing="ij"))
    t_back = rng.uniform(-5.0, 30.0, tilt.size)
    return dict(
        gas=gas_name, gamma=np.radians(tilt), t_front=t_back + dt, t_back=t_back, thickness=gap,
        height=rng.uniform(0.5, 2.0, tilt.size), ein=rng.uniform(0.1, 0.9, tilt.size),
        eout=rng.uniform(0.1, 0.9, tilt.size),
    )


@pytest.mark.parametrize("gas_name", sorted(gas.GASES))
def test_gas_properties_match_heatx(gas_name):
    temp = np.random.default_rng(1).uniform(230.0, 330.0, 50)
    for name in ("thermal_conductivity", "dynamic_viscosity", "heat_capacity", "density"):
        got = getattr(gas, name)(gas.GASES[gas_name], t(temp)).numpy()
        ref = getattr(hx_gas, name)(hx_gas.GASES[gas_name], temp)
        np.testing.assert_allclose(got, ref, rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("gas_name", ["air", "argon", "krypton"])
def test_cavity_convection_and_u_value_match_heatx_on_every_branch(gas_name):
    g = _grid(gas_name)
    hg, pg = hx_gas.GASES[gas_name], gas.GASES[gas_name]

    @jax.jit
    def ref_fn(tf, tb, d, h, gamma, ein, eout):
        ra = hx_gas.rayleigh(hg, tf, tb, d)
        return dict(
            ra=ra, nu=hx_gas.nusselt(ra, gamma, h / d),
            h=hx_gas.cavity_convection(hg, h, d, gamma, tf, tb),
            u=hx_cavity.cavity_u_value(hg, d, h, gamma, ein, eout, tf, tb),
        )

    args = [g[k] for k in ("t_front", "t_back", "thickness", "height", "gamma", "ein", "eout")]
    ref = {k: np.asarray(v) for k, v in ref_fn(*args).items()}
    tf, tb, d, h, gamma, ein, eout = (t(a) for a in args)
    ra = gas.rayleigh(pg, tf, tb, d)
    got = dict(
        ra=ra, nu=gas.nusselt(ra, gamma, h / d), h=gas.cavity_convection(pg, h, d, gamma, tf, tb),
        u=cavity.cavity_u_value(pg, d, h, gamma, ein, eout, tf, tb),
    )
    for name, r in ref.items():
        np.testing.assert_allclose(got[name].numpy(), r, rtol=RTOL, err_msg=name)

    # Every branch is reached: the isothermal Ra, the three Ra ranges of the
    # vertical correlation, and each tilt band on either side of the
    # complement (a warmer front face turns gamma into 180 - gamma).
    ra = ref["ra"]
    assert (ra == 1e-7).any()
    vertical = np.abs(np.degrees(g["gamma"]) - 90.0) < 0.5
    for lo, hi in ((1e-6, 1e4), (1e4, 5e4), (5e4, np.inf)):
        assert (vertical & (ra > lo) & (ra < hi)).any(), (lo, hi)
    eff = np.where(g["t_front"] > g["t_back"], 180.0 - np.degrees(g["gamma"]), np.degrees(g["gamma"]))
    for lo, hi in ((0, 59.5), (59.5, 60.5), (60.5, 89.5), (89.5, 90.5), (90.5, 180)):
        assert ((eff >= lo) & (eff < hi)).any(), (lo, hi)


def test_nusselt_gradient_finite_where_heatx_overflows_in_f32():
    """heatx evaluates the 60 deg correlation on every lane; in float32 its
    ``(Ra/3160)**20.6`` overflows above Ra ~2.3e5 and, though the value is
    right (g rounds to 0), the gradient is 0 x inf = NaN.  The port evaluates
    the selected branch only and gives the 0 heatx rounds g to, so its f32
    gradient is finite and matches the f64 one."""
    ra = np.array([3.0e5, 1.0e6, 5.0e3])
    gamma = np.radians(np.array([60.2, 75.0, 75.0]))
    a_gi = np.full(3, 40.0)

    def hx_grad(dtype):
        f = jax.grad(lambda r: jnp.sum(hx_gas.nusselt(r, jnp.asarray(gamma, dtype), jnp.asarray(a_gi, dtype))))
        return np.asarray(jax.jit(f)(jnp.asarray(ra, dtype)))

    def port_grad(dtype):
        r = torch.tensor(ra, dtype=dtype, requires_grad=True)
        gas.nusselt(r, torch.tensor(gamma, dtype=dtype), torch.tensor(a_gi, dtype=dtype)).sum().backward()
        return r.grad.double().numpy()

    ref32, ref64 = hx_grad(jnp.float32), hx_grad(jnp.float64)
    assert np.isnan(ref32[:2]).all() and np.isfinite(ref32[2])  # the reference's overflow
    np.testing.assert_allclose(port_grad(torch.float64), ref64, rtol=RTOL)
    got32 = port_grad(torch.float32)
    assert np.isfinite(got32).all()
    np.testing.assert_allclose(got32[2], ref32[2], rtol=1e-6)
    # Where f32 overflows, g is 0 in both packages' values, where f64 keeps
    # 0.5 (Ra/3160)^-2.06 (4e-5 at Ra 3e5): the gradient parts by that much.
    np.testing.assert_allclose(got32, ref64, rtol=1e-3)


def test_nusselt_f32_gradient_finite_with_every_band_in_one_call():
    """Lanes of all five tilt bands in one call, f32: each correlation is
    evaluated on every lane (no branch choice waits on the device), so the
    lanes that do not take it must keep its value and gradient finite
    (``1708/safe**2`` of the 0-60 deg one beyond 90 deg, ``(Ra/3160)**20.6``
    of the 60 deg one at large Ra).  The f32 gradient matches the f64 one."""
    ra = np.array([4.0e3, 3.0e5, 2.0e4, 6.0e4, 1.0e6, 8.0e3])
    gamma = np.radians(np.array([30.0, 60.2, 75.0, 90.0, 135.0, 170.0]))
    a_gi = np.full(6, 40.0)

    def port(dtype):
        r = torch.tensor(ra, dtype=dtype, requires_grad=True)
        nu = gas.nusselt(r, torch.tensor(gamma, dtype=dtype), torch.tensor(a_gi, dtype=dtype))
        nu.sum().backward()
        return nu.detach().double().numpy(), r.grad.double().numpy()

    nu32, g32 = port(torch.float32)
    nu64, g64 = port(torch.float64)
    assert np.isfinite(g32).all() and (np.abs(g64) > 0).all()
    np.testing.assert_allclose(nu64, np.asarray(hx_gas.nusselt(jnp.asarray(ra), jnp.asarray(gamma),
                                                               jnp.asarray(a_gi))), rtol=RTOL)
    # 3e5 at 60.2 deg: f32 rounds g to 0 where f64 keeps 4e-5 (the test
    # above), and the value and gradient part by about that much.
    np.testing.assert_allclose(nu32, nu64, rtol=1e-4)
    np.testing.assert_allclose(g32, g64, rtol=1e-3)


# ---------------------------------------------------------------------------
# engine.surface.segment_u
# ---------------------------------------------------------------------------


def _port_sb(pb):
    sb = pb.surfaces
    out = {f.name: getattr(sb, f.name) for f in dataclasses.fields(sb)}
    out = {k: (t(v) if isinstance(v, np.ndarray) else v) for k, v in out.items()}
    out["cav_gas"] = gas.GasProps(*(t(f) for f in sb.cav_gas))
    return type(sb)(**out)


def test_segment_u_with_cavities_matches_heatx():
    hx_model, port_model = _models()
    hb = hx_compile(hx_model, n=1, config=heatx.SimConfig(dtype=jnp.float64))
    pb = compile_building(port_model, n=1, config=SimConfig(dtype=torch.float64))
    assert hb.surfaces.has_cavity and pb.surfaces.has_cavity
    rng = np.random.default_rng(5)
    mask = pb.surfaces.node_mask
    T = np.where(mask, rng.uniform(0.0, 30.0, mask.shape), 0.0)
    air = rng.uniform(15.0, 25.0, pb.n_surfaces)
    W = rng.normal(size=mask.shape)
    cav = pb.surfaces.seg_is_cavity

    psb = _port_sb(pb)
    Tt = t(T).requires_grad_()
    u = surf.segment_u(psb, Tt, t(air))
    (u * t(W)).sum().backward()

    def hx_u(sb, T):
        return hx_surf.segment_u(sb, T, jnp.asarray(air))

    ref = np.asarray(jax.jit(functools.partial(hx_u, hb.surfaces))(jnp.asarray(T)))
    np.testing.assert_allclose(u.detach().numpy(), ref, rtol=RTOL)
    assert (u.detach().numpy()[~cav] == pb.surfaces.seg_u[~cav]).all()
    assert not np.allclose(ref[cav], hb.surfaces.seg_u[cav])  # the cavity U moved with T

    def hx_grad(sb):
        return np.asarray(jax.jit(jax.grad(lambda T: jnp.sum(hx_u(sb, T) * W)))(jnp.asarray(T)))

    # heatx's own gradient is NaN (0/0 off the cavities); with benign gas
    # operands there it is the port's.
    assert np.isnan(hx_grad(hb.surfaces)).any()
    np.testing.assert_allclose(Tt.grad.numpy(), hx_grad(_fill(hb.surfaces)), rtol=RTOL, atol=1e-15)
    assert np.abs(Tt.grad.numpy()[cav]).max() > 0


# ---------------------------------------------------------------------------
# The day march and its adjoint against heatx's kernels (interpret mode)
# ---------------------------------------------------------------------------

HOURS = 2
MARCH_SUB = 4
MARCH_CASES = [("trbdf2", None, None), ("trbdf2_refresh", 2, None), ("parity", None, 1), ("parity", None, 2)]


def _inputs(S, Z, sub, hours=HOURS, seed=7):
    """Seeded inputs: a cold day with sun, and a start state whose nodes
    differ, so every cavity carries heat one way or the other."""
    rng = np.random.default_rng(seed)
    return dict(
        weather=[rng.uniform(lo, hi, hours * sub) for lo, hi in ((-10, 5), (0, 8), (0, 6.28))],
        sol_front=rng.uniform(0.0, 500.0, (hours, S)),
        ir_front=rng.uniform(250.0, 400.0, (hours, S)),
        a_gain=rng.uniform(100.0, 900.0, Z),
        T0=rng.uniform(0.0, 28.0, (32, S)),
        zT0=rng.uniform(17.0, 27.0, Z),
    )


def _blocked(lay, bb, building, inp, hours=HOURS):
    SP = lay.padded_surfaces
    hi = tuple(inp["weather"]) + (
        np.stack([lay.surfaces_to_blocked(inp["sol_front"][h]) for h in range(hours)]),
        np.zeros((hours, SP)),
        np.stack([lay.surfaces_to_blocked(inp["ir_front"][h]) for h in range(hours)]),
        np.zeros((hours, SP)),
        np.stack([lay.zones_to_blocked(inp["a_gain"])] * hours),
        np.zeros((hours, bb.n_blocks, bb.zones_per_block)),
    )
    N = building.max_nodes
    T0 = lay.surfaces_to_blocked(np.where(building.surfaces.node_mask, inp["T0"][:N], 0.0))
    return hi, T0, lay.zones_to_blocked(inp["zT0"])


def _unblock(lay, S, Z, out):
    return dict(
        T=lay.surfaces_from_blocked(np.asarray(out[0]), S),
        zT=lay.zones_from_blocked(np.asarray(out[1]), Z),
        hq=np.stack([lay.surfaces_from_blocked(np.asarray(x), S) for x in out[2]]),
        hist=np.stack([lay.zones_from_blocked(np.asarray(h), Z) for h in out[3]]),
    )


def _configs(iters):
    if iters is None:
        return heatx.SimConfig(dtype=jnp.float64), SimConfig(dtype=torch.float64)
    hx = heatx.SimConfig(dtype=jnp.float64, max_dx=0.5, min_dt=900.0, nomass_fixed_iters=iters)
    return hx, testing.coarse_config(nomass_fixed_iters=iters)


@pytest.mark.parametrize("mode,k,iters", MARCH_CASES)
def test_plain_day_march_with_cavities_matches_heatx_kernel(mode, k, iters):
    hx_model, port_model = _models()
    hx_cfg, port_cfg = _configs(iters)
    hb = hx_compile(hx_model, n=1, config=hx_cfg)
    pb = ThermalModel(port_model, config=port_cfg, device="cpu").building
    sub = hb.dt_subdivisions if mode == "parity" else MARCH_SUB
    inp = _inputs(hb.n_surfaces, hb.n_zones, sub)
    kw = dict(mode=mode, hours=HOURS, refresh_every=k, substeps=None if mode == "parity" else sub)

    hbb = pallas_step.block_building(hb, block_size=16)
    hm, params = pallas_step.make_hour_march(hbb, interpret=True, **kw)
    hi, T0, zT0 = _blocked(hbb.layout, hbb, hb, inp)
    ref = unoptimized(hm)(params, jnp.asarray(T0), jnp.asarray(zT0), tuple(jnp.asarray(x) for x in hi))
    ref = _unblock(hbb.layout, hb.n_surfaces, hb.n_zones, ref)

    pbb = day_march.block_building(pb)
    assert pbb.surfaces.has_cavity  # block_building takes cavity buildings now
    pm, pparams = day_march.make_hour_march(pbb, device="cpu", **kw)
    assert pparams.cav is not None and pm.substeps == sub
    hi, T0, zT0 = _blocked(pbb.layout, pbb, pb, inp)
    got = pm(pparams, t(T0), t(zT0), tuple(t(x) for x in hi))
    got = _unblock(pbb.layout, pb.n_surfaces, pb.n_zones, got)
    for name in ("T", "zT", "hq", "hist"):
        np.testing.assert_allclose(got[name], ref[name], rtol=0, atol=ATOL_K, err_msg=name)
    assert np.abs(got["zT"] - inp["zT0"]).max() > 0.1


ADJ_SUB, ADJ_HOURS = 2, 1


def _flat(g):
    out = {k: v for k, v in g.items() if k != "d_params"}
    out.update({"p:" + k: v for k, v in g["d_params"].items()})
    return out


def _unblock_grads(lay, S, Z, g):
    out = {}
    for k, v in g.items():
        if k in ("d_zT0", "d_zone_volume"):
            out[k] = lay.zones_from_blocked(np.asarray(v), Z)
        elif k in ("d_a_extra", "d_b_extra"):
            out[k] = np.stack([lay.zones_from_blocked(x, Z) for x in np.asarray(v)])
        else:
            out[k] = lay.surfaces_from_blocked(np.asarray(v), S)
    return out


def _cotangents(lay, building, nb, zb, seed=11):
    rng = np.random.default_rng(seed)
    mask = building.surfaces.node_mask
    return (lay.surfaces_to_blocked(np.where(mask, rng.normal(size=mask.shape), 0.0)),
            lay.zones_to_blocked(rng.normal(size=building.n_zones)),
            np.stack([lay.zones_to_blocked(rng.normal(size=building.n_zones)) for _ in range(ADJ_HOURS)]))


def test_plain_adjoint_with_cavities_matches_heatx_kernel():
    """trbdf2 frozen, one operator over the hour's two sub-steps: the
    cavity U's cotangent from both sub-steps goes to the hour-start column
    that built the operator, not to the second sub-step's start.  heatx on its own building
    gives NaN (the reference property above); with benign gas operands off
    the cavities it gives the port's cotangents."""
    hx_model, port_model = _models()
    hb = hx_compile(hx_model, n=1, config=heatx.SimConfig(dtype=jnp.float64))
    pb = compile_building(port_model, n=1, config=SimConfig(dtype=torch.float64))
    kw = dict(substeps=ADJ_SUB, mode="trbdf2", hours=ADJ_HOURS)
    inp = _inputs(hb.n_surfaces, hb.n_zones, ADJ_SUB, hours=ADJ_HOURS)

    bb = pallas_step.block_building(hb, block_size=16)
    bb_filled = dataclasses.replace(bb, surfaces=_fill(bb.surfaces))
    adj = pallas_adjoint.make_day_adjoint(bb_filled, interpret=True, **kw)
    hi, T0, zT0 = _blocked(bb.layout, bb, hb, inp, hours=ADJ_HOURS)
    cots = _cotangents(bb.layout, hb, bb.n_blocks, bb.zones_per_block)
    args = (jnp.asarray(T0), jnp.asarray(zT0), tuple(jnp.asarray(x) for x in hi),
            tuple(jnp.asarray(c) for c in cots) + (None,))
    ref, run = {}, unoptimized(adj)
    for name, b in (("own", bb), ("filled", bb_filled)):
        _, params = pallas_step.make_hour_march(b, interpret=True, **kw)
        ref[name] = _unblock_grads(bb.layout, hb.n_surfaces, hb.n_zones, _flat(run(params, *args)))
    assert any(np.isnan(v).any() for v in ref["own"].values())
    ref = ref["filled"]

    pbb = day_march.block_building(pb, block_size=16)
    _, pparams = day_march.make_hour_march(pbb, device="cpu", **kw)
    padj = day_adjoint.make_day_adjoint(pbb, device="cpu", **kw)
    hi, T0, zT0 = _blocked(pbb.layout, pbb, pb, inp, hours=ADJ_HOURS)
    cots = _cotangents(pbb.layout, pb, pbb.n_blocks, pbb.zones_per_block)
    g = padj(pparams, t(T0), t(zT0), tuple(t(x) for x in hi), tuple(t(c) for c in cots))
    got = _unblock_grads(pbb.layout, pb.n_surfaces, pb.n_zones,
                         {k: v.numpy() for k, v in _flat(g).items()})
    assert sorted(got) == sorted(ref)
    for name, r in ref.items():
        assert np.isfinite(got[name]).all(), name
        scale = np.abs(r).max()
        np.testing.assert_allclose(got[name], r, rtol=0, atol=ADJ_RTOL * scale, err_msg=name)
    cav = pb.surfaces.seg_is_cavity
    assert (got["p:seg_u"][cav] == 0).all() and (ref["p:seg_u"][cav] == 0).all()
    assert np.abs(got["dT0"][cav]).max() > 0


@pytest.mark.parametrize("iters", [1, 2])
def test_plain_parity_adjoint_with_cavities_matches_finite_differences(iters):
    """The parity adjoint through the cavity U re-evaluated at every no-mass
    iteration and before RK4, against central differences of the plain
    parity march along the start state and seg_u."""
    tm = ThermalModel(testing.build_cavity_model(), config=testing.coarse_config(nomass_fixed_iters=iters),
                      device="cpu")
    pb = tm.building
    bb = day_march.block_building(pb)
    sub = pb.dt_subdivisions
    hm, params = day_march.make_hour_march(bb, mode="parity", hours=1, device="cpu")
    adj = day_adjoint.make_day_adjoint(bb, substeps=sub, mode="parity", hours=1, device="cpu")
    inp = _inputs(pb.n_surfaces, pb.n_zones, sub, hours=1)
    hi, T0, zT0 = _blocked(bb.layout, bb, pb, inp, hours=1)
    hi, T0, zT0 = tuple(t(x) for x in hi), t(T0), t(zT0)
    rng = np.random.default_rng(2)
    mask = day_march.bit_rows(params, "node_bits")
    cots = (t(rng.normal(size=T0.shape)) * mask, t(rng.normal(size=zT0.shape)),
            t(rng.normal(size=(1,) + tuple(zT0.shape))))
    g = _flat(adj(params, T0, zT0, hi, cots))
    cav_rows = day_march.bit_rows(params, "cav_bits")
    assert bool(cav_rows.any()) and float(g["p:seg_u"][cav_rows].abs().max()) == 0.0

    def loss(p, T):
        out = hm(p, T, zT0, hi)
        return float((out[0] * cots[0]).sum() + (out[1] * cots[1]).sum() + (out[3] * cots[2]).sum())

    D_T = t(rng.normal(size=T0.shape)) * mask
    D_u = t(rng.normal(size=T0.shape)) * params.node[0]

    def moved_u(e):
        node = params.node.clone()
        node[0] += e * D_u
        return dataclasses.replace(params, node=node)

    eps = 1e-6
    for name, grad, direction, f in (
        ("T0", g["dT0"], D_T, lambda e: loss(params, T0 + e * D_T)),
        ("seg_u", g["p:seg_u"], D_u, lambda e: loss(moved_u(e), T0)),
    ):
        fd = (f(eps) - f(-eps)) / (2 * eps)
        an = float((grad * direction).sum())
        assert an != 0 and abs(fd - an) <= FD_RTOL * abs(an), (name, fd, an)


# ---------------------------------------------------------------------------
# chunked_value_and_grad
# ---------------------------------------------------------------------------

CHUNKS, CHUNK_HOURS = 2, 1
T_STEPS = CHUNKS * CHUNK_HOURS
RUN_KW = dict(mode="trbdf2_refresh", substeps=1, hours=CHUNK_HOURS, refresh_every=1)
START = 8  # 08:00: the sun is up


def _seq_kw(b):
    dry, wind, wdir, ghi, ir = (w[START:START + T_STEPS] for w in testing.synthetic_weather(START + T_STEPS))
    return dict(t_out=dry, wind_speed=wind, wind_direction=wdir,
                sol_front=ghi[:, None] * testing.solar_factors(b.n_surfaces)[None, :], ir_front=ir,
                hvac_power=np.full(b.n_hvacs, 500.0))


def _chunk(v, xp):
    if v.ndim and v.shape[0] == T_STEPS:
        return v.reshape((CHUNKS, CHUNK_HOURS) + tuple(v.shape[1:]))
    return xp.broadcast_to(v, (CHUNKS,) + tuple(v.shape))


def test_chunked_value_and_grad_with_cavities_matches_heatx():
    hx_model, port_model = _models()
    tm = heatx.ThermalModel(hx_model, n=1, config=heatx.SimConfig(dtype=jnp.float64))
    tm.building = dataclasses.replace(tm.building, surfaces=_fill(tm.building.surfaces))
    tm.invalidate()
    xs = jax.tree.map(lambda v: _chunk(jnp.asarray(v), jnp), tm.inputs_sequence(T_STEPS, **_seq_kw(tm.building)))
    building = tm._device()
    sb0 = building.surfaces

    def hx_params(p):
        sb = dataclasses.replace(sb0, seg_u=sb0.seg_u * p["u_scale"], front_alphas=sb0.front_alphas * p["alpha_scale"])
        return dataclasses.replace(building, surfaces=sb)

    def hx_loss(zt, xs):
        return jnp.mean((zt - 21.0) ** 2) / CHUNKS

    fr = tm.fast_runner(block_size=16, interpret=True, **RUN_KW)
    val, g = hx_chunked_value_and_grad(
        None, {"u_scale": jnp.asarray(1.2), "alpha_scale": jnp.asarray(0.8)}, tm.initial_state(), xs,
        forward_fn=fr.chunk_forward(hx_params, hx_loss), backward_fn=fr.chunk_grad(hx_params, hx_loss),
    )
    ref = (float(val), float(g["u_scale"]), float(g["alpha_scale"]))

    ptm = ThermalModel(port_model, n=1, config=SimConfig(dtype=torch.float64), device="cpu")
    b = ptm.building
    pxs = tree_map(lambda v: _chunk(v, torch), ptm.inputs(**_seq_kw(b)))
    seg_u0, alphas0 = t(b.surfaces.seg_u), t(b.surfaces.front_alphas)

    def with_params(p):
        sb = dataclasses.replace(b.surfaces, seg_u=seg_u0 * p["u_scale"], front_alphas=alphas0 * p["alpha_scale"])
        return dataclasses.replace(b, surfaces=sb)

    def loss_fn(zt, xs):
        return torch.mean((zt - 21.0) ** 2) / CHUNKS

    runner = ptm.fast_runner(block_size=16, **RUN_KW)
    val, g = chunked_value_and_grad(
        None, {"u_scale": torch.tensor(1.2, dtype=torch.float64), "alpha_scale": torch.tensor(0.8, dtype=torch.float64)},
        ptm.initial_state(), pxs,
        forward_fn=runner.chunk_forward(with_params, loss_fn), backward_fn=runner.chunk_grad(with_params, loss_fn),
    )
    got = (float(val), float(g["u_scale"]), float(g["alpha_scale"]))
    np.testing.assert_allclose(got, ref, rtol=GRAD_RTOL)
    assert all(np.isfinite(got)) and all(abs(x) > 0 for x in got)

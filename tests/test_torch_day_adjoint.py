"""The port's day adjoint (plain PyTorch version, CPU) against heatx's adjoint
day kernel in interpret mode, f64, on the 6-zone bench city: block 16, 2
hours of 2 sub-steps, modes trbdf2 (one operator over both sub-steps of the
hour) and trbdf2_refresh k=1 (two refresh groups per hour), seeded numpy
cotangents on the final state and the zone history.  Two sub-steps, not
tests/test_kernel_adjoint.py's four: heatx's interpret-mode compile grows
with the unrolled sub-steps (~70 s per case at four, ~30 s at two, on one
CPU core), and two already cover both cadences.

Every output is compared in surface and zone order (heatx and the port
block differently) with max |d| <= 1e-9 * max |ref| per output: the port's
zone update uses expm1 and lane-order zone sums where heatx uses a series
and one-hot matmuls, so the two differ at round-off (~1e-13 relative
measured).  Every output is finite and padded lanes get exact zeros.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import heatx
from heatx.build.layout import compile_building as hx_compile
from heatx.ops import pallas_adjoint, pallas_step
from heatx_torch import SimConfig, testing
from heatx_torch.build.layout import compile_building
from heatx_torch.ops import day_adjoint, day_march
from torch_reference import unoptimized

torch.set_num_threads(1)

RTOL = 1e-9  # of max |ref|, per output
HOURS, SUB = 2, 2
CASES = [("trbdf2", None), ("trbdf2_refresh", 1)]


@pytest.fixture(scope="module")
def buildings():
    cfg = dict(n=1)
    hb = hx_compile(bench.build_city_model(6, 10), config=heatx.SimConfig(dtype=jnp.float64), **cfg)
    pb = compile_building(testing.build_city_model(6, 10), config=SimConfig(dtype=torch.float64), **cfg)
    return hb, pb


def _inputs(S, Z, N):
    """Seeded inputs and cotangents in surface/zone order (tests/test_kernel_adjoint.py:58-109)."""
    rng = np.random.default_rng(0)
    return dict(
        weather=[np.repeat(np.asarray(v), SUB) for v in ([2.0, 5.0], [3.0, 4.0], [0.7, 0.1])],
        sol_front=rng.uniform(0, 500, (HOURS, S)),
        sol_back=rng.uniform(0, 50, (HOURS, S)),
        ir_front=np.full((HOURS, S), 320.0),
        a_gain=np.full(Z, 500.0),
        dT=rng.normal(size=(N, S)),
        d_zT=rng.normal(size=Z),
        d_hist=rng.normal(size=(HOURS, Z)),
    )


def _blocked(lay, n_blocks, zones_per_block, inp):
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
    cots = (lay.surfaces_to_blocked(inp["dT"]), lay.zones_to_blocked(inp["d_zT"]), zones(inp["d_hist"]))
    return hour_inputs, cots


def _flat(g):
    out = {k: v for k, v in g.items() if k != "d_params"}
    out.update({"p:" + k: v for k, v in g["d_params"].items()})
    return out


def _unblock(lay, S, Z, g):
    """Blocked outputs -> surface/zone order."""
    out = {}
    for k, v in g.items():
        if k in ("d_zT0", "d_zone_volume"):
            out[k] = lay.zones_from_blocked(v, Z)
        elif k in ("d_a_extra", "d_b_extra"):
            out[k] = np.stack([lay.zones_from_blocked(x, Z) for x in v])
        else:
            out[k] = lay.surfaces_from_blocked(v, S)
    return out


def _state(lay, building):
    node_T = np.where(building.surfaces.node_mask, 22.0, 0.0)
    return lay.surfaces_to_blocked(node_T), lay.zones_to_blocked(np.full(building.n_zones, 22.0))


@pytest.fixture(scope="module")
def heatx_grads(buildings):
    """heatx's interpret-mode adjoint per case, computed once per module."""
    hb, _ = buildings
    bb = pallas_step.block_building(hb, block_size=16)
    inp = _inputs(hb.n_surfaces, hb.n_zones, bb.max_nodes)
    hi, cots = _blocked(bb.layout, bb.n_blocks, bb.zones_per_block, inp)
    T0, zT0 = _state(bb.layout, hb)
    cache = {}

    def get(mode, k):
        if (mode, k) not in cache:
            _, params = pallas_step.make_hour_march(
                bb, substeps=SUB, interpret=True, mode=mode, hours=HOURS, refresh_every=k
            )
            adj = pallas_adjoint.make_day_adjoint(
                bb, substeps=SUB, mode=mode, hours=HOURS, interpret=True, refresh_every=k
            )
            g = unoptimized(adj)(params, jnp.asarray(T0), jnp.asarray(zT0), tuple(jnp.asarray(x) for x in hi),
                    tuple(jnp.asarray(c) for c in cots) + (None,))
            g = {name: np.asarray(v) for name, v in _flat(g).items()}
            cache[mode, k] = _unblock(bb.layout, hb.n_surfaces, hb.n_zones, g)
        return cache[mode, k]

    return get


def _port_adjoint(pb, mode, k, device="cpu", plain=False):
    bb = day_march.block_building(pb, block_size=16)
    inp = _inputs(pb.n_surfaces, pb.n_zones, bb.max_nodes)
    hi, cots = _blocked(bb.layout, bb.n_blocks, bb.zones_per_block, inp)
    T0, zT0 = _state(bb.layout, pb)
    _, params = day_march.make_hour_march(
        bb, substeps=SUB, mode=mode, hours=HOURS, refresh_every=k, device=device
    )
    adj = day_adjoint.make_day_adjoint(
        bb, substeps=SUB, mode=mode, hours=HOURS, refresh_every=k, device=device
    )

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device)

    g = (adj.plain if plain else adj)(params, t(T0), t(zT0), tuple(t(x) for x in hi), tuple(t(c) for c in cots))
    return bb, {name: v.cpu().numpy() for name, v in _flat(g).items()}


@pytest.mark.parametrize("mode,k", CASES)
def test_day_adjoint_matches_heatx_kernel(buildings, heatx_grads, mode, k):
    _, pb = buildings
    bb, got = _port_adjoint(pb, mode, k)
    ref = heatx_grads(mode, k)
    got_sf = _unblock(bb.layout, pb.n_surfaces, pb.n_zones, got)
    assert sorted(got_sf) == sorted(ref)
    for name, r in ref.items():
        scale = np.abs(r).max()
        np.testing.assert_allclose(got_sf[name], r, rtol=0, atol=RTOL * scale, err_msg=name)
    # The cotangents reach every differentiated group the bench city exercises.
    for name in ("dT0", "d_zT0", "d_zone_volume", "d_sol_front", "d_sol_back", "d_ir_front",
                 "d_a_extra", "d_b_extra", "p:mass", "p:seg_u", "p:front_alphas",
                 "p:back_alphas", "p:area", "p:perimeter", "p:wind_mod", "p:eps_front",
                 "p:eps_back", "p:rf"):
        assert np.abs(ref[name]).max() > 0, name


@pytest.mark.parametrize("mode,k", CASES)
def test_day_adjoint_finite_and_zero_on_padded_lanes(buildings, mode, k):
    """Padded lanes (area padded to 1, so P*v/A and its derivative stay
    finite) get finite exact zeros for every parameter and channel."""
    _, pb = buildings
    bb, got = _port_adjoint(pb, mode, k)
    pad = ~bb.layout.surf_valid
    assert pad.any()
    for name, v in got.items():
        assert np.isfinite(v).all(), name
        if name.startswith("p:") or name.startswith("d_sol") or name.startswith("d_ir"):
            assert (v[..., pad] == 0).all(), name


def test_param_blocker_matches_params_from_blocked(buildings):
    """The differentiable blocking of the building's own arrays gives the
    packed operands bit for bit, and routes cotangents back to them."""
    _, pb = buildings
    for dtype in (torch.float32, torch.float64):
        b = dataclasses.replace(pb, config=SimConfig(dtype=dtype))
        bb = day_march.block_building(b, block_size=16)
        ref = day_march.params_from_blocked(bb, dtype, "cpu")
        got = day_march.ParamBlocker(bb, "cpu")(ref, b.surfaces, b.zone_volume)
        for name in ("node", "surf", "zone_volume"):
            torch.testing.assert_close(getattr(got, name), getattr(ref, name), rtol=0, atol=0,
                                       equal_nan=True, msg=name)
    area = torch.as_tensor(pb.surfaces.area, dtype=torch.float64).requires_grad_()
    sb = dataclasses.replace(pb.surfaces, area=area)
    bb = day_march.block_building(pb, block_size=16)
    params = day_march.params_from_blocked(bb, torch.float64, "cpu")
    got = day_march.ParamBlocker(bb, "cpu")(params, sb, pb.zone_volume)
    (g,) = torch.autograd.grad(got.field("area").sum(), area)
    assert torch.equal(g, torch.ones_like(g))  # each surface lands on exactly one lane


@pytest.mark.parametrize("mode,k", [("trbdf2_refresh", 1), ("trbdf2", None)])
def test_plain_adjoint_matches_finite_differences_on_every_branch(mode, k):
    """On testing.build_mixed_model (tilted roof, ground floor with a fixed
    contact h, partition, ambient back face) the parameters the bench city
    leaves at zero get cotangents, equal to central differences of the plain
    forward within 1e-5 relative (the differences' own round-off is ~1e-6): cos_tilt's TARP coefficients are taped,
    the temperatures and fixed h route as the forward reads them, and the
    mass row is masked to massive nodes."""
    b = compile_building(testing.build_mixed_model(), config=SimConfig(dtype=torch.float64))
    bb = day_march.block_building(b)
    hours, sub = 2, 2
    hm, params = day_march.make_hour_march(bb, substeps=sub, mode=mode, hours=hours, refresh_every=k, device="cpu")
    adj = day_adjoint.make_day_adjoint(bb, substeps=sub, mode=mode, hours=hours, refresh_every=k, device="cpu")
    lay, SP, NB, ZB = bb.layout, bb.layout.padded_surfaces, bb.n_blocks, bb.zones_per_block
    rng = np.random.default_rng(11)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64))

    mask = b.surfaces.node_mask
    hi = tuple(t(rng.uniform(lo, hi, hours * sub)) for lo, hi in ((-5, 15), (0, 8), (0, 6.28))) + (
        t(rng.uniform(0, 400, (hours, SP))), t(rng.uniform(0, 50, (hours, SP))),
        t(rng.uniform(250, 400, (hours, SP))), t(rng.uniform(250, 400, (hours, SP))),
        t(rng.uniform(0, 900, (hours, NB, ZB))), t(rng.uniform(0, 50, (hours, NB, ZB))),
    )
    T0 = t(lay.surfaces_to_blocked(np.where(mask, rng.uniform(15, 25, mask.shape), 0.0)))
    zT0 = t(lay.zones_to_blocked(rng.uniform(18, 24, b.n_zones)))
    W = (t(rng.normal(size=T0.shape)), t(rng.normal(size=zT0.shape)), t(rng.normal(size=(hours, NB, ZB))))
    g = adj(params, T0, zT0, hi, W)["d_params"]

    def loss(p):
        T, zT, _, hist = hm(p, T0, zT0, hi)[:4]
        return float((T * W[0]).sum() + (zT * W[1]).sum() + (hist * W[2]).sum())

    eps = 1e-6  # relative steps: round-off ~1e-16 |loss| / eps, O(eps^2) truncation
    for name in ("cos_tilt", "front_temp", "back_temp", "fixed_h_front", "eps_back", "area", "mass"):
        row = params.node[1] if name == "mass" else params.field(name)
        # Seeded directions relative to each value (capacities are ~1e5, cos ~1).
        D = torch.nan_to_num(t(rng.normal(size=row.shape)) * row.abs())

        def moved(e):
            node, surf = params.node.clone(), params.surf.clone()
            if name == "mass":
                node[1] += e * D
            else:
                surf[day_march.SURF_FIELDS.index(name)] += e * D
            return dataclasses.replace(params, node=node, surf=surf)

        fd = (loss(moved(eps)) - loss(moved(-eps))) / (2 * eps)
        an = float((torch.nan_to_num(g[name]) * D).sum())
        assert abs(an) > 0, name
        assert abs(fd - an) <= 1e-5 * abs(an), (name, fd, an)


def test_make_day_adjoint_refuses_what_is_not_ported(buildings):
    _, pb = buildings
    bb = day_march.block_building(pb, block_size=16)
    # Parity mode is ported, with heatx's rules: the sub-step count must be
    # given (and be the building's), and the adaptive no-mass loop of the
    # default config has no adjoint (heatx's refusal).
    with pytest.raises(ValueError, match="dt_subdivisions"):
        day_adjoint.make_day_adjoint(bb, substeps=SUB, mode="parity", device="cpu")
    with pytest.raises(ValueError, match="nomass_fixed_iters.*no reverse-mode rule"):
        day_adjoint.make_day_adjoint(bb, substeps=pb.dt_subdivisions, mode="parity", device="cpu")
    adj = day_adjoint.make_day_adjoint(bb, substeps=SUB, hours=HOURS, device="cpu")
    _, params = day_march.make_hour_march(bb, substeps=SUB, hours=HOURS, device="cpu")
    inp = _inputs(pb.n_surfaces, pb.n_zones, bb.max_nodes)
    hi, cots = _blocked(bb.layout, bb.n_blocks, bb.zones_per_block, inp)
    T0, zT0 = (torch.as_tensor(a) for a in _state(bb.layout, pb))
    hi = tuple(torch.as_tensor(x) for x in hi)
    # A load cotangent needs thermostats: ported, so heatx's ValueError.
    with pytest.raises(ValueError, match="setpoint-driven HVAC"):
        adj(params, T0, zT0, hi, (None, None, None, torch.zeros(HOURS, bb.n_blocks, bb.zones_per_block)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            day_adjoint.make_day_adjoint(bb, substeps=SUB)


def test_tr_adjoint_kernel_takes_any_substep_count():
    """The TR-BDF2 adjoint kernel keeps its hour's tape in a workspace in
    device memory ([2 substeps + 1, 32, SP] values), so no sub-step or node
    count is refused for it (the one-thread kernel it replaced refused
    (substeps + 1) * nodes > 384): at 47 sub-steps and 25 nodes the wrapper's
    first refusal of CPU tensors is its device check."""
    from heatx_torch import ThermalModel

    sub = 47  # (47 + 1) * 25 = 1200 values an hour per surface
    tm = ThermalModel(testing.build_city_model(2, 3), config=SimConfig(dtype=torch.float64), device="cpu")
    r = tm.fast_runner(mode="trbdf2", substeps=sub, hours=1)
    assert r.params.max_nodes == 25
    T, zT = r.to_blocked(tm.initial_state())
    hi = r.kernel_inputs(testing.bench_inputs(tm.building, 1), interp_weather=True)[0]
    adj = day_adjoint.make_day_adjoint(r._bb, substeps=sub, mode="trbdf2", hours=1, device="cpu")
    cots = (torch.zeros_like(T), torch.zeros_like(zT), torch.zeros((1, r._bb.n_blocks, r._bb.zones_per_block),
                                                                  dtype=torch.float64))
    assert not hasattr(day_adjoint, "MAX_TAPE")
    with pytest.raises(ValueError, match="expected a tensor on cpu, got cpu"):
        day_adjoint.day_adjoint_kernel(*adj._args(r.params, T, zT, hi, cots), **adj._hm._kw(observables=False))


def _chain_day(zones, sub, mode, k, hours, device):
    """One f64 day of testing.build_zone_chain_model (``zones`` zones in one
    block, 2-node panes, a thermostat each) on the demand inputs: (model,
    runner, T, zT, hour inputs, adjoint, seeded cotangents)."""
    from heatx_torch import ThermalModel

    tm = ThermalModel(testing.build_zone_chain_model(zones), n=1, config=SimConfig(dtype=torch.float64),
                      device=device)
    kw = dict(mode=mode, substeps=sub) if k is None else dict(mode=mode, substeps=sub, refresh_every=k)
    r = tm.fast_runner(hours=hours, **kw)
    T, zT = r.to_blocked(tm.initial_state())
    hi = r.kernel_inputs(testing.demand_inputs(tm.building, hours, device=device))[0]
    adj = day_adjoint.make_day_adjoint(r._bb, hours=hours, device=device, **kw)
    NB, ZB = r._bb.n_blocks, r._bb.zones_per_block
    rng = np.random.default_rng(zones)
    cots = tuple(torch.as_tensor(rng.normal(size=shape) * scale, dtype=torch.float64, device=device)
                 for shape, scale in ((T.shape, 1.0), (zT.shape, 1.0), ((hours, NB, ZB), 1.0),
                                      ((hours, NB, ZB), 1e-3)))
    return tm, r, T, zT, hi, adj, cots


def test_plain_adjoint_from_given_hour_starts():
    """plain_day_adjoint's ``starts``: given the plain march's own hour starts
    it returns what it returns without them, bit for bit; given other starts
    (cast to the adjoint's type) it re-runs the hours from those."""
    hours, sub = 2, 4
    tm, r, T, zT, hi, adj, cots = _chain_day(8, sub, "trbdf2_refresh", 2, hours, "cpu")
    r1 = tm.fast_runner(mode="trbdf2_refresh", substeps=sub, refresh_every=2, hours=1)
    starts, t, z = [], T, zT
    for h in range(hours):
        starts.append((t, z))
        hour = tuple(x[h * sub:(h + 1) * sub] if i < 3 else x[h:h + 1] for i, x in enumerate(hi))
        t, z = r1.hour_march.plain(r1.params, t, z, hour)[:2]
    own = _flat(adj.plain(r.params, T, zT, hi, cots))
    given = _flat(adj.plain(r.params, T, zT, hi, cots, starts=starts))
    assert own.keys() == given.keys()
    for name, ref in own.items():
        assert torch.equal(given[name], ref), name
    moved = _flat(adj.plain(r.params, T, zT, hi, cots, starts=[(t.float() + 0.5, z.float() + 0.5)
                                                               for t, z in starts]))
    assert all(v.dtype == torch.float64 and bool(torch.isfinite(v).all()) for v in moved.values())
    assert not torch.equal(moved["dT0"], own["dT0"])


@pytest.mark.cuda
@pytest.mark.parametrize("mode,k", [("trbdf2_refresh", 2), ("trbdf2", None)])
def test_cuda_tr_adjoint_most_zone_rows(mode, k):
    """The TR-BDF2 adjoint kernel where a block holds the most zone rows of
    an hour: 64 zones in one 64-lane block at 144 sub-steps an hour, the
    most the one-thread kernel it replaced took there (its shared memory
    grew with zones x sub-steps), against the plain adjoint, f64."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    _, r, T, zT, hi, adj, cots = _chain_day(64, 144, mode, k, 1, "cuda")
    assert (r.params.block_size, r.params.zones_per_block) == (64, 64)
    got, ref = _flat(adj(r.params, T, zT, hi, cots)), _flat(adj.plain(r.params, T, zT, hi, cots))
    for name, x in ref.items():
        assert float((got[name] - x).abs().max()) <= RTOL * float(x.abs().max()), name


@pytest.mark.cuda
@pytest.mark.parametrize("mode,k", CASES + [("trbdf2_refresh", 2)])
def test_cuda_adjoint_kernel_matches_plain(buildings, mode, k):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    _, pb = buildings
    _, got = _port_adjoint(pb, mode, k, device="cuda")
    _, ref = _port_adjoint(pb, mode, k, device="cuda", plain=True)
    for name, r in ref.items():
        np.testing.assert_allclose(got[name], r, rtol=0, atol=RTOL * np.abs(r).max(), err_msg=name)

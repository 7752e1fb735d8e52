"""The port's day march (plain PyTorch twin, CPU) against heatx's Pallas day
kernel in interpret mode, f64, on the 4-zone bench city: 3 hours of 8
sub-steps, modes trbdf2_refresh (k=2, k=8) and trbdf2.

Outputs are compared in surface and zone order: heatx blocks with its
node-height split, the port without, so lanes sit in different places.
Tolerance 1e-9 K: the port's zone update uses expm1 where heatx uses a
series below x = 1e-2, and its zone sums run in lane order where heatx's are
one-hot matmuls; both differ from heatx at round-off level.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import heatx
from heatx.build.layout import compile_building as hx_compile
from heatx.ops import pallas_step
from heatx_torch import SimConfig, testing
from heatx_torch.build.layout import compile_building
from heatx_torch.ops import day_march
from torch_reference import unoptimized

torch.set_num_threads(1)

ATOL = 1e-9
HOURS, SUB = 3, 8
CASES = [("trbdf2_refresh", 2), ("trbdf2_refresh", 8), ("trbdf2", None)]


@pytest.fixture(scope="module")
def buildings():
    hb = hx_compile(bench.build_city_model(4, 10), n=1, config=heatx.SimConfig(dtype=jnp.float64))
    pb = compile_building(testing.build_city_model(4, 10), n=1, config=SimConfig(dtype=torch.float64))
    return hb, pb


def _inputs(S, Z, hours=HOURS):
    rng = np.random.default_rng(7)
    gains = np.zeros(Z)
    gains[:] = 650.0  # one 500 W heater and one 150 W luminaire per zone
    return dict(
        weather=[rng.uniform(lo, hi, hours * SUB) for lo, hi in ((-5, 15), (0, 8), (0, 6.28))],
        sol_front=rng.uniform(0.0, 500.0, (hours, S)),
        ir_front=rng.uniform(250.0, 400.0, (hours, S)),
        a_gain=gains,
    )


def _hour_inputs(lay, n_blocks, zones_per_block, inp, hours=HOURS):
    SP = lay.padded_surfaces
    return tuple(inp["weather"]) + (
        np.stack([lay.surfaces_to_blocked(inp["sol_front"][h]) for h in range(hours)]),
        np.zeros((hours, SP)),
        np.stack([lay.surfaces_to_blocked(inp["ir_front"][h]) for h in range(hours)]),
        np.zeros((hours, SP)),
        np.stack([lay.zones_to_blocked(inp["a_gain"])] * hours),
        np.zeros((hours, n_blocks, zones_per_block)),
    )


def _initial(lay, building):
    node_T = np.where(building.surfaces.node_mask, 22.0, 0.0)
    return lay.surfaces_to_blocked(node_T), lay.zones_to_blocked(np.full(building.n_zones, 22.0))


def _unblock(lay, S, Z, out):
    T, zT, hq, hist = (out[0], out[1], out[2], out[3])
    return dict(
        T=lay.surfaces_from_blocked(np.asarray(T), S),
        zT=lay.zones_from_blocked(np.asarray(zT), Z),
        hq=np.stack([lay.surfaces_from_blocked(np.asarray(x), S) for x in hq]),
        hist=np.stack([lay.zones_from_blocked(np.asarray(hist[h]), Z) for h in range(len(hist))]),
    )


def _run_heatx(hb, mode, k, inp):
    bb = pallas_step.block_building(hb, block_size=16)
    hm, params = pallas_step.make_hour_march(
        bb, substeps=SUB, interpret=True, mode=mode, hours=HOURS, refresh_every=k
    )
    T0, zT0 = _initial(bb.layout, hb)
    hi = _hour_inputs(bb.layout, bb.n_blocks, bb.zones_per_block, inp)
    out = unoptimized(hm)(params, jnp.asarray(T0), jnp.asarray(zT0), tuple(jnp.asarray(x) for x in hi))
    return _unblock(bb.layout, hb.n_surfaces, hb.n_zones, out)


def _run_port(pb, mode, k, inp, device="cpu", plain=False):
    bb = day_march.block_building(pb, block_size=16)
    hm, params = day_march.make_hour_march(
        bb, substeps=SUB, mode=mode, hours=HOURS, refresh_every=k, collect_bad=True,
        device=device,
    )
    T0, zT0 = _initial(bb.layout, pb)

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device)

    hi = tuple(dev(x) for x in _hour_inputs(bb.layout, bb.n_blocks, bb.zones_per_block, inp))
    out = (hm.plain if plain else hm)(params, dev(T0), dev(zT0), hi)
    assert float(out[4].sum()) == 0.0  # no non-finite state
    out = [out[0].cpu(), out[1].cpu(), [x.cpu() for x in out[2]], out[3].cpu()]
    return _unblock(bb.layout, pb.n_surfaces, pb.n_zones, out)


@pytest.mark.parametrize("mode,k", CASES)
def test_day_march_matches_heatx_kernel(buildings, mode, k):
    hb, pb = buildings
    inp = _inputs(hb.n_surfaces, hb.n_zones)
    ref = _run_heatx(hb, mode, k, inp)
    got = _run_port(pb, mode, k, inp)
    for name in ("T", "zT", "hq", "hist"):
        np.testing.assert_allclose(got[name], ref[name], rtol=0, atol=ATOL, err_msg=name)
    # The march moved the state: a check that would pass on a no-op fails here.
    assert np.abs(got["zT"] - 22.0).max() > 0.1


def test_refresh_every_substeps_is_frozen(buildings):
    """k = substeps rebuilds the operators once per hour at the hour's first
    sub-step: the frozen mode, bit for bit (as in heatx)."""
    _, pb = buildings
    inp = _inputs(pb.n_surfaces, pb.n_zones)
    a = _run_port(pb, "trbdf2_refresh", SUB, inp)
    b = _run_port(pb, "trbdf2", None, inp)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_bad_count_names_the_block(buildings):
    """The per-hour non-finite count flags the block that holds a NaN node."""
    _, pb = buildings
    bb = day_march.block_building(pb, block_size=16)
    hm, params = day_march.make_hour_march(
        bb, substeps=2, mode="trbdf2", hours=2, collect_bad=True, device="cpu"
    )
    T0, zT0 = (torch.as_tensor(a) for a in _initial(bb.layout, pb))
    lane = int(np.nonzero(bb.layout.surf_valid)[0][bb.block_size + 1])  # in block 1
    T0[0, lane] = float("nan")
    inp = _inputs(pb.n_surfaces, pb.n_zones, hours=2)
    inp["weather"] = [w[:4] for w in inp["weather"]]
    hi = tuple(torch.as_tensor(x) for x in _hour_inputs(
        bb.layout, bb.n_blocks, bb.zones_per_block, inp, hours=2))
    bad = hm(params, T0, zT0, hi)[4]
    assert bad.shape == (2, bb.n_blocks)
    assert float(bad[0, 1]) > 0
    assert float(bad[0, 0]) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("mode,k", CASES)
def test_cuda_kernel_matches_plain_twin(buildings, mode, k):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    _, pb = buildings
    inp = _inputs(pb.n_surfaces, pb.n_zones)
    got = _run_port(pb, mode, k, inp, device="cuda")
    ref = _run_port(pb, mode, k, inp, device="cuda", plain=True)
    for name in got:
        np.testing.assert_allclose(got[name], ref[name], rtol=0, atol=ATOL, err_msg=name)

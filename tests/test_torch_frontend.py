"""heatx_torch's copy of the numpy front end gives exactly heatx's arrays:
compile_building and the zone-closed blocking (node_split=None), on the bench
city built once by bench.py and once by heatx_torch.testing."""

import dataclasses

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

torch.set_num_threads(1)

CASES = [(4, 16), (40, 64)]  # (zones, lanes per block): 4 and 7 blocks


def _assert_fields_equal(a, b, skip=()):
    for f in dataclasses.fields(a):
        if f.name in skip:
            continue
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, tuple):
            assert len(va) == len(vb), f.name
            for x, y in zip(va, vb):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f.name)
        elif isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
            assert va.dtype == vb.dtype, f.name
        else:
            assert va == vb, f.name


def _pair(n_zones):
    hb = hx_compile(
        bench.build_city_model(n_zones, 10), n=1,
        config=heatx.SimConfig(dtype=jnp.float64),
    )
    pb = compile_building(
        testing.build_city_model(n_zones, 10), n=1,
        config=SimConfig(dtype=torch.float64),
    )
    return hb, pb


@pytest.mark.parametrize("n_zones", [c[0] for c in CASES])
def test_compile_building_equal(n_zones):
    hb, pb = _pair(n_zones)
    _assert_fields_equal(hb.surfaces, pb.surfaces)
    _assert_fields_equal(hb, pb, skip=("surfaces", "config", "discretizations"))
    assert len(hb.discretizations) == len(pb.discretizations)
    for dh, dp in zip(hb.discretizations, pb.discretizations):
        assert dh.n_elements == dp.n_elements
        assert dh.tstep_subdivision == dp.tstep_subdivision
        assert [(s.mass, s.kind, s.u) for s in dh.segments] == [
            (s.mass, s.kind, s.u) for s in dp.segments
        ]


@pytest.mark.parametrize("n_zones,block", CASES)
def test_block_building_equal(n_zones, block):
    hb, pb = _pair(n_zones)
    hbb = pallas_step.block_building(hb, block_size=block, node_split=None)
    pbb = day_march.block_building(pb, block_size=block)
    assert pbb.n_blocks == hbb.n_blocks > 1
    _assert_fields_equal(hbb.layout, pbb.layout)
    _assert_fields_equal(hbb.surfaces, pbb.surfaces)
    for name in ("front_oh", "back_oh", "zone_volume", "zone_valid"):
        np.testing.assert_array_equal(getattr(hbb, name), getattr(pbb, name), err_msg=name)


def test_default_block_is_smallest_warp_multiple():
    """The default lanes per block: the largest zone component (10 surfaces
    per zone here) rounded up to a warp."""
    _, pb = _pair(40)
    assert day_march.min_block_lanes(pb) == 32
    assert day_march.block_building(pb).block_size == 32

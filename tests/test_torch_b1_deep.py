"""Walls past 32 nodes per surface (ROADMAP B1): the port's
``FastRunner.run`` on the CPU (the plain day march) against heatx's XLA
path (``ThermalModel.run``), f64, at the default discretization (max_dx 0.04,
min_dt 60: the insulated concrete of ``testing.build_office_block`` gives
36 nodes at 0.30 m, 47 at 0.40 m and 69 at 0.60 m).

The building is a small ``testing.build_office_block(2, 3, 1)`` (6 rooms
in one component of 23 surfaces), 1 h in ``trbdf2_refresh`` (2 sub-steps,
k = 2) and in parity (the building's own sub-steps, two no-mass
iterations; the 69-node column in parity only); every output within 1e-9 K.
The kernels take the 36- and 47-node columns at G = 8 threads a surface (64
rows); the 69-node one runs on the plain version and the kernels refuse it,
naming their limit.
"""

import dataclasses
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heatx
import heatx.model.building as hmb
from heatx.engine import step as hx_step
from heatx.engine.implicit import imp_march
from heatx_torch import SimConfig, ThermalModel, testing
from heatx_torch.ops import cuda_lib, day_march
from torch_reference import unoptimized

torch.set_num_threads(1)

ATOL_K = 1e-9
HOURS = 1
TR = dict(mode="trbdf2_refresh", substeps=2, refresh_every=2)
CFG = dict(nomass_fixed_iters=2)
NODES = {0.30: 36, 0.40: 47, 0.60: 69}


def hx_run(htm, seq, mode, substeps=None, refresh_every=None):
    """heatx's ``ThermalModel.run`` (its XLA path) in ``mode``, compiled
    without XLA's backend optimizations (``torch_reference.unoptimized``)."""
    march_fn = None if mode == "parity" else partial(
        imp_march, substeps=substeps, refresh_h=mode == "trbdf2_refresh", refresh_every=refresh_every)
    return unoptimized(partial(hx_step.run, march_fn=march_fn))(htm._device(), htm.initial_state(), seq)


def _wall(concrete):
    return (("poly", 0.02), ("concrete", concrete), ("poly", 0.02))


# The 69-node column in parity only (heatx's XLA TR-BDF2 compile grows with
# the rows: 13 s there).
@pytest.mark.parametrize("concrete, mode", [(0.30, "trbdf2_refresh"), (0.30, "parity"), (0.40, "trbdf2_refresh"),
                                            (0.40, "parity"), (0.60, "parity")])
def test_deep_wall_runs_and_matches_heatx(concrete, mode):
    htm = heatx.ThermalModel(testing.build_office_block(2, 3, 1, wall=_wall(concrete), classes=hmb),
                             config=heatx.SimConfig(dtype=jnp.float64, **CFG))
    ptm = ThermalModel(testing.build_office_block(2, 3, 1, wall=_wall(concrete)),
                       config=SimConfig(dtype=torch.float64, **CFG), device="cpu")
    b = ptm.building
    assert (b.n_surfaces, b.n_zones, b.max_nodes) == (testing.office_block_surfaces(2, 3, 1), 6, NODES[concrete])
    kw = TR if mode != "parity" else dict(mode="parity")
    runner = ptm.fast_runner(hours=HOURS, **kw)
    assert runner.params.max_nodes == b.max_nodes and runner.params.block_size == 32
    if b.max_nodes <= 64:  # one CTA of 32 lanes at G = 8
        shape = day_march.launch_shape(runner.params.block_size, b.max_nodes)
        assert (shape.index, shape.group, shape.nodes, shape.cluster, shape.threads) == (3, 8, 64, 1, 256)
    else:
        with pytest.raises(NotImplementedError, match="at most 64 nodes per surface.*ROADMAP B1"):
            day_march.launch_shape(runner.params.block_size, b.max_nodes)
    seq = testing.bench_inputs(b, HOURS)
    kw_h = {f.name: getattr(seq, f.name).numpy() for f in dataclasses.fields(seq)
            if getattr(seq, f.name) is not None}
    final, zt = runner.run(ptm.initial_state(), seq)
    ref_final, ref_zt = hx_run(htm, htm.inputs_sequence(HOURS, **kw_h), mode,
                               **{k: v for k, v in kw.items() if k != "mode"})
    mask = np.asarray(htm.building.surfaces.node_mask)
    np.testing.assert_allclose(zt.numpy(), np.asarray(ref_zt), rtol=0, atol=ATOL_K, err_msg="zone_T history")
    np.testing.assert_allclose(final.node_T.numpy() * mask, np.asarray(ref_final.node_T) * mask, rtol=0,
                               atol=ATOL_K, err_msg="node_T")
    # The deep wall's whole column moved: its inner nodes too.
    deep = np.asarray(b.surfaces.n_nodes) == b.max_nodes
    assert deep.any()
    moved = np.abs(final.node_T.numpy() - ptm.initial_state().node_T.numpy())[:, deep] * mask[:, deep]
    assert moved[b.max_nodes - 1].max() > 1e-6


def test_deep_lane_words():
    """A column past 32 nodes carries every per-node mask in two 32-bit
    words a lane (``day_march.BIT_FIELDS`` after the base rows), and
    ``bit_rows`` reads them back whole."""
    ptm = ThermalModel(testing.build_office_block(1, 2, 1, wall=_wall(0.40)),
                       config=SimConfig(dtype=torch.float64), device="cpu")
    runner = ptm.fast_runner(hours=HOURS, **TR)
    p, bb = runner.params, runner._bb
    assert tuple(p.lane.shape) == (len(day_march.LANE_FIELDS) + len(day_march.BIT_FIELDS), p.surf.shape[1])
    sb = bb.surfaces
    assert torch.equal(day_march.bit_rows(p, "node_bits"), torch.as_tensor(np.asarray(sb.node_mask)))
    assert torch.equal(day_march.bit_rows(p, "mass_bits"), torch.as_tensor(np.asarray(sb.massive)))
    assert torch.equal(day_march.bit_rows(p, "chunk_bits"), torch.as_tensor(np.asarray(sb.same_chunk)))
    assert int(day_march.bit_rows(p, "node_bits")[32:].sum()) > 0


def test_short_columns_in_the_cluster_variant_carry_one_word():
    """A component past 256 lanes with columns of at most 32 nodes runs the
    64-row cluster variant on one mask word a lane, so the kernels read a
    lane's second word only past 32 rows (``lane_word``): the word is not
    there."""
    ptm = ThermalModel(testing.build_wide_zone_model(300), config=SimConfig(dtype=torch.float64), device="cpu")
    p = ptm.fast_runner(hours=HOURS, **TR).params
    shape = day_march.launch_shape(p.block_size, p.max_nodes)
    assert (p.max_nodes, shape.nodes, shape.cluster) == (32, 64, 3)
    assert tuple(p.lane.shape) == (len(day_march.LANE_FIELDS), p.surf.shape[1])
    assert "if (N > 32) w |=" in (cuda_lib.CSRC_DIR / "day_common.cuh").read_text()

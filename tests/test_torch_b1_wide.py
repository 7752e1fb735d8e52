"""Zone-connected components past 256 surfaces (ROADMAP B1): the port's
``FastRunner.run`` on the CPU (the plain day march, blocked as the kernels
launch it: a thread-block cluster of CTAs of 128 lanes) against heatx's XLA
path (``ThermalModel.run``), f64, and the ``chunk_grad`` gradient against
heatx's ``jax.grad`` through the same XLA march (1 h at one sub-step).

The buildings: ``testing.build_wide_zone_model(300)`` (one zone, 300
surfaces, a 32-node wall: one block of 384 lanes, 3 CTAs) and a small
``testing.build_office_block(4, 13, 2)`` (52 rooms in one component of 269
surfaces with the 36-node wall: 384 lanes, 3 CTAs), each 1 h in
``trbdf2_refresh`` (2 sub-steps, k = 2) and in parity (the building's own
sub-steps, two no-mass iterations).  Every output within 1e-9 K, the
gradient within 1e-9 of its largest magnitude.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import heatx
import heatx.model.building as hmb
from heatx.engine import step as hx_step
from heatx.engine.implicit import imp_march
from heatx_torch import SimConfig, ThermalModel, testing
from heatx_torch.engine.adjoint import chunked_value_and_grad, tree_map
from heatx_torch.ops import day_march
from torch_reference import unoptimized

torch.set_num_threads(1)

ATOL_K = 1e-9
RTOL = 1e-9
HOURS = 1
TR = dict(mode="trbdf2_refresh", substeps=2, refresh_every=2)
# The gradient at one sub-step: heatx's reference unrolls its sub-steps.
GRAD_TR = dict(mode="trbdf2_refresh", substeps=1, refresh_every=1)
CFG = dict(nomass_fixed_iters=2)


def _wide(classes):
    if classes is hmb:
        return testing.build_wide_zone_model(300, base=bench.build_city_model(1, 300), classes=hmb)
    return testing.build_wide_zone_model(300)


def _office(classes):
    return testing.build_office_block(4, 13, 2, classes=classes)


BUILDINGS = {"wide_zone_300": (_wide, 300, 1), "office_4x13x2": (_office, 269, 52)}


def _models(build):
    htm = heatx.ThermalModel(build(hmb), config=heatx.SimConfig(dtype=jnp.float64, **CFG))
    ptm = ThermalModel(build(testing.building_mod), config=SimConfig(dtype=torch.float64, **CFG), device="cpu")
    return htm, ptm


def _inputs(htm, ptm):
    seq = testing.bench_inputs(ptm.building, HOURS)
    kw = {f.name: getattr(seq, f.name).numpy() for f in dataclasses.fields(seq)
          if getattr(seq, f.name) is not None}
    return htm.inputs_sequence(HOURS, **kw), seq


def hx_run(htm, seq, mode, substeps=None, refresh_every=None):
    """heatx's ``ThermalModel.run`` (its XLA path) in ``mode``, compiled
    without XLA's backend optimizations (``torch_reference.unoptimized``)."""
    march_fn = None if mode == "parity" else partial(
        imp_march, substeps=substeps, refresh_h=mode == "trbdf2_refresh", refresh_every=refresh_every)
    return unoptimized(partial(hx_step.run, march_fn=march_fn))(htm._device(), htm.initial_state(), seq)


def _close(got, ref, what, atol=ATOL_K):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0, atol=atol, err_msg=what)


@pytest.mark.parametrize("mode", ["trbdf2_refresh", "parity"])
@pytest.mark.parametrize("name", sorted(BUILDINGS))
def test_wide_component_runs_and_matches_heatx(name, mode):
    build, surfaces, zones = BUILDINGS[name]
    htm, ptm = _models(build)
    b = ptm.building
    assert (b.n_surfaces, b.n_zones) == (surfaces, zones)
    kw = TR if mode != "parity" else dict(mode="parity")
    runner = ptm.fast_runner(hours=HOURS, **kw)
    # One component past one CTA: a cluster of 3 CTAs of 128 lanes at G = 8.
    shape = day_march.launch_shape(runner.params.block_size, b.max_nodes)
    assert runner.params.n_blocks == 1 and runner.params.block_size == 384
    assert (shape.cluster, shape.group, shape.cta_lanes, shape.threads) == (3, 8, 128, 1024)
    hseq, pseq = _inputs(htm, ptm)
    final, zt = runner.run(ptm.initial_state(), pseq)
    run_kw = {k: v for k, v in kw.items() if k != "mode"}
    ref_final, ref_zt = hx_run(htm, hseq, mode, **run_kw)
    mask = np.asarray(htm.building.surfaces.node_mask)
    _close(zt, ref_zt, "zone_T history")
    _close(final.zone_T, ref_final.zone_T, "zone_T")
    _close(final.node_T.numpy() * mask, np.asarray(ref_final.node_T) * mask, "node_T")
    assert np.abs(np.asarray(ref_zt) - 20.0).max() > 0.05  # the hour moved the zones


def test_wide_component_chunk_grad_matches_heatx():
    """The calibration gradient on the wide block (a conductance and a
    solar-absorptance scale, bench.py's grad row): the port's
    ``chunked_value_and_grad`` through ``chunk_forward``/``chunk_grad`` (the
    plain day march and plain day adjoint on the CPU) against heatx's
    ``jax.grad`` through its XLA march in the same mode."""
    htm, ptm = _models(_wide)
    hseq, pseq = _inputs(htm, ptm)
    building = htm._device()
    sb0 = building.surfaces

    def with_params(p):
        sb = dataclasses.replace(sb0, seg_u=sb0.seg_u * p["u"], front_alphas=sb0.front_alphas * p["a"])
        return dataclasses.replace(building, surfaces=sb)

    march_fn = partial(imp_march, substeps=GRAD_TR["substeps"], refresh_h=True,
                       refresh_every=GRAD_TR["refresh_every"])

    def hx_loss(p):
        _, zt = hx_step.run(with_params(p), htm.initial_state(), hseq, march_fn=march_fn)
        return jnp.mean((zt - 21.0) ** 2)

    p0 = {"u": 1.2, "a": 0.9}
    ref_val, ref = unoptimized(jax.value_and_grad(hx_loss))({k: jnp.float64(v) for k, v in p0.items()})

    b = ptm.building
    u0, a0 = torch.as_tensor(b.surfaces.seg_u), torch.as_tensor(b.surfaces.front_alphas)

    def apply_params(p):
        return dataclasses.replace(b, surfaces=dataclasses.replace(
            b.surfaces, seg_u=u0 * p["u"], front_alphas=a0 * p["a"]))

    def loss(zt, xs):
        return torch.mean((zt - 21.0) ** 2)

    runner = ptm.fast_runner(hours=HOURS, **GRAD_TR)
    xs = tree_map(lambda v: v.reshape((1, HOURS) + v.shape[1:]) if v.ndim and v.shape[0] == HOURS
                  else torch.broadcast_to(v, (1,) + v.shape), pseq)
    val, g = chunked_value_and_grad(
        None, {k: torch.tensor(v, dtype=torch.float64) for k, v in p0.items()}, ptm.initial_state(), xs,
        forward_fn=runner.chunk_forward(apply_params, loss), backward_fn=runner.chunk_grad(apply_params, loss))
    assert abs(float(val) - float(ref_val)) <= RTOL * abs(float(ref_val))
    scale = max(abs(float(ref[k])) for k in p0)
    assert scale > 0
    for k in p0:
        assert abs(float(g[k]) - float(ref[k])) <= RTOL * scale, (k, float(g[k]), float(ref[k]))

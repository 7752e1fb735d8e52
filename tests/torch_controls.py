"""Shared set-up of the port's tests of the in-run passive controls
(test_torch_shading.py, test_torch_vent_gates.py): the controlled city in
both packages, its inputs, and heatx's day kernel in interpret mode on the
port's blocked hour inputs.

The buildings are ``testing.build_controlled_city(2, 3)`` (6 surfaces, 2
zones): zone 1's window is controlled by zone 0, so blocking must put both
zones in one block.  The inputs are the bench city's, with 0.1 m3/s of
ventilation per zone at the outdoor temperature, over 12 h from midnight:
zone 0 warms from 16 to 29 C, the setpoints are crossed both ways.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

import bench
import heatx
import heatx.model.building as hmb
from heatx.build.layout import compile_building as hx_compile
from heatx.ops import pallas_step
from heatx_torch import SimConfig, ThermalModel, testing
from heatx_torch.build.layout import compile_building
from torch_reference import unoptimized

HOURS = 12  # three day-march calls of CALL_HOURS
CALL_HOURS = 4
SUB = 2  # TR-BDF2 sub-steps per hour (trbdf2_refresh k=2: one operator group)
BLOCK = 8  # lanes per block, the same in both packages
N_ZONES, SURFACES = 2, 3

#: mode -> (heatx SimConfig, port SimConfig, fast_runner keywords)
MODES = {
    "trbdf2_refresh": (dict(), dict(), dict(mode="trbdf2_refresh", substeps=SUB, refresh_every=2)),
    # The coarse discretization: 6 stability sub-steps per hour.
    "parity": (dict(max_dx=0.5, min_dt=900.0, nomass_fixed_iters=2), dict(max_dx=0.5, min_dt=900.0,
                                                                          nomass_fixed_iters=2),
               dict(mode="parity")),
}


def configs(mode, **kw):
    hx_kw, port_kw, _ = MODES[mode]
    return (heatx.SimConfig(dtype=jnp.float64, **hx_kw, **kw),
            SimConfig(dtype=torch.float64, **port_kw, **kw))


def models(shading=True, gates=True, **kw):
    """The controlled city in heatx's classes and in the port's."""
    ctl = dict(shading=shading, gates=gates, **kw)
    return (testing.build_controlled_city(N_ZONES, SURFACES, base=bench.build_city_model(N_ZONES, SURFACES),
                                          classes=hmb, **ctl),
            testing.build_controlled_city(N_ZONES, SURFACES, **ctl))


def compiled(mode, shading=True, gates=True, **cfg):
    """(heatx's CompiledBuilding, the port's) of :func:`models`."""
    hm, pm = models(shading, gates)
    hx_cfg, port_cfg = configs(mode, **cfg)
    return hx_compile(hm, n=1, config=hx_cfg), compile_building(pm, n=1, config=port_cfg)


def port_inputs(building, hours=HOURS):
    """The port's input sequence (``testing.controlled_city_inputs``)."""
    return testing.controlled_city_inputs(building, hours)


def hx_inputs(tm, seq):
    """heatx's ``inputs_sequence`` of the port's ``StepInputs`` (the same
    values)."""
    T = int(seq.t_out.shape[0])
    kw = {f.name: np.asarray(getattr(seq, f.name)) for f in dataclasses.fields(seq)
          if getattr(seq, f.name) is not None}
    return tm.inputs_sequence(T, **kw)


def zone_history(runner, hist):
    """Blocked per-hour zone rows [T, NB, ZB] -> [T, Z] in zone order."""
    return hist.reshape(hist.shape[0], -1)[:, runner._zinv]


def day_marches(mode, pb, hb, gates_only=False):
    """The port's plain day march and heatx's interpret-mode kernel over
    HOURS in calls of CALL_HOURS on the port's blocked hour inputs (the
    runner's: with a shading setpoint series on a shaded building, the
    gated rows on a gated one), both from the initial state.  Returns
    (port outputs per call, heatx's, the port runner, its inputs)."""
    tm = ThermalModel.from_building(pb, device="cpu")
    runner = tm.fast_runner(block_size=BLOCK, hours=CALL_HOURS, **MODES[mode][2])
    hbb = pallas_step.block_building(hb, block_size=BLOCK, node_split=None)
    np.testing.assert_array_equal(np.asarray(hbb.layout.surf_perm), np.asarray(runner.layout.surf_perm))
    kw = dict(MODES[mode][2], hours=CALL_HOURS, interpret=True, collect_bad=True,
              scheduled_shade_sp=hbb.shade is not None)
    hm, hparams = pallas_step.make_hour_march(hbb, **kw)
    hm = unoptimized(hm)
    seq = port_inputs(pb)
    T, zT = runner.to_blocked(tm.initial_state())
    hT, hzT = jnp.asarray(T.numpy()), jnp.asarray(zT.numpy())
    got, ref = [], []
    for hi in runner.kernel_inputs(seq):
        out = runner.hour_march(runner.params, T, zT, hi)
        r = hm(hparams, hT, hzT, tuple(jnp.asarray(x.numpy()) for x in hi))
        got.append(out)
        ref.append(r)
        T, zT, hT, hzT = out[0], out[1], r[0], r[1]
    return got, ref, runner, seq

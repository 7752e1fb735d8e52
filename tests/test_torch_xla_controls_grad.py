"""The gradient through the in-run passive controls on the XLA path: the
port's autograd through ``engine.step.run`` (the controls at each main
step's start, ``engine/step.py`` ``apply_state_controls``) against heatx's
``jax.grad`` of its ``step.run``, f64, CPU.

heatx's adjoint kernel refuses in-run shading and ventilation gates and
sends the caller to "the XLA backward" (pallas_adjoint.py:162-171); the
port's refusals (``ops/day_adjoint.py`` ``refuse_gates``, ``FastRunner.
chunk_grad``) send the caller here.  The building is
``testing.build_controlled_city(2, 3)`` (a shaded window in each zone, zone
1's controlled by zone 0; ventilation gates in both), 2 h at the coarse
discretization's 6 parity sub-steps an hour, with a scheduled ``shade_sp``
and the gates' ventilation channel.  The loss weighs the zone history and
the final node columns by seeded weights; the gradient is taken in the
initial state, the front solar (which shading scales), the outdoor air, and
the ventilation's inlet temperature and flow (which the gates switch),
and agrees within 1e-9 of each gradient's largest magnitude.  Each
control's decision is held fixed within a main step in both packages (the
gradient of the march the decisions give).

heatx's reference is compiled without XLA's backend optimizations
(``torch_reference.unoptimized``): with them, XLA's CPU build of heatx's own
parity-path gradient parts from heatx's eager gradient and from its
unoptimized build by up to ~10 % of the node columns' gradient (ROADMAP C16),
while those two and the port's agree to 1e-16.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import bench
import heatx
import heatx.model.building as hmb
from heatx.engine import step as hx_step
from heatx_torch import SimConfig, ThermalModel, testing
from heatx_torch.engine import step as step_mod
from torch_reference import unoptimized

torch.set_num_threads(1)

RTOL = 1e-9
HOURS = 2
COARSE = dict(max_dx=0.5, min_dt=900.0, nomass_fixed_iters=2)


def _setup():
    htm = heatx.ThermalModel(
        testing.build_controlled_city(2, 3, base=bench.build_city_model(2, 3), classes=hmb),
        config=heatx.SimConfig(dtype=jnp.float64, **COARSE))
    ptm = ThermalModel(testing.build_controlled_city(2, 3), config=SimConfig(dtype=torch.float64, **COARSE),
                       device="cpu")
    assert htm.dt_subdivisions == ptm.dt_subdivisions == 6
    b = ptm.building
    assert b.has_zone_shading and b.has_vent_gates
    seq = testing.controlled_city_inputs(b, HOURS)
    kw = {f.name: getattr(seq, f.name).numpy() for f in dataclasses.fields(seq)
          if getattr(seq, f.name) is not None}
    # The first hour takes the compiled setpoints' schedule values, the
    # second a setpoint that deploys every shade (zone air above 10 C).
    kw["shade_sp"] = np.where(np.arange(HOURS)[:, None] == 0, 20.0, 10.0) * np.ones((HOURS, b.n_surfaces))
    # A warm start puts both zones above the gates' 18 C and the outdoor air
    # 2 K below them: the gates open.
    kw["t_out"] = np.asarray(kw["t_out"]) + 10.0
    kw["vent_temp"] = np.asarray(kw["vent_temp"]) + 10.0
    return htm, ptm, htm.inputs_sequence(HOURS, **kw), ptm.inputs_sequence(HOURS, **kw), kw


def test_xla_controls_gradient_matches_heatx():
    htm, ptm, hseq, pseq, kw = _setup()
    rng = np.random.default_rng(7)
    hst, pst = htm.initial_state(), ptm.initial_state()
    z0 = np.array([24.0, 21.5])
    n0 = np.asarray(pst.node_T.numpy()) + 3.0
    wz = rng.normal(size=(HOURS, 2))
    wn = rng.normal(size=n0.shape) * np.asarray(htm.building.surfaces.node_mask)
    names = ("sol_front", "t_out", "vent_temp", "vent_vol")
    x0 = (z0, n0, *(np.asarray(getattr(hseq, k), np.float64) for k in names))
    for k in names:
        assert tuple(getattr(pseq, k).shape) == np.shape(getattr(hseq, k)), k

    def hx_loss(zT, nT, *leaves):
        st = hst._replace(zone_T=zT, node_T=nT)
        seq = hseq._replace(**dict(zip(names, leaves)))
        final, zt = hx_step.run(htm.building, st, seq)
        return jnp.sum(wz * zt) + jnp.sum(wn * final.node_T), zt

    (ref_val, ref_zt), ref = unoptimized(jax.value_and_grad(hx_loss, argnums=tuple(range(len(x0))), has_aux=True))(
        *(jnp.asarray(x) for x in x0))

    xs = [torch.tensor(x, dtype=torch.float64, requires_grad=True) for x in x0]
    st = dataclasses.replace(pst, zone_T=xs[0], node_T=xs[1])
    seq = pseq.replace(**dict(zip(names, xs[2:])))
    final, zt = step_mod.run(step_mod.device_building(ptm.building), st, seq)
    val = (torch.as_tensor(wz) * zt).sum() + (torch.as_tensor(wn) * final.node_T).sum()
    got = torch.autograd.grad(val, xs)

    np.testing.assert_allclose(zt.detach().numpy(), np.asarray(ref_zt), rtol=0, atol=1e-9)
    assert abs(float(val.detach()) - float(ref_val)) <= RTOL * abs(float(ref_val))
    for name, g, r in zip(("zone_T0", "node_T0") + names, got, ref):
        r = np.asarray(r)
        scale = float(np.abs(r).max())
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=RTOL * scale, err_msg=name)
    # Both controls act on this run: every shade deploys in hour 2, and the
    # gates open (their ventilation's inlet temperature has a gradient).
    d = testing.control_decisions(ptm.building, zt.detach().numpy(), np.asarray(kw["t_out"]),
                                  np.asarray(kw["wind_speed"]), shade_sp=kw["shade_sp"], zone_T0=z0)
    assert d["shade"][1].all() and d["vent"].any()
    assert float(np.abs(np.asarray(ref[4])).max()) > 0

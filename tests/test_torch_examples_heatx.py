"""optimal_control of examples_torch/ against heatx's XLA-path routes
of the same computations, f64, CPU, at their smoke sizes
(``HEATX_EXAMPLE_FAST=1``), the models built from the same numbers in both
packages (each example's builder takes heatx's model classes); the other
examples in tests/test_torch_examples_heatx_*.py.

* ``optimal_control`` phase 1: tests/test_torch_examples_heatx_power.py;
* ``optimal_control`` phase 2 on its 2-zone variant (one schedule a zone):
  the kernel route's objective and schedule gradient (``chunk_forward``/
  ``chunk_grad`` with ``schedule_fn``, the plain day march and adjoint
  here) against heatx's scan of ``imp_march`` with the scheduled setpoints,
  every zone; the example's finite-difference gate passes on every zone, and
  fails when the adjoint's setpoint cotangents come back with the zones
  swapped;
* the calibrations: tests/test_torch_examples_heatx_calibrate.py and
  tests/test_torch_examples_heatx_demand.py.

Values and gradients within 1e-9 relative.  heatx's interpret-mode kernels
are never called: heatx's XLA path is the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_examples_ref import CPU, RTOL, example, hx_model, rel
from torch_reference import unoptimized

from heatx.engine import implicit as hx_imp
from heatx_torch.api import FastRunner

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def schedule_case():
    """optimal_control's setpoint phase on its 2-zone variant: the port's
    kernel route, its first value and gradient, and heatx's."""
    oc = example("optimal_control")
    pb = oc.setpoint_problem(True, CPU, zones=2)
    val, g = oc.value_and_grad(pb, pb.params)

    htm = hx_model(oc.build, 2, thermostat=True)
    hb, hst = htm._device(), htm.initial_state()
    T = pb.T
    t_out = -12.0 + 4.0 * np.sin((np.arange(T) - 8) / 24 * 2 * np.pi)
    hseq = htm.inputs_sequence(T, t_out=jnp.asarray(t_out), wind_speed=3.0, wind_direction=45.0)
    occ = jnp.asarray(pb.occ)[:, None]

    def objective(raw):
        sp = 14.0 + 8.0 * jax.nn.sigmoid(raw)

        def hour(s, xs):
            h, sp_h = xs
            x = jax.tree.map(lambda v: v[h] if v.ndim and v.shape[0] == T else v, hseq)
            s = hx_imp.imp_march(hb, s, x._replace(heat_sp=sp_h), substeps=oc.SUBS)
            return s, (s.zone_T, s.ideal_load)

        _, (zt, ld) = jax.lax.scan(hour, hst, (jnp.arange(T), sp))
        discomfort = jnp.sum(jnp.where(occ, jnp.maximum(oc.COMFORT - zt, 0.0) ** 2, 0.0))
        return jnp.sum(ld) / 1e3 + oc.WEIGHT * discomfort

    hval, hg = unoptimized(jax.value_and_grad(objective))(jnp.asarray(pb.params["raw"].numpy()))
    return oc, pb, val, g, hval, hg


def test_optimal_control_schedule_gradient_matches_heatx(schedule_case):
    oc, pb, val, g, hval, hg = schedule_case
    assert pb.Z == 2 and tuple(g["raw"].shape) == (pb.T, 2)
    assert rel(float(val), float(hval)) <= RTOL
    for z in range(pb.Z):  # zone by zone: a swap of the zones' cotangents shows here
        assert np.abs(g["raw"][:, z].numpy()).max() > 0
        assert rel(g["raw"][:, z].numpy(), np.asarray(hg)[:, z]) <= RTOL, z


def test_optimal_control_fd_gate_every_zone(schedule_case):
    oc, pb, val, g, _, _ = schedule_case
    rows = oc.fd_gate(pb, pb.params, g)
    assert len(rows) == pb.Z and all(rel < oc.FD_RTOL for _, _, rel in rows)


def test_optimal_control_fd_gate_catches_swapped_setpoint_cotangents(schedule_case, monkeypatch):
    """The adjoint's ``d_sp_heat [hours, NB, ZB]`` returned with the two
    zones' slots swapped: the schedule gradient is still nonzero, and the
    example's per-zone gate must fail."""
    oc, pb, _, _, _, _ = schedule_case
    make_adjoint = FastRunner.make_adjoint

    def swapped(self):
        raw = make_adjoint(self)
        slots = np.flatnonzero(np.asarray(self.layout.zone_table).reshape(-1) >= 0)
        assert len(slots) == 2

        def adjoint(*args, **kw):
            out = list(raw(*args, **kw))
            d = out[9].reshape(out[9].shape[0], -1).clone()
            d[:, slots] = d[:, slots[::-1].copy()]
            out[9] = d.reshape(out[9].shape)
            return tuple(out)

        return adjoint

    monkeypatch.setattr(FastRunner, "make_adjoint", swapped)
    bad = oc.setpoint_problem(True, CPU, zones=2)
    _, g_bad = oc.value_and_grad(bad, bad.params)
    assert float(g_bad["raw"].abs().max()) > 0
    with pytest.raises(AssertionError):
        oc.fd_gate(bad, bad.params, g_bad)

"""optimal_control of examples_torch/: its smoke run, and its phase 1
against heatx's XLA path, f64, CPU.  One run of the example's ``main``
(``HEATX_EXAMPLE_FAST=1 --platform cpu``, its closing asserts included)
serves both tests: it records phase 1's first heater-power objective and
its gradient at the start point (autograd through a loop of ``imp_march``,
24 h at 8 sub-steps), which are held against heatx's
``jax.value_and_grad`` through ``imp_march`` under ``jax.lax.scan`` on
heatx's one-room building built from the same numbers, within 1e-9
relative.  The other examples' smoke runs are tests/test_torch_examples.py's;
phase 2 against heatx is tests/test_torch_examples_heatx.py's.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_examples_ref import RTOL, example, hx_model, rel
from torch_reference import unoptimized

from heatx.engine import implicit as hx_imp

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def smoke_run(tmp_path_factory):
    """The example's smoke run: its printed output and phase 1's first
    (objective, gradient)."""
    oc = example("optimal_control")
    first = {}
    objective = oc.power_objective

    def recording(tm, seq, T, raw):
        val = objective(tm, seq, T, raw)
        if not first:
            first["val"] = val.detach().clone()
            raw.register_hook(lambda g: first.setdefault("grad", g.detach().clone()))
        return val

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HEATX_EXAMPLE_FAST", "1")
        mp.setenv("TMPDIR", str(tmp_path_factory.mktemp("optimal_control")))
        mp.setattr("tempfile.tempdir", None)
        mp.setattr(oc, "power_objective", recording)
        with contextlib.redirect_stdout(io.StringIO()) as out:
            rc = oc.main(["--platform", "cpu"])
    return oc, rc, out.getvalue(), first


def test_optimal_control_runs_on_cpu(smoke_run):
    _, rc, out, _ = smoke_run
    assert rc in (None, 0)
    assert "optimal control OK" in out.rstrip().splitlines()[-1], out[-800:]
    for engine in ("(xla engine)", "(kernel engine)"):
        assert engine in out, (engine, out[-800:])


def test_optimal_control_power_phase_matches_heatx(smoke_run):
    oc, _, _, first = smoke_run
    val, g = first["val"], first["grad"]
    T = g.shape[0]

    htm = hx_model(oc.build)
    hb, hst = htm._device(), htm.initial_state()
    t_out = -2.0 + 6.0 * np.sin((np.arange(T) - 8) / 24 * 2 * np.pi)
    one = htm.inputs(t_out=0.0, wind_speed=3.0, wind_direction=45.0)
    hseq = jax.tree.map(lambda x: jnp.broadcast_to(x, (T,) + jnp.shape(x)), one)._replace(t_out=jnp.asarray(t_out))

    def objective(r):
        p = jax.nn.softplus(r)

        def hour(s, xs):
            x, ph = xs
            s = hx_imp.imp_march(hb, s, x._replace(hvac_power=jnp.atleast_1d(ph) * 1e3), substeps=8)
            return s, s.zone_T[0]

        _, zt = jax.lax.scan(hour, hst, (hseq, p))
        return jnp.sum(p) + oc.COMFORT_WEIGHT * jnp.sum(jnp.maximum(oc.SETPOINT - zt, 0.0) ** 2)

    # the example's start point, raw = 1 (softplus: ~1.3 kW flat)
    hval, hg = unoptimized(jax.value_and_grad(objective))(jnp.full((T,), 1.0))
    assert rel(float(val), float(hval)) <= RTOL
    assert rel(g.numpy(), hg) <= RTOL

"""In-run zone shading in the port against heatx, f64, CPU.

The controlled city of tests/torch_controls.py (2 zones, one window
controlled by the other zone) and heatx's kernel tests of the control
(tests/test_zone_shading.py:269-317), held at 1e-9 K:

* the blocked operands: the controlling zone's block-local slot per lane
  against heatx's one-hot (its argmax), the transmittances and setpoints;
* the plain day march against heatx's kernel in interpret mode, 12 h in
  calls of 4 h, trbdf2_refresh (k=2, 2 sub-steps) and parity (6 sub-steps),
  with shading alone and with the ventilation gates too; each run deploys
  and retracts the devices (5-95 % of the decisions deployed);
* ``FastRunner.run`` against heatx's with a ``[T, S]`` ``shade_sp`` series
  that forbids deployment for some hours (+1e9), and with interior MRT and
  the operative history;
* heatx's operands carried across by ``convert``;
* heatx's kernel-test properties on the port: a +1e9 series is bit-equal
  to the uncontrolled building, an always-deployed control equals the
  uncontrolled building with pre-scaled solar within 1e-12;
* the refusals: ``chunk_grad``, ``make_day_adjoint`` and backward through a
  shaded march; ``shade_sp`` on an unshaded building; shapes that are not
  scalar, ``[S]`` or ``[T, S]``.
"""

import numpy as np
import pytest
import torch

import heatx
from heatx.ops import pallas_step
from heatx_torch import ThermalModel, convert, testing
from heatx_torch.ops import day_adjoint, day_march
from torch_controls import (
    BLOCK, CALL_HOURS, HOURS, MODES, compiled, day_marches, hx_inputs, models, port_inputs, zone_history,
)

torch.set_num_threads(1)

ATOL_K = 1e-9
KW = MODES["trbdf2_refresh"][2]


def _toggled(share, what):
    assert 0.05 < share < 0.95, f"{what}: {share:.0%} of the decisions deployed; the test would be vacuous"


def _hist(outs):
    return torch.cat([o[3] for o in outs])


@pytest.mark.parametrize("kind", ["shading", "both"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_plain_day_march_matches_heatx_kernel(mode, kind):
    hb, pb = compiled(mode, shading=True, gates=kind == "both")
    got, ref, runner, seq = day_marches(mode, pb, hb)
    for out, r in zip(got, ref):
        for name, i in (("T", 0), ("zT", 1), ("zt_hist", 3)):
            np.testing.assert_allclose(out[i].numpy(), np.asarray(r[i]), rtol=0, atol=ATOL_K, err_msg=name)
    d = testing.control_decisions(pb, zone_history(runner, _hist(got)).numpy(), seq.t_out.numpy(),
                                  seq.wind_speed.numpy())
    _toggled(d["shade"].mean(), f"{mode} {kind} shading")
    if kind == "both":
        _toggled(d["vent"].mean(), f"{mode} {kind} ventilation")


def test_blocked_shade_operands_match_heatx():
    hb, pb = compiled("trbdf2_refresh")
    hbb = pallas_step.block_building(hb, block_size=BLOCK, node_split=None)
    pbb = day_march.block_building(pb, block_size=BLOCK)
    oh, tau, sp = (np.asarray(x) for x in hbb.shade)
    slot = np.where(oh.any(axis=1), oh.argmax(axis=1), -1)
    np.testing.assert_array_equal(pbb.shade[0], slot)
    np.testing.assert_array_equal(pbb.shade[1], tau)
    np.testing.assert_array_equal(pbb.shade[2], sp)
    # Zone 1's window is controlled by zone 0: its slot is not its own zone's.
    own = day_march.local_zone(pbb.back_oh)
    remote = (slot >= 0) & (slot != own)
    assert remote.sum() == 1 and (slot >= 0).sum() == 2
    assert ((tau == 1.0) & (sp == 1e9))[slot < 0].all()
    params = day_march.params_from_blocked(pbb, torch.float64, "cpu")
    assert torch.equal(params.shade_slot, torch.as_tensor(slot, dtype=torch.int32))
    assert torch.equal(params.field("shade_tau"), torch.as_tensor(tau))


@pytest.fixture(scope="module")
def series_case():
    """heatx's FastRunner.run with a [T, S] shade_sp series that forbids
    deployment in hours 4-7 (+1e9), trbdf2_refresh k=2."""
    hb, pb = compiled("trbdf2_refresh", gates=False)
    tmh = heatx.ThermalModel(models(gates=False)[0], n=1, config=hb.config)
    tm = ThermalModel.from_building(pb, device="cpu")
    seq = port_inputs(pb)
    series = np.broadcast_to(pb.shade_sp, (HOURS, pb.n_surfaces)).copy()
    series[4:8] = 1e9
    seq = seq.replace(shade_sp=torch.as_tensor(series))
    fr = tmh.fast_runner(block_size=BLOCK, hours=CALL_HOURS, interpret=True, **KW)
    _, zt = fr.run(tmh.initial_state(), hx_inputs(tmh, seq))
    return tm, seq, np.asarray(zt)


def test_run_with_shade_sp_series_matches_heatx(series_case):
    tm, seq, ref = series_case
    fr = tm.fast_runner(hours=CALL_HOURS, **KW)
    _, zt = fr.run(tm.initial_state(), seq)
    np.testing.assert_allclose(zt.numpy(), ref, rtol=0, atol=ATOL_K)
    d = testing.control_decisions(tm.building, zt.numpy(), seq.t_out.numpy(), seq.wind_speed.numpy(),
                                  shade_sp=seq.shade_sp.numpy())
    _toggled(d["shade"].mean(), "shade_sp series")
    assert not d["shade"][4:8].any()
    # The series reaches the kernel inputs as the trailing leaf.
    hi = fr.kernel_inputs(seq)[1]
    assert len(hi) == 10 and float(hi[-1].max()) == 1e9
    # Without it, the compiled setpoints apply: a different run.
    _, z0 = fr.run(tm.initial_state(), seq.replace(shade_sp=None))
    assert float((z0 - zt).abs().max()) > 1e-3


def test_mrt_with_shading_and_operative_matches_heatx():
    hb, pb = compiled("trbdf2_refresh", gates=False, interior_mrt=True)
    tmh = heatx.ThermalModel(models(gates=False)[0], n=1, config=hb.config)
    tm = ThermalModel.from_building(pb, device="cpu")
    seq = port_inputs(pb)
    frh = tmh.fast_runner(block_size=BLOCK, hours=CALL_HOURS, interpret=True, collect_operative=True, **KW)
    _, zt_ref, top_ref = frh.run(tmh.initial_state(), hx_inputs(tmh, seq), collect_operative=True)
    fr = tm.fast_runner(hours=CALL_HOURS, collect_operative=True, **KW)
    _, zt, top = fr.run(tm.initial_state(), seq, collect_operative=True)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zt_ref), rtol=0, atol=ATOL_K)
    np.testing.assert_allclose(top.numpy(), np.asarray(top_ref), rtol=0, atol=ATOL_K)
    d = testing.control_decisions(pb, zt.numpy(), seq.t_out.numpy(), seq.wind_speed.numpy())
    _toggled(d["shade"].mean(), "MRT shading")


def test_convert_carries_heatx_shade_operands():
    """heatx's blocked operands (``shade_ohT`` and its rows, the vent rows)
    become the port's, and ``FastRunner.run`` on them gives heatx's run."""
    hb, pb = compiled("trbdf2_refresh")
    hbb = pallas_step.block_building(hb, block_size=BLOCK, node_split=None)
    hm, hparams = pallas_step.make_hour_march(hbb, interpret=True, hours=CALL_HOURS, scheduled_shade_sp=True,
                                              **KW)
    parts = pallas_step._prep_parts(hbb, np.float64, True)
    names = parts.part_node_names[0] + parts.part_surf_names[0] + parts.part_aux_names[0]
    ops = {n: np.asarray(hparams[i]) for i, n in enumerate(names)}
    ops["zone_volume"] = np.asarray(hparams[len(names)])
    ops["vent_min"], ops["vent_max"] = (np.asarray(hparams[len(names) + 1 + k]) for k in (0, 1))
    assert "shade_ohT" in ops and "shade_tau" in ops
    carried = convert.params_from_kernel_operands(ops, hbb.n_blocks, dtype=torch.float64)
    tm = ThermalModel.from_building(pb, device="cpu")
    fr = tm.fast_runner(block_size=BLOCK, hours=CALL_HOURS, **KW)
    for name in ("shade_slot", "shade", "vent", "lane"):
        assert torch.equal(getattr(carried, name), getattr(fr.params, name)), name
    seq = port_inputs(pb)
    tmh = heatx.ThermalModel(models()[0], n=1, config=hb.config)
    _, ref = tmh.fast_runner(block_size=BLOCK, hours=CALL_HOURS, interpret=True, **KW).run(
        tmh.initial_state(), hx_inputs(tmh, seq))
    fr.params = carried
    _, zt = fr.run(tm.initial_state(), seq)
    np.testing.assert_allclose(zt.numpy(), np.asarray(ref), rtol=0, atol=ATOL_K)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_never_and_always_deployed(mode):
    """heatx's kernel-test properties on the port: a +1e9 series equals the
    uncontrolled building bit for bit; a setpoint of -1e9 (always deployed)
    equals the uncontrolled building with the windows' solar pre-scaled by
    tau, within 1e-12."""
    _, pb = compiled(mode, gates=False)
    _, p0 = compiled(mode, shading=False, gates=False)
    tm, tm0 = ThermalModel.from_building(pb, device="cpu"), ThermalModel.from_building(p0, device="cpu")
    rkw = dict(hours=CALL_HOURS, **MODES[mode][2])
    fr, fr0 = tm.fast_runner(**rkw), tm0.fast_runner(**rkw)
    seq, seq0 = port_inputs(pb), port_inputs(p0)
    _, z_never = fr.run(tm.initial_state(), seq.replace(shade_sp=torch.full((HOURS, pb.n_surfaces), 1e9)))
    _, z_off = fr0.run(tm0.initial_state(), seq0)
    assert torch.equal(z_never, z_off)
    _, z_on = fr.run(tm.initial_state(), seq.replace(shade_sp=-1e9))
    panes = torch.as_tensor(np.asarray(pb.shade_zone) >= 0)
    scaled = torch.where(panes, seq0.sol_front * 0.3, seq0.sol_front)
    _, z_ref = fr0.run(tm0.initial_state(), seq0.replace(sol_front=scaled))
    np.testing.assert_allclose(z_on.numpy(), z_ref.numpy(), rtol=0, atol=1e-12)
    assert float((z_on - z_off).abs().max()) > 1e-2


def _shaded():
    _, pb = compiled("trbdf2_refresh", gates=False)
    return ThermalModel.from_building(pb, device="cpu")


def _backward_through_day_march():
    tm = _shaded()
    fr = tm.fast_runner(hours=CALL_HOURS, **KW)
    adj = day_adjoint.DayAdjoint.__new__(day_adjoint.DayAdjoint)  # any backward: it must not be reached
    p = fr.params
    node = p.node.clone().requires_grad_()
    T, zT = fr.to_blocked(tm.initial_state())
    hi = fr.kernel_inputs(port_inputs(tm.building, CALL_HOURS))[0]
    out = day_adjoint.DayMarchFn.apply(fr.hour_march, adj, p, node, p.surf, p.zone_volume, T, zT, *hi)
    out[1].sum().backward()


def _autograd_through_plain_march():
    tm = _shaded()
    fr = tm.fast_runner(hours=CALL_HOURS, **KW)
    T, zT = fr.to_blocked(tm.initial_state())
    hi = fr.kernel_inputs(port_inputs(tm.building, CALL_HOURS))[0]
    fr.hour_march(fr.params, T.clone().requires_grad_(), zT, hi)


def _chunk_grad():
    fr = _shaded().fast_runner(hours=CALL_HOURS, **KW)
    fr.chunk_grad(lambda p: fr._tm.building, lambda zt, xs: zt.sum())


def _make_day_adjoint():
    tm = _shaded()
    day_adjoint.make_day_adjoint(day_march.block_building(tm.building), substeps=2, mode="trbdf2_refresh",
                                 hours=CALL_HOURS, refresh_every=2, device="cpu")


def _unshaded_shade_sp():
    _, p0 = compiled("trbdf2_refresh", shading=False, gates=False)
    tm = ThermalModel.from_building(p0, device="cpu")
    tm.fast_runner(hours=CALL_HOURS, **KW).run(tm.initial_state(), port_inputs(p0).replace(shade_sp=25.0))


def _bad_shape(shape):
    def run():
        tm = _shaded()
        tm.fast_runner(hours=CALL_HOURS, **KW).run(
            tm.initial_state(), port_inputs(tm.building).replace(shade_sp=torch.full(shape, 25.0)))
    return run


def _unshaded_scheduled_shade_sp():
    _, p0 = compiled("trbdf2_refresh", shading=False, gates=False)
    day_march.make_hour_march(day_march.block_building(p0), device="cpu", scheduled_shade_sp=True)


# The refusals send the caller to the XLA path (tests/test_torch_xla_controls_grad.py).
XLA_BACKWARD = r" \(use the XLA backward: autograd through ThermalModel\.run, engine\.step\.run\)"


@pytest.mark.parametrize("call, match", [
    (_chunk_grad, "chunk_grad: in-run zone shading is not supported" + XLA_BACKWARD),
    (_make_day_adjoint, "in-run zone shading is not supported" + XLA_BACKWARD),
    (_backward_through_day_march, "in-run zone shading is not supported" + XLA_BACKWARD),
    (_autograd_through_plain_march, "in-run zone shading and ventilation gates"),
    (_unshaded_shade_sp, "shade_sp requires in-run zone-shading controls"),
    (_bad_shape((HOURS, 7)), "shade_sp schedule shape"),
    (_bad_shape((HOURS, 6, 1)), "shade_sp schedule shape"),
    (_unshaded_scheduled_shade_sp, "scheduled_shade_sp requires"),
], ids=["chunk_grad", "make_day_adjoint", "day_march_fn_backward", "plain_autograd", "unshaded_shade_sp",
        "shape_T_S_plus_1", "shape_3d", "scheduled_without_shading"])
def test_shading_refusals(call, match):
    with pytest.raises(ValueError, match=match):
        call()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(MODES))
def test_shaded_kernel_matches_plain_on_cuda(mode):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    _, pb = compiled(mode)
    tm = ThermalModel.from_building(pb, device="cuda")
    fr = tm.fast_runner(hours=CALL_HOURS, **MODES[mode][2])
    T, zT = fr.to_blocked(tm.initial_state())
    hi = fr.kernel_inputs(testing.controlled_city_inputs(pb, CALL_HOURS, device="cuda"))[0]
    got, ref = fr.hour_march(fr.params, T, zT, hi), fr.hour_march.plain(fr.params, T, zT, hi)
    for i in (0, 1, 3):
        assert float((got[i] - ref[i]).abs().max()) <= ATOL_K

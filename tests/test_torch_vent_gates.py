"""In-run ventilation gates in the port against heatx, f64, CPU.

The controlled city of tests/torch_controls.py (every zone gated at 18 C
indoors and a delta of 2 K, zone 0 closed above 15.5 C outdoors, zone 1 at
4 m/s of wind) and heatx's kernel tests of the gates
(tests/test_vent_gates.py:336-376), held at 1e-9 K:

* the blocked indoor limits against heatx's;
* the plain day march against heatx's kernel in interpret mode on the
  12-leaf hour inputs, 12 h in calls of 4 h, trbdf2_refresh (k=2, 2
  sub-steps) and parity (6 sub-steps); each run opens and closes the vents
  (5-95 % of the decisions open);
* ``FastRunner.run`` against heatx's with the outdoor and wind gates, which
  the host applies from the hourly weather (the march's interpolated
  sub-steps do not move them); with thermostats and ``collect_loads``;
* the controlled office IDF (``testing.controlled_office_idf``: the argon
  window shaded on a schedule, the ventilation's indoor and delta limits,
  thermostats, ground swaps) over 48 h;
* a no-op control (EnergyPlus's default limits) equals the ungated building
  within 1e-12;
* ``chunk_forward`` runs a gated and shaded building (its loss is the run's);
* the refusals: ``chunk_grad``, ``make_day_adjoint`` and backward through a
  gated march; a 9-leaf hour input on a gated march.
"""

import dataclasses

import numpy as np
import pytest
import torch

import heatx
import heatx.model.building as hmb
from heatx.model.idf import load_idf as hx_load_idf
from heatx.ops import pallas_step
from heatx_torch import SimConfig, ThermalModel, testing
from heatx_torch.model import building as pmb
from heatx_torch.model.idf import load_idf
from heatx_torch.ops import day_adjoint, day_march
from heatx_torch.weather.epw import read_epw
from torch_controls import BLOCK, CALL_HOURS, MODES, compiled, configs, day_marches, hx_inputs, models, port_inputs

torch.set_num_threads(1)

ATOL_K = 1e-9
KW = MODES["trbdf2_refresh"][2]


def _toggled(share, what):
    assert 0.05 < share < 0.95, f"{what}: {share:.0%} of the decisions open; the test would be vacuous"


def _decisions(pb, zt, seq):
    return testing.control_decisions(pb, zt.numpy(), seq.t_out.numpy(), seq.wind_speed.numpy())


@pytest.mark.parametrize("mode", sorted(MODES))
def test_plain_day_march_matches_heatx_kernel(mode):
    hb, pb = compiled(mode, shading=False)
    got, ref, runner, seq = day_marches(mode, pb, hb)
    assert all(len(hi) == 12 for hi in runner.kernel_inputs(seq))
    for out, r in zip(got, ref):
        for name, i in (("T", 0), ("zT", 1), ("zt_hist", 3)):
            np.testing.assert_allclose(out[i].numpy(), np.asarray(r[i]), rtol=0, atol=ATOL_K, err_msg=name)
    hist = torch.cat([o[3] for o in got])
    _toggled(_decisions(pb, hist.reshape(hist.shape[0], -1)[:, runner._zinv], seq)["vent"].mean(), mode)


def test_blocked_vent_operands_match_heatx():
    hb, pb = compiled("trbdf2_refresh", shading=False)
    hbb = pallas_step.block_building(hb, block_size=BLOCK, node_split=None)
    pbb = day_march.block_building(pb, block_size=BLOCK)
    for got, ref in zip(pbb.vent, hbb.vent):
        np.testing.assert_array_equal(got, np.asarray(ref))
    assert pbb.shade is None and (pbb.vent[0][pbb.zone_valid] == 18.0).all()
    params = day_march.params_from_blocked(pbb, torch.float64, "cpu")
    assert params.gated and params.shade_slot is None
    assert tuple(params.vent.shape) == (2, pbb.n_blocks, pbb.zones_per_block)


def _hx_run(hb_model, cfg, seq, runner_kw=None, block_size=BLOCK, **run_kw):
    tmh = heatx.ThermalModel(hb_model, n=1, config=cfg)
    fr = tmh.fast_runner(block_size=block_size, interpret=True, **(runner_kw or dict(hours=CALL_HOURS, **KW)))
    return fr.run(tmh.initial_state(), hx_inputs(tmh, seq), **run_kw)


def test_run_with_outdoor_and_wind_gates_matches_heatx():
    """The host's gates read each hour's outdoor temperature and wind, not
    the interpolated sub-steps of ``interp_weather``."""
    hm, _ = models(shading=False)
    hb_cfg, _ = configs("trbdf2_refresh")
    _, pb = compiled("trbdf2_refresh", shading=False)
    tm = ThermalModel.from_building(pb, device="cpu")
    seq = port_inputs(pb)
    _, ref = _hx_run(hm, hb_cfg, seq, interp_weather=True)
    fr = tm.fast_runner(hours=CALL_HOURS, **KW)
    _, zt = fr.run(tm.initial_state(), seq, interp_weather=True)
    np.testing.assert_allclose(zt.numpy(), np.asarray(ref), rtol=0, atol=ATOL_K)
    t_o, w = seq.t_out.numpy(), seq.wind_speed.numpy()
    assert (t_o > 15.5).any() and (t_o < 15.5).any() and (w > 4.0).any() and (w < 4.0).any()
    d = _decisions(pb, zt, seq)
    _toggled(d["vent"][:, 0].mean(), "zone 0 (outdoor gate)")
    _toggled(d["vent"][:, 1].mean(), "zone 1 (wind gate)")
    # The host's rows: closed where the weather closes them.
    a_vent = torch.stack([hi[9] for hi in fr.kernel_inputs(seq)]).reshape(len(t_o), -1)[:, fr._zinv]
    assert bool((a_vent[torch.as_tensor(t_o > 15.5), 0] == 0).all())
    assert bool((a_vent[torch.as_tensor(w > 4.0), 1] == 0).all()) and bool((a_vent != 0).any())


def _with_thermostat(m, classes):
    m.add_hvac(classes.IdealHeaterCooler("t0", ["z0"], heat_setpoint=19.0, cool_setpoint=25.0))
    return m


def test_thermostats_with_gates_and_loads_match_heatx():
    hm, pm = models(shading=False)
    hb_cfg, pb_cfg = configs("trbdf2_refresh")
    tm = ThermalModel(_with_thermostat(pm, pmb), config=pb_cfg, device="cpu")
    seq = port_inputs(tm.building)
    _, ref_zt, ref_ld = _hx_run(_with_thermostat(hm, hmb), hb_cfg, seq, collect_loads=True)
    _, zt, ld = tm.fast_runner(hours=CALL_HOURS, **KW).run(tm.initial_state(), seq, collect_loads=True)
    np.testing.assert_allclose(zt.numpy(), np.asarray(ref_zt), rtol=0, atol=ATOL_K)
    scale = np.abs(np.asarray(ref_ld)).max()
    np.testing.assert_allclose(ld.numpy(), np.asarray(ref_ld), rtol=0, atol=1e-9 * scale)
    assert (np.asarray(ref_ld) > 0).any() and (np.asarray(ref_ld) < 0).any()
    _toggled(_decisions(tm.building, zt, seq)["vent"].mean(), "thermostat building")


OFFICE_HOURS = 48
OFFICE_KW = dict(mode="trbdf2", substeps=2, hours=24, scheduled_setpoints=True)


def test_controlled_office_matches_heatx(tmp_path):
    """Gas cavities, thermostats, ground swaps, the scheduled shade and the
    vent gates in one building, 48 h."""
    text = testing.controlled_office_idf()
    loaded, hx_loaded = load_idf(text), hx_load_idf(text)
    assert repr(loaded.model) == repr(hx_loaded.model)
    tm = ThermalModel(loaded.model, config=SimConfig(dtype=torch.float64), device="cpu")
    b = tm.building
    assert b.surfaces.has_cavity and b.has_zone_shading and b.has_vent_gates and b.has_ideal_hvac
    w = read_epw(testing.write_synthetic_epw(tmp_path / "syn.epw", seed=3))
    seq, ground = testing.office_inputs(loaded, tm, w, OFFICE_HOURS)
    series = loaded.shading_setpoint_series(OFFICE_HOURS)
    assert np.array_equal(np.unique(series), [23.0, 1e9])
    seq = seq.replace(shade_sp=torch.as_tensor(series))
    _, ref_zt, ref_ld = _hx_run(hx_loaded.model, heatx.SimConfig(dtype=np.float64), seq, OFFICE_KW,
                                block_size=16, ground_hourly=ground, collect_loads=True)
    fr = tm.fast_runner(**OFFICE_KW)
    _, zt, ld = fr.run(tm.initial_state(), seq, ground_hourly=ground, collect_loads=True)
    np.testing.assert_allclose(zt.numpy(), np.asarray(ref_zt), rtol=0, atol=ATOL_K)
    scale = np.abs(np.asarray(ref_ld)).max()
    np.testing.assert_allclose(ld.numpy(), np.asarray(ref_ld), rtol=0, atol=1e-9 * scale)
    d = testing.control_decisions(b, zt.numpy(), seq.t_out.numpy(), seq.wind_speed.numpy(), shade_sp=series)
    _toggled(d["shade"].mean(), "office shade")
    _toggled(d["vent"].mean(), "office vents")


@pytest.mark.parametrize("mode", sorted(MODES))
def test_noop_control_equals_ungated(mode):
    """A default-constructed control (EnergyPlus's no-op limits) takes the
    gated path and equals the ungated building within 1e-12."""
    _, p0 = compiled(mode, shading=False, gates=False)
    pm = testing.build_city_model(2, 3)
    pm.add_vent_control(pmb.ZoneVentilationControl("z0"))
    pb = ThermalModel(pm, config=p0.config, device="cpu").building
    rkw = dict(hours=CALL_HOURS, **MODES[mode][2])
    tm, tm0 = ThermalModel.from_building(pb, device="cpu"), ThermalModel.from_building(p0, device="cpu")
    fr = tm.fast_runner(**rkw)
    assert fr.params.vent is not None
    _, zt = fr.run(tm.initial_state(), port_inputs(pb))
    _, z0 = tm0.fast_runner(**rkw).run(tm0.initial_state(), port_inputs(p0))
    np.testing.assert_allclose(zt.numpy(), z0.numpy(), rtol=0, atol=1e-12)


def _gated():
    _, pb = compiled("trbdf2_refresh", shading=False)
    return ThermalModel.from_building(pb, device="cpu")


def test_chunk_forward_runs_gated_and_shaded_buildings():
    """``chunk_forward`` re-blocks the parameter rows and keeps the gates'
    operands: its loss is the run's (only ``chunk_grad`` refuses)."""
    _, pb = compiled("trbdf2_refresh")
    tm = ThermalModel.from_building(pb, device="cpu")
    fr = tm.fast_runner(hours=CALL_HOURS, **KW)
    seq = port_inputs(pb)
    u0 = torch.as_tensor(pb.surfaces.seg_u)

    def apply_params(p):
        return dataclasses.replace(pb, surfaces=dataclasses.replace(pb.surfaces, seg_u=u0 * p["u"]))

    fwd = fr.chunk_forward(apply_params, lambda zt, xs: zt.mean())
    _, loss = fwd({"u": torch.tensor(1.0, dtype=torch.float64)}, tm.initial_state(), seq)
    assert fr.params.gated and fr.params.shade_slot is not None
    _, zt = tm.fast_runner(hours=CALL_HOURS, **KW).run(tm.initial_state(), seq)
    assert float(loss) == float(zt.mean())


def _chunk_grad():
    fr = _gated().fast_runner(hours=CALL_HOURS, **KW)
    fr.chunk_grad(lambda p: fr._tm.building, lambda zt, xs: zt.sum())


def _make_day_adjoint():
    day_adjoint.make_day_adjoint(day_march.block_building(_gated().building), substeps=2,
                                 mode="trbdf2_refresh", hours=CALL_HOURS, refresh_every=2, device="cpu")


def _backward_through_day_march():
    tm = _gated()
    fr = tm.fast_runner(hours=CALL_HOURS, **KW)
    p = fr.params
    surf = p.surf.clone().requires_grad_()
    T, zT = fr.to_blocked(tm.initial_state())
    hi = fr.kernel_inputs(port_inputs(tm.building, CALL_HOURS))[0]
    adj = day_adjoint.DayAdjoint.__new__(day_adjoint.DayAdjoint)  # never reached
    out = day_adjoint.DayMarchFn.apply(fr.hour_march, adj, p, p.node, surf, p.zone_volume, T, zT, *hi)
    out[2].sum().backward()


def _nine_leaves():
    tm = _gated()
    fr = tm.fast_runner(hours=CALL_HOURS, **KW)
    T, zT = fr.to_blocked(tm.initial_state())
    fr.hour_march(fr.params, T, zT, fr.kernel_inputs(port_inputs(tm.building, CALL_HOURS))[0][:9])


# The refusals send the caller to the XLA path (tests/test_torch_xla_controls_grad.py).
XLA_BACKWARD = r" \(use the XLA backward: autograd through ThermalModel\.run, engine\.step\.run\)"


@pytest.mark.parametrize("call, match", [
    (_chunk_grad, "in-run ventilation gates are not supported" + XLA_BACKWARD),
    (_make_day_adjoint, "in-run ventilation gates are not supported" + XLA_BACKWARD),
    (_backward_through_day_march, "in-run ventilation gates are not supported" + XLA_BACKWARD),
    (_nine_leaves, "12-leaf hour-input tuple"),
], ids=["chunk_grad", "make_day_adjoint", "day_march_fn_backward", "nine_leaves"])
def test_vent_gate_refusals(call, match):
    with pytest.raises(ValueError, match=match):
        call()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(MODES))
def test_gated_kernel_matches_plain_on_cuda(mode):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    _, pb = compiled(mode, shading=False)
    tm = ThermalModel.from_building(pb, device="cuda")
    fr = tm.fast_runner(hours=CALL_HOURS, **MODES[mode][2])
    T, zT = fr.to_blocked(tm.initial_state())
    hi = fr.kernel_inputs(testing.controlled_city_inputs(pb, CALL_HOURS, device="cuda"))[0]
    got, ref = fr.hour_march(fr.params, T, zT, hi), fr.hour_march.plain(fr.params, T, zT, hi)
    for i in (0, 1, 3):
        assert float((got[i] - ref[i]).abs().max()) <= ATOL_K

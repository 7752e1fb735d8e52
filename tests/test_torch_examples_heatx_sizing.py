"""examples_torch/size_equipment.py against heatx, f64, CPU, at its smoke
settings: the office IDF under ``testing.write_synthetic_epw``'s weather
(seed 0) at the coarse discretization the example's CPU smoke run takes
(``testing.coarse_config(interior_mrt=True, min_dt=1800)``: 2 parity
sub-steps an hour), through the example's steps and heatx's ``sizing``
functions on the same arguments:

* both design days (``design_day_loads`` on the XLA path, the example's CPU
  route): load profiles within 1e-9 of their max |load|, the same warm-up
  counts and peak hours;
* the verification run at the capacities sized from them, 72 h with the
  monthly soil after a warm-up of day 1, on both of the example's routes:
  ``ThermalModel.run(mode="trbdf2")`` month by month (the CPU's) and the
  day march with ``ground_hourly`` (the card's; its plain version here),
  each against heatx's ``ThermalModel.run``: zone temperatures within
  1e-9 K, the same warm-up count.
"""

import copy

import jax.numpy as jnp
import numpy as np
import torch
from torch_examples_ref import CPU, example

import heatx
from heatx import sizing as hx_sizing
from heatx.build.layout import B_OUTDOOR as HX_OUTDOOR
from heatx.model.idf import load_idf as hx_load_idf
from heatx.weather import epw as hx_epw
from heatx.weather import solar as hx_solar
from heatx_torch import testing
from heatx_torch.model.idf import load_idf

torch.set_num_threads(1)

T_RUN = 72


def _hx_verify(model, epw, cfg, annual_extra, T):
    """heatx's step 3 (examples/size_equipment.py), cut to ``T_RUN`` hours."""
    tm = heatx.ThermalModel(model, n=1, config=cfg)
    b = tm.building
    outf = np.asarray(b.surfaces.front_code) == HX_OUTDOOR
    sol = hx_solar.surface_irradiance(epw, b, hours=T, sky="perez", ground_view=hx_solar.model_ground_views(model))
    ir = hx_solar.surface_longwave(epw, b, hours=T)
    seq = tm.inputs_sequence(T, t_out=epw.dry_bulb[:T], wind_speed=epw.wind_speed[:T],
                             wind_direction=np.radians(epw.wind_direction_deg[:T]),
                             sol_front=sol * outf, ir_front=ir * outf, **annual_extra)

    def _sl(s, lo, hi):
        return hx_sizing.slice_time(s, lo, hi, T)

    soil = hx_epw.monthly_to_hourly(epw.ground_temperature(), hours=T)
    tm.set_ground_temperature(float(soil[0]))
    day1 = _sl(seq, 0, 24)
    state, reps = tm.warmup(tm.initial_state(), day1,
                            run=lambda s: tm.run(s, day1, collect_zone_T=False, mode="trbdf2")[0])
    soil = soil[:T_RUN]
    bounds = np.concatenate([[0], np.flatnonzero(np.diff(soil)) + 1, [T_RUN]])
    parts = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        tm.set_ground_temperature(float(soil[lo]))
        state, zt = tm.run(state, _sl(seq, lo, hi), mode="trbdf2")
        parts.append(np.asarray(zt))
    return np.concatenate(parts, axis=0), reps


def test_size_equipment_matches_heatx(tmp_path):
    se = example("size_equipment")
    path = testing.write_synthetic_epw(tmp_path / "santiago.epw", seed=0)
    cfg = testing.coarse_config(dtype=torch.float64, interior_mrt=True, min_dt=1800.0)
    hcfg = heatx.SimConfig(dtype=jnp.float64, max_dx=0.5, min_dt=1800.0, nomass_fixed_iters=2, interior_mrt=True)

    # The port: the example's steps on its CPU route
    from heatx_torch.weather.epw import read_epw

    loaded, epw = load_idf(se.IDF), read_epw(path)
    ch, sizing_extra, annual_extra = se.channels(loaded, epw, loaded.model)
    dd = se.design_days(loaded, epw, cfg, ch, sizing_extra, CPU, engine="xla")

    # heatx: the same steps through its own functions
    hl, hepw = hx_load_idf(se.IDF), hx_epw.read_epw(path)
    hmodel = hl.model
    Z = len(hmodel.spaces)
    zidx = {sp.name: z for z, sp in enumerate(hmodel.spaces)}
    hch = hl.hourly_channels(se.T)
    hch.pop("heat_sp", None)
    hch.pop("cool_sp", None)
    air = hl.airflow_series(se.T)
    t_in = np.repeat(hepw.dry_bulb[:se.T, None], Z, axis=1)
    airflow = dict(inf_vol=air["inf_vol"], inf_mask=air["inf_vol"] > 0.0, inf_temp=t_in,
                   vent_vol=air["vent_vol"], vent_mask=air["vent_vol"] > 0.0, vent_temp=t_in)
    hsizing = dict(hch, hvac_power=hx_sizing.sizing_hvac_power(hmodel, hch["hvac_power"]), **airflow)
    inf = np.zeros(Z)
    for src in (hl.infiltration, hl.ventilation):
        for zname, v in src.items():
            inf[zidx[zname]] += v
    for season, day in hx_sizing.design_days_from_epw(hepw).items():
        extra = {"inf_vol": inf, "inf_mask": inf > 0.0,
                 "inf_temp": np.repeat(day.dry_bulb_profile[:, None], Z, axis=1)}
        if season == "summer":
            extra["hvac_power"] = np.asarray(hsizing["hvac_power"]).max(0)
            extra["lum_power"] = np.asarray(hch["lum_power"]).max(0)
        ref = hx_sizing.design_day_loads(hmodel, day, heat_sp=se.HEAT_SP, cool_sp=se.COOL_SP, epw=hepw,
                                         config=hcfg, extra_channels=extra)
        got = dd[season]
        scale = float(np.abs(np.asarray(ref.profile_W)).max())
        assert scale > 0
        np.testing.assert_allclose(np.asarray(got.profile_W), np.asarray(ref.profile_W), rtol=0, atol=1e-9 * scale,
                                   err_msg=season)
        np.testing.assert_allclose(got.peak_W, np.asarray(ref.peak_W), rtol=0, atol=1e-9 * scale)
        assert got.warmup_days == ref.warmup_days and list(got.peak_hour) == list(ref.peak_hour), season

    # The verification run at the sized capacities (the smoke path: the
    # design days' peaks)
    heat_cap, cool_cap = dd["winter"].peak_W, dd["summer"].peak_W
    model = copy.deepcopy(loaded.model)
    se.cap_thermostats(model, heat_cap, cool_cap)
    zt, reps = se.verify(model, epw, cfg, annual_extra, T_RUN, CPU, "xla")
    hmodel = copy.deepcopy(hmodel)
    for h in hmodel.hvacs:
        if getattr(h, "heat_setpoint", None) is None and getattr(h, "cool_setpoint", None) is None:
            continue
        (zname,) = h.target_spaces
        h.heat_setpoint, h.cool_setpoint = se.HEAT_SP, se.COOL_SP
        h.max_heating = float(heat_cap[zidx[zname]])
        h.max_cooling = float(cool_cap[zidx[zname]])
    hzt, hreps = _hx_verify(hmodel, hepw, hcfg, dict(hch, **airflow), se.T)
    assert reps == hreps
    np.testing.assert_allclose(zt, hzt, rtol=0, atol=1e-9)
    zk, reps_k = se.verify(model, epw, cfg, annual_extra, T_RUN, CPU, "kernel")
    assert reps_k == hreps
    np.testing.assert_allclose(zk, hzt, rtol=0, atol=1e-9)

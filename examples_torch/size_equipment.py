"""Size the HVAC, then prove the sizes hold up over the whole year.

heatx_torch's counterpart of examples/size_equipment.py: the complete
equipment-sizing workflow on the 3-zone office IDF.

1. ``heatx_torch.sizing.design_days_from_epw`` + ``design_day_loads`` give
   the classic ASHRAE design-day peaks (winter 99.6 % dry-bulb / summer
   0.4 % with the ASHRAE clear sky), as ``python -m heatx_torch size``.
   On the card they march the parity day kernel (``engine="auto"``).
2. ``annual_peak_loads(engine="kernel")`` sizes by simulation: the EPW year
   with unlimited ideal loads through the TR-BDF2 day march, taking the
   99.6th-percentile demand.
3. The year then re-runs with every thermostat capped at the sized
   capacities (heating at the winter design-day value or the annual
   percentile, whichever is larger; cooling at the annual percentile) and
   reports unmet setpoint hours, with the EPW's monthly soil temperatures.

Everything uses the same physics configuration (interior MRT network).

Deliberate differences from heatx: on the card the warm-up and the
verification year (heatx's ``ThermalModel.run(mode="trbdf2")``, plain
PyTorch there: minutes a simulated day) run
``fast_runner(mode="trbdf2", substeps=8, hours=24).run`` with
``ground_hourly=`` the monthly soil, the same TR-BDF2 scheme at 8 sub-steps
an hour on the day kernel; with ``--platform cpu`` they keep
``ThermalModel.run``.  With ``HEATX_EXAMPLE_FAST=1`` on the CPU the model
takes ``testing.coarse_config(interior_mrt=True, min_dt=1800)`` (2 parity
sub-steps an hour instead of 118: the design days on the XLA path take
seconds, not minutes).  Without the EPW file (``--epw`` or ``HEATX_EPW``)
the year comes from ``testing.write_synthetic_epw(<tmp>, seed=0)``
(Santiago's location, seeded weather), labelled synthetic; heatx returns 2.

Run:  python examples_torch/size_equipment.py [--platform gpu|cpu] [--epw path.epw] [--margin 1.0]
      (HEATX_EXAMPLE_FAST=1: the design days and 3 verification days)
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
IDF = os.path.normpath(os.path.join(HERE, "..", "examples", "data", "office.idf"))
HEAT_SP, COOL_SP = 21.0, 26.0  # the office's own daytime band
T = 8760


def epw_data(path):
    """The EPW record at ``path`` where the file exists, else a synthetic
    one (seed 0); and whether it is synthetic."""
    from heatx_torch.weather.epw import read_epw

    if path and os.path.isfile(path):
        return read_epw(path), False
    from heatx_torch import testing

    tmp = os.path.join(tempfile.mkdtemp(prefix="heatx_torch_"), "synthetic.epw")
    return read_epw(testing.write_synthetic_epw(tmp, seed=0)), True


def config(fast, device):
    """One physics configuration for everything: the interior MRT network
    (at the coarse discretization for the CPU's smoke settings)."""
    from heatx_torch import SimConfig, testing

    if fast and torch.device(device).type == "cpu":
        return testing.coarse_config(dtype=torch.float32, interior_mrt=True, min_dt=1800.0)
    return SimConfig(interior_mrt=True)


def channels(loaded, epw, model):
    """The IDF's scheduled gains and airflows as annual input channels: for
    the sizing copy (thermostats removed, the sizing unit appended) and for
    the verification model (the hvac_power channel is laid out per device)."""
    from heatx_torch.sizing import sizing_hvac_power

    Z = len(model.spaces)
    ch = loaded.hourly_channels(T)
    ch.pop("heat_sp", None)
    ch.pop("cool_sp", None)  # the sizing/capped thermostats rule
    air = loaded.airflow_series(T)
    t_in = np.repeat(epw.dry_bulb[:T, None], Z, axis=1)
    airflow_kw = dict(inf_vol=air["inf_vol"], inf_mask=air["inf_vol"] > 0.0, inf_temp=t_in,
                      vent_vol=air["vent_vol"], vent_mask=air["vent_vol"] > 0.0, vent_temp=t_in)
    sizing_extra = dict(ch, hvac_power=sizing_hvac_power(model, ch["hvac_power"]), **airflow_kw)
    return ch, sizing_extra, dict(ch, **airflow_kw)


def design_days(loaded, epw, cfg, ch, sizing_extra, device, engine="auto"):
    """Step 1: each design day's :class:`SizingResult`."""
    from heatx_torch.sizing import design_day_loads, design_days_from_epw

    model = loaded.model
    Z = len(model.spaces)
    zidx = {sp.name: z for z, sp in enumerate(model.spaces)}
    inf = np.zeros(Z)
    for src in (loaded.infiltration, loaded.ventilation):
        for zname, v in src.items():
            inf[zidx[zname]] += v
    dd = {}
    for season, day in design_days_from_epw(epw).items():
        extra = {"inf_vol": inf, "inf_mask": inf > 0.0,
                 "inf_temp": np.repeat(day.dry_bulb_profile[:, None], Z, axis=1)}
        if season == "summer":
            extra["hvac_power"] = np.asarray(sizing_extra["hvac_power"]).max(0)
            extra["lum_power"] = np.asarray(ch["lum_power"]).max(0)
        dd[season] = design_day_loads(model, day, heat_sp=HEAT_SP, cool_sp=COOL_SP, epw=epw, config=cfg,
                                      extra_channels=extra, engine=engine, device=device)
    return dd


def cap_thermostats(model, heat_cap, cool_cap):
    """Every setpoint-driven unit at the office band, capped per zone."""
    zidx = {sp.name: z for z, sp in enumerate(model.spaces)}
    for h in model.hvacs:
        if getattr(h, "heat_setpoint", None) is None and getattr(h, "cool_setpoint", None) is None:
            continue
        (zname,) = h.target_spaces
        h.heat_setpoint, h.cool_setpoint = HEAT_SP, COOL_SP
        h.max_heating = float(heat_cap[zidx[zname]])
        h.max_cooling = float(cool_cap[zidx[zname]])


def verify(model, epw, cfg, annual_extra, T_run, device, engine):
    """Step 3: warm up on day 1, then march ``T_run`` hours at the capped
    capacities with the monthly soil.  ``engine="kernel"``: the day march
    (``ground_hourly``); ``"xla"``: ``ThermalModel.run`` month by month.
    Returns (zone T [T_run, Z], warm-up repeats)."""
    from heatx_torch import ThermalModel
    from heatx_torch.build.layout import B_OUTDOOR
    from heatx_torch.sizing import slice_time
    from heatx_torch.weather.epw import monthly_to_hourly
    from heatx_torch.weather.solar import model_ground_views, surface_irradiance, surface_longwave

    tm = ThermalModel(model, n=1, config=cfg, device=device)
    b = tm.building
    outf = np.asarray(b.surfaces.front_code) == B_OUTDOOR
    sol = surface_irradiance(epw, b, hours=T, sky="perez", ground_view=model_ground_views(model))
    ir = surface_longwave(epw, b, hours=T)
    seq = tm.inputs_sequence(T, t_out=epw.dry_bulb[:T], wind_speed=epw.wind_speed[:T],
                             wind_direction=np.radians(epw.wind_direction_deg[:T]),
                             sol_front=sol * outf, ir_front=ir * outf, **annual_extra)

    def _sl(s, lo, hi):
        return slice_time(s, lo, hi, T)

    # Monthly soil from the EPW when available (office.idf has slab floors;
    # a ground-less model or a header-less EPW skips this).
    soil = None
    if epw.ground_temps:
        try:
            soil = monthly_to_hourly(epw.ground_temperature(), hours=T)
            tm.set_ground_temperature(float(soil[0]))
        except ValueError:
            soil = None  # model has no ground boundaries
    day1 = _sl(seq, 0, 24)
    if soil is not None:
        soil = soil[:T_run]
    if engine == "kernel":
        fr = tm.fast_runner(mode="trbdf2", substeps=8, hours=24)
        state, reps = tm.warmup(tm.initial_state(), day1,
                                run=lambda s: fr.run(s, day1, collect_zone_T=False)[0])
        state, zt = fr.run(state, _sl(seq, 0, T_run), ground_hourly=soil)
        return zt.cpu().numpy(), reps
    state, reps = tm.warmup(tm.initial_state(), day1,
                            run=lambda s: tm.run(s, day1, collect_zone_T=False, mode="trbdf2")[0])
    if soil is None:
        state, zt = tm.run(state, _sl(seq, 0, T_run), mode="trbdf2")
        return zt.cpu().numpy(), reps
    bounds = np.concatenate([[0], np.flatnonzero(np.diff(soil)) + 1, [T_run]])
    parts = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        tm.set_ground_temperature(float(soil[lo]))
        state, zt_m = tm.run(state, _sl(seq, lo, hi), mode="trbdf2")
        parts.append(zt_m.cpu().numpy())
    return np.concatenate(parts, axis=0), reps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--platform", choices=("gpu", "cpu"), default="gpu")
    ap.add_argument("--epw", default=os.environ.get("HEATX_EPW", ""))
    ap.add_argument("--margin", type=float, default=1.0,
                    help="capacity = margin x sized peak (try 0.5 to see failures)")
    args = ap.parse_args(argv)
    fast = os.environ.get("HEATX_EXAMPLE_FAST") == "1"
    device = torch.device("cuda" if args.platform == "gpu" else "cpu")
    engine = "kernel" if device.type == "cuda" else "xla"

    from heatx_torch.model.idf import load_idf
    from heatx_torch.sizing import annual_peak_loads

    loaded = load_idf(IDF)
    model = loaded.model
    epw, synthetic = epw_data(args.epw)
    if synthetic:
        print("# weather: synthetic EPW (testing.write_synthetic_epw, seed 0)")
    cfg = config(fast, device)
    ch, sizing_extra, annual_extra = channels(loaded, epw, model)

    # -- 1. classic design days ----------------------------------------------
    t0 = time.time()
    dd = design_days(loaded, epw, cfg, ch, sizing_extra, device, engine)
    for season in dd:
        print(dd[season].summary())
    print(f"# design days {time.time() - t0:.2f}s ({engine} engine)")

    # -- 2. sizing by simulation ---------------------------------------------
    if fast:
        # Smoke-test path: size from the design days alone (the annual
        # march is the expensive step).
        heat_cap = dd["winter"].peak_W * args.margin
        cool_cap = dd["summer"].peak_W * args.margin
    else:
        t0 = time.time()
        ann = annual_peak_loads(model, epw, heat_sp=HEAT_SP, cool_sp=COOL_SP, coverage=99.6, config=cfg,
                                extra_channels=sizing_extra, engine=engine, device=device)
        print(ann.summary())
        print(f"# annual sizing {time.time() - t0:.2f}s ({engine} engine)")
        # Heating: the winter design day is the stricter test (the year may
        # never reach the 99.6 % design temperature); cooling: the annual
        # percentile (the design day's constant-max assumptions oversize).
        heat_cap = np.maximum(dd["winter"].peak_W, ann.peak_heating_W) * args.margin
        cool_cap = ann.peak_cooling_W * args.margin

    # -- 3. the year at the sized capacities ---------------------------------
    cap_thermostats(model, heat_cap, cool_cap)
    t0 = time.time()
    T_run = 72 if fast else T  # smoke-test: 3 verification days
    zt, reps = verify(model, epw, cfg, annual_extra, T_run, device, engine)
    unmet_h = (zt < HEAT_SP - 0.5).sum(axis=0)
    unmet_c = (zt > COOL_SP + 0.5).sum(axis=0)
    print(f"\nannual check at {args.margin:.2f} x sized capacity (warm-up {reps} days; "
          f"{T_run} h in {time.time() - t0:.2f}s, {engine} engine):")
    for z, sp in enumerate(model.spaces):
        print(f"  {sp.name}: heating cap {heat_cap[z]:,.0f} W -> {int(unmet_h[z])} unmet heating h; "
              f"cooling cap {cool_cap[z]:,.0f} W -> {int(unmet_c[z])} unmet cooling h")
    return 0


if __name__ == "__main__":
    sys.exit(main())

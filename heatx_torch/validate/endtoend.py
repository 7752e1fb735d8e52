"""Full-stack EnergyPlus comparison: EPW weather in, zone temperature out.

PyTorch counterpart of ``heatx.validate.endtoend``.  The replay harness
(``heatx_torch.validate.replay``) feeds EnergyPlus's own logged boundary
conditions, so it isolates the wall+zone solver.  This module closes the
loop: the port computes the incident solar (``weather.solar``, Perez sky) and
the incident longwave from the same CHL_Santiago EPW EnergyPlus ran with,
marches the fixture model, and compares zone temperature against
``eplusout.csv``.  A miss here implicates the weather-model stack (sun
position, transposition, sky/ground longwave), not the solver.

The alignment details are heatx's: outdoor dry-bulb and wind come from the
fixture log (EnergyPlus's own interpolation of the EPW), and the model is
built from the fixture's own ``in.idf``, whose importer carries the explicit
"View Factor to Ground" into the solar input.  The march is a loop of main
steps on the model's device (heatx's ``lax.scan``).
"""

from __future__ import annotations

import numpy as np
import torch

from heatx_torch.build.layout import B_OUTDOOR
from heatx_torch.config import SimConfig
from heatx_torch.engine import step as step_mod
from heatx_torch.engine import surface as surf_mod
from heatx_torch.io.eplus import read_eplusout
from heatx_torch.validate.replay import WALL_CASES, build_case_model
from heatx_torch.weather.epw import read_epw
from heatx_torch.weather.solar import (
    model_ground_views,
    solar_position,
    sun_and_sky,
    sun_and_sky_steps,
    surface_irradiance,
    surface_irradiance_steps,
    surface_longwave,
)

#: The fixtures whose physics the weather stack fully drives.
FULL_CASES = ("massive_full", "nomass_full", "mixed_full", "tilted", "horizontal")

HOURS = 21 * 24  # every fixture: a 21-day January run period


def fixture_anomaly_sun(epw, steps_per_hour, hours, day_fixed=11.0):
    """The 21-day fixtures' apparent sun path, frozen near mid-run (heatx
    ``fixture_anomaly_sun``): the sun position of day ``day_fixed`` through
    run day 20 and the live path afterwards, as ``(dni, dhi, ghi, alt, az,
    day)`` per step, the layout of ``weather.solar.sun_and_sky_steps``.
    The logged fixture solar best matches a sun computed for days ~10-13
    over run days 1-20 and the true path on day 21 (heatx's best-fit
    analysis), an EnergyPlus-side run-period quirk this reproduces."""
    sph = int(steps_per_hour)
    dni, dhi, ghi, alt, az, day = sun_and_sky_steps(epw, sph, hours=hours)
    dayf = np.where(day <= 20, float(day_fixed), day)
    t = (np.arange(hours * sph, dtype=np.float64) + 1.0) / sph
    alt2, az2 = solar_position(
        epw.latitude_deg, epw.longitude_deg, epw.tz_hours, dayf, t % 24.0
    )
    return dni, dhi, ghi, alt2, az2, dayf


def weather_model_inputs(epw, model, building, sky="perez",
                         steps_per_hour=None, mimic_fixture_sun=False):
    """The incident solar and longwave the port computes for a fixture model
    from the EPW alone (heatx ``weather_model_inputs``): with
    ``steps_per_hour=None`` hourly ``[HOURS+1, S]`` arrays (one extra hour
    for sub-hour interpolation); with ``steps_per_hour=k`` the solar of the
    sub-hour EnergyPlus-convention chain (``surface_irradiance_steps``) as
    ``[HOURS*k, S]`` and the longwave hourly ``[HOURS+1, S]``.  Returns
    ``(sol, ir)``, dicts by side ("front", "back")."""
    gv = model_ground_views(model)
    sun = sun_and_sky(epw, hours=HOURS + 1)  # shared by both faces
    sol = {}
    ir = {}
    for side in ("front", "back"):
        if steps_per_hour is None:
            sol[side] = surface_irradiance(
                epw, building, hours=HOURS + 1, sky=sky, side=side,
                ground_view=gv, sun=sun,
            )
        else:
            sun_steps = (
                fixture_anomaly_sun(epw, steps_per_hour, HOURS)
                if mimic_fixture_sun
                else None
            )
            sol[side] = surface_irradiance_steps(
                epw, building, steps_per_hour, hours=HOURS, side=side,
                ground_view=gv, sun=sun_steps,
            )
        ir[side] = surface_longwave(epw, building, hours=HOURS + 1, side=side)
    return sol, ir


def run_end_to_end_case(
    name: str,
    fixtures_root: str,
    n: int = 20,
    dtype=torch.float64,
    sky: str = "perez",
    passes: int = 1,
    mimic_fixture_sun: bool = False,
    device="cuda",
):
    """March one fixture under the port's own weather models on ``device``
    (heatx ``run_end_to_end_case``); returns ``(expected, found)``
    zone-temperature series after the reference's 5000-step warm-up skip,
    the LAST of ``passes`` back-to-back replays scored."""
    from heatx_torch.api import ThermalModel

    case = WALL_CASES[name]
    model = build_case_model(case, fixtures_root, via_idf=True)
    tm = ThermalModel(model, n=n, config=SimConfig(dtype=dtype), device=device)
    b = tm.building
    # EnergyPlus assumes zero IR indoors on single-surface models
    # (validate_wall_heat_transfer.rs:629-630): zero the interior face's
    # emissivity, whichever side that is.
    front_outdoor = bool(np.asarray(b.surfaces.front_code)[0] == B_OUTDOOR)
    if front_outdoor:
        b.surfaces.eps_back[:] = 0.0
    else:
        b.surfaces.eps_front[:] = 0.0
    tm.invalidate()

    epw = read_epw(f"{fixtures_root}/epw/CHL_Santiago.855740_IWEC.epw")
    run = read_eplusout(f"{fixtures_root}/{name}/eplusout.csv")
    T = run.n_steps
    steps_per_hour = T // HOURS
    sol, ir = weather_model_inputs(
        epw, model, b, sky=sky, steps_per_hour=steps_per_hour,
        mimic_fixture_sun=mimic_fixture_sun,
    )
    t_mid = (np.arange(T) + 0.5) / steps_per_hour
    hr_mid = np.arange(HOURS + 1) + 0.5

    def to_steps(a):  # [H+1, S] hourly -> [T, S]
        return np.stack([np.interp(t_mid, hr_mid, a[:, s]) for s in range(a.shape[1])], 1)

    side = "front" if front_outdoor else "back"
    skey, ikey = ("sol_front", "ir_front") if front_outdoor else ("sol_back", "ir_back")
    bd = tm._device()
    kw = dict(dtype=bd.dtype, device=bd.device)

    def series(v):  # [T, ...] -> [passes*T, ...] (replay.run_case semantics)
        v = np.asarray(v, np.float64)
        return torch.as_tensor(np.tile(v, (passes,) + (1,) * (v.ndim - 1)), **kw)

    t_out, ws, wd, sol_s, ir_s = (series(v) for v in (
        run.outdoor_temp, run.site_wind_speed, np.radians(run.site_wind_direction),
        np.asarray(sol[side]), to_steps(np.asarray(ir[side]))))
    base = tm.inputs()
    statics = surf_mod.compute_statics(bd.surfaces)
    state = tm.initial_state()
    state.zone_T = torch.full_like(state.zone_T, float(run.zone_air_temp[0]))
    found = []
    for i in range(t_out.shape[0]):
        inputs = base.replace(t_out=t_out[i], wind_speed=ws[i], wind_direction=wd[i],
                              **{skey: sol_s[i], ikey: ir_s[i]})
        found.append(state.zone_T[0])  # the pre-march state, like the reference (:667)
        state = step_mod.march(bd, state, inputs, statics=statics)
    found = torch.stack(found).cpu().numpy()
    warmup = 5000
    return run.zone_air_temp[warmup + 1:], found[-T:][warmup + 1:]

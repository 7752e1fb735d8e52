"""Design-day sizing: peak heating/cooling loads (heatx extension).

Every production building simulator sizes equipment from design days;
the reference has no sizing machinery at all (its IdealHeaterCooler is
``todo!()``, heating_cooling.rs:66-90).  heatx composes it from parts it
already has: unlimited setpoint-driven ideal loads (engine.zone), the
EnergyPlus-style warm-up (``ThermalModel.warmup``), the ASHRAE clear-sky
solar model (weather.solar.ashrae_clear_sky) and the tilted longwave
blend.

Conventions (the ASHRAE / EnergyPlus ``SizingPeriod:DesignDay`` ones):

* **Winter (heating) design day**: constant dry-bulb at the 99.6 %
  heating design temperature, **no solar**, clear-sky longwave (the
  coldest radiant environment), mean-coincident wind.  Internal gains
  excluded unless the caller passes them — the conservative heating
  convention.
* **Summer (cooling) design day**: dry-bulb follows the ASHRAE daily
  profile ``T(h) = DB_max - range * f(h)``, ASHRAE clear-sky beam +
  diffuse transposed to every exterior face (21st of the hottest month),
  mean-coincident wind.
* The day repeats until the building converges day-over-day (warm-up),
  then one more day is marched with unlimited ideal loads in every zone;
  the reported load profile/peaks come from that converged periodic day.

Design conditions come from the EPW's ``DESIGN CONDITIONS`` header
(``EPWData.design_conditions``) or explicit ``DesignDay`` fields.

heatx_torch copy of heatx's sizing module.  Every function that builds a
``ThermalModel`` takes ``device=`` (the card unless the caller asks for the
CPU): on the card the design days march through the parity day march
(``design_day_loads(engine="auto")``; heatx's ``ThermalModel.run`` with
``engine="xla"`` and on the CPU) and ``annual_peak_loads(engine="kernel")``
runs the year through the TR-BDF2 one (``FastRunner.run``, the CUDA kernel
on the card).  The load series
come back to the host once, as numpy arrays.
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from heatx_torch.api import _np as _host  # a load series off the device, once
from heatx_torch.constants import SIGMA

# ASHRAE daily range fractions f(h): fraction of the daily dry-bulb range
# subtracted from the day's maximum at each hour 0-23 (local standard
# time; max at 15:00, min at 05:00) — 2017 Fundamentals ch. 14 table 6.
DAILY_RANGE_FRACTION = np.array([
    0.88, 0.92, 0.95, 0.98, 1.00, 0.98, 0.91, 0.74,
    0.55, 0.38, 0.23, 0.13, 0.05, 0.00, 0.00, 0.06,
    0.14, 0.24, 0.39, 0.50, 0.59, 0.68, 0.75, 0.82,
])


def clark_allen_sky_emissivity(t_dew_c):
    """Clark & Allen (1978) clear-sky emissivity from dew point —
    EnergyPlus's default design-day sky model:
    ``eps = 0.787 + 0.764 ln((T_dp + 273.15)/273.15)``."""
    return 0.787 + 0.764 * np.log((np.asarray(t_dew_c) + 273.15) / 273.15)


@dataclass
class DesignDay:
    """One design day's independent conditions."""

    kind: str  # "winter" | "summer"
    db_max: float  # C (winter: the constant dry-bulb)
    db_range: float = 0.0  # C, daily dry-bulb swing (summer)
    wind_speed: float = 3.0  # m/s
    month: int = 1  # for sun position + clear-sky coefficients (summer)
    dew_point: Optional[float] = None  # C, for the sky emissivity
    clearness: float = 1.0  # ASHRAE clear-sky multiplier (summer solar)

    @property
    def dry_bulb_profile(self) -> np.ndarray:
        """[24] hourly dry-bulb series."""
        if self.kind == "winter":
            return np.full(24, self.db_max)
        return self.db_max - self.db_range * DAILY_RANGE_FRACTION

    def sky_ir_horizontal(self) -> np.ndarray:
        """[24] horizontal incident longwave under the clear design sky."""
        t = self.dry_bulb_profile
        dp = self.dew_point if self.dew_point is not None else t - 2.0
        eps = clark_allen_sky_emissivity(dp)
        return eps * SIGMA * (t + 273.15) ** 4


def design_days_from_epw(epw) -> Dict[str, DesignDay]:
    """The 99.6 % heating / 0.4 % cooling design days from the EPW's
    DESIGN CONDITIONS header."""
    dc = epw.design_conditions
    if not dc:
        raise ValueError(
            f"{epw.location or 'EPW'} has no DESIGN CONDITIONS header; "
            "construct DesignDay values explicitly"
        )
    out = {}
    if "heating_db_996" in dc:
        out["winter"] = DesignDay(
            kind="winter",
            db_max=dc["heating_db_996"],
            wind_speed=dc.get("heating_mcws", 3.0),
            month=int(dc.get("heating_coldest_month", 1)),
            dew_point=dc.get("heating_dp_996"),
        )
    if "cooling_db_004" in dc:
        out["summer"] = DesignDay(
            kind="summer",
            db_max=dc["cooling_db_004"],
            db_range=dc.get("cooling_db_range", 0.0),
            wind_speed=dc.get("cooling_mcws", 3.0),
            month=int(dc.get("cooling_hottest_month", 7)),
            # Approximation: dew point ~ the mean-coincident wet bulb
            # (exact only at saturation; biases the sky slightly warm,
            # i.e. conservative for cooling).
            dew_point=dc.get("cooling_mcwb_004"),
        )
    return out


@dataclass
class SizingResult:
    zone_names: list
    peak_W: np.ndarray  # [Z] peak load, positive W (heating or cooling)
    profile_W: np.ndarray  # [24*n, Z] signed ideal load (+heat / -cool)
    peak_hour: np.ndarray  # [Z] hour-of-day of each zone's peak
    warmup_days: int
    design_day: DesignDay

    def summary(self) -> str:
        kind = self.design_day.kind
        lines = [
            f"{kind} design day ({self.design_day.db_max:.1f} C"
            + (f", range {self.design_day.db_range:.1f} K"
               if kind == "summer" else "")
            + f", wind {self.design_day.wind_speed:.1f} m/s; converged "
            f"after {self.warmup_days} repeats)"
        ]
        verb = "heating" if kind == "winter" else "cooling"
        for z, name in enumerate(self.zone_names):
            lines.append(
                f"  {name}: peak {verb} {self.peak_W[z]:,.0f} W "
                f"at {int(self.peak_hour[z]):02d}:00"
            )
        return "\n".join(lines)


# Channels this module ever builds as 1-D per-hour series; static
# per-zone/per-device vectors stay whatever their length (the CLI's
# _SERIES_1D convention — shape alone is ambiguous when Z == T).
_SERIES_1D = {
    "t_out", "wind_speed", "wind_direction",
    "sol_front", "sol_back", "ir_front", "ir_back",
}


def _hold_hourly(channels, T: int, n: int) -> dict:
    """Repeat hourly channels onto the [T*n] main-step grid (hold within
    the hour).  1-D arrays classify by name (:data:`_SERIES_1D`); 2-D+
    arrays are series iff their leading axis is T."""
    if n <= 1:
        return channels
    return {
        k: (np.repeat(v, n, axis=0)
            if np.ndim(v) > 0 and np.shape(v)[0] == T
            and (np.ndim(v) > 1 or k in _SERIES_1D) else v)
        for k, v in channels.items()
    }


def slice_time(seq, lo: int, hi: int, total: int):
    """Slice the time axis of a StepInputs: every channel whose leading
    axis is ``total`` takes ``[lo:hi]``; static channels pass."""
    upd = {}
    for f in dataclasses.fields(seq):
        v = getattr(seq, f.name)
        if v is not None and v.ndim > 0 and v.shape[0] == total:
            upd[f.name] = v[lo:hi]
    return seq.replace(**upd)



def _is_gain_hvac(h) -> bool:
    """Scheduled power devices (kept as gains by the sizing copy), as
    opposed to setpoint-driven units (removed — their capacity is the
    unknown sizing solves for)."""
    return (
        getattr(h, "heat_setpoint", None) is None
        and getattr(h, "cool_setpoint", None) is None
    )


def sizing_hvac_power(model, hvac_power):
    """Remap an ``hvac_power`` channel built for ``model``'s device order
    ([n_hvacs] static or [T, n_hvacs] series) onto the sizing copy's:
    setpoint-driven units drop out, the appended sizing unit gets zero
    scheduled power.  Use this for ``design_day_loads(extra_channels=
    {"hvac_power": ...})`` whenever the model has thermostats."""
    keep = [i for i, h in enumerate(model.hvacs) if _is_gain_hvac(h)]
    v = np.asarray(hvac_power, np.float64)
    kept = v[..., keep]
    zero = np.zeros(kept.shape[:-1] + (1,))
    return np.concatenate([kept, zero], axis=-1)


def _sizing_model(model, heat_sp: float, cool_sp: float):
    """A copy of the model with unlimited ideal loads in every zone and
    every pre-existing *setpoint-driven* HVAC removed (their capacities
    are exactly what sizing is asked to find); scheduled power devices
    (heaters as gains) are kept."""
    from heatx_torch.model.building import IdealHeaterCooler

    m = copy.deepcopy(model)
    m.hvacs = [h for h in m.hvacs if _is_gain_hvac(h)]
    m.hvacs.append(IdealHeaterCooler(
        "sizing ideal loads", [sp.name for sp in m.spaces],
        heat_setpoint=heat_sp, cool_setpoint=cool_sp,
    ))
    return m


def design_day_loads(
    model,
    day: DesignDay,
    *,
    heat_sp: float = 20.0,
    cool_sp: float = 26.0,
    epw=None,
    albedo: float = 0.2,
    n: int = 1,
    config=None,
    max_repeats: int = 25,
    extra_channels: Optional[dict] = None,
    engine: str = "auto",
    device="cuda",
) -> SizingResult:
    """Peak heating/cooling loads for ``model`` on one design day.

    ``epw`` supplies site latitude/longitude/timezone for the summer
    clear-sky sun path (required for summer days; winter days have no
    solar).  ``extra_channels`` passes additional ``inputs_sequence``
    channels ([24, ...] series or static), e.g. scheduled internal gains
    for the cooling day.  Returns a :class:`SizingResult`; loads are the
    converged periodic day's, heating positive on winter days and cooling
    positive on summer days.  The model marches on ``device``.

    ``engine="xla"`` marches heatx's way, ``ThermalModel.run`` (plain
    PyTorch: many small launches and a host check per no-mass iteration,
    minutes a simulated day on the card).  ``engine="kernel"`` marches the
    same parity sub-steps through the parity day march (``FastRunner``: the
    CUDA kernel on the card, its plain version on the CPU; hourly main steps
    only), the adaptive no-mass loop included, which heatx's kernel keeps
    behind ``HEATX_KERNEL_WHILE=1``.  ``engine="auto"`` takes the kernel on
    the card when ``n == 1``, else ``"xla"``.
    """
    from heatx_torch.api import ThermalModel
    from heatx_torch.build.layout import B_OUTDOOR
    from heatx_torch.config import SimConfig
    from heatx_torch.weather.solar import (
        ashrae_clear_sky,
        longwave_irradiance,
        model_ground_views,
        poa_irradiance,
        solar_position,
    )

    if engine not in ("auto", "xla", "kernel"):
        raise ValueError(f"engine must be 'auto', 'xla' or 'kernel', got {engine!r}")
    if engine == "kernel" and n != 1:
        raise ValueError("the fused kernel marches hourly main steps (n=1)")
    sized = _sizing_model(model, heat_sp, cool_sp)
    if config is None:
        # Sizing wants conserving interior physics: the reference's
        # zone-air radiant bath books interior radiant flux against an
        # infinite reservoir (surface.rs:611-640), which understates
        # heating loads (measured ~2x on a bare two-wall zone).  The
        # Carroll MRT network (heatx extension) closes the balance.
        config = SimConfig(interior_mrt=True)
    tm = ThermalModel(sized, n=n, config=config, device=device)
    b = tm.building
    sb = b.surfaces
    T = 24

    # Ground-contact faces: soil at the design month's EPW monthly ground
    # temperature (the compiled default would otherwise apply year-round —
    # a 10 C slab under the cooling design day overstates heating and
    # understates cooling).
    from heatx_torch.build.layout import B_GROUND

    has_ground = bool((
        (np.asarray(sb.front_code) == B_GROUND)
        | (np.asarray(sb.back_code) == B_GROUND)
    ).any())
    if has_ground and epw is not None and getattr(epw, "ground_temps", None):
        # (set_ground_temperature itself drops the model's device copy.)
        tm.set_ground_temperature(
            float(epw.ground_temperature()[day.month - 1])
        )

    t_out = day.dry_bulb_profile
    ir_h = day.sky_ir_horizontal()

    out_front = np.asarray(sb.front_code) == B_OUTDOOR
    out_back = np.asarray(sb.back_code) == B_OUTDOOR
    ct = np.asarray(sb.cos_tilt, np.float64)
    sv_front = sv_back = None
    if sized.shades:
        # Per-face sky-view factors: context geometry blocks the cold
        # design sky on both seasons' longwave (and the summer diffuse).
        from heatx_torch.weather.shadow import sky_view_fraction

        sv_front = sky_view_fraction(sized)
        sv_back = sky_view_fraction(sized, side="back")
    ir_f = longwave_irradiance(
        ir_h[:, None], t_out[:, None], ct[None, :],
        sky_view=None if sv_front is None else sv_front[None, :],
    )
    ir_b = longwave_irradiance(
        ir_h[:, None], t_out[:, None], -ct[None, :],
        sky_view=None if sv_back is None else sv_back[None, :],
    )

    S = b.n_surfaces
    sol_f = np.zeros((T, S))
    sol_b = np.zeros((T, S))
    if day.kind == "summer":
        if epw is None:
            raise ValueError(
                "summer design days need the epw for the site sun path"
            )
        # The 21st of the design month, EnergyPlus's convention.
        month_day = [0, 31, 59, 90, 120, 151, 181, 212, 243, 273, 304, 334]
        doy = month_day[day.month - 1] + 21
        alt, az = solar_position(
            epw.latitude_deg, epw.longitude_deg, epw.tz_hours,
            float(doy), np.arange(24, dtype=np.float64) + 0.5,
        )
        dni, dhi = ashrae_clear_sky(alt, day.month, clearness=day.clearness)
        ghi = dni * np.clip(np.sin(alt), 0.0, None) + dhi
        gv = model_ground_views(sized)
        beam = None
        if sized.shades:
            # Permanent context geometry (overhangs, neighbors) shades
            # the design day too; scheduled WINDOW shades are deliberately
            # excluded here — ignoring them oversizes, the conservative
            # direction (the annual method applies them exactly via
            # solar_scale).
            from heatx_torch.weather.shadow import sunlit_fraction

            beam = sunlit_fraction(sized, alt, az)

        def poa(sign):
            sv = sv_front if sign > 0 else sv_back
            return poa_irradiance(
                dni[:, None], dhi[:, None], ghi[:, None],
                alt[:, None], az[:, None],
                sign * np.asarray(sb.normal[:, 0])[None, :],
                sign * np.asarray(sb.normal[:, 1])[None, :],
                (sign * ct)[None, :],
                albedo=albedo, ground_view=gv[None, :],
                beam_fraction=beam,
                sky_view=None if sv is None else sv[None, :],
            )

        sol_f = poa(1.0)
        sol_b = poa(-1.0)

    channels = dict(
        t_out=t_out,
        wind_speed=np.full(T, day.wind_speed),
        sol_front=sol_f * out_front,
        sol_back=sol_b * out_back,
        ir_front=ir_f * out_front,
        ir_back=ir_b * out_back,
    )
    if extra_channels:
        channels.update(extra_channels)
    seq = tm.inputs_sequence(T * n, **_hold_hourly(channels, T, n))

    if engine == "auto":
        engine = "kernel" if tm.device.type == "cuda" and n == 1 else "xla"
    if engine == "kernel":
        fr = tm.fast_runner(
            mode="parity", hours=T, adaptive_nomass=True,
            scheduled_setpoints=(
                channels.get("heat_sp") is not None
                or channels.get("cool_sp") is not None
            ),
        )
        run_day = lambda s: fr.run(s, seq, collect_zone_T=False)[0]  # noqa: E731
    else:
        run_day = None
    state, repeats = tm.warmup(
        tm.initial_state(), seq, max_repeats=max_repeats, run=run_day
    )
    if engine == "kernel":
        _, _, loads = fr.run(state, seq, collect_loads=True)
    else:
        _, (_, loads) = tm.run(state, seq, collect_loads=True)
    loads = _host(loads)  # [24*n, Z], +heating / -cooling
    signed = loads if day.kind == "winter" else -loads
    per_zone = np.clip(signed, 0.0, None)
    peak = per_zone.max(axis=0)
    peak_hour = per_zone.argmax(axis=0) // n
    return SizingResult(
        zone_names=[sp.name for sp in sized.spaces],
        peak_W=peak,
        profile_W=loads,
        peak_hour=peak_hour,
        warmup_days=repeats,
        design_day=day,
    )


def size_from_epw(
    model, epw, *, heat_sp: float = 20.0, cool_sp: float = 26.0, **kw
) -> Dict[str, SizingResult]:
    """Both design days from the EPW's DESIGN CONDITIONS header:
    ``{"winter": SizingResult, "summer": SizingResult}`` (whichever the
    header provides)."""
    days = design_days_from_epw(epw)
    return {
        season: design_day_loads(
            model, day, heat_sp=heat_sp, cool_sp=cool_sp, epw=epw, **kw
        )
        for season, day in days.items()
    }


@dataclass
class AnnualSizing:
    zone_names: list
    peak_heating_W: np.ndarray  # [Z] at the requested coverage
    peak_cooling_W: np.ndarray  # [Z]
    max_heating_W: np.ndarray  # [Z] absolute annual peaks
    max_cooling_W: np.ndarray  # [Z]
    coverage: float  # % of main steps the reported peaks cover
    #: [T*n, Z] signed demand series (+heat / -cool) on the MAIN-STEP
    #: grid — hourly only at n=1; a percentile of main steps, so at n>1
    #: the conceded tail is (100-coverage)% of steps, not hours.
    loads_W: np.ndarray
    warmup_days: int

    def summary(self) -> str:
        lines = [
            f"annual-simulation sizing ({self.coverage:.1f} % coverage; "
            f"warm-up {self.warmup_days} days)"
        ]
        for z, name in enumerate(self.zone_names):
            lines.append(
                f"  {name}: heating {self.peak_heating_W[z]:,.0f} W "
                f"(abs max {self.max_heating_W[z]:,.0f}), cooling "
                f"{self.peak_cooling_W[z]:,.0f} W "
                f"(abs max {self.max_cooling_W[z]:,.0f})"
            )
        return "\n".join(lines)


def annual_peak_loads(
    model,
    epw,
    *,
    heat_sp: float = 20.0,
    cool_sp: float = 26.0,
    coverage: float = 100.0,
    albedo: float = 0.2,
    sky: str = "perez",
    n: int = 1,
    config=None,
    extra_channels: Optional[dict] = None,
    max_repeats: int = 25,
    engine: str = "xla",  # "xla": ThermalModel.run, heatx's name for that path
    block_size: int = None,
    solar_scale=None,
    device="cuda",
) -> AnnualSizing:
    """Sizing by simulation: the whole EPW year with unlimited ideal loads.

    Synthetic design days bake in assumptions — a clear-sky model's
    diffuse, full-on gains, single-day periodicity (no multi-day heat
    waves), no schedule/weather coincidence — and so can land on either
    side of the real requirement.  Marching the actual year (heatx's own
    Perez solar + tilted longwave + seasonal soil, the TR-BDF2 march) makes the weather exact by construction and measures
    the coverage directly: on the office example the ASHRAE days oversize
    2-6x, and the annual 99.6 % percentile right-sizes to single-digit
    unmet hours (examples/size_equipment.py).  Compare both; sizing and
    any verification run must share the same ``config`` (the interior
    radiant model alone shifts loads substantially).

    ``coverage`` < 100 sizes to the demand percentile instead of the
    absolute peak (e.g. 99.6 leaves ~35 not-fully-served hours — the
    ASHRAE design-condition convention).  ``extra_channels`` adds
    scheduled gains/airflows, as in :func:`design_day_loads` but [T]-long.
    Returns the signed demand series too, so callers can study the peaks.

    Context shading polygons (``model.shades``) ray-cast into the beam
    term automatically; ``solar_scale`` ([T, S]) additionally multiplies
    the incident solar — pass ``LoadedIdf.shading_series(epw.n_hours)``
    to include scheduled window shades (the CLI's ``size --annual``
    does).

    ``engine="kernel"`` runs the year through the day march
    (``FastRunner.run``: the CUDA kernel on the card, its plain version on
    the CPU) instead of the plain-PyTorch TR-BDF2 march (hourly main steps
    only): the in-kernel thermostats collect the same demand series, with
    the seasonal soil handled by the runner's own per-dispatch operand
    swaps.  ``block_size`` is the runner's lanes per block (None: the
    fewest that hold the largest zone-connected component; at most 256).
    The model marches on ``device``.
    """
    from heatx_torch.api import ThermalModel
    from heatx_torch.build.layout import B_GROUND, B_OUTDOOR
    from heatx_torch.config import SimConfig
    from heatx_torch.weather.epw import monthly_to_hourly
    from heatx_torch.weather.solar import (
        model_ground_views,
        surface_irradiance,
        surface_longwave,
    )

    q = float(coverage)
    if not 0.0 < q <= 100.0:
        raise ValueError(f"coverage must be in (0, 100], got {coverage}")
    if engine not in ("xla", "kernel"):
        raise ValueError(f"engine must be 'xla' or 'kernel', got {engine!r}")
    if engine == "kernel" and n != 1:
        raise ValueError("the fused kernel marches hourly main steps (n=1)")
    sized = _sizing_model(model, heat_sp, cool_sp)
    if config is None:
        config = SimConfig(interior_mrt=True)
    tm = ThermalModel(sized, n=n, config=config, device=device)
    b = tm.building
    sb = b.surfaces
    T = epw.n_hours

    from heatx_torch.weather.solar import sun_and_sky

    out_front = np.asarray(sb.front_code) == B_OUTDOOR
    out_back = np.asarray(sb.back_code) == B_OUTDOOR
    gv = model_ground_views(sized)
    sun = sun_and_sky(epw)
    beam = None
    sv_f = sv_b = None
    if sized.shades:
        # Context shading geometry shades the sizing year exactly like
        # the simulate path: beam sunlit fractions plus the per-face
        # sky-view factors on the diffuse and longwave terms.
        from heatx_torch.weather.shadow import sky_view_fraction, sunlit_fraction

        beam = sunlit_fraction(sized, sun[3], sun[4])
        sv_f = sky_view_fraction(sized)
        if out_back.any():
            sv_b = sky_view_fraction(sized, side="back")
    sol_f = surface_irradiance(epw, b, albedo=albedo, sky=sky,
                               ground_view=gv, sun=sun,
                               beam_fraction=beam,
                               sky_view=sv_f) * out_front
    ir_f = surface_longwave(epw, b, sky_view=sv_f) * out_front
    if out_back.any():
        sol_b = surface_irradiance(epw, b, albedo=albedo, sky=sky,
                                   side="back", ground_view=gv,
                                   sun=sun, beam_fraction=beam,
                                   sky_view=sv_b) * out_back
        ir_b = surface_longwave(epw, b, side="back",
                                sky_view=sv_b) * out_back
    else:
        sol_b = np.zeros_like(sol_f)
        ir_b = np.zeros_like(ir_f)
    if solar_scale is not None:
        # Scheduled window shading (LoadedIdf.shading_series): [T, S]
        # multipliers on the incident solar, both faces.
        sol_f = sol_f * solar_scale
        sol_b = sol_b * solar_scale
    channels = dict(
        t_out=epw.dry_bulb, wind_speed=epw.wind_speed,
        wind_direction=epw.wind_direction_rad,
        sol_front=sol_f, sol_back=sol_b, ir_front=ir_f, ir_back=ir_b,
    )
    if extra_channels:
        channels.update(extra_channels)
    seq = tm.inputs_sequence(T * n, **_hold_hourly(channels, T, n))

    def _sl(s, lo, hi):
        return slice_time(s, lo, hi, T * n)

    has_ground = bool((
        (np.asarray(sb.front_code) == B_GROUND)
        | (np.asarray(sb.back_code) == B_GROUND)
    ).any())
    soil_hourly = None
    if has_ground and getattr(epw, "ground_temps", None):
        soil_hourly = monthly_to_hourly(
            epw.ground_temperature(), hours=T, leap=(T == 8784)
        )
        tm.set_ground_temperature(float(soil_hourly[0]))

    day1 = _sl(seq, 0, 24 * n)
    if engine == "kernel":
        # Setpoint schedules in extra_channels need the runner built with
        # the per-hour setpoint operands (the plain-PyTorch march consumes
        # the channels directly).
        fr = tm.fast_runner(
            mode="trbdf2", hours=24, block_size=block_size,
            scheduled_setpoints=(
                channels.get("heat_sp") is not None
                or channels.get("cool_sp") is not None
            ),
        )
        run_day = lambda s: fr.run(s, day1, collect_zone_T=False)[0]  # noqa: E731
    else:
        run_day = lambda s: tm.run(  # noqa: E731
            s, day1, collect_zone_T=False, mode="trbdf2"
        )[0]
    state, repeats = tm.warmup(
        tm.initial_state(), day1, max_repeats=max_repeats, run=run_day
    )
    if engine == "kernel":
        # The runner's own seasonal-ground handling splits dispatches at
        # soil changes and swaps the kernel operands in place.
        _, _, loads = fr.run(
            state, seq, collect_loads=True, ground_hourly=soil_hourly
        )
        loads = _host(loads)
    else:
        if soil_hourly is None:
            _, (_, loads) = tm.run(
                state, seq, collect_loads=True, mode="trbdf2"
            )
            loads = _host(loads)
        else:
            # Month-chunked runs so the soil temperature tracks the EPW's
            # monthly series.
            bounds = np.flatnonzero(np.diff(soil_hourly)) + 1
            bounds = np.concatenate([[0], bounds, [T]])
            parts = []
            for lo, hi in zip(bounds[:-1], bounds[1:]):
                # set_ground_temperature drops the model's device copy.
                tm.set_ground_temperature(float(soil_hourly[lo]))
                state, (_, ld) = tm.run(
                    state, _sl(seq, lo * n, hi * n),
                    collect_loads=True, mode="trbdf2",
                )
                parts.append(_host(ld))
            loads = np.concatenate(parts, axis=0)

    heat = np.clip(loads, 0.0, None)
    cool = np.clip(-loads, 0.0, None)
    return AnnualSizing(
        zone_names=[sp.name for sp in sized.spaces],
        peak_heating_W=np.percentile(heat, q, axis=0),
        peak_cooling_W=np.percentile(cool, q, axis=0),
        max_heating_W=heat.max(axis=0),
        max_cooling_W=cool.max(axis=0),
        coverage=q,
        loads_W=loads,
        warmup_days=repeats,
    )

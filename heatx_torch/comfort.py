"""Thermal-comfort indices (heatx extension; host post-processing).

heatx_torch copy of ``heatx.comfort`` (numpy only: pass host arrays, a
history's ``.cpu().numpy()``).

Fanger's PMV/PPD per ISO 7730:2005 (the model EnergyPlus's
``People ... Fanger`` option reports): the predicted mean vote solves the
steady-state heat balance of a clothed body — clothing surface
temperature by fixed-point iteration, then the six loss terms — and the
predicted percentage dissatisfied follows from the standard's quartic.

heatx already exposes the physical inputs per zone and hour: air
temperature (the zone history), mean radiant temperature
(``ThermalModel.zone_mrt`` / the in-kernel operative collection), and the
EPW's relative humidity (indoor moisture is not modeled — pass measured
or assumed indoor RH when you have it).  Everything here is plain
vectorized numpy over any broadcastable shapes ([T, Z] histories in one
call).

The reference has no comfort machinery (its observables stop at the
state-vector channels, surface_trait.rs:223-354).
"""

from __future__ import annotations

import numpy as np


def saturation_vapor_pressure(t_c):
    """Water saturation pressure, Pa (the Antoine-form fit ISO 7730 uses:
    ``exp(16.6536 - 4030.183/(t + 235))`` kPa)."""
    t = np.asarray(t_c, np.float64)
    return 1000.0 * np.exp(16.6536 - 4030.183 / (t + 235.0))


def indoor_rh_from_outdoor(rh_out_pct, t_out_c, t_in_c):
    """Indoor relative humidity assuming the indoor air carries the
    outdoor air's moisture (constant vapor pressure, no indoor sources):
    ``RH_in = RH_out * psat(T_out) / psat(T_in)``, clipped to [0, 100].

    RH% is temperature-relative — applying an outdoor percentage at a
    warmer indoor temperature inflates the vapor pressure (80 % at 0 C is
    ~20 % at 21 C, a ~+0.3 PMV error).  All arguments broadcast."""
    pa_times_100 = (
        np.asarray(rh_out_pct, np.float64)
        * saturation_vapor_pressure(t_out_c)
    )
    return np.clip(
        pa_times_100 / saturation_vapor_pressure(t_in_c), 0.0, 100.0
    )


def pmv_ppd(
    t_air_c,
    t_mrt_c,
    rel_humidity_pct,
    air_speed=0.1,
    met=1.2,
    clo=0.5,
    work_met=0.0,
    iters=30,
):
    """Fanger PMV and PPD (ISO 7730:2005, clause 4 + annex D algorithm).

    All arguments broadcast; returns ``(pmv, ppd_pct)`` arrays.  ``met``
    is the metabolic rate in met (1 met = 58.15 W/m2), ``clo`` the
    clothing insulation in clo (1 clo = 0.155 m2K/W), ``air_speed`` the
    relative air velocity in m/s, ``work_met`` external work (usually 0).
    The clothing-surface-temperature fixed point runs ``iters`` bisected
    iterations (the standard's loop; 30 converges far below 1e-5 for the
    habitable range).
    """
    ta = np.asarray(t_air_c, np.float64)
    tr = np.asarray(t_mrt_c, np.float64)
    rh = np.asarray(rel_humidity_pct, np.float64)
    vel = np.maximum(np.asarray(air_speed, np.float64), 0.0)

    pa = rh / 100.0 * saturation_vapor_pressure(ta)  # vapour pressure, Pa
    icl = 0.155 * clo  # m2K/W
    m = met * 58.15  # W/m2
    w = work_met * 58.15
    mw = m - w
    fcl = np.where(icl <= 0.078, 1.0 + 1.29 * icl, 1.05 + 0.645 * icl)
    hcf = 12.1 * np.sqrt(vel)  # forced convection
    taa = ta + 273.15
    tra = tr + 273.15

    # Clothing surface temperature by the standard's averaged fixed point.
    tcla = taa + (35.5 - ta) / (3.5 * icl + 0.1)
    p1 = icl * fcl
    p2 = p1 * 3.96
    p3 = p1 * 100.0
    p4 = p1 * taa
    p5 = 308.7 - 0.028 * mw + p2 * (tra / 100.0) ** 4
    xn = tcla / 100.0
    xf = tcla / 50.0
    hc = hcf
    for _ in range(int(iters)):
        xf = (xf + xn) / 2.0
        hcn = 2.38 * np.abs(100.0 * xf - taa) ** 0.25  # natural convection
        hc = np.maximum(hcf, hcn)
        xn = (p5 + p4 * hc - p2 * xf**4) / (100.0 + p3 * hc)
    tcl = 100.0 * xn - 273.15

    # The six heat-loss terms (skin diffusion, sweat, latent + dry
    # respiration, radiation, convection).
    hl1 = 3.05e-3 * (5733.0 - 6.99 * mw - pa)
    hl2 = np.where(mw > 58.15, 0.42 * (mw - 58.15), 0.0)
    hl3 = 1.7e-5 * m * (5867.0 - pa)
    hl4 = 0.0014 * m * (34.0 - ta)
    hl5 = 3.96 * fcl * (xn**4 - (tra / 100.0) ** 4)
    hl6 = fcl * hc * (tcl - ta)

    ts = 0.303 * np.exp(-0.036 * m) + 0.028
    pmv = ts * (mw - hl1 - hl2 - hl3 - hl4 - hl5 - hl6)
    ppd = 100.0 - 95.0 * np.exp(-0.03353 * pmv**4 - 0.2179 * pmv**2)
    return pmv, ppd


def zone_comfort_history(
    zone_T,
    zone_mrt,
    rel_humidity_pct=50.0,
    **kw,
):
    """PMV/PPD over a simulation's [T, Z] zone-temperature and zone-MRT
    histories (e.g. ``run(collect_operative=True)``'s inputs: operative =
    (air + MRT)/2, so ``mrt = 2*operative - air``).  ``rel_humidity_pct``
    may be a scalar or a [T] / [T, Z] series (the EPW column, or measured
    indoor RH).  Extra keywords pass to :func:`pmv_ppd`."""
    zt = np.asarray(zone_T, np.float64)
    mrt = np.asarray(zone_mrt, np.float64)
    rh = np.asarray(rel_humidity_pct, np.float64)
    if rh.ndim == 1 and zt.ndim == 2:
        rh = rh[:, None]
    return pmv_ppd(zt, mrt, rh, **kw)


def prevailing_mean_outdoor(dry_bulb_hourly, days=7):
    """ASHRAE 55's prevailing mean outdoor air temperature: for each hour,
    the mean of the previous ``days`` full days' daily mean dry-bulbs
    (7-30 days per the standard).  The annual series wraps (hour 0 looks
    back into December), matching heatx's year-periodic schedule/weather
    conventions.  Returns a [T] series for :func:`adaptive_comfort`."""
    t = np.asarray(dry_bulb_hourly, np.float64)
    if len(t) % 24:
        raise ValueError(f"need whole days of hourly data, got {len(t)} h")
    days = int(days)
    if not 7 <= days <= 30:
        raise ValueError(f"days must be in [7, 30] (ASHRAE 55), got {days}")
    daily = t.reshape(-1, 24).mean(1)
    nd = len(daily)
    if nd < days:
        # Wrapping a shorter series would silently double-count days.
        raise ValueError(
            f"need at least {days} days of data for a {days}-day "
            f"prevailing mean, got {nd}"
        )
    # Mean of the `days` daily means preceding each day, with wraparound.
    idx = (np.arange(nd)[:, None] - 1 - np.arange(days)[None, :]) % nd
    pma_daily = daily[idx].mean(1)
    return np.repeat(pma_daily, 24)


#: ASHRAE 55 adaptive-model applicability range for the prevailing mean
#: outdoor temperature, C.
ADAPTIVE_RANGE = (10.0, 33.5)


def adaptive_comfort(t_pma_c):
    """The ASHRAE 55 adaptive comfort model for occupant-controlled,
    naturally conditioned spaces: ``t_comf = 0.31 t_pma + 17.8`` with the
    80 % acceptability band at +-3.5 K and 90 % at +-2.5 K.  Outside the
    model's 10-33.5 C applicability range everything is NaN (the standard
    offers no limits there).  Returns a dict of arrays: ``t_comf``,
    ``lo_80``/``hi_80``, ``lo_90``/``hi_90``."""
    t = np.asarray(t_pma_c, np.float64)
    ok = (t >= ADAPTIVE_RANGE[0]) & (t <= ADAPTIVE_RANGE[1])
    t_comf = np.where(ok, 0.31 * t + 17.8, np.nan)
    return {
        "t_comf": t_comf,
        "lo_80": t_comf - 3.5,
        "hi_80": t_comf + 3.5,
        "lo_90": t_comf - 2.5,
        "hi_90": t_comf + 2.5,
    }


def adaptive_acceptability(t_operative_c, t_pma_c):
    """Hours-in-band summary for a free-running building: boolean masks of
    the operative temperature inside the ASHRAE 55 adaptive 80 %/90 %
    bands (False wherever the model does not apply).  Broadcastable:
    [T, Z] operative against a [T] prevailing-mean series."""
    top = np.asarray(t_operative_c, np.float64)
    band = adaptive_comfort(t_pma_c)
    lo80, hi80 = band["lo_80"], band["hi_80"]
    lo90, hi90 = band["lo_90"], band["hi_90"]
    if top.ndim == 2 and np.ndim(lo80) == 1:
        lo80, hi80 = lo80[:, None], hi80[:, None]
        lo90, hi90 = lo90[:, None], hi90[:, None]
    # NaN band limits (inapplicable hours) compare False on both sides.
    return {
        "in_80": (top >= lo80) & (top <= hi80),
        "in_90": (top >= lo90) & (top <= hi90),
        "applicable": ~np.isnan(np.broadcast_to(lo80, top.shape)),
    }

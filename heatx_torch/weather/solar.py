"""Solar position and plane-of-array irradiance (heatx extension).

heatx_torch copy of ``heatx.weather.solar`` (numpy only).

The reference takes per-surface incident solar as an *input* — the SIMPLE
ecosystem's separate solar module computes it (surface.rs:916-931 reads the
irradiance state channels; nothing in the heat crate computes sun geometry).
heatx ships the standard model so annual EPW runs are self-contained:

* solar position from the Cooper (1969) declination + Spencer (1971)
  equation of time + hour-angle formulas (Duffie & Beckman eq. 1.6.1 et
  seq.) — the same textbook chain EnergyPlus and PVLIB implement;
* plane-of-array irradiance with either the isotropic-sky (Liu-Jordan)
  transposition ``POA = DNI*max(cos theta, 0) + DHI*(1+cos beta)/2 +
  GHI*rho*(1-cos beta)/2`` or the Perez (1990) anisotropic-sky model
  (``sky="perez"``) — the diffuse transposition EnergyPlus itself uses —
  which splits DHI into isotropic dome, circumsolar, and horizon-brightening
  components via the binned brightness coefficients F1/F2.

Azimuth convention matches the rest of heatx (EPW wind direction): compass
radians from north, clockwise, so a direction ``a`` is the horizontal unit
vector ``(sin a, cos a)`` in the building's (x=east, y=north) frame —
see physics.convection.is_windward.

Everything is plain numpy on the host (weather preprocessing, like the EPW
reader); the [T, S] result feeds StepInputs.sol_front/back.
"""

from __future__ import annotations

import numpy as np

_DEG = np.pi / 180.0


def declination(day_of_year):
    """Solar declination, radians (Cooper 1969; D&B eq. 1.6.1a)."""
    n = np.asarray(day_of_year, np.float64)
    return 23.45 * _DEG * np.sin(2.0 * np.pi * (284.0 + n) / 365.0)


def equation_of_time_minutes(day_of_year):
    """Equation of time in minutes (Spencer 1971; D&B eq. 1.5.3)."""
    b = 2.0 * np.pi * (np.asarray(day_of_year, np.float64) - 1.0) / 365.0
    return 229.2 * (
        0.000075
        + 0.001868 * np.cos(b)
        - 0.032077 * np.sin(b)
        - 0.014615 * np.cos(2.0 * b)
        - 0.04089 * np.sin(2.0 * b)
    )


def solar_position(latitude_deg, longitude_deg, tz_hours, day_of_year, local_hour):
    """Sun direction for local-standard-time hours.

    Returns ``(altitude_rad, azimuth_rad)`` with azimuth compass-style
    (from north, clockwise; east = pi/2).  All arguments broadcast.
    """
    phi = np.asarray(latitude_deg, np.float64) * _DEG
    dec = declination(day_of_year)
    # Local standard time -> solar time: 4 min per degree of longitude east
    # of the zone meridian, plus the equation of time.
    solar_time = (
        np.asarray(local_hour, np.float64)
        + (np.asarray(longitude_deg, np.float64) - 15.0 * np.asarray(tz_hours, np.float64))
        * 4.0
        / 60.0
        + equation_of_time_minutes(day_of_year) / 60.0
    )
    omega = (solar_time - 12.0) * 15.0 * _DEG  # hour angle, afternoon positive

    sin_alt = np.sin(phi) * np.sin(dec) + np.cos(phi) * np.cos(dec) * np.cos(omega)
    sin_alt = np.clip(sin_alt, -1.0, 1.0)
    altitude = np.arcsin(sin_alt)
    # Sun unit vector, horizon frame (x=east, y=north, z=up).
    east = -np.cos(dec) * np.sin(omega)
    north = np.sin(dec) * np.cos(phi) - np.cos(dec) * np.cos(omega) * np.sin(phi)
    azimuth = np.arctan2(east, north) % (2.0 * np.pi)
    return altitude, azimuth


def sun_vector(altitude_rad, azimuth_rad):
    """(x=east, y=north, z=up) unit vector from altitude/azimuth."""
    ca = np.cos(altitude_rad)
    return (
        ca * np.sin(azimuth_rad),
        ca * np.cos(azimuth_rad),
        np.sin(altitude_rad),
    )


def extraterrestrial_normal(day_of_year):
    """Extraterrestrial normal irradiance, W/m2 (D&B eq. 1.4.1a)."""
    n = np.asarray(day_of_year, np.float64)
    return 1367.0 * (1.0 + 0.033 * np.cos(2.0 * np.pi * n / 365.0))


def relative_air_mass(zenith_rad):
    """Relative optical air mass (Kasten & Young 1989), clipped at the
    horizon (the Perez brightness is irrelevant past it: DHI ~ 0)."""
    z = np.clip(np.asarray(zenith_rad, np.float64), 0.0, 89.9 * _DEG)
    zd = z / _DEG
    return 1.0 / (np.cos(z) + 0.50572 * (96.07995 - zd) ** -1.6364)


# Perez et al. (1990) "all sites composite" brightness coefficients
# (f11 f12 f13 f21 f22 f23 per sky-clearness bin) — the table EnergyPlus
# and PVLIB ship.  Bin edges on the clearness parameter epsilon.
_PEREZ_EDGES = np.array([1.065, 1.230, 1.500, 1.950, 2.800, 4.500, 6.200])
_PEREZ_F = np.array(
    [
        [-0.0083117, 0.5877285, -0.0620636, -0.0596012, 0.0721249, -0.0220216],
        [0.1299457, 0.6825954, -0.1513752, -0.0189325, 0.0659650, -0.0288748],
        [0.3296958, 0.4868735, -0.2210958, 0.0554140, -0.0639588, -0.0260542],
        [0.5682053, 0.1874525, -0.2951290, 0.1088631, -0.1519229, -0.0139754],
        [0.8730280, -0.3920403, -0.3616149, 0.2255647, -0.4620442, 0.0012448],
        [1.1326077, -1.2367284, -0.4118494, 0.2877813, -0.8230357, 0.0558651],
        [1.0601591, -1.5999137, -0.3589221, 0.2642124, -1.1272340, 0.1312794],
        [0.6777470, -0.3272588, -0.2504286, 0.1561313, -1.3765031, 0.2506212],
    ]
)


def perez_brightness_coefficients(dni, dhi, zenith_rad, day_of_year, i0=None):
    """Perez (1990) circumsolar/horizon brightening factors ``(F1, F2)``.

    All inputs broadcast.  Where DHI is ~0 both factors are 0 (the sky
    term vanishes anyway).  ``i0`` fixes the normalizing extraterrestrial
    irradiance (EnergyPlus uses a constant 1367 W/m2 solar constant in its
    sky-brightness delta); default: the seasonally corrected value."""
    dni = np.asarray(dni, np.float64)
    dhi = np.asarray(dhi, np.float64)
    z = np.asarray(zenith_rad, np.float64)
    day = np.asarray(day_of_year, np.float64)
    lit = dhi > 1e-6
    dhi_s = np.where(lit, dhi, 1.0)
    kappa = 1.041
    eps = ((dhi_s + dni) / dhi_s + kappa * z**3) / (1.0 + kappa * z**3)
    i0v = extraterrestrial_normal(day) if i0 is None else float(i0)
    delta = relative_air_mass(z) * dhi_s / i0v
    b = np.digitize(eps, _PEREZ_EDGES)  # 0..7
    f11, f12, f13, f21, f22, f23 = (_PEREZ_F[b, i] for i in range(6))
    F1 = np.maximum(0.0, f11 + f12 * delta + z * f13)
    F2 = f21 + f22 * delta + z * f23
    return np.where(lit, F1, 0.0), np.where(lit, F2, 0.0)


def perez_sky_diffuse(dhi, cos_tilt, cos_inc, zenith_rad, F1, F2):
    """Sky diffuse on a tilted plane, Perez (1990) eq. 9:
    ``DHI * [(1-F1)(1+cos beta)/2 + F1 a/b + F2 sin beta]`` with
    ``a = max(0, cos theta_i)`` and ``b = max(cos 85deg, cos z)``."""
    dhi = np.asarray(dhi, np.float64)
    a = np.clip(cos_inc, 0.0, None)
    b = np.maximum(np.cos(85.0 * _DEG), np.cos(zenith_rad))
    sin_tilt = np.sqrt(np.clip(1.0 - np.asarray(cos_tilt) ** 2, 0.0, None))
    iso = (1.0 - F1) * (1.0 + cos_tilt) / 2.0
    return np.clip(dhi * (iso + F1 * a / b + F2 * sin_tilt), 0.0, None)


def poa_irradiance(
    dni, dhi, ghi, altitude_rad, azimuth_rad, normal_x, normal_y, cos_tilt,
    albedo=0.2, sky="isotropic", day_of_year=None, ground_view=None,
    beam_fraction=None, sky_view=None, perez_i0=None,
    ground_irradiance=None,
):
    """Plane-of-array irradiance.

    ``sky="isotropic"`` (default) uses the Liu-Jordan transposition;
    ``sky="perez"`` the Perez (1990) anisotropic model (requires
    ``day_of_year``; falls back to isotropic for sun-below-horizon steps,
    where EPW diffuse is ~0 anyway).

    ``ground_view`` overrides the ground-reflected term's view factor
    (default: the geometric ``(1 - cos beta)/2``).  EnergyPlus surfaces
    carry an explicit "View Factor to Ground" that it honors even where
    it disagrees with the tilt (e.g. 0.5 on a roof); pass it here to
    reproduce such runs.  NaN entries fall back to geometric.

    ``perez_i0`` pins the Perez brightness normalization (EnergyPlus:
    1367).  ``ground_irradiance`` overrides the horizontal global used by
    the ground-reflected term — EnergyPlus reconstructs it from the
    interpolated components (``DNI*sin(alt) + DHI``) instead of reading
    the EPW's GHI column; pass that reconstruction to reproduce its runs.

    Time arrays broadcast against surface arrays: pass time as [T, 1] and
    surfaces as [S] to get [T, S].  ``(normal_x, normal_y, cos_tilt)`` is the
    3-D unit outward normal in heatx's frame (cos_tilt = z-component, the
    same stored per surface in SurfaceBatch).
    """
    sx, sy, sz = sun_vector(altitude_rad, azimuth_rad)
    cos_inc = sx * normal_x + sy * normal_y + sz * cos_tilt
    up = np.asarray(altitude_rad) > 0.0
    bf = (
        np.asarray(beam_fraction, np.float64)
        if beam_fraction is not None else None
    )
    sv = (
        np.asarray(sky_view, np.float64) if sky_view is not None else None
    )
    direct = np.asarray(dni) * np.clip(cos_inc, 0.0, None) * up
    if bf is not None:
        # Sunlit fraction from context shading (heatx.weather.shadow):
        # scales the beam (and, under Perez, the circumsolar — it follows
        # the sun, so the per-hour beam visibility gates it, not the
        # hemispheric average).
        direct = direct * bf
    iso_sky = np.asarray(dhi) * (1.0 + cos_tilt) / 2.0
    if sky == "perez":
        if day_of_year is None:
            raise ValueError("sky='perez' requires day_of_year")
        zenith = np.pi / 2.0 - np.asarray(altitude_rad)
        F1, F2 = perez_brightness_coefficients(
            dni, dhi, zenith, day_of_year, i0=perez_i0
        )
        dhi_a = np.asarray(dhi, np.float64)
        a = np.clip(cos_inc, 0.0, None)
        b = np.maximum(np.cos(85.0 * _DEG), np.cos(zenith))
        sin_tilt = np.sqrt(np.clip(1.0 - np.asarray(cos_tilt) ** 2, 0.0, None))
        circ = dhi_a * F1 * a / b  # circumsolar: beam-like
        dome = dhi_a * ((1.0 - F1) * (1.0 + cos_tilt) / 2.0 + F2 * sin_tilt)
        if sv is not None:
            dome = dome * sv
        if bf is not None:
            circ = circ * bf
        elif sv is not None:
            circ = circ * sv  # best available obstruction estimate
        anis = np.clip(dome + circ, 0.0, None)
        iso_down = iso_sky * sv if sv is not None else iso_sky
        sky_term = np.where(up, anis, iso_down)
    elif sky == "isotropic":
        sky_term = iso_sky * sv if sv is not None else iso_sky
    else:
        raise ValueError(f"unknown sky model {sky!r}")
    f_gnd = (1.0 - cos_tilt) / 2.0
    if ground_view is not None:
        gv = np.asarray(ground_view, np.float64)
        f_gnd = np.where(np.isnan(gv), f_gnd, gv)
    g_h = ghi if ground_irradiance is None else ground_irradiance
    ground = np.asarray(g_h) * albedo * f_gnd
    return direct + sky_term + ground


def longwave_irradiance(
    ir_horizontal, t_air_c, cos_tilt, t_ground_c=None, sky_view=None,
):
    """Incident longwave IR on a tilted exterior face, W/m2.

    The EPW's ``horizontal_ir`` column is the sky's hemispheric blackbody
    emission onto a horizontal surface (sigma*T_sky^4).  A tilted face sees
    the sky through ``F_sky = (1 + cos beta)/2`` and the ground through
    ``F_ground = (1 - cos beta)/2``; following EnergyPlus's exterior
    longwave model the sky view further splits between sky temperature and
    air temperature with ``beta = sqrt(F_sky)`` (the near-horizon part of
    the sky dome radiates at ~air temperature).  The ground radiates as a
    blackbody at ``t_ground_c`` (default: air temperature, EnergyPlus's own
    default).  heatx's solver consumes ONE incident-IR channel per face and
    takes its fourth root for the radiant temperature (surface.rs:611-702
    semantics), so the three components sum as fluxes here:

        IR = F_sky*beta*IR_h + (F_sky*(1-beta))*sigma*T_air^4
             + F_ground*sigma*T_ground^4

    Invariant: an isothermal environment (IR_h = sigma*T_air^4 = ground)
    yields IR_h at every tilt.  All arguments broadcast (time as [T, 1],
    surfaces as [S]).
    """
    from heatx_torch.constants import SIGMA

    ir_h = np.asarray(ir_horizontal, np.float64)
    ct = np.clip(np.asarray(cos_tilt, np.float64), -1.0, 1.0)
    f_sky = (1.0 + ct) / 2.0
    f_ground = 1.0 - f_sky
    beta = np.sqrt(f_sky)
    e_air = SIGMA * (np.asarray(t_air_c, np.float64) + 273.15) ** 4
    if t_ground_c is None:
        e_ground = e_air
    else:
        e_ground = SIGMA * (np.asarray(t_ground_c, np.float64) + 273.15) ** 4
    if sky_view is not None:
        # Context obstruction (heatx.weather.shadow.sky_view_fraction):
        # the blocked part of the sky dome radiates at ~air temperature
        # (a building face) instead of the cold sky column.
        sv = np.asarray(sky_view, np.float64)
        ir_h = sv * ir_h + (1.0 - sv) * e_air
    return f_sky * beta * ir_h + f_sky * (1.0 - beta) * e_air + f_ground * e_ground


def surface_longwave(
    epw, building, hours=None, side="front", start_hour=0, t_ground_c=None,
    sky_view=None,
):
    """Per-surface incident longwave from an EPW: the [T, S] ``ir_front``
    input for a compiled building (:func:`longwave_irradiance` over each
    surface's tilt).  ``side``/``hours``/``start_hour`` follow
    :func:`surface_irradiance`; ``t_ground_c`` optionally fixes the ground
    radiant temperature (scalar or [T] series; default air temperature).

    The reference takes incident IR as an input channel and never computes
    it (surface_trait.rs:223-354); this closes the EPW -> inputs loop the
    same way the solar model does.
    """
    T = int(hours) if hours is not None else epw.n_hours
    start = int(start_hour)
    reps = int(np.ceil((start + T) / epw.n_hours))

    def tile(v):
        return np.tile(np.asarray(v, np.float64), reps)[start : start + T]

    ir_h = tile(epw.horizontal_ir)
    t_air = tile(epw.dry_bulb)
    sign = 1.0 if side == "front" else -1.0
    ct = sign * np.asarray(building.surfaces.cos_tilt, np.float64)
    tg = None
    if t_ground_c is not None:
        tg = np.asarray(t_ground_c, np.float64)
        if tg.ndim == 1:
            tg = tg[:, None]
    sv = None
    if sky_view is not None:
        sv = np.asarray(sky_view, np.float64)
        sv = sv[None, :] if sv.ndim == 1 else sv
    return longwave_irradiance(
        ir_h[:, None], t_air[:, None], ct[None, :], tg, sky_view=sv
    )


def sun_and_sky(epw, hours=None, start_hour=0):
    """The side-independent solar state for hours [start, start+T): the
    tiled EPW irradiance columns and the sun path.  Returns
    ``(dni, dhi, ghi, alt, az, day)`` — compute once and pass as ``sun=``
    to :func:`surface_irradiance` for both faces (the per-face work is
    only the final plane-of-array projection)."""
    T = int(hours) if hours is not None else epw.n_hours
    start = int(start_hour)
    reps = int(np.ceil((start + T) / epw.n_hours))

    def tile(v):
        return np.tile(np.asarray(v, np.float64), reps)[start : start + T]

    dni, dhi, ghi = tile(epw.direct_normal), tile(epw.diffuse_horizontal), tile(
        epw.global_horizontal
    )
    h = start + np.arange(T, dtype=np.float64)
    # Day-of-year for the sun position: honor a leap-year EPW's 366 days
    # (the 365 modulo would shift every post-Feb-28 day and map Dec 31 to
    # Jan 1).  Multi-year tiling of a normal EPW keeps the 365-day wrap.
    year_days = 366.0 if epw.n_hours == 8784 else 365.0
    day = (np.floor(h / 24.0) % year_days) + 1.0
    local_hour = (h % 24.0) + 0.5
    alt, az = solar_position(
        epw.latitude_deg, epw.longitude_deg, epw.tz_hours, day, local_hour
    )
    return dni, dhi, ghi, alt, az, day


def sun_and_sky_steps(epw, steps_per_hour, hours=None, start_hour=0):
    """Per-TIMESTEP solar state, EnergyPlus-convention: the EPW irradiance
    columns interpolated to sub-hour steps with records centered at
    mid-hour (hour-ending record h applies at h+0.5 — EnergyPlus's solar
    interpolation scheme), and the sun position evaluated at each step's
    END time (its weather update cadence).  Returns
    ``(dni, dhi, ghi, alt, az, day)`` shaped [hours*steps_per_hour],
    consumable by :func:`poa_irradiance` like :func:`sun_and_sky`'s.

    Measured against EnergyPlus's logged per-timestep incident solar
    (Timestep 20, tests/test_e2e_eplus.py), this convention roughly HALVES
    the hourly-then-interpolate path's residual (massive 5.1 -> 2.8,
    horizontal 6.3 -> 3.2 W/m2 RMSE) and collapses its -1.1..+1.5 W/m2
    mean offsets to < +-0.45 — the convention experiment is in PERF.md.
    """
    sph = int(steps_per_hour)
    T = int(hours) if hours is not None else epw.n_hours
    start = int(start_hour)
    # One record past the horizon for the trailing half-hour interpolation.
    reps = int(np.ceil((start + T + 2) / epw.n_hours))

    def tile(v):
        return np.tile(np.asarray(v, np.float64), reps)[start : start + T + 2]

    rec = (
        tile(epw.direct_normal),
        tile(epw.diffuse_horizontal),
        tile(epw.global_horizontal),
    )
    t = (np.arange(T * sph, dtype=np.float64) + 1.0) / sph  # step END, hours
    k = np.clip(np.floor(t - 0.5).astype(int), 0, T)
    frac = np.clip(t - 0.5 - k, 0.0, 1.0)

    def midlerp(v):
        return v[k] * (1.0 - frac) + v[k + 1] * frac

    dni, dhi, ghi = (midlerp(v) for v in rec)
    h = start + t
    year_days = 366.0 if epw.n_hours == 8784 else 365.0
    day = (np.floor(h / 24.0) % year_days) + 1.0
    alt, az = solar_position(
        epw.latitude_deg, epw.longitude_deg, epw.tz_hours, day, h % 24.0
    )
    return dni, dhi, ghi, alt, az, day


def surface_irradiance_steps(
    epw, building, steps_per_hour, albedo=0.2, hours=None, side="front",
    start_hour=0, sun=None, ground_view=None, beam_fraction=None,
    sky_view=None,
):
    """Per-surface incident solar at SUB-HOUR resolution, matching
    EnergyPlus's own sub-hour chain: :func:`sun_and_sky_steps` conventions
    plus its Perez normalization (solar constant 1367) and
    ground-reflected term reconstructed from the interpolated components
    (``DNI*sin(alt) + DHI``) rather than the EPW GHI column.  Returns
    [hours*steps_per_hour, S]; arguments follow :func:`surface_irradiance`.

    Use for sub-hourly (n > 1) runs and EnergyPlus cross-validation; the
    hourly :func:`surface_irradiance` remains the annual-run default (at
    hourly resolution the two agree by construction).
    """
    sb = building.surfaces
    if sun is None:
        sun = sun_and_sky_steps(
            epw, steps_per_hour, hours=hours, start_hour=start_hour
        )
    dni, dhi, ghi, alt, az, day = sun
    sign = 1.0 if side == "front" else -1.0
    nx = sign * np.asarray(sb.normal[:, 0], np.float64)
    ny = sign * np.asarray(sb.normal[:, 1], np.float64)
    ct = sign * np.asarray(sb.cos_tilt, np.float64)
    gv = None
    if ground_view is not None:
        gv = np.asarray(ground_view, np.float64)
        gv = gv[None, :] if gv.ndim == 1 else gv
    sv = None
    if sky_view is not None:
        sv = np.asarray(sky_view, np.float64)
        sv = sv[None, :] if sv.ndim == 1 else sv
    g_recon = np.where(
        alt > 0.0, dni * np.sin(np.maximum(alt, 0.0)) + dhi, dhi
    )
    return poa_irradiance(
        dni[:, None], dhi[:, None], ghi[:, None],
        alt[:, None], az[:, None], nx[None, :], ny[None, :], ct[None, :],
        albedo=albedo, sky="perez", day_of_year=day[:, None], ground_view=gv,
        beam_fraction=beam_fraction, sky_view=sv, perez_i0=1367.0,
        ground_irradiance=g_recon[:, None],
    )


# ASHRAE (1997 Fundamentals ch. 29, table 7) clear-sky coefficients per
# month: A = apparent extraterrestrial irradiance [W/m2], B = atmospheric
# extinction, C = diffuse-to-beam ratio.  The design-day solar model
# EnergyPlus's ASHRAEClearSky option implements.
_ASHRAE_A = np.array([1230., 1215., 1186., 1136., 1104., 1088.,
                      1085., 1107., 1151., 1192., 1221., 1233.])
_ASHRAE_B = np.array([0.142, 0.144, 0.156, 0.180, 0.196, 0.205,
                      0.207, 0.201, 0.177, 0.160, 0.149, 0.142])
_ASHRAE_C = np.array([0.058, 0.060, 0.071, 0.097, 0.121, 0.134,
                      0.136, 0.122, 0.092, 0.073, 0.063, 0.057])


def ashrae_clear_sky(altitude_rad, month, clearness=1.0):
    """ASHRAE clear-sky ``(DNI, DHI)`` for design days.

    ``DNI = clearness * A * exp(-B / sin alt)`` (0 below the horizon),
    ``DHI = C * DNI``; ``month`` is 1-12 (scalar), ``clearness`` the
    optional sky clearness number (EnergyPlus design-day field, 0..1.2).
    """
    m = int(month) - 1
    alt = np.asarray(altitude_rad, np.float64)
    up = alt > 0.0
    sin_a = np.where(up, np.sin(alt), 1.0)
    dni = np.where(
        up, clearness * _ASHRAE_A[m] * np.exp(-_ASHRAE_B[m] / sin_a), 0.0
    )
    return dni, _ASHRAE_C[m] * dni


def model_ground_views(model):
    """Per-surface solar ground view factors for :func:`surface_irradiance`,
    aligned with the compiled surface order (surfaces then fenestrations,
    build/layout.py): each surface's explicit ``ground_view_factor`` where
    given (e.g. an imported IDF's "View Factor to Ground"), NaN where
    geometric."""
    defs = list(model.surfaces) + list(model.fenestrations)
    return np.array(
        [np.nan if s.ground_view_factor is None else float(s.ground_view_factor)
         for s in defs],
        np.float64,
    )


def surface_irradiance(
    epw, building, albedo=0.2, hours=None, side="front", sky="isotropic",
    start_hour=0, sun=None, ground_view=None, beam_fraction=None,
    sky_view=None,
):
    """Per-surface incident solar from an EPW: the [T, S] ``sol_front``
    input for a compiled building (front faces are the outdoor side in
    heatx's layout convention).  ``side="back"`` evaluates the opposite
    faces (negated normals) for models whose outdoor boundary is the back.
    ``sky`` selects the diffuse transposition ("isotropic" or "perez").

    EPW records are hour-ending local standard time; sun position is
    evaluated at the middle of each hour.  ``hours`` tiles/truncates the
    annual series (default: the EPW's own length); ``start_hour`` offsets
    into the year (segmented runs) — evaluating hours [start, start+T)
    directly instead of computing the prefix and slicing.  ``sun`` accepts
    a precomputed :func:`sun_and_sky` result so callers evaluating both
    faces pay for the sun path once.  ``ground_view`` optionally overrides
    the ground-reflected view factor (scalar or [S]; NaN entries stay
    geometric — :func:`model_ground_views` builds the array from a
    BuildingModel's explicit per-surface factors).  ``beam_fraction``
    ([T, S]) scales the direct term only — the sunlit fractions
    :func:`heatx.weather.shadow.sunlit_fraction` computes from context
    shading polygons.
    """
    sb = building.surfaces
    if sun is None:
        sun = sun_and_sky(epw, hours=hours, start_hour=start_hour)
    dni, dhi, ghi, alt, az, day = sun
    sign = 1.0 if side == "front" else -1.0
    nx = sign * np.asarray(sb.normal[:, 0], np.float64)
    ny = sign * np.asarray(sb.normal[:, 1], np.float64)
    ct = sign * np.asarray(sb.cos_tilt, np.float64)
    gv = None
    if ground_view is not None:
        gv = np.asarray(ground_view, np.float64)
        gv = gv[None, :] if gv.ndim == 1 else gv
    sv = None
    if sky_view is not None:
        sv = np.asarray(sky_view, np.float64)
        sv = sv[None, :] if sv.ndim == 1 else sv
    return poa_irradiance(
        dni[:, None], dhi[:, None], ghi[:, None],
        alt[:, None], az[:, None], nx[None, :], ny[None, :], ct[None, :],
        albedo=albedo, sky=sky, day_of_year=day[:, None], ground_view=gv,
        beam_fraction=beam_fraction, sky_view=sv,
    )

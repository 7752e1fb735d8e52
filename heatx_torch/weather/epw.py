"""EPW weather-file reader.

heatx_torch copy of ``heatx.weather.epw`` (numpy only).

Host-side replacement for the slice of SIMPLE's external ``weather`` crate
that the thermal module consumes (model.rs:372-374: dry-bulb temperature,
wind speed, wind direction per timestep), with the solar and longwave
columns and the monthly soil temperatures.  Returns plain numpy arrays;
``FastRunner.run`` tiles/interpolates them into per-sub-step inputs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np

# EPW data-record field indices (EnergyPlus Auxiliary Programs spec).
_F_DRY_BULB = 6
_F_REL_HUMIDITY = 8
_F_WIND_DIR = 20
_F_WIND_SPEED = 21
_F_GLOBAL_HORIZ = 13
_F_DIRECT_NORMAL = 14
_F_DIFFUSE_HORIZ = 15
_F_HORIZ_IR = 12


@dataclass
class EPWData:
    """Hourly weather series (8760 or 8784 entries)."""

    dry_bulb: np.ndarray  # C
    rel_humidity: np.ndarray  # %
    wind_speed: np.ndarray  # m/s
    wind_direction_deg: np.ndarray  # degrees
    global_horizontal: np.ndarray  # W/m2
    direct_normal: np.ndarray  # W/m2
    diffuse_horizontal: np.ndarray  # W/m2
    horizontal_ir: np.ndarray  # W/m2
    location: str = ""
    latitude_deg: float = 0.0  # north positive (EPW LOCATION header)
    longitude_deg: float = 0.0  # east positive
    tz_hours: float = 0.0  # UTC offset of the records' local standard time
    #: depth (m) -> 12 monthly soil temperatures (C), from the EPW's
    #: GROUND TEMPERATURES header line (empty when the file omits it).
    ground_temps: Dict[float, np.ndarray] = field(default_factory=dict)
    #: ASHRAE climatic design data parsed from the DESIGN CONDITIONS
    #: header (empty when absent).  Keys: heating_coldest_month,
    #: heating_db_996, heating_db_990, heating_dp_996, heating_mcws
    #: (mean wind coincident with the 99.6% DB), cooling_hottest_month,
    #: cooling_db_range, cooling_db_004/010/020, cooling_mcwb_004,
    #: cooling_mcws (heatx's design-day sizing reads them).
    design_conditions: Dict[str, float] = field(default_factory=dict)

    @property
    def n_hours(self) -> int:
        return len(self.dry_bulb)

    @property
    def wind_direction_rad(self) -> np.ndarray:
        return np.radians(self.wind_direction_deg)

    def ground_temperature(self, depth: float = None) -> np.ndarray:
        """The 12 monthly soil temperatures at ``depth`` (m) — the closest
        tabulated depth when the exact one is absent; the deepest one by
        default (the most seasonally damped, the usual slab choice)."""
        if not self.ground_temps:
            raise ValueError(
                f"{self.location or 'EPW'} has no GROUND TEMPERATURES header"
            )
        depths = sorted(self.ground_temps)
        if depth is None:
            return self.ground_temps[depths[-1]]
        best = min(depths, key=lambda d: abs(d - depth))
        return self.ground_temps[best]


def read_epw(path: str) -> EPWData:
    """Parse an EPW file (8 header lines + hourly records)."""
    with open(path, "r", errors="replace") as f:
        lines = f.readlines()
    location = lines[0].strip() if lines else ""
    lat = lon = tz = 0.0
    loc_parts = location.split(",")
    if len(loc_parts) >= 9 and loc_parts[0].upper() == "LOCATION":
        try:
            lat, lon, tz = (float(loc_parts[k]) for k in (6, 7, 8))
        except ValueError:
            pass
    design_conditions: Dict[str, float] = {}
    for line in lines[:8]:
        parts = [p.strip() for p in line.split(",")]
        if parts[0].upper() != "DESIGN CONDITIONS":
            continue
        # ASHRAE Handbook layout (EnergyPlus Auxiliary Programs): the
        # 'Heating' / 'Cooling' markers start fixed-order value runs.
        def _take(marker, offsets):
            try:
                i = next(
                    k for k, p in enumerate(parts) if p.lower() == marker
                )
            except StopIteration:
                return
            for key, off in offsets.items():
                try:
                    design_conditions[key] = float(parts[i + off])
                except (ValueError, IndexError):
                    pass
        _take("heating", {
            "heating_coldest_month": 1, "heating_db_996": 2,
            "heating_db_990": 3, "heating_dp_996": 4, "heating_mcws": 14,
        })
        _take("cooling", {
            "cooling_hottest_month": 1, "cooling_db_range": 2,
            "cooling_db_004": 3, "cooling_mcwb_004": 4,
            "cooling_db_010": 5, "cooling_db_020": 7, "cooling_mcws": 15,
        })
        break
    ground_temps: Dict[float, np.ndarray] = {}
    for line in lines[:8]:
        parts = [p.strip() for p in line.split(",")]
        if parts[0].upper() != "GROUND TEMPERATURES":
            continue
        # GROUND TEMPERATURES, n, then per set: depth, soil conductivity,
        # soil density, soil specific heat (all may be blank), 12 monthly C.
        try:
            n_sets = int(float(parts[1]))
        except (ValueError, IndexError):
            continue
        for g in range(n_sets):
            base = 2 + g * 16
            try:
                depth = float(parts[base])
                months = np.array(
                    [float(v) for v in parts[base + 4 : base + 16]], np.float64
                )
            except (ValueError, IndexError):
                continue
            if len(months) == 12:
                ground_temps[depth] = months
    rows = []
    blank_at = None  # tolerate blank lines only at EOF: a mid-file blank
    # is a lost record and would shift every later hour of the year
    for li, line in enumerate(lines[8:], start=9):
        if not line.strip():
            if blank_at is None:
                blank_at = li
            continue
        if blank_at is not None:
            raise ValueError(
                f"EPW blank line {blank_at} in the middle of the data "
                "section (a lost record would misalign the year)"
            )
        parts = line.strip().split(",")
        if len(parts) < 22:
            # Silently skipping a truncated record would shift every later
            # hour of the year (solar position, ground series, schedules).
            raise ValueError(
                f"EPW data record at line {li} has {len(parts)} fields "
                "(need >= 22): truncated or damaged file"
            )
        rows.append(
            (
                float(parts[_F_DRY_BULB]),
                float(parts[_F_REL_HUMIDITY]),
                float(parts[_F_WIND_SPEED]),
                float(parts[_F_WIND_DIR]),
                float(parts[_F_GLOBAL_HORIZ]),
                float(parts[_F_DIRECT_NORMAL]),
                float(parts[_F_DIFFUSE_HORIZ]),
                float(parts[_F_HORIZ_IR]),
            )
        )
    if not rows:
        raise ValueError(f"no weather data records found in EPW file")
    data = np.array(rows, dtype=np.float64)
    # EPW missing-data markers (99.9 dry bulb, 999 wind, 9999 radiation/IR):
    # hold the last valid value (EnergyPlus's substitution convention) rather
    # than injecting the marker as physics.
    _MISSING = (99.0, 999.0, 999.0, 400.0, 9999.0, 9999.0, 9999.0, 9999.0)
    for col, thresh in enumerate(_MISSING):
        v = data[:, col]
        bad = v >= thresh
        if not bad.any():
            continue
        if bad.all():
            raise ValueError(
                f"EPW column {col} is entirely missing-data markers"
            )
        import warnings

        warnings.warn(
            f"EPW: {int(bad.sum())} missing-data records in column {col} "
            "held at the last valid value",
            stacklevel=2,
        )
        idx = np.where(bad, 0, np.arange(len(v)))
        idx = np.maximum.accumulate(idx)  # last valid index at or before i
        first = np.flatnonzero(~bad)[0]
        v = v[np.maximum(idx, first)]  # head gap back-fills the first valid
        data[:, col] = v
    return EPWData(
        dry_bulb=data[:, 0],
        rel_humidity=data[:, 1],
        wind_speed=data[:, 2],
        wind_direction_deg=data[:, 3],
        global_horizontal=data[:, 4],
        direct_normal=data[:, 5],
        diffuse_horizontal=data[:, 6],
        horizontal_ir=data[:, 7],
        location=location,
        latitude_deg=lat,
        longitude_deg=lon,
        tz_hours=tz,
        ground_temps=ground_temps,
        design_conditions=design_conditions,
    )


_MONTH_HOURS = np.repeat(
    np.arange(12), np.array([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31]) * 24
)
_MONTH_HOURS_LEAP = np.repeat(
    np.arange(12), np.array([31, 29, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31]) * 24
)


def monthly_to_hourly(
    monthly: np.ndarray, hours: int = 8760, leap: bool = False
) -> np.ndarray:
    """Expand 12 monthly values into an hourly series (each month's value
    held across its hours, EnergyPlus's ground-temperature convention),
    tiled/truncated to ``hours``.  Pass ``leap=True`` for an 8784-hour
    leap-year weather file — the 365-day table would otherwise shift every
    boundary after Feb 28 and give Dec 31 January's value (8784 alone is
    ambiguous: it is also one year + one day of a multi-year tiling)."""
    monthly = np.asarray(monthly, np.float64)
    if monthly.shape != (12,):
        raise ValueError(f"expected 12 monthly values, got {monthly.shape}")
    year = monthly[_MONTH_HOURS_LEAP if leap else _MONTH_HOURS]
    reps = -(-hours // len(year))
    return np.tile(year, reps)[:hours]


def interpolate_to_steps(values: np.ndarray, steps_per_hour: int) -> np.ndarray:
    """Linearly interpolate an hourly series to ``steps_per_hour`` sub-values
    per hour (length n_hours * steps_per_hour), wrapping at the year end."""
    n = len(values)
    xi = np.arange(n * steps_per_hour) / steps_per_hour
    wrapped = np.concatenate([values, values[:1]])
    return np.interp(xi, np.arange(n + 1), wrapped)

"""The command line: simulate a ``.spl`` or EnergyPlus ``.idf`` building
under an EPW weather file.

The reference ships as a library only — it plugs into SIMPLE's orchestrator
through the ``SimulationModel`` trait (model.rs:182-428) and has no
executable.  heatx additionally ships this standalone program so a model +
weather pair can be inspected and simulated without writing Python:

    python -m heatx_torch info model.spl
    python -m heatx_torch simulate model.spl weather.epw -o zones.csv --hours 168
    python -m heatx_torch simulate in.idf weather.epw -o zones.csv
    python -m heatx_torch size in.idf weather.epw --annual

``.idf`` models load via :mod:`heatx_torch.model.idf` (envelope subset); their
``Timestep`` sets the main-step rate unless ``--n`` overrides it.

``simulate`` writes the hourly zone-temperature history as CSV (the
reference's observable output channel, zone.rs:45-49) and prints a per-zone
summary.  Solar irradiance on outdoor faces is computed from the EPW's
DNI/DHI/GHI via :mod:`heatx_torch.weather.solar` (the reference takes
per-surface irradiance as an external input); incident infrared uses the
EPW's horizontal IR column.  Engines: the plain-PyTorch march
(``ThermalModel.run``, heatx's "XLA" engine: ``--engine xla``) or the day
march (``--engine kernel``: the CUDA day kernel on the card, its plain
version with ``--platform cpu``; picked automatically on the card).

heatx_torch copy of heatx's command line, with its flags, exit codes and
file formats.  ``--platform`` takes ``gpu`` (the default: the card) or
``cpu``; ``--block-size`` defaults to the fewest lanes that hold the largest
zone-connected component (at most 256).  Histories come off the device
once, before they are formatted.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import sys
import time

import numpy as np
import torch

from heatx_torch.api import _np as _host  # a history off the device, once


def _device(args) -> torch.device:
    """The torch device of ``--platform`` (gpu: the card, the default;
    cpu: the plain versions).  Asking for the card without one raises."""
    from heatx_torch.ops.cuda_lib import resolve_device

    platform = (getattr(args, "platform", None) or "gpu").lower()
    if platform not in ("gpu", "cuda", "cpu"):
        raise ValueError(f"--platform must be gpu or cpu, got {platform!r}")
    return resolve_device("cpu" if platform == "cpu" else "cuda")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _build(args, device):
    from heatx_torch import SimConfig, ThermalModel

    extras = {"infiltration": {}, "loaded": None}
    if args.model.lower().endswith(".idf"):
        from heatx_torch.model.idf import load_idf

        loaded = load_idf(args.model)
        model = loaded.model
        n = args.n if args.n is not None else loaded.timestep
        extras["infiltration"] = loaded.infiltration
        extras["loaded"] = loaded
    else:
        from heatx_torch.model.spl import load_spl

        model = load_spl(args.model)
        n = args.n if args.n is not None else 1
    kw = {"dtype": torch.float64 if args.f64 else torch.float32}
    if getattr(args, "nomass_iters", None):
        kw["nomass_fixed_iters"] = args.nomass_iters
    if getattr(args, "interior_mrt", False):
        kw["interior_mrt"] = True
    tm = ThermalModel(model, n=n, config=SimConfig(**kw), device=device)
    return model, tm, extras


def cmd_info(args) -> int:
    model, tm, extras = _build(args, _device(args))
    b = tm.building
    sb = b.surfaces
    print(f"model: {args.model}")
    print(
        f"  {b.n_surfaces} surfaces ({int(np.sum(sb.is_fenestration))} "
        f"fenestrations), {b.n_zones} zones, {b.n_hvacs} HVACs, "
        f"{b.n_luminaires} luminaires"
    )
    print(
        f"  main step: {3600.0 / b.n_steps_per_hour:.0f} s; sub-steps per "
        f"main step: {b.dt_subdivisions} "
        f"(dt = {3600.0 / (b.n_steps_per_hour * b.dt_subdivisions):.1f} s)"
    )
    names = [s.name for s in model.surfaces] + [f.name for f in model.fenestrations]
    massive_nodes = np.sum(np.asarray(sb.massive), axis=0)
    nomass_nodes = np.sum(np.asarray(sb.node_mask), axis=0) - massive_nodes
    print(f"  {'surface':<28} {'area m2':>8} {'nodes':>6} {'massive':>8} {'no-mass':>8}")
    for i, name in enumerate(names):
        print(
            f"  {name:<28} {float(sb.area[i]):>8.2f} {int(sb.n_nodes[i]):>6}"
            f" {int(massive_nodes[i]):>8} {int(nomass_nodes[i]):>8}"
        )
    for z, sp in enumerate(model.spaces):
        print(f"  zone {z}: {sp.name} ({sp.volume:.1f} m3)")
    loaded = extras.get("loaded")
    if loaded is not None:
        for g in loaded.gains:
            sched = " x ".join(g.schedules) if g.schedules else "always on"
            print(
                f"  gain: {g.name} -> {g.zone} ({g.design_w:.0f} W sensible, "
                f"{sched})"
            )
        for t in loaded.thermostats:
            print(
                f"  thermostat: {t.name} -> {t.zone} "
                f"(heat {t.heat_schedule or 'constant'}, "
                f"cool {t.cool_schedule or 'constant'})"
            )
        for r in loaded.airflows:
            print(
                f"  {r.kind}: {r.zone} {r.flow:.3f} m3/s "
                f"({r.schedule or 'always on'})"
            )
    return 0


def _weather_series(epw, T, start=0):
    """Tile/truncate the EPW's hourly columns to hours [start, start+T)."""

    reps = -(-(start + T) // epw.n_hours)

    def tile(v):
        return np.tile(np.asarray(v, np.float64), reps)[start : start + T]

    return (
        tile(epw.dry_bulb),
        tile(epw.wind_speed),
        tile(np.radians(epw.wind_direction_deg)),
        tile(epw.horizontal_ir),
        tile(epw.rel_humidity),
    )


# The only channels this CLI ever builds as 1-D per-step series; per-zone /
# per-device vectors (inf_*, vent_*, mix_vol, hvac_power, lum_power) are
# static whatever their length.
_SERIES_1D = {
    "t_out", "wind_speed", "wind_direction",
    "sol_front", "sol_back", "ir_front", "ir_back",
}


def _time_leaf_mask(seq, total_steps: int):
    """Per-FIELD "carries the [T, ...] time axis" mask (dict by name) of a
    StepInputs.

    Shape alone is ambiguous on short runs: a static per-zone [Z] leaf with
    Z == T would masquerade as a series (e.g. a 48-zone model run with
    --hours 48).  1-D leaves therefore classify by channel name
    (_SERIES_1D); 2-D+ leaves are series iff their leading axis is the run
    length (this CLI builds no 2-D static leaves)."""
    out = {}
    for f in dataclasses.fields(seq):
        name = f.name
        v = getattr(seq, name)
        ok = (
            v is not None
            and v.ndim > 0
            and v.shape[0] == total_steps
        )
        if ok and v.ndim == 1 and name not in _SERIES_1D:
            ok = False
        out[name] = ok
    return out


def _slice_inputs(seq, idx, is_time):
    """Index/slice the time axis of every series field; static fields pass."""
    return seq.replace(
        **{k: getattr(seq, k)[idx] for k, t in is_time.items() if t}
    )


def _first_day(seq, total_steps: int, day_steps: int):
    """Slice a [T, ...]-leading StepInputs to its first simulated day
    (static channels pass through) — the repeated period for --warmup-days.
    Returns ``(day, is_time)`` with the time-field mask for further slicing."""
    k = min(day_steps, total_steps)
    is_time = _time_leaf_mask(seq, total_steps)
    return _slice_inputs(seq, slice(0, k), is_time), is_time


def cmd_simulate(args) -> int:
    if args.refresh_every is not None and args.mode != "trbdf2_refresh":
        print("error: --refresh-every applies to --mode trbdf2_refresh",
              file=sys.stderr)
        return 2
    if args.refresh_every is not None and (
        args.refresh_every < 1 or args.substeps % args.refresh_every
    ):
        print(
            f"error: --refresh-every {args.refresh_every} must divide "
            f"--substeps {args.substeps}",
            file=sys.stderr,
        )
        return 2
    if args.engine == "kernel" and args.mode == "exp":
        print(
            "error: --engine kernel supports --mode parity/trbdf2 only; "
            "use --engine xla for the exponential integrator",
            file=sys.stderr,
        )
        return 2
    device = _device(args)

    from heatx_torch.build.layout import B_OUTDOOR
    from heatx_torch.weather.epw import read_epw
    from heatx_torch.weather.solar import (
        longwave_irradiance,
        sun_and_sky,
        surface_irradiance,
    )

    model, tm, extras = _build(args, device)
    b = tm.building
    sb = b.surfaces
    epw = read_epw(args.epw)
    T, start = args.hours, args.start_hour
    loaded0 = extras.get("loaded")
    if loaded0 is not None and loaded0.run_period is not None and (
        start is None or not T
    ):
        # The IDF's own RunPeriod dates, unless overridden on the line
        # (--start-hour 0 is an explicit Jan-1 request, hence the None
        # default).  A begin date after the end date runs across the year
        # boundary, as EnergyPlus does.
        d0, d1 = loaded0.run_period
        year_days = epw.n_hours // 24  # 366 for a leap EPW
        days = d1 - d0 + 1 if d1 >= d0 else year_days - d0 + d1 + 1
        from_dates = start is None
        if start is None:
            start = d0 * 24
        if not T:
            T = days * 24
        if from_dates:
            print(
                f"# RunPeriod: days {d0 + 1}..{d1 + 1} ({T} h from hour "
                f"{start})",
                file=sys.stderr,
            )
        else:
            # --start-hour overrides the dates; only the duration is kept.
            print(
                f"# RunPeriod duration kept ({T} h), from --start-hour "
                f"{start}",
                file=sys.stderr,
            )
    T = T or epw.n_hours
    start = start % epw.n_hours if start else 0
    n = b.n_steps_per_hour
    # Sub-hourly runs interpolate toward the EPW's ACTUAL next record at
    # the horizon end, so fetch one extra hour (wrapping to hour 0 of the
    # series there would blend e.g. a July evening toward Jan 1 00:30).
    Tx = T + 1 if n > 1 else T
    dry, wind, wdir, ir, _rh = _weather_series(epw, Tx, start)

    # Seasonal soil temperatures: monthly per-hour ground series when the
    # model has ground-contact faces and the EPW tabulates GROUND
    # TEMPERATURES (--no-ground disables; --ground-depth picks the depth).
    from heatx_torch.build.layout import B_GROUND
    from heatx_torch.weather.epw import _MONTH_HOURS, _MONTH_HOURS_LEAP

    has_ground = bool(
        ((np.asarray(sb.front_code) == B_GROUND)
         | (np.asarray(sb.back_code) == B_GROUND)).any()
    )
    ground_hourly = None
    if args.ground and has_ground and epw.ground_temps:
        monthly = epw.ground_temperature(args.ground_depth)
        # Leap-year weather (8784 records) keeps Feb = 29 days so the month
        # boundaries stay aligned with the weather series.
        mh = _MONTH_HOURS_LEAP if epw.n_hours == 8784 else _MONTH_HOURS
        ground_hourly = monthly[mh[(start + np.arange(T)) % len(mh)]]
        print(
            f"# seasonal ground temperatures "
            f"({monthly.min():.1f}..{monthly.max():.1f} C)",
            file=sys.stderr,
        )

    out_front = np.asarray(sb.front_code) == B_OUTDOOR
    out_back = np.asarray(sb.back_code) == B_OUTDOOR
    # Context-shading per-face sky obstruction (set under --solar).
    sky_view_f = sky_view_b = None
    if args.solar:
        # The sun path and tiled irradiance columns are side-independent:
        # compute once, project onto both faces.  Explicit per-surface
        # "View Factor to Ground" declarations (IDF imports) override the
        # geometric ground-reflected term, like EnergyPlus.
        from heatx_torch.weather.solar import model_ground_views

        gv = model_ground_views(model)
        sun = sun_and_sky(epw, hours=Tx, start_hour=start)
        beam_frac = None
        if model.shades:
            # Context shading (overhangs / fins / neighbors): ray-cast
            # sunlit fractions scale the beam term on both faces, and
            # per-FACE static sky-view factors carry the obstruction into
            # the diffuse sky term and the longwave (the blocked dome
            # radiates at ~air temperature).
            from heatx_torch.weather.shadow import sky_view_fraction, sunlit_fraction

            _, _, _, alt_s, az_s, _ = sun
            beam_frac = sunlit_fraction(model, alt_s, az_s)
            sky_view_f = sky_view_fraction(model)
            if out_back.any():
                sky_view_b = sky_view_fraction(model, side="back")
            print(
                f"# context shading: {len(model.shades)} polygon(s) "
                "ray-cast into beam sunlit fractions (min sky view "
                f"{sky_view_f.min():.2f})",
                file=sys.stderr,
            )
        sol_f = (
            surface_irradiance(
                epw, b, hours=Tx, albedo=args.albedo, sky=args.sky, sun=sun,
                ground_view=gv, beam_fraction=beam_frac,
                sky_view=sky_view_f,
            )
            * out_front
        )
        sol_b = (
            surface_irradiance(
                epw, b, hours=Tx, albedo=args.albedo, side="back",
                sky=args.sky, sun=sun, ground_view=gv,
                beam_fraction=beam_frac, sky_view=sky_view_b,
            )
            * out_back
        )
        if loaded0 is not None and loaded0.shading:
            # Imported window shading: scale the controlled panes'
            # incident solar by the deployed shade's transmittance.
            # Weather-dependent controls read the EPW columns and the
            # pre-scaling incident solar (a pane's outdoor face is
            # whichever side is exterior, so front+back covers both).
            reps = -(-(start + Tx) // epw.n_hours)

            def _tile(v):
                return np.tile(np.asarray(v, np.float64), reps)[
                    start : start + Tx
                ]

            shade_mult = loaded0.shading_series(
                Tx, start,
                dry_bulb=_tile(epw.dry_bulb),
                horizontal_solar=_tile(epw.global_horizontal),
                incident=sol_f + sol_b,
            )
            sol_f = sol_f * shade_mult
            sol_b = sol_b * shade_mult
            print(
                f"# window shading: {len(loaded0.shading)} rule(s) applied "
                "to the incident-solar inputs",
                file=sys.stderr,
            )
    else:
        S = b.n_surfaces
        sol_f = np.zeros((Tx, S))
        sol_b = np.zeros((Tx, S))
    if args.ir_model == "tilted":
        # EnergyPlus-style exterior longwave: sky through F_sky (split
        # sky/air by sqrt(F_sky)), ground at air temperature through
        # F_ground.  A vertical wall sees ~35% cold sky instead of 100%.
        # Context shades reduce the visible sky further (per-face factors
        # from the solar block above; None without shades or --no-solar).
        ct = np.asarray(sb.cos_tilt, np.float64)
        svf = sky_view_f[None, :] if sky_view_f is not None else None
        svb = sky_view_b[None, :] if sky_view_b is not None else None
        ir_f = longwave_irradiance(
            ir[:, None], dry[:, None], ct[None, :], sky_view=svf
        )
        ir_b = longwave_irradiance(
            ir[:, None], dry[:, None], -ct[None, :], sky_view=svb
        )
        ir_f = ir_f * out_front
        ir_b = ir_b * out_back
    else:
        ir_f = ir[:, None] * out_front
        ir_b = ir[:, None] * out_back

    engine = args.engine
    if engine == "auto":
        # The day kernel implements parity, both trbdf2 modes, the
        # interior-MRT network, and the in-run zone-state controls
        # (window shading + ventilation temperature gates); exp stays on
        # the plain-PyTorch loop even on the card.  It marches whole
        # hours, so sub-hourly main steps (--n / IDF Timestep > 1) stay
        # on the plain march.
        on_card = device.type == "cuda"
        engine = (
            "kernel"
            if (on_card and args.mode != "exp" and n == 1)
            else "xla"
        )
    if engine == "kernel" and n > 1:
        print(
            "error: --engine kernel marches hourly main steps; rebuild with "
            "--n 1 or use --engine xla",
            file=sys.stderr,
        )
        return 2
    if getattr(args, "checked", False) and (
        engine == "kernel" or args.mode != "parity"
    ):
        # Don't let the flag imply a guard that isn't running: the per-step
        # check exists on the plain parity march (run_checked) only.
        print(
            "# note: --checked applies to the XLA parity engine; this run "
            "uses the kernel's per-chunk fail-fast / post-run finiteness "
            "checks instead",
            file=sys.stderr,
        )
    if n > 1:
        # Hourly EPW weather drives n main steps per hour.  Continuous
        # channels interpolate linearly to the main-step grid (EnergyPlus's
        # own hourly->Timestep convention), with the horizon's last hour
        # blending toward the fetched hour-T record (the [Tx = T+1]-length
        # series above); wind direction is circular and holds.  The CSV
        # reports end-of-hour temperatures.
        def interp(a):  # a: [T+1, ...] including the true next record
            xi = np.arange(T * n) / n
            i0 = np.floor(xi).astype(int)
            frac = (xi - i0).reshape((-1,) + (1,) * (a.ndim - 1))
            return a[i0] * (1.0 - frac) + a[i0 + 1] * frac

        dry, wind = interp(dry), interp(wind)
        sol_f, sol_b, ir_f, ir_b = (interp(a) for a in (sol_f, sol_b, ir_f, ir_b))
        wdir = np.repeat(wdir[:T], n)
        T_steps = T * n
    else:
        T_steps = T

    # IDF internal gains and thermostat schedules: rendered hourly channel
    # overrides (lights/equipment/people power, scheduled setpoints).
    gain_kw = {}
    loaded = extras.get("loaded")
    if loaded is not None:
        gain_kw = loaded.hourly_channels(T, start_hour=start)
        if gain_kw:
            kinds = ", ".join(sorted(gain_kw))
            print(
                f"# imported gains/schedules: {len(loaded.gains)} devices, "
                f"{len(loaded.thermostats)} thermostats ({kinds})",
                file=sys.stderr,
            )
            if n > 1:
                # Gains and setpoints hold constant within the hour on the
                # sub-hourly main-step grid (E+ reads schedules hourly too).
                gain_kw = {
                    k: np.repeat(v, n, axis=0) for k, v in gain_kw.items()
                }
        if loaded.zone_shading:
            # In-run zone-state shading: the controls are compiled into the
            # model; only their schedule AND-gates need a per-step channel.
            sp_series = loaded.shading_setpoint_series(T, start_hour=start)
            if sp_series is not None:
                if n > 1:
                    sp_series = np.repeat(sp_series, n, axis=0)
                gain_kw["shade_sp"] = sp_series
            print(
                f"# in-run zone shading: {len(loaded.zone_shading)} "
                "rule(s) compiled into the march"
                + (" (with schedule gates)" if sp_series is not None else ""),
                file=sys.stderr,
            )

    # IDF infiltration/ventilation flows: outdoor air exchanged at the
    # scheduled m3/s per zone, inlet at the (interpolated) outdoor dry bulb.
    inf_kw = {}
    if loaded is not None and loaded.airflows:
        Z = len(model.spaces)
        air = loaded.airflow_series(T, start_hour=start)
        if n > 1:  # hold within the hour on the sub-hourly main-step grid
            air = {k: np.repeat(v, n, axis=0) for k, v in air.items()}
        t_in = np.repeat(dry[:, None], Z, axis=1)
        if "inf_vol" in air and air["inf_vol"].any():
            inf_kw.update(
                inf_vol=air["inf_vol"], inf_mask=air["inf_vol"] > 0.0,
                inf_temp=t_in,
            )
        if "vent_vol" in air and air["vent_vol"].any():
            inf_kw.update(
                vent_vol=air["vent_vol"], vent_mask=air["vent_vol"] > 0.0,
                vent_temp=t_in,
            )
        for kind, m_ in (("infiltration", extras.get("infiltration") or {}),
                         ("ventilation", loaded.ventilation)):
            if any(v > 0.0 for v in m_.values()):
                tot = ", ".join(
                    f"{name} {v:.3f}" for name, v in m_.items() if v > 0
                )
                print(f"# {kind} (m3/s): {tot}", file=sys.stderr)
    print(
        f"# {b.n_surfaces} surfaces / {b.n_zones} zones, {T} h, "
        f"engine={engine} mode={args.mode}",
        file=sys.stderr,
    )

    want_loads = bool(args.loads_csv) or (
        bool(args.summary_json) and b.has_ideal_hvac
    )
    if bool(args.loads_csv) and not b.has_ideal_hvac:
        print(
            "error: --loads-csv needs setpoint-driven HVAC (imported "
            "thermostats or IdealHeaterCooler setpoints)",
            file=sys.stderr,
        )
        return 2
    loads = None  # [T_steps, Z] mean ideal power, when collected
    want_fluxes = bool(args.fluxes_csv)
    if want_fluxes and engine != "kernel":
        print(
            "error: --fluxes-csv collects the per-hour h/q history inside "
            "the fused kernel; run with --engine kernel",
            file=sys.stderr,
        )
        return 2
    fluxes = None
    want_comfort = bool(getattr(args, "comfort_csv", None))
    want_op = bool(getattr(args, "operative_csv", None)) or want_comfort
    if want_op and engine != "kernel":
        which = "--comfort-csv" if want_comfort else "--operative-csv"
        print(
            f"error: {which} needs the per-hour operative temperature "
            "collected inside the fused kernel; run with --engine kernel",
            file=sys.stderr,
        )
        return 2
    operative = None

    if args.init_state:
        from heatx_torch.io.checkpoint import load_state

        st, step0 = load_state(
            args.init_state, dtype=b.config.dtype, building=b, device=device
        )
        print(
            f"# resumed state from {args.init_state} (step {step0})",
            file=sys.stderr,
        )
    else:
        st = tm.initial_state()
    t0 = time.time()
    if engine == "kernel":
        # Day-sized invocations need day-aligned segments: with a ground
        # series and a non-day-aligned --start-hour, soil-temperature
        # changes would land mid-chunk and run() rejects the series.
        day_ok = T % 24 == 0 and (ground_hourly is None or start % 24 == 0)
        hours = 24 if day_ok else 1
        fr = tm.fast_runner(
            block_size=args.block_size, mode=args.mode, hours=hours,
            substeps=None if args.mode == "parity" else args.substeps,
            scheduled_setpoints="heat_sp" in gain_kw,
            collect_fluxes=want_fluxes,
            collect_operative=want_op,
            refresh_every=args.refresh_every,
        )
        # Every series on the model's device in its dtype, converted once.
        def dev(v):
            return torch.as_tensor(
                np.asarray(v, np.float64), dtype=b.config.dtype, device=device
            )

        seq = tm.inputs(**inf_kw).replace(
            t_out=dev(dry),
            wind_speed=dev(wind),
            wind_direction=dev(wdir),
            sol_front=dev(sol_f),
            sol_back=dev(sol_b),
            ir_front=dev(ir_f),
            ir_back=dev(ir_b),
            **{k: dev(v) for k, v in gain_kw.items()},
        )
        if args.warmup_days:
            day, _ = _first_day(seq, T_steps, 24)
            g_day = ground_hourly[:24] if ground_hourly is not None else None
            st, reps = tm.warmup(
                st, day, max_repeats=args.warmup_days,
                run=lambda s: fr.run(
                    s, day, collect_zone_T=False, ground_hourly=g_day
                )[0],
            )
            print(f"# warm-up: {reps} first-day repeats", file=sys.stderr)
        try:
            out = fr.run(
                st, seq, ground_hourly=ground_hourly, collect_loads=want_loads,
                collect_fluxes=want_fluxes, collect_operative=want_op,
            )
        except FloatingPointError as e:
            # The kernel's per-chunk fail-fast check (the in-kernel NaN
            # guard): exit cleanly like the plain paths' post-run check.
            print(
                f"error: {e} (hours are run-relative; the run starts at "
                f"absolute hour {start})",
                file=sys.stderr,
            )
            return 1
        out = list(out)
        final, zt = out[:2]
        k = 2
        if want_fluxes:
            fluxes = out[k]
            k += 1
        if want_loads:
            loads = out[k]
            k += 1
        if want_op:
            operative = out[k]
    elif args.mode == "parity":
        seq = tm.inputs_sequence(
            T_steps, t_out=dry, wind_speed=wind, wind_direction=wdir,
            sol_front=sol_f, sol_back=sol_b, ir_front=ir_f, ir_back=ir_b,
            **inf_kw, **gain_kw,
        )
        if args.checked and want_loads:
            print(
                "# note: --checked does not collect loads; using the "
                "plain scan",
                file=sys.stderr,
            )
        if want_loads:
            run = lambda s, x: tm.run(s, x, collect_loads=True)  # noqa: E731
        else:
            run = tm.run_checked if args.checked else tm.run
        if args.warmup_days:
            if ground_hourly is not None:
                tm.set_ground_temperature(float(ground_hourly[0]))
            st, reps = tm.warmup(
                st, _first_day(seq, T_steps, 24 * n)[0],
                max_repeats=args.warmup_days,
            )
            print(f"# warm-up: {reps} first-day repeats", file=sys.stderr)
        if ground_hourly is None:
            final, hist_out = run(st, seq)
            zt, loads = hist_out if want_loads else (hist_out, None)
        else:
            # Month-chunked scans with a ground-temperature leaf swap
            # between chunks (at most a few distinct chunk lengths, so a
            # few compiles).
            bounds = (
                [0] + list(np.flatnonzero(np.diff(ground_hourly)) + 1) + [T]
            )
            state, hists, ldists = st, [], []
            seq_is_time = _time_leaf_mask(seq, T_steps)
            for lo, hi in zip(bounds[:-1], bounds[1:]):
                tm.set_ground_temperature(float(ground_hourly[lo]))
                sub = _slice_inputs(seq, slice(lo * n, hi * n), seq_is_time)
                state, h = run(state, sub)
                if want_loads:
                    h, ld = h
                    ldists.append(_host(ld))
                hists.append(_host(h))
            final, zt = state, np.concatenate(hists)
            loads = np.concatenate(ldists) if want_loads else None
    else:
        # Fast modes: loop the per-step march on the host, as heatx does
        # (ThermalModel.run(mode=...) is the same march step for step).
        seq = tm.inputs_sequence(
            T_steps, t_out=dry, wind_speed=wind, wind_direction=wdir,
            sol_front=sol_f, sol_back=sol_b, ir_front=ir_f, ir_back=ir_b,
            **inf_kw, **gain_kw,
        )
        if args.mode == "exp":
            march = tm.march_exp
        else:

            def march(state, step, substeps):
                return tm.march_imp(
                    state, step, substeps=substeps,
                    refresh_h=args.mode == "trbdf2_refresh",
                    refresh_every=args.refresh_every,
                )
        if args.warmup_days:
            day, day_is_time = _first_day(seq, T_steps, 24 * n)
            k = min(24 * n, T_steps)
            if ground_hourly is not None:
                tm.set_ground_temperature(float(ground_hourly[0]))

            def run_day(s):
                for t in range(k):
                    s = march(
                        s, _slice_inputs(day, t, day_is_time),
                        substeps=args.substeps,
                    )
                return s

            st, reps = tm.warmup(st, day, max_repeats=args.warmup_days,
                                 run=run_day)
            print(f"# warm-up: {reps} first-day repeats", file=sys.stderr)
        hist, ldist = [], []
        state = st
        seq_is_time = _time_leaf_mask(seq, T_steps)
        for t in range(T_steps):
            if ground_hourly is not None:
                hour = t // n
                if t == 0 or (
                    t % n == 0
                    and ground_hourly[hour] != ground_hourly[hour - 1]
                ):
                    tm.set_ground_temperature(float(ground_hourly[hour]))
            # Static fields (mix_vol etc.) carry no time axis; slice only
            # the [T, ...] ones.
            step = _slice_inputs(seq, t, seq_is_time)
            state = march(state, step, substeps=args.substeps)
            hist.append(state.zone_T)
            if want_loads:
                ldist.append(state.ideal_load)
        final, zt = state, torch.stack(hist)
        if want_loads:
            loads = torch.stack(ldist)
    # Each history off the device once (formatting a device tensor value by
    # value would wait on the device for every value).
    zt = _host(zt)
    loads = None if loads is None else _host(loads)
    if fluxes is not None:
        fluxes = {k: _host(v) for k, v in fluxes.items()}
    operative = None if operative is None else _host(operative)
    _sync(device)
    if n > 1:
        zt = zt[n - 1 :: n]  # end-of-hour samples for the hourly CSV
        if loads is not None:
            # Mean power within each hour (energy-preserving downsample).
            loads = np.asarray(loads).reshape(T, n, -1).mean(axis=1)
    wall = time.time() - t0
    print(f"# simulated {T} h in {wall:.2f} s", file=sys.stderr)

    if not np.isfinite(zt).all():
        bad = int(np.argmax(~np.isfinite(zt).all(axis=1)))
        print(
            f"error: non-finite zone temperature at hour {start + bad} "
            f"(run hour {bad})",
            file=sys.stderr,
        )
        return 1

    if args.save_state:
        from heatx_torch.io.checkpoint import save_state

        saved = save_state(args.save_state, final, step=start + T)
        print(f"# saved final state to {saved}", file=sys.stderr)

    znames = [sp.name for sp in model.spaces]
    if args.out:
        with open(args.out, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["hour"] + znames)
            for t in range(T):
                w.writerow([start + t] + [f"{v:.4f}" for v in zt[t]])
        print(f"# wrote {args.out}", file=sys.stderr)
    if fluxes is not None:
        # The reference's observable per-surface state channels
        # (surface_trait.rs:223-354): per-hour convection coefficient and
        # convective flow, front and back, one CSV per channel.
        snames = (
            [s.name for s in model.surfaces]
            + [f.name for f in model.fenestrations]
        )
        for chan, series in fluxes.items():
            path = f"{args.fluxes_csv}_{chan}.csv"
            series = np.asarray(series)
            with open(path, "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(["hour"] + snames)
                for t in range(T):
                    w.writerow([start + t] + [f"{v:.4f}" for v in series[t]])
        print(
            f"# wrote {args.fluxes_csv}_{{h,q}}_{{front,back}}.csv",
            file=sys.stderr,
        )
    if loads is not None:
        loads = np.asarray(loads)
        if args.loads_csv:
            with open(args.loads_csv, "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(["hour"] + znames)
                for t in range(T):
                    w.writerow([start + t] + [f"{v:.1f}" for v in loads[t]])
            print(f"# wrote {args.loads_csv}", file=sys.stderr)
        # Zone Multipliers (EnergyPlus Zone field 7): each zone is
        # simulated once; its contribution to BUILDING totals scales by
        # the multiplier.  Per-zone series/figures stay per-instance.
        zmult = (
            loaded0.multipliers()
            if loaded0 is not None
            else np.ones(len(znames))
        )
        mloads = loads * zmult[None, :]
        heat_kwh = mloads.clip(min=0).sum() / 1e3
        cool_kwh = (-mloads.clip(max=0)).sum() / 1e3
        mult_note = (
            "" if np.all(zmult == 1.0)
            else f", zone multipliers x{zmult.sum():g} instances"
        )
        print(
            f"demand: heating {heat_kwh:.1f} kWh  cooling {cool_kwh:.1f} kWh "
            f"({len(znames)} zones, {T} h{mult_note})"
        )
    if operative is not None:
        operative = np.asarray(operative)
        if args.operative_csv:
            with open(args.operative_csv, "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(["hour"] + znames)
                for t in range(T):
                    w.writerow(
                        [start + t] + [f"{v:.4f}" for v in operative[t]]
                    )
            print(f"# wrote {args.operative_csv}", file=sys.stderr)
        if want_comfort:
            # Fanger PMV/PPD (ISO 7730) per zone and hour: MRT from the
            # collected operative (op = (air + mrt)/2).  Default RH holds
            # the OUTDOOR vapor pressure at the zone temperature (RH% is
            # temperature-relative: 80% at 0 C outdoors is ~20% at 21 C
            # indoors) — --indoor-rh pins a constant instead (heatx does
            # not model indoor moisture sources).
            from heatx_torch.comfort import (
                indoor_rh_from_outdoor,
                zone_comfort_history,
            )

            ztc = np.asarray(zt, np.float64)[:T]
            mrt = 2.0 * operative[:T] - ztc
            if args.indoor_rh is not None:
                rh = float(args.indoor_rh)
            else:
                # The kernel engine runs hourly steps, so the already-
                # tiled weather series align with the zt grid.
                rh = indoor_rh_from_outdoor(
                    _rh[:T, None], dry[:T, None], ztc
                )
            pmv, ppd = zone_comfort_history(
                ztc, mrt, rh, met=args.met, clo=args.clo
            )
            with open(args.comfort_csv, "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(
                    ["hour"]
                    + [f"{z} PMV" for z in znames]
                    + [f"{z} PPD%" for z in znames]
                )
                for t in range(T):
                    w.writerow(
                        [start + t]
                        + [f"{v:.3f}" for v in pmv[t]]
                        + [f"{v:.1f}" for v in ppd[t]]
                    )
            print(f"# wrote {args.comfort_csv}", file=sys.stderr)
    for z, name in enumerate(znames):
        col = zt[:, z]
        print(
            f"{name}: min {col.min():.2f} C  mean {col.mean():.2f} C  "
            f"max {col.max():.2f} C"
        )
    if args.summary_json:
        import json

        summary = {
            "model": args.model,
            "epw": args.epw,
            "hours": T,
            "start_hour": start,
            "engine": engine,
            "mode": args.mode,
            "wall_clock_s": round(wall, 3),
            "zones": {
                name: {
                    "min_C": round(float(zt[:, z].min()), 4),
                    "mean_C": round(float(zt[:, z].mean()), 4),
                    "max_C": round(float(zt[:, z].max()), 4),
                }
                for z, name in enumerate(znames)
            },
        }
        if loads is not None:
            def kwh(x):
                return round(float(x) / 1e3, 3) + 0.0  # +0.0 kills -0.0

            # Building totals apply the Zone Multipliers (see the demand
            # print above); per-zone figures stay per-instance.  Peaks are
            # the coincident building-wide maxima (largest hourly sum of
            # the multiplied per-zone loads, heating and cooling separately
            # — not the single-zone peak).
            mloads_s = loads * zmult[None, :]
            summary["demand"] = {
                "heating_kwh": kwh(mloads_s.clip(min=0).sum()),
                "cooling_kwh": kwh(-mloads_s.clip(max=0).sum()),
                "peak_heating_w": round(
                    max(0.0, float(mloads_s.clip(min=0).sum(axis=1).max())), 1
                ),
                "peak_cooling_w": round(
                    max(0.0, float(-mloads_s.clip(max=0).sum(axis=1).min())), 1
                ),
                "per_zone_heating_kwh": {
                    name: kwh(loads[:, z].clip(min=0).sum())
                    for z, name in enumerate(znames)
                },
                "per_zone_cooling_kwh": {
                    name: kwh(-loads[:, z].clip(max=0).sum())
                    for z, name in enumerate(znames)
                },
            }
            if not np.all(zmult == 1.0):
                summary["demand"]["zone_multipliers"] = {
                    name: float(zmult[z])
                    for z, name in enumerate(znames)
                    if zmult[z] != 1.0
                }
            if T >= 2 * 24 and start % epw.n_hours == 0 and T <= epw.n_hours:
                # Whole-year-aligned runs within one weather year get a
                # calendar-month breakdown (partial trailing months report
                # what was simulated).  Leap Februaries come from the
                # EPW's own length, not the simulated horizon.
                month_days = [31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31]
                if epw.n_hours == 8784:
                    month_days[1] = 29
                edges = np.concatenate(
                    [[0], np.cumsum(np.array(month_days) * 24)]
                ).clip(max=T)
                mh, mc = [], []
                for lo, hi in zip(edges[:-1], edges[1:]):
                    if hi <= lo:
                        break
                    seg = mloads_s[lo:hi]
                    mh.append(kwh(seg.clip(min=0).sum()))
                    mc.append(kwh(-seg.clip(max=0).sum()))
                summary["demand"]["monthly_heating_kwh"] = mh
                summary["demand"]["monthly_cooling_kwh"] = mc
            # Unmet setpoint hours (zone-hours outside the setpoint +-0.5 K
            # throttling range, the ASHRAE 90.1 convention): nonzero only
            # when capacity limits (max_heating/max_cooling) bind — ideal
            # loads otherwise land exactly on the setpoint.
            Z = len(znames)
            hs = gain_kw.get("heat_sp")
            cs = gain_kw.get("cool_sp")
            if n > 1:
                # Scheduled setpoints were repeated onto the [T*n] sub-hourly
                # grid (hour-constant); sample them back to the hourly zt grid.
                hs = None if hs is None else np.asarray(hs)[n - 1 :: n]
                cs = None if cs is None else np.asarray(cs)[n - 1 :: n]
            hs = np.broadcast_to(
                np.asarray(b.ctl_heat_sp if hs is None else hs, np.float64),
                (T, Z),
            )
            cs = np.broadcast_to(
                np.asarray(b.ctl_cool_sp if cs is None else cs, np.float64),
                (T, Z),
            )
            ztc = np.asarray(zt, np.float64)
            unmet_h = (hs > -1e8) & (ztc < hs - 0.5)
            unmet_c = (cs < 1e8) & (ztc > cs + 0.5)
            summary["demand"]["unmet_heating_hours"] = int(unmet_h.sum())
            summary["demand"]["unmet_cooling_hours"] = int(unmet_c.sum())
        with open(args.summary_json, "w") as f:
            json.dump(summary, f, indent=1)
        print(f"# wrote {args.summary_json}", file=sys.stderr)
    return 0


def cmd_size(args) -> int:
    """Design-day sizing: peak heating/cooling ideal loads per zone."""
    device = _device(args)

    from heatx_torch import SimConfig
    from heatx_torch.sizing import design_day_loads, design_days_from_epw
    from heatx_torch.weather.epw import read_epw

    # Load the model without compiling (sizing builds its own ThermalModel
    # with unlimited ideal loads in every zone).
    loaded = None
    if args.model.lower().endswith(".idf"):
        from heatx_torch.model.idf import load_idf

        loaded = load_idf(args.model)
        model = loaded.model
        n = args.n if args.n is not None else loaded.timestep
    else:
        from heatx_torch.model.spl import load_spl

        model = load_spl(args.model)
        n = args.n if args.n is not None else 1
    epw = read_epw(args.epw)
    days = design_days_from_epw(epw)
    cfg = SimConfig(
        dtype=torch.float64 if args.f64 else torch.float32,
        interior_mrt=not args.air_bath,
    )

    Z = len(model.spaces)
    zidx = {sp.name: z for z, sp in enumerate(model.spaces)}
    size_mult = loaded.multipliers() if loaded is not None else np.ones(Z)
    inf_vol = np.zeros(Z)
    if loaded is not None:
        for src in (loaded.infiltration, loaded.ventilation):
            for zname, v in src.items():
                inf_vol[zidx[zname]] += v
    gains_max = {}
    if loaded is not None and args.gains:
        # Cooling days include internal gains at their scheduled annual
        # maximum (conservative); heating days exclude them (the ASHRAE
        # convention).  Setpoint schedules never override the sizing
        # thermostat.
        from heatx_torch.sizing import sizing_hvac_power

        ch = loaded.hourly_channels(8760)
        if "lum_power" in ch and np.asarray(ch["lum_power"]).size:
            gains_max["lum_power"] = np.asarray(ch["lum_power"]).max(axis=0)
        if "hvac_power" in ch and np.asarray(ch["hvac_power"]).size:
            # The channel is laid out for the model's hvac list; the sizing
            # copy removes thermostats and appends its own ideal-loads unit.
            gains_max["hvac_power"] = sizing_hvac_power(
                model, np.asarray(ch["hvac_power"]).max(axis=0)
            )

    if not 0.0 < args.coverage <= 100.0:
        print(f"error: --coverage must be in (0, 100], got {args.coverage}",
              file=sys.stderr)
        return 2
    out = {}
    if args.annual:
        # Sizing by simulation: the actual EPW year with unlimited ideal
        # loads (exact weather by construction — synthetic clear-sky
        # design days understate diffuse solar on glazing; see
        # heatx_torch.sizing.annual_peak_loads).  On the card the year runs
        # through the day kernel where the main steps are hourly, as
        # simulate's --engine auto picks it.
        from heatx_torch.sizing import annual_peak_loads

        engine = "kernel" if device.type == "cuda" and n == 1 else "xla"

        extra = {}
        if inf_vol.any():
            extra.update(
                inf_vol=inf_vol, inf_mask=inf_vol > 0.0,
                inf_temp=np.repeat(epw.dry_bulb[:, None], Z, axis=1),
            )
        if loaded is not None and args.gains:
            ch_y = loaded.hourly_channels(epw.n_hours)
            ch_y.pop("heat_sp", None)
            ch_y.pop("cool_sp", None)
            if "hvac_power" in ch_y:
                from heatx_torch.sizing import sizing_hvac_power

                ch_y["hvac_power"] = sizing_hvac_power(
                    model, ch_y["hvac_power"]
                )
            extra.update(ch_y)
        solar_scale = None
        if loaded is not None and loaded.shading:
            # No per-pane incident context here (annual_peak_loads
            # computes its own solar): OnIfHighSolarOnWindow rules warn
            # and run unshaded — conservative for the cooling peak.
            solar_scale = loaded.shading_series(
                epw.n_hours,
                dry_bulb=epw.dry_bulb,
                horizontal_solar=epw.global_horizontal,
            )
            print(
                f"# window shading: {len(loaded.shading)} rule(s) applied "
                "to the annual sizing",
                file=sys.stderr,
            )
        ann = annual_peak_loads(
            model, epw, heat_sp=args.heat_sp, cool_sp=args.cool_sp,
            coverage=args.coverage, n=n, config=cfg,
            extra_channels=extra or None, solar_scale=solar_scale,
            engine=engine, device=device,
        )
        print(ann.summary())
        out["annual"] = {
            "coverage_pct": ann.coverage,
            "warmup_days": ann.warmup_days,
            "peak_heating_W": {
                nm: round(float(ann.peak_heating_W[z]), 1)
                for z, nm in enumerate(ann.zone_names)
            },
            "peak_cooling_W": {
                nm: round(float(ann.peak_cooling_W[z]), 1)
                for z, nm in enumerate(ann.zone_names)
            },
            "abs_max_heating_W": {
                nm: round(float(ann.max_heating_W[z]), 1)
                for z, nm in enumerate(ann.zone_names)
            },
            "abs_max_cooling_W": {
                nm: round(float(ann.max_cooling_W[z]), 1)
                for z, nm in enumerate(ann.zone_names)
            },
            # Building totals apply the Zone Multipliers (per-zone peaks
            # stay per-instance, EnergyPlus semantics).
            "total_peak_heating_W": round(
                float((ann.peak_heating_W * size_mult).sum()), 1
            ),
            "total_peak_cooling_W": round(
                float((ann.peak_cooling_W * size_mult).sum()), 1
            ),
        }
    for season in ("winter", "summer"):
        if season not in days:
            print(f"# no {season} design conditions in the EPW header",
                  file=sys.stderr)
            continue
        day = days[season]
        extra = {}
        if inf_vol.any():
            # Outdoor air at the design rate, inlet at the design dry bulb
            # (full-on infiltration: conservative for both seasons).
            extra.update(
                inf_vol=inf_vol, inf_mask=inf_vol > 0.0,
                inf_temp=np.repeat(day.dry_bulb_profile[:, None], Z, axis=1),
            )
        if season == "summer":
            extra.update(gains_max)
        res = design_day_loads(
            model, day, heat_sp=args.heat_sp, cool_sp=args.cool_sp,
            epw=epw, n=n, config=cfg, extra_channels=extra or None,
            device=device,
        )
        print(res.summary())
        verb = "heating" if season == "winter" else "cooling"
        out[season] = {
            "design_db_C": day.db_max,
            "db_range_K": day.db_range,
            "wind_m_s": day.wind_speed,
            "warmup_days": res.warmup_days,
            f"peak_{verb}_W": {
                nm: round(float(res.peak_W[z]), 1)
                for z, nm in enumerate(res.zone_names)
            },
            # Building total applies the Zone Multipliers (per-zone peaks
            # stay per-instance, EnergyPlus semantics).
            f"total_peak_{verb}_W": round(
                float((res.peak_W * size_mult).sum()), 1
            ),
        }
    if args.sizing_json:
        import json

        with open(args.sizing_json, "w") as f:
            json.dump(out, f, indent=1)
        print(f"# wrote {args.sizing_json}", file=sys.stderr)
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m heatx_torch",
        description="building thermal simulation on the GPU (heatx's PyTorch/CUDA port)",
    )
    sub = ap.add_subparsers(dest="command", required=True)

    def common(p):
        p.add_argument(
            "model", help=".spl or EnergyPlus .idf building description"
        )
        p.add_argument(
            "--n", type=int, default=None,
            help="main steps per hour (default: the IDF's Timestep, else 1)",
        )
        p.add_argument("--f64", action="store_true", help="double precision")
        p.add_argument(
            "--platform", default=None, choices=("gpu", "cpu"),
            help="torch device: gpu (the card, the default) or cpu (the "
            "plain PyTorch versions)",
        )

    p = sub.add_parser("info", help="compile a model and print its discretization")
    common(p)
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser(
        "size",
        help="design-day sizing: peak heating/cooling loads per zone "
        "(ASHRAE 99.6%%/0.4%% design days from the EPW header)",
    )
    common(p)
    p.add_argument("epw", help="EPW weather file (DESIGN CONDITIONS header)")
    p.add_argument("--heat-sp", type=float, default=20.0,
                   help="heating setpoint C (default 20)")
    p.add_argument("--cool-sp", type=float, default=26.0,
                   help="cooling setpoint C (default 26)")
    p.add_argument(
        "--no-gains", dest="gains", action="store_false",
        help="exclude scheduled internal gains from the cooling day "
        "(default: included at their annual maximum)",
    )
    p.add_argument(
        "--air-bath", action="store_true",
        help="reference interior radiant semantics (zone-air bath) instead "
        "of the conserving Carroll MRT network",
    )
    p.add_argument(
        "--annual", action="store_true",
        help="also size by simulation: march the whole EPW year with "
        "unlimited ideal loads and report peak/percentile demand — exact "
        "weather, gain/weather coincidence and multi-day mass effects "
        "included (design days bound conservatively; this right-sizes)",
    )
    p.add_argument(
        "--coverage", type=float, default=99.6,
        help="--annual demand percentile to size at (default 99.6, the "
        "ASHRAE design-condition convention; 100 = absolute peak)",
    )
    p.add_argument("--sizing-json", default=None,
                   help="write the machine-readable sizing table")
    p.set_defaults(fn=cmd_size)

    p = sub.add_parser("simulate", help="march a model under an EPW weather file")
    common(p)
    p.add_argument("epw", help="EPW weather file")
    p.add_argument("-o", "--out", default=None, help="hourly zone-T CSV path")
    p.add_argument("--hours", type=int, default=None, help="default: EPW length")
    p.add_argument(
        "--mode", choices=("parity", "trbdf2", "trbdf2_refresh", "exp"),
        default="parity",
        help="integrator: reference-parity sub-steps or a fast mode "
        "(trbdf2_refresh re-evaluates film coefficients every sub-step: "
        "~6x the frozen-h accuracy at the same sub-step count)",
    )
    p.add_argument(
        "--engine", choices=("auto", "xla", "kernel"), default="auto",
        help="plain-PyTorch march (xla) or the CUDA day kernel (auto: "
        "kernel on the card)",
    )
    p.add_argument("--substeps", type=int, default=8, help="fast-mode sub-steps/h")
    p.add_argument(
        "--refresh-every", type=int, default=None,
        help="trbdf2_refresh hybrid cadence: rebuild film coefficients / "
        "stage factorizations every k sub-steps (default every sub-step; "
        "2 is the scored-bench headline setting — see PERF.md)",
    )
    p.add_argument(
        "--block-size", type=int, default=None,
        help="day-kernel surface lanes per block (default: the fewest that "
        "hold the largest zone-connected component; at most 256)",
    )
    p.add_argument(
        "--no-ground", dest="ground", action="store_false",
        help="hold ground boundaries at their compiled temperatures instead "
        "of the EPW's monthly soil series",
    )
    p.add_argument(
        "--ground-depth", type=float, default=None,
        help="EPW ground-temperature depth in m (default: deepest tabulated)",
    )
    p.add_argument("--no-solar", dest="solar", action="store_false",
                   help="skip the computed plane-of-array solar inputs")
    p.add_argument("--albedo", type=float, default=0.2)
    p.add_argument(
        "--sky", choices=("isotropic", "perez"), default="isotropic",
        help="diffuse transposition model for the computed solar inputs "
        "(perez = the EnergyPlus anisotropic sky)",
    )
    p.add_argument(
        "--ir-model", choices=("tilted", "horizontal"), default="tilted",
        help="incident longwave on outdoor faces: 'tilted' blends sky / "
        "air / ground by view factor like EnergyPlus's exterior LW model "
        "(default); 'horizontal' applies the EPW sky column to every tilt",
    )
    p.add_argument("--checked", action="store_true",
                   help="per-step finiteness guard (xla parity engine)")
    p.add_argument(
        "--warmup-days", type=int, default=0, metavar="N",
        help="EnergyPlus-style warm-up: repeat the first simulated day until "
        "zone/node temperatures converge day-over-day (< 0.01 K), up to N "
        "repeats, before marching the reported horizon (cures the 22 C "
        "initialization transient; EnergyPlus's own cap is 25).  Warm-up "
        "time is included in the reported wall clock",
    )
    p.add_argument(
        "--interior-mrt", action="store_true",
        help="interior longwave exchange between each zone's surfaces via "
        "Carroll's MRT network instead of the zone-air radiant bath "
        "(conservative)",
    )
    p.add_argument(
        "--loads-csv", default=None,
        help="also write the hourly per-zone ideal-load demand (W, "
        "heating +) — requires thermostats (imported or modeled)",
    )
    p.add_argument(
        "--operative-csv", default=None,
        help="also write the hourly per-zone operative temperature "
        "(T_air + T_mrt)/2 with the Carroll zone MRT solved in-kernel "
        "(kernel engine)",
    )
    p.add_argument(
        "--comfort-csv", default=None,
        help="also write hourly per-zone Fanger PMV/PPD (ISO 7730) from "
        "the in-kernel operative history (kernel engine); RH from the EPW "
        "unless --indoor-rh",
    )
    p.add_argument("--met", type=float, default=1.2,
                   help="metabolic rate for --comfort-csv (met)")
    p.add_argument("--clo", type=float, default=0.5,
                   help="clothing insulation for --comfort-csv (clo)")
    p.add_argument(
        "--indoor-rh", type=float, default=None,
        help="constant indoor relative humidity %% for --comfort-csv "
        "(default: the EPW's outdoor column)",
    )
    p.add_argument(
        "--summary-json", default=None,
        help="write a machine-readable run summary (per-zone temperature "
        "stats; heating/cooling kWh, peaks, per-zone split and unmet "
        "setpoint hours when --loads-csv collection runs)",
    )
    p.add_argument(
        "--fluxes-csv", default=None, metavar="PREFIX",
        help="write the per-hour per-surface convection coefficients and "
        "convective flows (PREFIX_{h,q}_{front,back}.csv; kernel engine — "
        "the history is collected inside the fused kernel)",
    )
    p.add_argument(
        "--start-hour", type=int, default=None,
        help="year hour to start at (weather/solar/schedules/soil offset; "
        "pairs with --init-state for segmented runs; default: the IDF's "
        "RunPeriod begin date, else 0 — pass 0 explicitly to force Jan 1)",
    )
    p.add_argument(
        "--init-state", default=None,
        help="resume from a saved state checkpoint (.npz, see --save-state)",
    )
    p.add_argument(
        "--save-state", default=None,
        help="write the final simulation state to this .npz checkpoint",
    )
    p.add_argument(
        "--nomass-iters", type=int, default=None,
        help="fix the no-mass solve at N relaxed iterations "
        "(required for the parity kernel engine; replay-validated at 1-2)",
    )
    p.set_defaults(fn=cmd_simulate)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

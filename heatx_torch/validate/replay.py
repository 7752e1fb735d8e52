"""EnergyPlus fixture replay harness.

PyTorch counterpart of ``heatx.validate.replay`` (the reference's
``march_model`` validation harness, tests/validate_wall_heat_transfer.rs:
615-750): replay EnergyPlus's own boundary conditions (site wind, incident
solar, outdoor dry-bulb, and the logged net IR gain converted back to
incident IR irradiance via ``gain/(A*eps) + sigma*T_s^4``) through the
wall+zone solver, and compare the resulting zone temperature series after a
5000-step warm-up skip.

heatx runs the replay as one ``lax.scan``; here it is a loop of main steps
on the model's device, and the IR back-conversion reads the front node from
the marching state.  The main-step integrator is the reference-parity
``engine.step.march`` unless ``march_fn`` replaces it: a
``(building, state, inputs) -> state`` function of the XLA path, or a
one-hour ``FastRunner(...).march`` (the day march, one launch a step).
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from heatx_torch.config import SimConfig
from heatx_torch.constants import SIGMA
from heatx_torch.engine import step as step_mod
from heatx_torch.engine import surface as surf_mod
from heatx_torch.io.eplus import EPlusWallRun, read_eplusout
from heatx_torch.model.spl import load_spl
from heatx_torch.testing import SingleZoneOptions, TestMat, single_zone_building


def _runner_march(march_fn):
    """The FastRunner whose bound ``march`` ``march_fn`` is, or None."""
    from heatx_torch.api import FastRunner

    owner = getattr(march_fn, "__self__", None)
    return owner if isinstance(owner, FastRunner) else None


def _pinned(building, h_in=None, h_out=None):
    """The device building with the fixed film coefficients of the step."""
    sb = building.surfaces
    upd = {}
    S = building.n_surfaces
    if h_in is not None:  # inside film = the back (space-facing) face
        upd["fixed_h_back"] = h_in.expand(S)
    if h_out is not None:
        upd["fixed_h_front"] = h_out.expand(S)
    return SimpleNamespace(**{**vars(building), "surfaces": SimpleNamespace(**{**vars(sb), **upd})})


def replay_wall_run(
    tm,
    run: EPlusWallRun,
    emissivity: float,
    surface_area: float,
    warmup: int = 5000,
    march_fn=None,
    pin_h_inside: bool = False,
    pin_h_outside: bool = False,
    passes: int = 1,
    collect_channels: bool = False,
):
    """March the compiled model (a ``heatx_torch.ThermalModel``) through the
    fixture's boundary conditions (heatx ``replay_wall_run``).

    Returns ``(expected, found)`` zone-temperature series with the first
    ``warmup`` steps skipped, exactly like the reference
    (validate_wall_heat_transfer.rs:662-709).  ``march_fn`` overrides the
    main-step integrator (see the module docstring).  ``pin_h_inside`` /
    ``pin_h_outside`` drive the inside (back) / outside (front) film
    coefficient from the fixture's logged per-step h series instead of the
    TARP evaluation (the XLA path only: a runner's blocked operands hold the
    building's own).  ``passes`` replays the series that many times back to
    back and scores the LAST pass.  ``collect_channels`` returns a dict of
    (ours, energyplus) series pairs of every channel the fixture logs (zone
    T, outside/inside face temperatures, h out/in)."""
    runner = _runner_march(march_fn)
    if runner is not None and (pin_h_inside or pin_h_outside):
        raise ValueError("pinned film coefficients need an XLA-path march_fn (the day march's "
                         "blocked operands hold the building's own)")
    building = tm._device()
    dtype, device = building.dtype, building.device
    S = building.n_surfaces
    if march_fn is None:
        statics = surf_mod.compute_statics(building.surfaces)
        mrt_static = (surf_mod.mrt_statics(building.surfaces, building.n_zones)
                      if building.config.interior_mrt else None)

        def march_fn(b, state, inputs):
            return step_mod.march(b, state, inputs, mrt_static=mrt_static,
                                  statics=None if b is not building else statics)

    state = tm.initial_state()
    state.zone_T = torch.full_like(state.zone_T, float(run.zone_air_temp[0]))
    base = tm.inputs()
    nan_s = np.full(run.n_steps, np.nan)

    def series(v):
        return torch.as_tensor(np.tile(np.asarray(v, np.float64), passes), dtype=dtype, device=device)

    t_out, ws, wd, sol, gain = (series(v) for v in (
        run.outdoor_temp, run.site_wind_speed, np.radians(run.site_wind_direction),
        run.incident_solar, run.outdoor_thermal_gain))
    h_in = series(run.hs_inside if pin_h_inside else nan_s)
    h_out = series(run.hs_outside if pin_h_outside else nan_s)
    use_ir = emissivity > 1e-3
    zero_ir = torch.zeros((S,), dtype=dtype, device=device)
    rows = []
    for i in range(t_out.shape[0]):
        ts = state.node_T[0]
        ir = gain[i] / (surface_area * emissivity) + SIGMA * (ts + 273.15) ** 4 if use_ir else zero_ir
        inputs = base.replace(t_out=t_out[i], wind_speed=ws[i], wind_direction=wd[i],
                              sol_front=sol[i].expand(S), ir_front=ir)
        # Record the state *before* this march, like the reference.
        row = [state.zone_T[0]]
        if collect_channels:
            row += [state.node_T[0, 0], surf_mod._last_node(building.surfaces, state.node_T)[0],
                    state.h_front[0], state.h_back[0]]
        rows.append(torch.stack(row))
        if runner is not None:
            state = march_fn(state, inputs)
        else:
            b = building
            if pin_h_inside or pin_h_outside:
                b = _pinned(building, h_in[i] if pin_h_inside else None,
                            h_out[i] if pin_h_outside else None)
            state = march_fn(b, state, inputs)
    found = torch.stack(rows).cpu().numpy()

    def last_pass(a):
        # Score the LAST replayed pass, skipping the warm-up steps
        # (i > warmup strict, matching validate_wall_heat_transfer.rs:669).
        return a[-run.n_steps:][warmup + 1:]

    if collect_channels:
        sl = slice(warmup + 1, None)
        return {
            "zone_T": (last_pass(found[:, 0]), run.zone_air_temp[sl]),
            "outside_face_T": (last_pass(found[:, 1]), run.outside_surface_temp[sl]),
            "inside_face_T": (last_pass(found[:, 2]), run.inside_surface_temp[sl]),
            "h_outside": (last_pass(found[:, 3]), run.hs_outside[sl]),
            "h_inside": (last_pass(found[:, 4]), run.hs_inside[sl]),
        }
    return run.zone_air_temp[warmup + 1:], last_pass(found[:, 0])


def replay_wall_channels(tm, run: EPlusWallRun, emissivity: float, surface_area: float,
                         warmup: int = 5000, **kw):
    """Channel-localizing replay: :func:`replay_wall_run` with
    ``collect_channels=True`` (extra keywords pass through)."""
    return replay_wall_run(tm, run, emissivity, surface_area, warmup=warmup,
                           collect_channels=True, **kw)


# ---------------------------------------------------------------------------
# The 13 fixture cases (validate_wall_heat_transfer.rs:817-994)
# ---------------------------------------------------------------------------


@dataclass
class WallCase:
    name: str  # fixture directory
    emissivity: float
    solar_abs: float
    construction: Optional[List[TestMat]] = None  # None -> .spl model
    spl_file: str = "back"
    surface_area: float = 60.0


CONCRETE = [TestMat.concrete(0.2)]
MIXED = [TestMat.polyurethane(0.02), TestMat.concrete(0.2), TestMat.polyurethane(0.02)]
NOMASS = [TestMat.polyurethane(0.02)]

WALL_CASES: Dict[str, WallCase] = {
    c.name: c
    for c in [
        WallCase("massive_full", 0.9, 0.7, CONCRETE),
        WallCase("massive_no_ir_no_solar", 0.0, 0.0, CONCRETE),
        WallCase("massive_no_ir_yes_solar", 0.0, 0.7, CONCRETE),
        WallCase("massive_yes_ir_no_solar", 0.9, 0.0, CONCRETE),
        WallCase("mixed_full", 0.9, 0.7, MIXED),
        WallCase("mixed_no_ir_no_solar", 0.0, 0.0, MIXED),
        WallCase("mixed_no_ir_yes_solar", 0.0, 0.7, MIXED),
        WallCase("mixed_yes_ir_no_solar", 0.9, 0.0, MIXED),
        WallCase("nomass_full", 0.9, 0.7, NOMASS),
        WallCase("nomass_no_ir_no_solar", 0.0, 0.0, NOMASS),
        WallCase("nomass_no_ir_yes_solar", 0.0, 0.7, NOMASS),
        WallCase("nomass_yes_ir_no_solar", 0.9, 0.0, NOMASS),
        WallCase("tilted", 0.9, 0.7, None),
        WallCase("horizontal", 0.9, 0.7, None),
    ]
}


def build_case_model(case: WallCase, fixtures_root: str, via_idf: bool = False):
    """The fixture's model (heatx ``build_case_model``): the hand-authored
    single-zone box, the fixture's ``.spl`` model, or with ``via_idf`` its
    own ``in.idf``."""
    if via_idf:
        from heatx_torch.model.idf import load_idf

        return load_idf(f"{fixtures_root}/{case.name}/in.idf").model
    if case.construction is not None:
        opts = SingleZoneOptions(
            zone_volume=600.0,
            surface_height=3.0,
            surface_width=20.0,
            construction=case.construction,
            emissivity=case.emissivity,
            solar_absorbtance=case.solar_abs,
        )
        return single_zone_building(opts)
    return load_spl(f"{fixtures_root}/{case.name}/{case.spl_file}.spl")


def run_case(
    case: WallCase,
    fixtures_root: str,
    n: int = 20,
    dtype=torch.float64,
    march_fn=None,
    nomass_fixed_iters: Optional[int] = None,
    pin_h_inside: bool = False,
    pin_h_outside: bool = False,
    passes: int = 1,
    via_idf: bool = False,
    device="cuda",
):
    """Compile and replay one fixture case on ``device`` (heatx
    ``run_case``); returns ``(expected, found)``.  ``nomass_fixed_iters``
    None runs the reference-exact adaptive no-mass loop."""
    from heatx_torch.api import ThermalModel

    model = build_case_model(case, fixtures_root, via_idf=via_idf)
    tm = ThermalModel(model, n=n, config=SimConfig(dtype=dtype, nomass_fixed_iters=nomass_fixed_iters),
                      device=device)
    # "in models like these — a single surface — EnergyPlus assumes zero IR
    # radiation indoors" (validate_wall_heat_transfer.rs:629-630)
    tm.building.surfaces.eps_back[:] = 0.0
    tm.invalidate()
    run = read_eplusout(f"{fixtures_root}/{case.name}/eplusout.csv")
    return replay_wall_run(
        tm, run, case.emissivity, case.surface_area, march_fn=march_fn,
        pin_h_inside=pin_h_inside, pin_h_outside=pin_h_outside, passes=passes,
    )

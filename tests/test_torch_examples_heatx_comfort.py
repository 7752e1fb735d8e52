"""examples_torch/comfort.py and passive_controls.py against heatx, f64,
CPU, at their smoke sizes (48 h), on ``testing.write_synthetic_epw``'s
weather (seed 0), the models built from the same numbers in both packages.

* ``comfort``: each office's warm-up (repeat count), zone air and operative
  temperature on the example's route (the day march with the MRT network and
  the operative history, its plain version here) against heatx's
  ``ThermalModel.warmup``/``run(mode="trbdf2", substeps=8,
  collect_operative=True)``, 1e-9 K; the PMV/PPD of
  ``heatx_torch.comfort.zone_comfort_history`` against heatx's on the same
  histories, 1e-9.
* ``passive_controls``: both rooms (free-running; shading and ventilation
  gates) on both of the example's routes (``ThermalModel.run``, the CPU's;
  the day march, the card's) against heatx's ``ThermalModel.run(mode=
  "trbdf2", substeps=8)``, 1e-9 K, with the weekly-mean and overheating
  numbers the example prints.
"""

import numpy as np
import pytest
import torch
from torch_examples_ref import CPU, example, hx_model

import heatx
from heatx.comfort import zone_comfort_history as hx_comfort_history
from heatx.weather.epw import read_epw as hx_read_epw
from heatx.weather.solar import surface_irradiance as hx_irradiance
from heatx.weather.solar import surface_longwave as hx_longwave
from heatx_torch import SimConfig, testing
from heatx_torch.comfort import zone_comfort_history
from heatx_torch.weather.epw import read_epw

torch.set_num_threads(1)

HOURS = 48
ATOL_K = 1e-9


@pytest.fixture(scope="module")
def epw_path(tmp_path_factory):
    return testing.write_synthetic_epw(tmp_path_factory.mktemp("weather") / "santiago.epw", seed=0)


@pytest.mark.parametrize("kind", ["igu", "single"])
def test_comfort_matches_heatx(kind, epw_path):
    cf = example("comfort")
    dry, wind, ir, synthetic = cf.week(epw_path, HOURS)
    assert not synthetic
    cfg = SimConfig(dtype=torch.float64, interior_mrt=True, nomass_fixed_iters=1)
    zt, top, reps, _ = cf.run_office(kind, dry, wind, ir, CPU, config=cfg)

    htm = hx_model(cf.office, kind, config=heatx.SimConfig(dtype=np.float64, interior_mrt=True,
                                                           nomass_fixed_iters=1))
    seq = htm.inputs_sequence(HOURS, t_out=dry, wind_speed=wind, ir_front=ir)
    day = htm.inputs_sequence(24, t_out=dry[:24], wind_speed=wind[:24], ir_front=ir[:24])
    st, hreps = htm.warmup(htm.initial_state(), day, run=lambda s: htm.run(
        s, day, collect_zone_T=False, mode="trbdf2", substeps=8)[0])
    _, (hzt, htop) = htm.run(st, seq, mode="trbdf2", substeps=8, collect_operative=True)
    hzt, htop = np.asarray(hzt)[:, 0], np.asarray(htop)[:, 0]
    assert reps == hreps
    np.testing.assert_allclose(zt, hzt, rtol=0, atol=ATOL_K)
    np.testing.assert_allclose(top, htop, rtol=0, atol=ATOL_K)
    pmv, ppd = zone_comfort_history(zt, 2.0 * top - zt, 40.0, met=1.2, clo=1.0)
    hpmv, hppd = hx_comfort_history(hzt, 2.0 * htop - hzt, 40.0, met=1.2, clo=1.0)
    np.testing.assert_allclose(pmv, np.asarray(hpmv), rtol=0, atol=1e-9)
    np.testing.assert_allclose(ppd, np.asarray(hppd), rtol=0, atol=1e-9)


def test_passive_controls_match_heatx(epw_path):
    pc = example("passive_controls")
    epw, hepw = read_epw(epw_path), hx_read_epw(epw_path)
    start, sl = pc.START, slice(pc.START, pc.START + HOURS)
    got = {}
    for name in ("free", "controlled"):
        controlled = name == "controlled"
        zx, _ = pc.week(name, epw, HOURS, CPU, engine="xla")
        zk, _ = pc.week(name, epw, HOURS, CPU, engine="kernel")
        htm = hx_model(pc.room, controlled)
        b = htm.building
        dry = np.asarray(hepw.dry_bulb[sl])
        hseq = htm.inputs_sequence(
            HOURS, t_out=dry, wind_speed=np.asarray(hepw.wind_speed[sl]),
            wind_direction=np.asarray(hepw.wind_direction_deg[sl]),
            sol_front=hx_irradiance(hepw, b, start_hour=start, hours=HOURS, sky="perez"),
            ir_front=hx_longwave(hepw, b, start_hour=start, hours=HOURS),
            vent_vol=np.full(1, 0.12 if controlled else 0.0), vent_temp=dry[:, None],
            vent_mask=np.full(1, controlled), inf_vol=np.full(1, 0.01), inf_temp=dry[:, None],
            inf_mask=np.ones(1, bool),
        )
        _, hz = htm.run(htm.initial_state(), hseq, mode="trbdf2", substeps=8)
        hz = np.asarray(hz)[:, 0]
        np.testing.assert_allclose(zx, hz, rtol=0, atol=ATOL_K, err_msg=f"{name}, ThermalModel.run")
        np.testing.assert_allclose(zk, hz, rtol=0, atol=ATOL_K, err_msg=f"{name}, the day march")
        got[name] = hz
    # The controls act: shading and the night vent take the mean down.
    assert got["free"].mean() - got["controlled"].mean() > 0

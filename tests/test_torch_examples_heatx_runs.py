"""examples_torch/annual_city.py and annual_demand.py against heatx, f64,
CPU, at their smoke sizes (4 zones, 48 h), the models built from the same
numbers in both packages (the district through the example's builder with
heatx's classes; the bench city through bench.py's ``build_city_model``).

* ``annual_city``: the example's model and inputs through the day march (the
  example's route; its plain version here) against heatx's
  ``ThermalModel.run(mode="trbdf2", substeps=8)`` on the same hourly
  weather, 1e-9 K.  The example interpolates the weather to the sub-steps
  (``interp_weather=True``), which heatx's XLA path has no counterpart for:
  that run is held to the port's own plain runner instead (the example's
  checkpoint equals ``FastRunner.run(interp_weather=True)``'s final state),
  and heatx's ``load_state`` reads the checkpoint the example saves.
* ``annual_demand``: the thermostat city's zone temperatures (1e-9 K) and
  hourly ideal loads (1e-9 of the largest) through the day march against
  heatx's ``ThermalModel.run(mode="trbdf2", substeps=8, collect_loads=True)``.
"""

import numpy as np
import torch
from torch_examples_ref import CPU, example, hx_model

import bench
import heatx
from heatx.io.checkpoint import load_state as hx_load_state
from heatx_torch import SimConfig, ThermalModel

torch.set_num_threads(1)

ZONES, HOURS = 4, 48
ATOL_K = 1e-9
F64 = SimConfig(dtype=torch.float64)


def test_annual_city_matches_heatx(tmp_path, monkeypatch, capsys):
    ac = example("annual_city")
    tm = ThermalModel(ac.build_district(ZONES), config=F64, device=CPU)
    seq = ac.inputs(tm, HOURS, "")
    runner = tm.fast_runner(mode="trbdf2", substeps=8, hours=24)
    _, zt = runner.run(tm.initial_state(), seq)

    htm = hx_model(ac.build_district, ZONES, config=heatx.SimConfig(dtype=np.float64))
    b = htm.building
    dry, wind, wdir, ghi, ir = ac.weather(HOURS, "")
    S = b.n_surfaces
    factor = np.random.default_rng(0).uniform(0.2, 1.0, S)
    hseq = htm.inputs_sequence(HOURS, t_out=dry, wind_speed=wind, wind_direction=wdir,
                               sol_front=ghi[:, None] * factor[None], ir_front=np.repeat(ir[:, None], S, axis=1),
                               hvac_power=np.full((HOURS, b.n_hvacs), 400.0),
                               lum_power=np.full((HOURS, b.n_luminaires), 120.0))
    _, hzt = htm.run(htm.initial_state(), hseq, mode="trbdf2", substeps=8)
    np.testing.assert_allclose(zt.numpy(), np.asarray(hzt), rtol=0, atol=ATOL_K)

    # The example itself (f32, the weather interpolated to the sub-steps)
    # against the port's plain runner on the same model, and its checkpoint
    # read back by heatx.
    monkeypatch.setenv("HEATX_EXAMPLE_FAST", "1")
    out = tmp_path / "city.npz"
    ac.main(["--platform", "cpu", "--out", str(out)])
    assert f"checkpoint saved to {out}" in capsys.readouterr().out
    tm32 = ThermalModel(ac.build_district(ZONES), device=CPU)
    final, _ = tm32.fast_runner(mode="trbdf2", substeps=8, hours=24).run(
        tm32.initial_state(), ac.inputs(tm32, HOURS, ""), interp_weather=True)
    state, step = hx_load_state(str(out))
    assert step == 0
    np.testing.assert_array_equal(np.asarray(state.zone_T), final.zone_T.numpy())
    np.testing.assert_array_equal(np.asarray(state.node_T), final.node_T.numpy())


def test_annual_demand_matches_heatx():
    ad = example("annual_demand")
    tm = ThermalModel(ad.build(ZONES), config=SimConfig(dtype=torch.float64, nomass_fixed_iters=1), device=CPU)
    seq = ad.inputs(tm, HOURS, "")
    _, zt, loads = tm.fast_runner(mode="trbdf2", substeps=8, hours=24).run(
        tm.initial_state(), seq, collect_loads=True)

    htm = hx_model(ad.build, ZONES, city=bench.build_city_model)
    b = htm.building
    dry, wind, wdir, ghi, ir = bench.load_weather(HOURS)
    sol = ghi[:, None] * np.random.default_rng(0).uniform(0.2, 1.0, b.n_surfaces)[None, :]
    hseq = htm.inputs_sequence(HOURS, t_out=dry, wind_speed=wind, wind_direction=wdir, sol_front=sol,
                               ir_front=ir, lum_power=np.full(b.n_luminaires, 150.0))
    _, (hzt, hld) = htm.run(htm.initial_state(), hseq, mode="trbdf2", substeps=8, collect_loads=True)
    np.testing.assert_allclose(zt.numpy(), np.asarray(hzt), rtol=0, atol=ATOL_K)
    scale = float(np.abs(np.asarray(hld)).max())
    assert scale > 0
    np.testing.assert_allclose(loads.numpy(), np.asarray(hld), rtol=0, atol=1e-9 * scale)

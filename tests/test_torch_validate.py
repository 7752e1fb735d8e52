"""The port's validation harness (``heatx_torch.io.eplus``,
``heatx_torch.validate``) against heatx's, f64, CPU, on synthetic inputs:
the EnergyPlus fixtures and the Santiago EPW are not in the repository
(tests/conftest.py), so no replay here is compared with EnergyPlus itself.

* ``read_eplusout`` on a seeded synthetic ``eplusout.csv``: equal arrays;
* ``SeriesValidation.metrics``/``passes`` and the rendered HTML of a
  ``Validator`` report: equal to heatx's;
* ``replay_wall_run`` on a seeded synthetic ``EPlusWallRun`` of 300
  three-minute steps (the fixtures' ``n = 20``), the mixed wall with its
  no-mass skins: within 1e-9 K of heatx's, plain, with the inside film
  pinned and by channel; and through the port's one-hour
  ``FastRunner(...).march`` (the parity day march, one launch a step);
* ``fixture_anomaly_sun`` and ``weather_model_inputs`` on a
  ``testing.write_synthetic_epw`` year: equal to heatx's to round-off;
* ``run_case`` without fixtures fails as heatx's does.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heatx
from heatx.io import eplus as hx_eplus
from heatx.validate import Validator as HxValidator
from heatx.validate import SeriesValidation as HxSeries
from heatx.validate import endtoend as hx_e2e
from heatx.validate import replay as hx_replay
from heatx.weather import epw as hx_epw
from heatx_torch import SimConfig, ThermalModel, testing
from heatx_torch.io import eplus
from heatx_torch.validate import SeriesValidation, Validator, endtoend, replay
from heatx_torch.weather import epw

torch.set_num_threads(1)

STEPS = 300
WARMUP = 40


def _synthetic_run(rng, n=STEPS) -> np.ndarray:
    """[n, 12] columns of a plausible three-minute EnergyPlus log."""
    t = np.arange(n) / 20.0
    cols = [
        3.0 + rng.uniform(0, 2, n),  # site wind speed
        rng.uniform(0, 360, n),  # site wind direction
        np.maximum(0.0, 500.0 * np.sin(2 * np.pi * (t - 6) / 24)) + rng.uniform(0, 20, n),
        20.0 + rng.normal(0, 0.5, n),  # inside face T
        8.0 + rng.normal(0, 1, n),  # outside face T
        2.0 + rng.uniform(0, 1, n),  # h inside
        rng.normal(0, 10, n),  # indoor gain
        6.0 + 5.0 * np.sin(2 * np.pi * t / 24) + rng.normal(0, 0.2, n),  # outdoor T
        4.0 + rng.uniform(0, 1, n),  # surface wind
        10.0 + rng.uniform(0, 5, n),  # h outside
        -300.0 + rng.normal(0, 50, n),  # outdoor net IR gain
        20.0 + rng.normal(0, 0.3, n),  # zone air T
    ]
    return np.stack(cols, 1)


@pytest.fixture(scope="module")
def csv_run(tmp_path_factory):
    data = _synthetic_run(np.random.default_rng(3))
    path = tmp_path_factory.mktemp("eplus") / "eplusout.csv"
    lines = ["Date/Time," + ",".join(f"col{i}" for i in range(1, 13))]
    lines += [f" 01/01  00:{i % 60:02d}:00," + ",".join(repr(float(v)) for v in row)
              for i, row in enumerate(data)]
    path.write_text("\n".join(lines) + "\n")
    return str(path), data


def test_read_eplusout_matches_heatx(csv_run):
    path, data = csv_run
    got, ref = eplus.read_eplusout(path), hx_eplus.read_eplusout(path)
    assert got.n_steps == ref.n_steps == STEPS
    for f in dataclasses.fields(ref):
        np.testing.assert_array_equal(getattr(got, f.name), getattr(ref, f.name))
    np.testing.assert_array_equal(got.zone_air_temp, data[:, 11])


def test_series_validation_and_report_match_heatx(tmp_path):
    rng = np.random.default_rng(5)
    exp = 20.0 + np.cumsum(rng.normal(0, 0.1, 500))
    cases = [("close", exp + rng.normal(0, 0.01, 500)), ("biased", exp + 1.5),
             ("short", exp[:300] * 1.01)]
    docs = []
    for cls_s, cls_v, name in ((HxSeries, HxValidator, "ref"), (SeriesValidation, Validator, "got")):
        v = cls_v("synthetic walls", target_file=str(tmp_path / f"{name}.html"))
        for title, found in cases:
            v.push(cls_s(title, exp, found, y_label="zone T", y_units="C"))
        assert v.validate(raise_on_fail=False) is False
        docs.append(((tmp_path / f"{name}.html").read_text(),
                     [(s.metrics(), s.passes(), s.to_html()) for s in v.validations]))
    assert docs[0] == docs[1]
    with pytest.raises(AssertionError, match="biased"):
        Validator("x", validations=[SeriesValidation("biased", exp, exp + 1.5)]).validate()


def _models(case):
    cfg = dict(nomass_fixed_iters=2)
    hx_tm = heatx.ThermalModel(hx_replay.build_case_model(case, "/nonexistent"), n=20,
                               config=heatx.SimConfig(dtype=jnp.float64, **cfg))
    tm = ThermalModel(replay.build_case_model(case, "/nonexistent"), n=20,
                      config=SimConfig(dtype=torch.float64, **cfg), device="cpu")
    hx_tm.building.surfaces.eps_back[:] = 0.0
    tm.building.surfaces.eps_back[:] = 0.0
    tm.invalidate()
    return hx_tm, tm


@pytest.fixture(scope="module")
def replay_case(csv_run):
    case = replay.WALL_CASES["mixed_full"]
    hx_tm, tm = _models(case)
    run_h, run_p = hx_eplus.read_eplusout(csv_run[0]), eplus.read_eplusout(csv_run[0])
    return case, hx_tm, tm, run_h, run_p


@pytest.mark.parametrize("pin", [False, True])
def test_replay_matches_heatx(replay_case, pin):
    case, hx_tm, tm, run_h, run_p = replay_case
    assert tm.dt_subdivisions == hx_tm.dt_subdivisions
    kw = dict(warmup=WARMUP, pin_h_inside=pin)
    exp_r, ref = hx_replay.replay_wall_run(hx_tm, run_h, case.emissivity, case.surface_area, **kw)
    exp_g, got = replay.replay_wall_run(tm, run_p, case.emissivity, case.surface_area, **kw)
    assert got.shape == (STEPS - WARMUP - 1,)
    np.testing.assert_array_equal(exp_g, exp_r)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9)
    assert np.ptp(got) > 0.1


def test_replay_channels_and_day_march_match_heatx(replay_case):
    case, hx_tm, tm, run_h, run_p = replay_case
    ref = hx_replay.replay_wall_channels(hx_tm, run_h, case.emissivity, case.surface_area, warmup=WARMUP)
    got = replay.replay_wall_channels(tm, run_p, case.emissivity, case.surface_area, warmup=WARMUP)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k][0], np.asarray(ref[k][0]), rtol=0, atol=1e-9, err_msg=k)
        np.testing.assert_array_equal(got[k][1], ref[k][1])
    runner = tm.fast_runner(mode="parity", hours=1)
    _, fast = replay.replay_wall_run(tm, run_p, case.emissivity, case.surface_area, warmup=WARMUP,
                                     march_fn=runner.march)
    np.testing.assert_allclose(fast, np.asarray(ref["zone_T"][0]), rtol=0, atol=1e-9)
    with pytest.raises(ValueError, match="pinned film"):
        replay.replay_wall_run(tm, run_p, case.emissivity, case.surface_area, march_fn=runner.march,
                               pin_h_inside=True)


def test_weather_model_inputs_match_heatx(tmp_path):
    path = testing.write_synthetic_epw(tmp_path / "year.epw", seed=2)
    hw, pw = hx_epw.read_epw(path), epw.read_epw(path)
    case = replay.WALL_CASES["massive_full"]
    hx_tm, tm = _models(case)
    np.testing.assert_allclose(np.stack(endtoend.fixture_anomaly_sun(pw, 20, endtoend.HOURS)),
                               np.stack(hx_e2e.fixture_anomaly_sun(hw, 20, hx_e2e.HOURS)), rtol=1e-13, atol=1e-12)
    for sph, mimic in ((None, False), (4, True)):
        ref = hx_e2e.weather_model_inputs(hw, hx_replay.build_case_model(case, "/nonexistent"),
                                          hx_tm.building, steps_per_hour=sph, mimic_fixture_sun=mimic)
        got = endtoend.weather_model_inputs(pw, replay.build_case_model(case, "/nonexistent"), tm.building,
                                            steps_per_hour=sph, mimic_fixture_sun=mimic)
        for r, g in zip(ref, got):
            for side in ("front", "back"):
                assert np.shape(g[side]) == np.shape(r[side])
                np.testing.assert_allclose(g[side], r[side], rtol=1e-12, atol=1e-9, err_msg=side)
        assert np.asarray(got[0]["front"]).max() > 100.0


def test_run_case_without_fixtures_fails_as_heatx():
    case = replay.WALL_CASES["massive_full"]
    with pytest.raises(OSError):
        hx_replay.run_case(case, "/nonexistent")
    with pytest.raises(OSError):
        replay.run_case(case, "/nonexistent", device="cpu")

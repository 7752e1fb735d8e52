"""The port's copies of heatx's shading, ``.spl`` reader, comfort indices,
state checkpoints, NaN guards, step timing and single-zone test building,
against heatx, f64, CPU:

* ``sky_view_fraction`` (both faces) and ``sunlit_fraction`` on the office
  IDF with an overhang and a neighbouring block added, over a week of the
  synthetic EPW's sun path: within 1e-12;
* ``parse_spl``/``load_spl`` on tests/test_weather_spl.py's inline model
  (copied here): the same objects, model and compiled arrays;
* ``pmv_ppd``, ``zone_comfort_history``, ``indoor_rh_from_outdoor``,
  ``prevailing_mean_outdoor``, ``adaptive_comfort`` and
  ``adaptive_acceptability`` on seeded arrays: within 1e-12, the same
  refusals;
* checkpoints: the port's file loads in heatx and heatx's in the port, both
  ways with the optional ``ideal_load`` reconciled, equal arrays;
* ``check_state_finite``/``assert_state_finite``, ``time_steps`` and
  ``profile_trace`` on the CPU; ``testing.single_zone_building`` equal to
  heatx's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heatx
import heatx.testing as hx_testing
from heatx import comfort as hx_comfort
from heatx.build.layout import compile_building as hx_compile
from heatx.io import checkpoint as hx_checkpoint
from heatx.model import spl as hx_spl
from heatx.model.idf import load_idf as hx_load_idf
from heatx.weather import epw as hx_epw
from heatx.weather import shadow as hx_shadow
from heatx.weather import solar as hx_solar
from heatx_torch import SimConfig, ThermalModel, comfort, testing
from heatx_torch.build.layout import compile_building
from heatx_torch.io import checkpoint
from heatx_torch.model import spl
from heatx_torch.model.idf import load_idf
from heatx_torch.utils import assert_state_finite, check_state_finite, profile_trace, time_steps
from heatx_torch.weather import epw, shadow, solar
from test_torch_cli import IDF
from test_torch_office import _same_arrays

torch.set_num_threads(1)

RTOL = 1e-12

#: An overhang over the south facade and a neighbouring block to the north.
SHADES = [
    np.array([[0.0, -1.5, 3.2], [30.0, -1.5, 3.2], [30.0, 0.0, 3.2], [0.0, 0.0, 3.2]]),
    np.array([[-5.0, 25.0, 0.0], [35.0, 25.0, 0.0], [35.0, 25.0, 12.0], [-5.0, 25.0, 12.0]]),
]


@pytest.fixture(scope="module")
def shaded(tmp_path_factory):
    hx, port = hx_load_idf(IDF).model, load_idf(IDF).model
    for m in (hx, port):
        for p in SHADES:
            m.add_shade(p)
    path = testing.write_synthetic_epw(tmp_path_factory.mktemp("weather") / "w.epw", seed=2)
    return hx, port, hx_epw.read_epw(path), epw.read_epw(path)


def test_sky_view_and_sunlit_fractions_match_heatx(shaded):
    hx, port, hw, pw = shaded
    for kw in (dict(), dict(side="back"), dict(include_building=True, samples=64)):
        ref, got = hx_shadow.sky_view_fraction(hx, **kw), shadow.sky_view_fraction(port, **kw)
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-15, err_msg=str(kw))
    assert ref.min() < 0.999  # something is obstructed
    _, _, _, alt_h, az_h, _ = hx_solar.sun_and_sky(hw, hours=168, start_hour=24 * 170)
    _, _, _, alt, az, _ = solar.sun_and_sky(pw, hours=168, start_hour=24 * 170)
    np.testing.assert_allclose(alt, alt_h, rtol=RTOL)
    for kw in (dict(), dict(include_building=True, shrink=0.2)):
        # The office's furniture carries no vertex loop: both packages say so.
        with pytest.warns(UserWarning, match="Furniture:South") as w_ref:
            ref = hx_shadow.sunlit_fraction(hx, alt_h, az_h, **kw)
        with pytest.warns(UserWarning, match="Furniture:South") as w_got:
            got = shadow.sunlit_fraction(port, alt, az, **kw)
        assert str(w_got[0].message) == str(w_ref[0].message)
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-15, err_msg=str(kw))
    assert ref.shape == (168, 12) and 0.0 < ref.mean() < 1.0
    np.testing.assert_array_equal(shadow.sample_points(SHADES[0]), hx_shadow.sample_points(SHADES[0]))


#: tests/test_weather_spl.py:168-202's model.
SPL = """
Building { name: "test" }
SiteDetails { terrain_class: "City" }
Substance {
    type: "Normal", name: "Concrete", thermal_conductivity: 0.816,
    density: 1700., specific_heat_capacity: 800.,
}
Material { name: "C10", substance: "Concrete", thickness: 0.1 }
Construction { name: "Wall", materials: ["C10"] }
Space { name: "Room", volume: 300. }
Space { name: "Attic", volume: 100. }
Surface {
    name: "W", construction: "Wall",
    back_boundary: { type: "Space", space: "Room" },
    vertices: [ 0.,0.,0., 10.,0.,0., 10.,0.,3., 0.,0.,3. ]
}
Surface {
    name: "A", construction: "Wall",
    back_boundary: { type: "Space", space: "Attic" },
    vertices: [ 0.,5.,0., 10.,5.,0., 10.,5.,3., 0.,5.,3. ]
}
Luminaire { name: "lights", target_space: "Room", max_power: 120. }
HVAC {
    type: "ElectricHeater", name: "heater", target_space: "Attic",
    max_heating_power: 2300.,
}
HVAC {
    type: "IdealHeaterCooler", name: "tstat", target_spaces: ["Room"],
    heating_setpoint: 19., cooling_setpoint: 27.,
}
"""


def test_load_spl_matches_heatx(tmp_path):
    assert spl.parse_spl(SPL) == hx_spl.parse_spl(SPL)
    path = tmp_path / "m.spl"
    path.write_text(SPL)
    ref, got = hx_spl.load_spl(str(path)), spl.load_spl(str(path))
    assert repr(got) == repr(ref)
    assert got.site_details.terrain == "city" and [h.name for h in got.hvacs] == ["heater", "tstat"]
    hb = hx_compile(ref, n=1, config=heatx.SimConfig(dtype=jnp.float64))
    pb = compile_building(got, n=1, config=SimConfig(dtype=torch.float64))
    assert pb.has_ideal_hvac
    _same_arrays(hb, pb, "building")
    for bad in ('Widget { name: "x" }', 'Space { name "x" }', 'Substance { type: "Odd", name: "x" }'):
        with pytest.raises(ValueError) as e_ref:
            hx_spl.load_spl(_write(tmp_path, bad))
        with pytest.raises(ValueError) as e_got:
            spl.load_spl(_write(tmp_path, bad))
        assert str(e_got.value) == str(e_ref.value)


def _write(tmp_path, text):
    p = tmp_path / "bad.spl"
    p.write_text(text)
    return str(p)


def test_comfort_matches_heatx():
    rng = np.random.default_rng(4)
    ta, tr = rng.uniform(15, 32, (48, 3)), rng.uniform(12, 35, (48, 3))
    rh, vel = rng.uniform(10, 90, (48, 3)), rng.uniform(0.0, 1.0, (48, 3))
    for kw in (dict(), dict(air_speed=vel, met=1.6, clo=1.0), dict(met=2.5, clo=0.05, work_met=0.2)):
        for a, b in zip(comfort.pmv_ppd(ta, tr, rh, **kw), hx_comfort.pmv_ppd(ta, tr, rh, **kw)):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-12, err_msg=str(kw))
    for r in (55.0, rh[:, 0], rh):
        for a, b in zip(comfort.zone_comfort_history(ta, tr, r, clo=0.7),
                        hx_comfort.zone_comfort_history(ta, tr, r, clo=0.7)):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-12)
    t_out = rng.uniform(-5, 30, 48)
    np.testing.assert_allclose(comfort.indoor_rh_from_outdoor(rh[:, 0], t_out, ta[:, 0]),
                               hx_comfort.indoor_rh_from_outdoor(rh[:, 0], t_out, ta[:, 0]), rtol=RTOL)
    dry = 15 + 10 * np.sin(np.arange(24 * 40) / 24 / 6) + rng.normal(0, 2, 24 * 40)
    for days in (7, 30):
        pma = comfort.prevailing_mean_outdoor(dry, days)
        np.testing.assert_allclose(pma, hx_comfort.prevailing_mean_outdoor(dry, days), rtol=RTOL)
    band, ref = comfort.adaptive_comfort(pma), hx_comfort.adaptive_comfort(pma)
    assert sorted(band) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(band[k], ref[k], rtol=RTOL, equal_nan=True)
    top = rng.uniform(18, 30, (24 * 40, 2))
    acc, ref = comfort.adaptive_acceptability(top, pma), hx_comfort.adaptive_acceptability(top, pma)
    for k in ref:
        np.testing.assert_array_equal(acc[k], ref[k])
    assert acc["in_80"].any() and not acc["in_80"].all()
    for args in ((dry[:30],), (dry, 5), (dry[:24 * 5], 7)):
        with pytest.raises(ValueError) as e_ref:
            hx_comfort.prevailing_mean_outdoor(*args)
        with pytest.raises(ValueError) as e_got:
            comfort.prevailing_mean_outdoor(*args)
        assert str(e_got.value) == str(e_ref.value)


def _models(thermostat):
    hx, port = hx_load_idf(IDF).model, load_idf(IDF).model
    if not thermostat:
        hx.hvacs, port.hvacs = [], []
    return (heatx.ThermalModel(hx, config=heatx.SimConfig(dtype=jnp.float64)),
            ThermalModel(port, config=SimConfig(dtype=torch.float64), device="cpu"))


def _random_state(state, rng, fields):
    return {f: rng.uniform(10, 30, np.shape(getattr(state, f))) for f in fields}


@pytest.mark.parametrize("thermostat", [True, False])
def test_checkpoints_round_trip_both_ways(tmp_path, thermostat):
    th, tp = _models(thermostat)
    rng = np.random.default_rng(8)
    names = ["node_T", "zone_T", "h_front", "h_back", "q_front", "q_back"] + (["ideal_load"] if thermostat else [])
    vals = _random_state(tp.initial_state(), rng, names)
    port_state = dataclasses.replace(tp.initial_state(), **{k: torch.as_tensor(v) for k, v in vals.items()})
    hx_state = th.initial_state()._replace(**{k: jnp.asarray(v) for k, v in vals.items()})
    # The port writes (the suffix normalized), heatx reads, and the reverse.
    p1 = checkpoint.save_state(str(tmp_path / "port"), port_state, step=7)
    assert p1.endswith(".npz")
    got_h, step_h = hx_checkpoint.load_state(str(tmp_path / "port"), building=th.building)
    p2 = hx_checkpoint.save_state(str(tmp_path / "heatx"), hx_state, step=9)
    got_p, step_p = checkpoint.load_state(str(tmp_path / "heatx"), building=tp.building, device="cpu")
    assert (step_h, step_p) == (7, 9)
    with np.load(p1) as a, np.load(p2) as b:
        assert sorted(a.files) == sorted(b.files)
    for k in names:
        np.testing.assert_array_equal(np.asarray(getattr(got_h, k)), vals[k], err_msg=k)
        np.testing.assert_array_equal(getattr(got_p, k).numpy(), vals[k], err_msg=k)
    # A state without ideal_load into a building with thermostats gets a zero
    # channel; one with it into a building without drops it.
    other_h, other_p = _models(not thermostat)
    got, _ = checkpoint.load_state(p2, dtype=torch.float32, building=other_p.building, device="cpu")
    ref, _ = hx_checkpoint.load_state(p2, dtype=np.float32, building=other_h.building)
    assert (got.ideal_load is None) == (ref.ideal_load is None) == thermostat
    if not thermostat:
        np.testing.assert_array_equal(got.ideal_load.numpy(), np.asarray(ref.ideal_load))
    assert got.zone_T.dtype == torch.float32
    # A foreign file: the same KeyError.
    np.savez(tmp_path / "bad.npz", step=np.int64(0), zone_T=vals["zone_T"])
    with pytest.raises(KeyError) as e_ref:
        hx_checkpoint.load_state(str(tmp_path / "bad.npz"))
    with pytest.raises(KeyError) as e_got:
        checkpoint.load_state(str(tmp_path / "bad.npz"), device="cpu")
    assert str(e_got.value) == str(e_ref.value)


def test_checkpoint_loads_onto_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-GPU refusal")
    _, tp = _models(True)
    path = checkpoint.save_state(str(tmp_path / "s"), tp.initial_state())
    with pytest.raises(RuntimeError, match="CUDA"):
        checkpoint.load_state(path)


def test_state_guards_and_timing(tmp_path):
    _, tp = _models(True)
    st = tp.initial_state()
    assert check_state_finite(st) == {}
    assert_state_finite(st)
    st.node_T[0, 1] = float("nan")
    st.ideal_load[0] = float("inf")
    assert check_state_finite(st) == {"node_T": 1, "ideal_load": 1}
    with pytest.raises(FloatingPointError, match="at hour 3.*node_T"):
        assert_state_finite(st, "hour 3")
    runner = tp.fast_runner(mode="trbdf2", substeps=2, hours=1)
    inputs = tp.inputs(t_out=5.0)
    final, per_step = time_steps(lambda s: runner.march(s, inputs), tp.initial_state(), 3)
    assert per_step > 0 and torch.isfinite(final.zone_T).all()
    with profile_trace(str(tmp_path / "trace")) as prof:
        runner.march(tp.initial_state(), inputs)
    assert len(prof.key_averages()) > 0 and any((tmp_path / "trace").iterdir())


def test_single_zone_building_matches_heatx():
    for kw in (dict(construction=[testing.TestMat.concrete(0.2)]),
               dict(construction=[testing.TestMat.glass(0.006), testing.TestMat.air(0.012),
                                  testing.TestMat.glass(0.006)], window_width=1.0, window_height=1.2,
                    heating_power=500.0, lighting_power=100.0)):
        hx_kw = dict(kw, construction=[hx_testing.TestMat(m.kind, m.thickness, m.tau) for m in kw["construction"]])
        ref = hx_testing.single_zone_building(hx_testing.SingleZoneOptions(**hx_kw))
        got = testing.single_zone_building(testing.SingleZoneOptions(**kw))
        assert repr(got) == repr(ref)

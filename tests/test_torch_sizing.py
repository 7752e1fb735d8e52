"""The port's equipment sizing (``heatx_torch.sizing``) against heatx's, f64,
CPU.

* ``design_days_from_epw`` (and its refusal), ``clark_allen_sky_emissivity``,
  the design-day profiles, ``ashrae_clear_sky`` and ``sizing_hvac_power``:
  equal to heatx's;
* ``size_from_epw`` (``design_day_loads`` on the winter and the summer day)
  on ``single_zone_building`` with a window and a slab on the ground, at the
  coarse discretization of ``testing.coarse_config`` (6 parity sub-steps an
  hour): load profiles within 1e-9 of their max |load|, the same warm-up
  counts and peak hours;
* ``design_day_loads(engine="kernel")`` (the parity day march with the
  adaptive no-mass loop) on the office's winter day against heatx's
  ``design_day_loads``, 1e-9 of max |load|;
* ``annual_peak_loads`` with ``engine="kernel"`` (the port's day march, its
  plain version here; heatx's kernel in interpret mode) and ``engine="xla"``
  on the same building over a weather object cut to 7 days (168 h), with the
  Carroll MRT network and the seasonal soil: the demand series within 1e-9
  of max |load|, peaks and warm-up counts alike;
* the ``ValueError``s of heatx's sizing.py:482-487, with heatx's messages.

The room's walls are all concrete.  With a no-mass insulation layer the
parity march with the MRT network and two fixed no-mass iterations carries a
1e-13 K difference between the two packages to ~5e-7 K within 8 sub-steps
of this room's first hour (ROADMAP C), far past these bars.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heatx
import heatx.testing as hx_testing
from heatx import sizing as hx_sizing
from heatx.model.building import Boundary as HxBoundary
from heatx.model.building import SurfaceDef as HxSurfaceDef
from heatx.model.idf import load_idf as hx_load_idf
from heatx.weather import epw as hx_epw
from heatx.weather import solar as hx_solar
from heatx_torch import SimConfig, sizing, testing
from heatx_torch.model.building import Boundary, SurfaceDef
from heatx_torch.model.idf import load_idf
from heatx_torch.weather import epw, solar
from test_torch_cli import IDF

torch.set_num_threads(1)

HOURS = 168
BLOCK = 16


@pytest.fixture(scope="module")
def weather(tmp_path_factory):
    path = testing.write_synthetic_epw(tmp_path_factory.mktemp("weather") / "design.epw", seed=1)
    return hx_epw.read_epw(path), epw.read_epw(path)


def _room(testing_mod, boundary, surface_def):
    """A single-zone box with a 2 x 1.5 m window and a slab on the ground."""
    opts = testing_mod.SingleZoneOptions(
        zone_volume=60.0, surface_height=3.0, surface_width=5.0, window_height=1.5, window_width=2.0,
        construction=[testing_mod.TestMat.concrete(0.2)],
    )
    m = testing_mod.single_zone_building(opts)
    m.add_surface(surface_def(
        "slab", "the construction", boundary.ground(), boundary.space_("Space"),
        vertices=np.array([[0, 0, 0], [0, 4, 0], [5, 4, 0], [5, 0, 0]], float),
    ))
    return m


def _models():
    return _room(hx_testing, HxBoundary, HxSurfaceDef), _room(testing, Boundary, SurfaceDef)


def test_design_days_and_helpers_match_heatx(weather):
    hw, pw = weather
    ref, got = hx_sizing.design_days_from_epw(hw), sizing.design_days_from_epw(pw)
    assert sorted(got) == sorted(ref) == ["summer", "winter"]
    for season in ref:
        assert dataclasses.asdict(got[season]) == dataclasses.asdict(ref[season])
        np.testing.assert_array_equal(got[season].dry_bulb_profile, ref[season].dry_bulb_profile)
        np.testing.assert_allclose(got[season].sky_ir_horizontal(), ref[season].sky_ir_horizontal(),
                                   rtol=1e-15)
    np.testing.assert_array_equal(sizing.DAILY_RANGE_FRACTION, hx_sizing.DAILY_RANGE_FRACTION)
    dew = np.linspace(-20.0, 25.0, 19)
    np.testing.assert_array_equal(sizing.clark_allen_sky_emissivity(dew),
                                  hx_sizing.clark_allen_sky_emissivity(dew))
    alt = np.linspace(-0.2, 1.5, 23)
    for month in (1, 7, 12):
        for a, b in zip(solar.ashrae_clear_sky(alt, month, 0.9), hx_solar.ashrae_clear_sky(alt, month, 0.9)):
            np.testing.assert_array_equal(a, b)
    # No DESIGN CONDITIONS: the same refusal.
    bare_h, bare_p = dataclasses.replace(hw, design_conditions={}), dataclasses.replace(pw, design_conditions={})
    with pytest.raises(ValueError) as e_ref:
        hx_sizing.design_days_from_epw(bare_h)
    with pytest.raises(ValueError) as e_got:
        sizing.design_days_from_epw(bare_p)
    assert str(e_got.value) == str(e_ref.value)


def test_sizing_hvac_power_matches_heatx():
    hx, port = hx_load_idf(IDF).model, load_idf(IDF).model
    assert any(not sizing._is_gain_hvac(h) for h in port.hvacs)
    power = np.random.default_rng(0).uniform(0.0, 900.0, (5, len(port.hvacs)))
    for v in (power, power[0]):
        np.testing.assert_array_equal(sizing.sizing_hvac_power(port, v), hx_sizing.sizing_hvac_power(hx, v))
    assert repr(sizing._sizing_model(port, 19.0, 25.0)) == repr(hx_sizing._sizing_model(hx, 19.0, 25.0))


def _coarse(mrt=True):
    return (heatx.SimConfig(dtype=jnp.float64, max_dx=0.5, min_dt=900.0, nomass_fixed_iters=2, interior_mrt=mrt),
            testing.coarse_config(interior_mrt=mrt))


def test_design_day_loads_match_heatx(weather):
    hw, pw = weather
    hm, pm = _models()
    hx_cfg, cfg = _coarse()
    ref = hx_sizing.size_from_epw(hm, hw, heat_sp=18.0, cool_sp=21.0, config=hx_cfg)
    got = sizing.size_from_epw(pm, pw, heat_sp=18.0, cool_sp=21.0, config=cfg, device="cpu")
    assert sorted(got) == sorted(ref) == ["summer", "winter"]
    for season in ref:
        r, g = ref[season], got[season]
        assert g.zone_names == r.zone_names and g.warmup_days == r.warmup_days
        scale = np.abs(r.profile_W).max()
        assert scale > 100.0, season
        np.testing.assert_allclose(g.profile_W, r.profile_W, rtol=0, atol=1e-9 * scale, err_msg=season)
        np.testing.assert_allclose(g.peak_W, r.peak_W, rtol=0, atol=1e-9 * scale)
        np.testing.assert_array_equal(g.peak_hour, r.peak_hour)
        assert g.summary() == r.summary()
    assert (got["winter"].profile_W > 0).all() and (got["summer"].profile_W < 0).any()


def test_design_day_kernel_route_matches_heatx(weather):
    """``engine="kernel"`` (the parity day march, its plain version here) on
    the office, whose argon panes are no-mass nodes, with the adaptive
    no-mass loop at the coarse discretization and two warm-up repeats: the
    winter day within 1e-9 of max |load| of heatx's design_day_loads (its
    XLA path), which keeps that loop out of its kernel."""
    hw, pw = weather
    day = sizing.design_days_from_epw(pw)["winter"]
    hx_cfg = heatx.SimConfig(dtype=jnp.float64, max_dx=0.5, min_dt=900.0, nomass_fixed_iters=None,
                             interior_mrt=True)
    cfg = testing.coarse_config(nomass_fixed_iters=None, interior_mrt=True)
    ref = hx_sizing.design_day_loads(hx_load_idf(IDF).model, hx_sizing.design_days_from_epw(hw)["winter"],
                                     epw=hw, config=hx_cfg, max_repeats=2)
    got = sizing.design_day_loads(load_idf(IDF).model, day, epw=pw, config=cfg, max_repeats=2,
                                  engine="kernel", device="cpu")
    assert got.warmup_days == ref.warmup_days == 2
    scale = np.abs(ref.profile_W).max()
    assert scale > 100.0
    np.testing.assert_allclose(got.profile_W, ref.profile_W, rtol=0, atol=1e-9 * scale)
    np.testing.assert_array_equal(got.peak_hour, ref.peak_hour)
    with pytest.raises(ValueError, match="hourly main steps"):
        sizing.design_day_loads(load_idf(IDF).model, day, epw=pw, n=2, engine="kernel", device="cpu")
    with pytest.raises(ValueError, match="engine must be"):
        sizing.design_day_loads(load_idf(IDF).model, day, epw=pw, engine="bogus", device="cpu")


@pytest.fixture(scope="module")
def annual(weather):
    hw, pw = (testing.cut_weather(w, HOURS) for w in weather)
    assert pw.n_hours == hw.n_hours == HOURS
    hm, pm = _models()
    hx_cfg = heatx.SimConfig(dtype=jnp.float64, interior_mrt=True)
    cfg = SimConfig(dtype=torch.float64, interior_mrt=True)
    kw = dict(heat_sp=21.0, cool_sp=22.0, coverage=99.0, block_size=BLOCK)
    return {
        engine: (hx_sizing.annual_peak_loads(hm, hw, engine=engine, config=hx_cfg, **kw),
                 sizing.annual_peak_loads(pm, pw, engine=engine, config=cfg, device="cpu", **kw))
        for engine in ("kernel", "xla")
    }


@pytest.mark.parametrize("engine", ["kernel", "xla"])
def test_annual_peak_loads_match_heatx(annual, engine):
    ref, got = annual[engine]
    assert got.loads_W.shape == ref.loads_W.shape == (HOURS, 1)
    assert got.warmup_days == ref.warmup_days and got.coverage == ref.coverage
    scale = np.abs(ref.loads_W).max()
    assert (ref.loads_W > 0).any() and (ref.loads_W < 0).any()  # heats and cools
    np.testing.assert_allclose(got.loads_W, ref.loads_W, rtol=0, atol=1e-9 * scale)
    for name in ("peak_heating_W", "peak_cooling_W", "max_heating_W", "max_cooling_W"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name), rtol=0, atol=1e-9 * scale,
                                   err_msg=name)
    assert got.summary() == ref.summary()


def test_annual_peak_loads_engines_agree(annual):
    """The day march (12 sub-steps an hour) and the plain TR-BDF2 march (8)
    size the room alike, at heatx's bar of tests/test_sizing.py."""
    k, x = annual["kernel"][1], annual["xla"][1]
    np.testing.assert_allclose(k.loads_W, x.loads_W, atol=3.0)
    np.testing.assert_allclose(k.peak_heating_W, x.peak_heating_W, rtol=2e-3)
    np.testing.assert_allclose(k.peak_cooling_W, x.peak_cooling_W, rtol=2e-3, atol=1.0)


@pytest.mark.parametrize("kw", [dict(coverage=0.0), dict(coverage=100.5), dict(engine="bogus"),
                                dict(engine="kernel", n=2)])
def test_annual_refusals_match_heatx(weather, kw):
    hw, pw = (testing.cut_weather(w, 24) for w in weather)
    hm, pm = _models()
    with pytest.raises(ValueError) as e_ref:
        hx_sizing.annual_peak_loads(hm, hw, **kw)
    with pytest.raises(ValueError) as e_got:
        sizing.annual_peak_loads(pm, pw, device="cpu", **kw)
    assert str(e_got.value) == str(e_ref.value)

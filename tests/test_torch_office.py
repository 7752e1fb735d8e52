"""The office IDF workflow of the port against heatx, f64, CPU.

bench.py's ``run_office_bench`` on ``examples/data/office.idf`` (3 zones,
argon double glazing, simple glazing, slab floors on the ground, internal
mass, zone-list gains on office schedules, scheduled infiltration and
ventilation, night-setback ideal loads), with weather from
``testing.write_synthetic_epw`` (the Santiago IWEC file is not in the
repository):

* ``read_epw`` of the synthetic file: every field and the ground
  temperatures, equal in both packages;
* ``surface_irradiance``/``surface_longwave`` on the office, rtol 1e-12;
* ``load_idf``: equal models, compiled arrays, ``hourly_channels`` and
  ``airflow_series`` over 48 h; tests/test_idf.py's inline snippets parse
  alike or raise the same ``ValueError``;
* ``FastRunner.run`` (trbdf2, scheduled setpoints, ``collect_loads``,
  ``ground_hourly`` changing after day 1) against heatx's interpret-mode
  kernel over 48 h: 1e-9 K, loads within 1e-9 of max |load|, the same
  dispatch splits and ground swaps; ``set_ground_temperature`` on both
  runners and both models; ``chunk_forward(ground_hourly=...)`` paired with
  ``chunk_grad`` refused;
* ``testing.build_glazed_city(4, 10)`` compiles to the same arrays as heatx's
  bench city with the same glazing.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import heatx
import heatx.model.building as hmb
from heatx.build.layout import B_GROUND as HX_B_GROUND
from heatx.build.layout import B_OUTDOOR as HX_B_OUTDOOR
from heatx.build.layout import compile_building as hx_compile
from heatx.model.idf import load_idf as hx_load_idf
from heatx.weather import epw as hx_epw
from heatx.weather import solar as hx_solar
from heatx_torch import SimConfig, ThermalModel, testing
from heatx_torch.build.layout import B_GROUND, compile_building
from heatx_torch.engine.adjoint import tree_map
from heatx_torch.model.idf import load_idf
from heatx_torch.weather import epw, solar

torch.set_num_threads(1)

IDF = os.path.join(os.path.dirname(__file__), os.pardir, "examples", "data", "office.idf")
RTOL = 1e-12
ATOL_K = 1e-9
HOURS = 48
SUB = 4
RUN_KW = dict(mode="trbdf2", substeps=SUB, hours=24, scheduled_setpoints=True)


@pytest.fixture(scope="module")
def epw_path(tmp_path_factory):
    return testing.write_synthetic_epw(tmp_path_factory.mktemp("weather") / "santiago.epw", seed=3)


def _same_arrays(a, b, what):
    """Equal compiled fields (dataclasses of arrays, tuples and scalars)."""
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            if f.name not in ("discretizations", "config"):
                _same_arrays(getattr(a, f.name), getattr(b, f.name), f"{what}.{f.name}")
    elif isinstance(a, tuple):
        for i, (x, y) in enumerate(zip(a, b)):
            _same_arrays(x, y, f"{what}[{i}]")
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.shape == y.shape, what
        if x.dtype.kind == "f":
            np.testing.assert_allclose(x, y, rtol=1e-14, atol=0, err_msg=what)
        else:
            np.testing.assert_array_equal(x, y, err_msg=what)


def test_read_epw_matches_heatx(epw_path):
    ref = hx_epw.read_epw(epw_path)
    got = epw.read_epw(epw_path)
    assert got.n_hours == 8760 and (got.latitude_deg, got.longitude_deg, got.tz_hours) == testing.SANTIAGO[:3]
    for f in dataclasses.fields(ref):
        r, g = getattr(ref, f.name), getattr(got, f.name)
        if isinstance(r, np.ndarray):
            np.testing.assert_array_equal(g, r, err_msg=f.name)
        elif f.name == "ground_temps":
            assert sorted(g) == sorted(r) and len(r) == 1
            for depth in r:
                np.testing.assert_array_equal(g[depth], r[depth])
        else:
            assert g == r, f.name
    np.testing.assert_array_equal(got.ground_temperature(None), ref.ground_temperature(None))
    np.testing.assert_array_equal(epw.monthly_to_hourly(got.ground_temperature(), 9000),
                                  hx_epw.monthly_to_hourly(ref.ground_temperature(), 9000))
    assert np.ptp(got.dry_bulb) > 10 and got.direct_normal.max() > 300


@pytest.fixture(scope="module")
def loaded():
    return hx_load_idf(IDF), load_idf(IDF)


@pytest.fixture(scope="module")
def compiled(loaded):
    hx, port = loaded
    hb = hx_compile(hx.model, n=1, config=heatx.SimConfig(dtype=jnp.float64))
    pb = compile_building(port.model, n=1, config=SimConfig(dtype=torch.float64))
    return hb, pb


def test_load_idf_matches_heatx(loaded, compiled):
    hx, port = loaded
    assert repr(port.model) == repr(hx.model)
    assert (port.infiltration, port.ventilation, port.counts) == (hx.infiltration, hx.ventilation, hx.counts)
    hb, pb = compiled
    assert pb.surfaces.has_cavity and (np.asarray(pb.surfaces.front_code) == B_GROUND).any()
    _same_arrays(hb, pb, "building")
    for name in ("hourly_channels", "airflow_series"):
        ref, got = getattr(hx, name)(HOURS), getattr(port, name)(HOURS)
        assert sorted(got) == sorted(ref), name
        for k in ref:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=f"{name} {k}")
    assert "heat_sp" in port.hourly_channels(HOURS)


SNIPPETS = {
    "infiltration_methods": """
    Zone, Z1, 0, 0, 0, 0, 1, 1, 3, 720, 240;
    Schedule:Constant, Half, Any number, 0.5;
    ZoneInfiltration:DesignFlowRate, InfA, Z1, Half, AirChanges/Hour,
        0, 0, 0, 2.0, 1, 0, 0, 0;
    ZoneInfiltration:DesignFlowRate, InfB, Z1, , Flow/Zone,
        0.25, 0, 0, 0, 1, 0, 0, 0;
    """,
    "autocalculated_volume": "Zone, Z1, 0, 0, 0, 0, 1, 1, 3, autocalculate;",
    "foundation_boundary": """
    Zone, Z1, 0, 0, 0, 0, 1, 1, 3, 720;
    BuildingSurface:Detailed, W, Wall, C, Z1, , Foundation, , No, No, 0,
        4, 0,0,0, 1,0,0, 1,0,1, 0,0,1;
    """,
    "no_space_name_field": """
    Zone, Z1, 0, 0, 0, 0, 1, 1, 3, 720;
    BuildingSurface:Detailed, W, Wall, C, Z1, Outdoors, , Sun, Wind, 0.5,
        4, 0,0,3, 0,0,0, 2,0,0, 2,0,3;
    """,
}


@pytest.mark.parametrize("name", list(SNIPPETS))
def test_idf_snippets_parse_alike(name):
    """tests/test_idf.py's inline IDFs: the same model and flows, or the
    same refusal."""
    try:
        ref = hx_load_idf(SNIPPETS[name])
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            load_idf(SNIPPETS[name])
        assert str(got.value) == str(e)
        return
    got = load_idf(SNIPPETS[name])
    assert repr(got.model) == repr(ref.model)
    assert (got.infiltration, got.ventilation) == (ref.infiltration, ref.ventilation)
    for a, b in zip(got.model.surfaces, ref.model.surfaces):
        np.testing.assert_allclose(a.resolved_geometry()[0], b.resolved_geometry()[0], rtol=RTOL)


def test_surface_irradiance_and_longwave_match_heatx(epw_path, compiled):
    hb, pb = compiled
    ref_w, got_w = hx_epw.read_epw(epw_path), epw.read_epw(epw_path)
    for kw in (dict(), dict(sky="perez"), dict(side="back", start_hour=4000)):
        ref = hx_solar.surface_irradiance(ref_w, hb, hours=HOURS, **kw)
        got = solar.surface_irradiance(got_w, pb, hours=HOURS, **kw)
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-12, err_msg=str(kw))
    assert ref.max() > 100  # the sun is up on some face
    ref = hx_solar.surface_longwave(ref_w, hb, hours=HOURS)
    got = solar.surface_longwave(got_w, pb, hours=HOURS)
    np.testing.assert_allclose(got, ref, rtol=RTOL)


def _heatx_inputs(loaded, tm, w, T):
    """bench.py:432-458 on heatx's classes."""
    b = tm.building
    reps = -(-T // w.n_hours)

    def tile(v):
        return np.tile(np.asarray(v, np.float64), reps)[:T]

    sol_f = hx_solar.surface_irradiance(w, b, hours=T) * (np.asarray(b.surfaces.front_code) == HX_B_OUTDOOR)
    ch, air = loaded.hourly_channels(T), loaded.airflow_series(T)
    dry = tile(w.dry_bulb)
    t_in = np.repeat(dry[:, None], b.n_zones, axis=1)
    seq = tm.inputs()._replace(
        t_out=jnp.asarray(dry), wind_speed=jnp.asarray(tile(w.wind_speed)),
        wind_direction=jnp.asarray(tile(np.radians(w.wind_direction_deg))),
        sol_front=jnp.asarray(sol_f), ir_front=jnp.asarray(tile(w.horizontal_ir)),
        inf_vol=air["inf_vol"], inf_mask=air["inf_vol"] > 0, inf_temp=t_in,
        vent_vol=air["vent_vol"], vent_mask=air["vent_vol"] > 0, vent_temp=t_in,
        **{k: jnp.asarray(v) for k, v in ch.items()},
    )
    has_ground = (np.asarray(b.surfaces.front_code) == HX_B_GROUND).any()
    return seq, w.ground_temperature(None)[hx_epw._MONTH_HOURS[np.arange(T) % 8760]] if has_ground else None


def _spy_ground(runner):
    """Record the runner's ground swaps."""
    calls, swap = [], runner.set_ground_temperature

    def spy(value):
        calls.append(float(value))
        swap(value)

    runner.set_ground_temperature = spy
    return calls


@pytest.fixture(scope="module")
def heatx_office(loaded, epw_path):
    hx = loaded[0]
    tm = heatx.ThermalModel(hx.model, n=1, config=heatx.SimConfig(dtype=jnp.float64))
    seq, ground = _heatx_inputs(hx, tm, hx_epw.read_epw(epw_path), HOURS)
    ground = ground.copy()
    ground[24:] += 4.0  # a second soil temperature from day 1 on
    fr = tm.fast_runner(block_size=16, interpret=True, **RUN_KW)
    swaps = _spy_ground(fr)
    final, zt, loads = fr.run(tm.initial_state(), seq, ground_hourly=ground, collect_loads=True)
    swaps = list(swaps)
    # Then a swap by hand, and a day without a ground series.
    fr.set_ground_temperature(5.0)
    day = jax.tree.map(lambda v: v[:24] if np.ndim(v) and np.shape(v)[0] == HOURS else v, seq)
    _, zt5, loads5 = fr.run(final, day, collect_loads=True)
    tm.set_ground_temperature(9.0)
    fr9 = tm.fast_runner(block_size=16, interpret=True, **RUN_KW)
    _, zt9, _ = fr9.run(final, day, collect_loads=True)
    return dict(final=final, zt=np.asarray(zt), loads=np.asarray(loads), swaps=swaps, ground=ground,
                zt5=np.asarray(zt5), loads5=np.asarray(loads5), zt9=np.asarray(zt9))


def _port_office(loaded, epw_path):
    tm = ThermalModel(loaded[1].model, n=1, config=SimConfig(dtype=torch.float64), device="cpu")
    seq, ground = testing.office_inputs(loaded[1], tm, epw.read_epw(epw_path), HOURS)
    return tm, seq, ground


def test_office_run_with_ground_swaps_matches_heatx(loaded, epw_path, heatx_office):
    ref = heatx_office
    tm, seq, ground = _port_office(loaded, epw_path)
    np.testing.assert_array_equal(ground + np.where(np.arange(HOURS) >= 24, 4.0, 0.0), ref["ground"])
    fr = tm.fast_runner(**RUN_KW)
    swaps = _spy_ground(fr)
    final, zt, loads = fr.run(tm.initial_state(), seq, ground_hourly=ref["ground"], collect_loads=True)
    assert fr.dispatch_starts == [0, 1] and swaps == ref["swaps"] == [ref["ground"][0], ref["ground"][24]]
    np.testing.assert_allclose(zt.numpy(), ref["zt"], rtol=0, atol=ATOL_K)
    scale = np.abs(ref["loads"]).max()
    assert scale > 100 and (ref["loads"] > 0).any() and (ref["loads"] < 0).any()  # heats and cools
    np.testing.assert_allclose(loads.numpy(), ref["loads"], rtol=0, atol=1e-9 * scale)
    for name in ("node_T", "zone_T", "h_front", "h_back", "q_front", "q_back"):
        np.testing.assert_allclose(getattr(final, name).numpy(), np.asarray(getattr(ref["final"], name)),
                                   rtol=0, atol=ATOL_K, err_msg=name)

    # The runner keeps the last soil temperature; a swap by hand writes the
    # blocked ground rows only; a model-level swap reaches new runners.
    before = fr.params.field("front_temp").clone()
    fr.set_ground_temperature(5.0)
    ground_lane = fr.params.field("front_code") == B_GROUND
    assert bool(ground_lane.any())
    assert bool((fr.params.field("front_temp")[ground_lane] == 5.0).all())
    assert torch.equal(fr.params.field("front_temp")[~ground_lane], before[~ground_lane])
    day = _head(seq, 24)
    _, zt5, loads5 = fr.run(final, day, collect_loads=True)
    np.testing.assert_allclose(zt5.numpy(), ref["zt5"], rtol=0, atol=ATOL_K)
    np.testing.assert_allclose(loads5.numpy(), ref["loads5"], rtol=0, atol=1e-9 * scale)
    tm.set_ground_temperature(9.0)
    _, zt9, _ = tm.fast_runner(**RUN_KW).run(final, day, collect_loads=True)
    np.testing.assert_allclose(zt9.numpy(), ref["zt9"], rtol=0, atol=ATOL_K)
    assert np.abs(ref["zt9"] - ref["zt5"]).max() > 1e-6  # the soil temperature reaches the zones


def _head(seq, hours):
    return tree_map(lambda v: v[:hours] if v.ndim and v.shape[0] == HOURS else v, seq)


def test_ground_refusals(loaded, epw_path):
    tm, seq, ground = _port_office(loaded, epw_path)
    fr = tm.fast_runner(**RUN_KW)
    with pytest.raises(ValueError, match="one value per hour"):
        fr.run(tm.initial_state(), seq, ground_hourly=ground[:24])
    with pytest.raises(ValueError, match="constant within each 24-hour"):
        fr.run(tm.initial_state(), seq, ground_hourly=ground + np.arange(HOURS) * 0.1)
    free = ThermalModel(testing.build_city_model(2, 3), config=SimConfig(dtype=torch.float64), device="cpu")
    with pytest.raises(ValueError, match="no ground boundaries"):
        free.set_ground_temperature(10.0)
    with pytest.raises(ValueError, match="no ground boundaries"):
        free.fast_runner(mode="trbdf2", substeps=2, hours=1).set_ground_temperature(10.0)
    # A ground series changes the forward trajectory: chunk_grad refuses a
    # chunk_forward that ran with one (heatx api.py:704 accepts it, ROADMAP C).
    with pytest.raises(ValueError, match="ground_hourly"):
        fr.chunk_forward(lambda p: tm.building, lambda zt, ld, xs: zt.sum(), collect_loads=True,
                         ground_hourly=ground)
        fr.chunk_grad(lambda p: tm.building, lambda zt, ld, xs: zt.sum(), collect_loads=True)


def test_glazed_city_matches_heatx():
    hb = hx_compile(testing.glaze_windows(bench.build_city_model(4, 10), hmb), n=1,
                    config=heatx.SimConfig(dtype=jnp.float64))
    pb = compile_building(testing.build_glazed_city(4, 10), n=1, config=SimConfig(dtype=torch.float64))
    assert int(pb.surfaces.seg_is_cavity.any(axis=0).sum()) == 4  # one window per zone
    _same_arrays(hb, pb, "building")


@pytest.mark.parametrize("wind_deg, parts", [(270.0, True), (270.1, False)])
def test_f32_loads_part_from_f64_only_at_the_windward_tie(loaded, epw_path, wind_deg, parts):
    """Wind exactly along a facade (a multiple of 90 deg on the office) is
    the windward test's tie: float32 and float64 take opposite sides, the
    forced film coefficient of those faces changes for the hour, and the
    loads part by more than 1e-3 of max |load|.  A tenth of a degree off the
    tie they agree to 1e-4 (what testing.write_synthetic_epw keeps to)."""
    out = {}
    for dtype in (torch.float32, torch.float64):
        tm = ThermalModel(loaded[1].model, n=1, config=SimConfig(dtype=dtype), device="cpu")
        seq, ground = testing.office_inputs(loaded[1], tm, epw.read_epw(epw_path), HOURS)
        seq = seq.replace(wind_direction=torch.full((HOURS,), np.radians(wind_deg), dtype=dtype))
        _, _, loads = tm.fast_runner(**RUN_KW).run(tm.initial_state(), seq, ground_hourly=ground,
                                                   collect_loads=True)
        out[dtype] = loads.double()
    gap = float((out[torch.float32] - out[torch.float64]).abs().max())
    scale = float(out[torch.float64].abs().max())
    assert (gap > 1e-3 * scale) if parts else (gap < 1e-4 * scale), (gap, scale)

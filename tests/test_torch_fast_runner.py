"""heatx_torch's FastRunner.run against heatx's FastRunner.run (Pallas kernel
in interpret mode), f64, on the 4-zone bench city: 48 h as two 24-hour
day-kernel calls, trbdf2_refresh k=2 at 8 sub-steps, interpolated bench
weather, the bench's seeded solar factors and gains.  Also: the same run on
heatx's own kernel operands carried across by heatx_torch.convert, the
finiteness check, and the features that are not ported yet.

Tolerance 1e-9 K, for the reasons given in test_torch_day_march.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import heatx
from heatx.ops import pallas_step
from heatx_torch import SimConfig, ThermalModel, convert, testing
from heatx_torch.model.building import IdealHeaterCooler, ZoneShadingControl, ZoneVentilationControl

torch.set_num_threads(1)

ATOL = 1e-9
HOURS = 48
KW = dict(mode="trbdf2_refresh", substeps=8, hours=24, refresh_every=2)


def _heatx_inputs(tm, hours):
    b = tm.building
    dry, wind, wdir, ghi, ir = testing.synthetic_weather(hours)
    sol = ghi[:, None] * testing.solar_factors(b.n_surfaces)[None, :]
    return tm.inputs_sequence(
        hours, t_out=dry, wind_speed=wind, wind_direction=wdir, sol_front=sol,
        ir_front=ir, hvac_power=np.full(b.n_hvacs, 500.0),
        lum_power=np.full(b.n_luminaires, 150.0),
    )


@pytest.fixture(scope="module")
def heatx_run():
    tm = heatx.ThermalModel(
        bench.build_city_model(4, 10), n=1, config=heatx.SimConfig(dtype=jnp.float64)
    )
    runner = tm.fast_runner(block_size=16, interpret=True, **KW)
    final, zone_T = runner.run(tm.initial_state(), _heatx_inputs(tm, HOURS), interp_weather=True)
    return tm, final, np.asarray(zone_T)


def _port_model(device="cpu"):
    return ThermalModel(
        testing.build_city_model(4, 10), n=1, config=SimConfig(dtype=torch.float64),
        device=device,
    )


def _check_run(final, zone_T, ref_final, ref_zone_T):
    assert tuple(zone_T.shape) == (HOURS, 4)
    np.testing.assert_allclose(zone_T.cpu().numpy(), ref_zone_T, rtol=0, atol=ATOL)
    for name in ("node_T", "zone_T", "h_front", "h_back", "q_front", "q_back"):
        np.testing.assert_allclose(
            getattr(final, name).cpu().numpy(), np.asarray(getattr(ref_final, name)),
            rtol=0, atol=ATOL, err_msg=name,
        )


@pytest.mark.parametrize("dispatch_days", [None, 1])
def test_fast_runner_matches_heatx(heatx_run, dispatch_days):
    _, ref_final, ref_zone_T = heatx_run
    tm = _port_model()
    runner = tm.fast_runner(**KW)
    final, zone_T = runner.run(
        tm.initial_state(), testing.bench_inputs(tm.building, HOURS),
        interp_weather=True, dispatch_days=dispatch_days,
    )
    _check_run(final, zone_T, ref_final, ref_zone_T)
    assert np.ptp(zone_T.numpy()) > 1.0  # the weather moved the zones


def _operand_dict(bb, params):
    """heatx make_hour_march operands by name (one node-height part)."""
    aux = (["front_oh", "front_ohT"] if bb.front_oh.any() else []) + (
        ["back_oh", "back_ohT"] if bb.back_oh.any() else []
    )
    names = (
        pallas_step._NODE_NAMES + pallas_step._SURF_NAMES + ["chunk_count"] + aux
        + ["zone_volume"]
    )
    assert len(names) == len(params)
    return {n: np.asarray(p) for n, p in zip(names, params)}


def _building_dict(b):
    sb = {f.name: getattr(b.surfaces, f.name) for f in dataclasses.fields(b.surfaces)}
    sb["cav_gas"] = tuple(np.asarray(x) for x in sb["cav_gas"])
    fields = {
        f.name: getattr(b, f.name) for f in dataclasses.fields(b)
        if f.name not in ("surfaces", "discretizations")
    }
    cfg = dataclasses.asdict(b.config)
    cfg["dtype"] = np.dtype(cfg["dtype"])
    return dict(fields, surfaces=sb, config=cfg)


def test_convert_runs_port_on_heatx_operands(heatx_run):
    """The port marches heatx's own compiled building and kernel operands
    (block_building(node_split=None), as the port blocks) to heatx's result."""
    tm_hx, ref_final, ref_zone_T = heatx_run
    hb = tm_hx.building
    bb = pallas_step.block_building(hb, block_size=32, node_split=None)
    _, params = pallas_step.make_hour_march(bb, interpret=True, collect_bad=True, **KW)
    building = convert.building_from_arrays(_building_dict(hb))
    own = _port_model().building
    for name in ("node_mask", "mass", "seg_u", "front_alphas", "area", "front_code"):
        np.testing.assert_array_equal(
            getattr(building.surfaces, name), getattr(own.surfaces, name), err_msg=name
        )
    assert building.config.dtype == torch.float64

    tm = ThermalModel.from_building(building, device="cpu")
    runner = tm.fast_runner(block_size=32, **KW)
    runner.params = convert.params_from_kernel_operands(
        _operand_dict(bb, params), bb.n_blocks, dtype=torch.float64
    )
    final, zone_T = runner.run(
        tm.initial_state(), testing.bench_inputs(building, HOURS), interp_weather=True
    )
    _check_run(final, zone_T, ref_final, ref_zone_T)


def test_nonfinite_state_raises_with_hour_and_block():
    tm = _port_model()
    runner = tm.fast_runner(**KW)
    st = tm.initial_state()
    st.node_T[0, 13] = float("nan")  # surface 13 sits in zone 1
    with pytest.raises(FloatingPointError, match="hour 0 .*block"):
        runner.run(st, testing.bench_inputs(tm.building, HOURS))


def _thermostat_model(shaded=False):
    m = testing.build_city_model(2, 4)
    m.add_hvac(IdealHeaterCooler("t0", ["z0"], heat_setpoint=20.0, cool_setpoint=26.0))
    if shaded:
        m.add_zone_shading(ZoneShadingControl("s0_3", "z0", transmittance=0.3, setpoint=24.0))
    return ThermalModel(m, config=SimConfig(dtype=torch.float64), device="cpu")


def _gated_model():
    m = testing.build_city_model(2, 4)
    m.add_vent_control(ZoneVentilationControl("z1", min_indoor=18.0))
    return ThermalModel(m, config=SimConfig(dtype=torch.float64), device="cpu")


@pytest.mark.parametrize(
    "make, exc, match",
    [
        # Parity mode is ported; its adaptive no-mass loop (the default
        # nomass_fixed_iters=None) is not, and heatx's kernel refuses it too.
        (lambda: _port_model().fast_runner(mode="parity"), ValueError, "nomass_fixed_iters.*ROADMAP"),
        # The h/q history and the ventilation gates run; their gradient does
        # not (heatx's adjoint refuses the gates too).
        (lambda: _gated_model().fast_runner(collect_fluxes=True, **KW).chunk_grad(
            lambda p: None, lambda zt, xs: zt.sum()), ValueError, "in-run ventilation gates are not supported"),
        (lambda: _port_model().fast_runner(block_size=512, **KW), NotImplementedError, "ROADMAP"),
        # Thermostats, the operative temperature they are judged by and in-run
        # window shading run; the shading's gradient does not (heatx refuses it).
        (lambda: _thermostat_model(shaded=True).fast_runner(collect_operative=True, **KW).chunk_grad(
            lambda p: None, lambda zt, xs: zt.sum()), ValueError, "chunk_grad: in-run zone shading"),
        # Loads exist only with thermostats: heatx's ValueError, not a missing feature.
        (lambda: _port_model().fast_runner(**KW).run(
            _port_model().initial_state(), testing.bench_inputs(_port_model().building, 24),
            collect_loads=True,
        ), ValueError, "setpoint-driven HVAC"),
    ],
    ids=["parity", "collect_fluxes", "block_over_256", "thermostats", "collect_loads"],
)
def test_not_ported_features_raise(make, exc, match):
    with pytest.raises(exc, match=match):
        make()


@pytest.mark.cuda
def test_fast_runner_on_cuda_matches_heatx(heatx_run):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    _, ref_final, ref_zone_T = heatx_run
    tm = _port_model("cuda")
    final, zone_T = tm.fast_runner(**KW).run(
        tm.initial_state(), testing.bench_inputs(tm.building, HOURS, device="cuda"),
        interp_weather=True,
    )
    _check_run(final, zone_T, ref_final, ref_zone_T)

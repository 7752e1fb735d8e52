"""Does the parity march amplify round-off on a room with a no-mass
insulation layer, the Carroll MRT network and two fixed no-mass iterations?
(ROADMAP C12.)  CPU, f64, both packages.

The room of tests/test_torch_sizing.py (a 60 m3 single-zone box with a 2 x
1.5 m window and a slab on the ground, the sizing model's ideal loads) with
5 cm of polyurethane on its walls, outside (``pc``) or inside (``cp``) the
20 cm of concrete, at ``testing.coarse_config``'s discretization (6 parity
sub-steps an hour) with ``interior_mrt``, on the winter design day of a
``testing.write_synthetic_epw`` year (seed 1).  Hour by hour over ``--days``
days, each package's march is started from its own state and from that
state moved by 1e-13 K (every node and the zone), and the two are compared
after 1, 2 and 8 sub-steps; the packages' states are compared too.  Prints
one line an hour and the worst amplification of each package.

    python3 scripts/torch_c12_probe.py [--wall pc|cp|c] [--days 2] [--heat-sp 18 --cool-sp 21]
"""

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax

jax.config.update("jax_enable_x64", True)
jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

EPS = 1e-13


def room(mod, boundary, surface_def, wall):
    mats = {"pc": [mod.TestMat.polyurethane(0.05), mod.TestMat.concrete(0.2)],
            "cp": [mod.TestMat.concrete(0.2), mod.TestMat.polyurethane(0.05)],
            "c": [mod.TestMat.concrete(0.2)]}[wall]
    m = mod.single_zone_building(mod.SingleZoneOptions(
        zone_volume=60.0, surface_height=3.0, surface_width=5.0, window_height=1.5, window_width=2.0,
        construction=mats))
    m.add_surface(surface_def("slab", "the construction", boundary.ground(), boundary.space_("Space"),
                              vertices=np.array([[0, 0, 0], [0, 4, 0], [5, 4, 0], [5, 0, 0]], float)))
    return m


def main():
    import heatx
    import heatx.testing as hx_testing
    from heatx import sizing as hx_sizing
    from heatx.engine import step as hx_step
    from heatx.model.building import Boundary as HxBoundary
    from heatx.model.building import SurfaceDef as HxSurfaceDef
    from heatx_torch import ThermalModel, sizing, testing
    from heatx_torch.build.layout import B_OUTDOOR
    from heatx_torch.engine import step as step_mod
    from heatx_torch.engine import surface as surf_mod
    from heatx_torch.model.building import Boundary, SurfaceDef
    from heatx_torch.weather import epw, solar

    ap = argparse.ArgumentParser()
    ap.add_argument("--wall", choices=("pc", "cp", "c"), default="pc")
    ap.add_argument("--days", type=int, default=2)
    ap.add_argument("--heat-sp", type=float, default=18.0)
    ap.add_argument("--cool-sp", type=float, default=21.0)
    ap.add_argument("--iters", type=int, default=2)
    args = ap.parse_args()
    torch.set_num_threads(1)

    import tempfile

    with tempfile.TemporaryDirectory() as d:
        w = epw.read_epw(testing.write_synthetic_epw(os.path.join(d, "design.epw"), seed=1))
    day = sizing.design_days_from_epw(w)["winter"]
    hm = hx_sizing._sizing_model(room(hx_testing, HxBoundary, HxSurfaceDef, args.wall), args.heat_sp, args.cool_sp)
    pm = sizing._sizing_model(room(testing, Boundary, SurfaceDef, args.wall), args.heat_sp, args.cool_sp)
    htm = heatx.ThermalModel(hm, config=heatx.SimConfig(
        dtype=jnp.float64, max_dx=0.5, min_dt=900.0, nomass_fixed_iters=args.iters, interior_mrt=True))
    ptm = ThermalModel(pm, config=testing.coarse_config(nomass_fixed_iters=args.iters, interior_mrt=True),
                       device="cpu")
    hb, pb = htm.building, ptm._device()
    sb = ptm.building.surfaces
    ct = np.asarray(sb.cos_tilt, np.float64)
    out_f, out_b = (np.asarray(c) == B_OUTDOOR for c in (sb.front_code, sb.back_code))
    statics = surf_mod.compute_statics(pb.surfaces)
    mrt_static = surf_mod.mrt_statics(pb.surfaces, pb.n_zones)
    mask = np.asarray(hb.surfaces.node_mask)
    f64 = lambda v: torch.tensor(float(v), dtype=torch.float64)  # noqa: E731
    h_sub = jax.jit(lambda b, s, t, i: hx_step.substep(b, s, t, jnp.asarray(day.wind_speed), jnp.asarray(0.0), i))

    def hour_inputs(h):
        h = min(h, 23)
        t0, irh = float(day.dry_bulb_profile[h]), float(day.sky_ir_horizontal()[h])
        lw = lambda sign: solar.longwave_irradiance(  # noqa: E731
            np.array([[irh]]), np.array([[t0]]), sign * ct[None, :])[0]
        kw = dict(t_out=t0, wind_speed=day.wind_speed, ir_front=lw(1.0) * out_f, ir_back=lw(-1.0) * out_b)
        return t0, htm.inputs(**kw), ptm.inputs(**kw)

    def p_sub(s, t0, inputs):
        return step_mod.substep(pb, s, f64(t0), f64(day.wind_speed), f64(0.0), inputs, mrt_static, statics)

    def gap_h(a, b):
        return max(float(np.abs(np.asarray(a.node_T) - np.asarray(b.node_T))[mask].max()),
                   float(np.abs(np.asarray(a.zone_T) - np.asarray(b.zone_T)).max()))

    def gap_p(a, b):
        return max(float((a.node_T - b.node_T).abs().numpy()[mask].max()),
                   float((a.zone_T - b.zone_T).abs().max()))

    h_a, p_a = htm.initial_state(), ptm.initial_state()
    worst = [0.0, 0.0, 0.0]
    for d in range(args.days):
        for h in range(24):
            t0, hin, pin = hour_inputs(h)
            t1, hin1, pin1 = hour_inputs(h + 1) if h < 23 else (t0, hin, pin)
            h_b = h_a._replace(node_T=h_a.node_T + EPS * mask, zone_T=h_a.zone_T + EPS)
            p_b = dataclasses.replace(p_a, node_T=p_a.node_T + EPS * torch.as_tensor(mask), zone_T=p_a.zone_T + EPS)
            hr, pr = h_a, p_a
            rows = []
            for k in range(8):
                ti, hi_, pi_ = (t0, hin, pin) if k < 6 else (t1, hin1, pin1)
                hr, pr = h_sub(hb, hr, jnp.asarray(ti), hi_), p_sub(pr, ti, pi_)
                h_b, p_b = h_sub(hb, h_b, jnp.asarray(ti), hi_), p_sub(p_b, ti, pi_)
                rows.append((gap_h(hr, h_b), gap_p(pr, p_b)))
                if k == 5:
                    h_a, p_a = hr, pr  # the hour's end state
            worst[:2] = [max(worst[0], max(r[0] for r in rows)), max(worst[1], max(r[1] for r in rows))]
            between = max(float(np.abs(np.asarray(h_a.node_T) - p_a.node_T.numpy())[mask].max()),
                          float(np.abs(np.asarray(h_a.zone_T) - p_a.zone_T.numpy()).max()))
            worst[2] = max(worst[2], between)
            print(f"day {d} hour {h:2d} zone {float(h_a.zone_T[0]):8.4f} C; a {EPS:g} K move after 1/2/8 "
                  f"sub-steps: heatx {rows[0][0]:.1e} {rows[1][0]:.1e} {rows[7][0]:.1e}, port {rows[0][1]:.1e} "
                  f"{rows[1][1]:.1e} {rows[7][1]:.1e}; heatx vs port {between:.1e} K", flush=True)
    print(f"wall {args.wall}: the worst 8-sub-step gap of a {EPS:g} K move: heatx {worst[0]:.3e} K, "
          f"port {worst[1]:.3e} K ({worst[0] / EPS:.1f}x and {worst[1] / EPS:.1f}x); the packages' states at most "
          f"{worst[2]:.3e} K apart")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""The TR-BDF2 day adjoint kernel (heatx_torch/csrc/day_adjoint_tr.cu) on one
NVIDIA GPU: every kind in f64 against the plain adjoint, then the bench
city's recompute against the forward kernel and its day-launch.  The
quickest check after a change to the kernel.  Run from the repository root:

    python3 scripts/torch_adjoint_check.py [--no-bench]

It builds both kernel libraries (printing the TR-BDF2 adjoint's ptxas lines
and the build time), then for each small building and cadence below (every
kind: free-float, thermostats with mixing, scheduled setpoints, gas
cavities, interior MRT, MRT with cavities; blocks of 16 lanes, of a part
warp, of 64 lanes and of 256 lanes with a 32-node wall, and of 64 zones with
2-node panes at 144 sub-steps an hour) runs one adjoint
launch on seeded inputs, start state and cotangents and holds every output
to 1e-9 of the plain adjoint's largest magnitude.  On the bench city (f32
and f64, trbdf2_refresh k=2, 8 sub-steps, 24 h) it prints the largest gap
between the adjoint's recomputed hour-start states and the forward kernel's
states at the same hours (the forward marched hour by hour; its 24 one-hour
launches are first checked bit-equal to its one-day launch), and the f32
adjoint day-launch (CUDA events, 10 reps) with its launch variant.  Exits
non-zero on a failed check.
"""

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

TOL = 1e-9  # of the plain adjoint's max |ref|, per output
NAMES = ("dT0", "d_zT0", "d_node", "d_surf", "d_zv", "d_chan", "d_a", "d_b", "d_ctl", "d_sp_heat", "d_sp_cool",
         "d_mrt")


def cases(torch, testing, SimConfig):
    f64 = SimConfig(dtype=torch.float64)
    mrt = SimConfig(dtype=torch.float64, interior_mrt=True)
    k2, k1, frozen = ("trbdf2_refresh", 2), ("trbdf2_refresh", 1), ("trbdf2", None)
    return [  # name, model, config, (mode, k), block size, hours, sub-steps, scheduled setpoints
        ("4-zone city, k=2, 16 lanes", testing.build_city_model(4, 10), f64, k2, 16, 3, 8, False),
        ("4-zone city, k=1, 10 lanes (part-warp blocks)", testing.build_city_model(4, 10), f64, k1, 10, 2, 4, False),
        ("4-zone city, frozen", testing.build_city_model(4, 10), f64, frozen, None, 3, 8, False),
        ("mixed boundaries, k=1", testing.build_mixed_model(), f64, k1, None, 2, 4, False),
        ("thermostats and mixing, k=2", testing.build_thermostat_model(), f64, k2, None, 2, 4, False),
        ("thermostats, scheduled, frozen", testing.build_thermostat_model(), f64, frozen, None, 2, 4, True),
        ("cavity model, k=2", testing.build_cavity_model(), f64, k2, None, 2, 4, False),
        ("glazed city, frozen", testing.build_glazed_city(4, 3), f64, frozen, None, 2, 4, False),
        ("two-zone MRT, k=2", testing.build_two_zone_model(), mrt, k2, None, 2, 4, False),
        ("glazed city with MRT, k=1", testing.build_glazed_city(4, 3), mrt, k1, None, 2, 4, False),
        ("50 surfaces, 32 nodes, k=2", testing.build_wide_zone_model(50), f64, k2, None, 2, 4, False),
        ("50 surfaces, 32 nodes, thermostat, frozen", testing.build_wide_zone_model(50, thermostat=True), f64,
         frozen, None, 2, 4, False),
        ("256 surfaces, 32 nodes, k=2", testing.build_wide_zone_model(), f64, k2, None, 2, 4, False),
        ("64 zones in a 64-lane block, 2 nodes, thermostats, 144 sub-steps, k=2", testing.build_zone_chain_model(),
         f64, k2, None, 2, 144, False),
        ("64 zones in a 64-lane block, 2 nodes, thermostats, 144 sub-steps, frozen",
         testing.build_zone_chain_model(), f64, frozen, None, 2, 144, False),
    ]


def operands(torch, day_march, day_adjoint, compile_building, model, config, mode, k, block_size, hours, sub,
             sched, device, seed=0):
    """Seeded inputs, start state and cotangents of one case: (adjoint, its
    kernel arguments, its keywords)."""
    b = compile_building(model, n=1, config=config)
    sub = sub or b.dt_subdivisions  # parity: the building's own
    bb = day_march.block_building(b, block_size=block_size) if block_size else day_march.block_building(b)
    lay, S, Z, mask = bb.layout, b.n_surfaces, b.n_zones, b.surfaces.node_mask
    rng = np.random.default_rng(seed)

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=config.dtype, device=device)

    def lanes(a):
        return dev(np.stack([lay.surfaces_to_blocked(x) for x in a]))

    def zones(a):
        return dev(np.stack([lay.zones_to_blocked(x) for x in a]))

    hi = tuple(dev(rng.uniform(lo, hi_, hours * sub)) for lo, hi_ in ((-5, 15), (0, 8), (0, 6.28))) + (
        lanes(rng.uniform(0, 400, (hours, S))), lanes(rng.uniform(0, 50, (hours, S))),
        lanes(rng.uniform(250, 400, (hours, S))), lanes(rng.uniform(250, 400, (hours, S))),
        zones(rng.uniform(0, 900, (hours, Z))), zones(rng.uniform(0, 50, (hours, Z))))
    if sched:
        hi = hi + (zones(rng.uniform(18, 23, (hours, Z))), zones(rng.uniform(24, 27, (hours, Z))))
    # A random start state: away from the |dT| = 0 kink of the cube root.
    T0 = dev(lay.surfaces_to_blocked(np.where(mask, rng.uniform(15, 25, mask.shape), 0.0)))
    zT0 = dev(lay.zones_to_blocked(rng.uniform(18, 24, Z)))
    cots = [dev(lay.surfaces_to_blocked(rng.normal(size=mask.shape))), dev(lay.zones_to_blocked(rng.normal(size=Z))),
            zones(rng.normal(size=(hours, Z)))]
    _, params = day_march.make_hour_march(bb, substeps=sub, mode=mode, hours=hours, refresh_every=k, device=device,
                                          scheduled_setpoints=sched)
    if params.ctl is not None:
        cots.append(zones(rng.normal(size=(hours, Z)) * 1e-3))
    adj = day_adjoint.make_day_adjoint(bb, substeps=sub, mode=mode, hours=hours, refresh_every=k, device=device,
                                       scheduled_setpoints=sched)
    return adj, adj._args(params, T0, zT0, hi, cots), adj._hm._kw(observables=False)


def check(torch, testing, SimConfig, compile_building, day_march, day_adjoint, device="cuda", log=print,
          cases=cases):
    """Every case of ``cases``, the adjoint kernel against the plain adjoint
    in f64; returns the worst gap (relative to each output's max |ref|)."""
    kern = day_adjoint.day_adjoint_kernel
    worst = 0.0
    for name, model, config, (mode, k), block_size, hours, sub, sched in cases(torch, testing, SimConfig):
        _, args, kw = operands(torch, day_march, day_adjoint, compile_building, model, config, mode, k, block_size,
                               hours, sub, sched, device)
        before = kern.launches
        got = kern(*args, **kw)
        ref = day_adjoint.plain_day_adjoint(*args, **kw)
        if device != "cpu":
            torch.cuda.synchronize()
        if kern.launches != before + 1:
            raise AssertionError(f"{name}: the kernel did not launch")
        err = 0.0
        for out, x, y in zip(NAMES, got, ref):
            if (x is None) != (y is None):
                raise AssertionError(f"{name}: {out} present on one side only")
            if x is None:
                continue
            if not bool(torch.isfinite(x).all()):
                raise AssertionError(f"{name}: {out} not finite")
            scale = float(y.abs().max())
            d = float((x - y).abs().max())
            err = max(err, d / scale if scale else d)
        if not err <= TOL:
            raise AssertionError(f"{name}: adjoint kernel vs plain max |d| / max |ref| {err:.3e} > {TOL:g}")
        worst = max(worst, err)
        log(f"{name} ({args[0].block_size} lanes x {args[0].n_blocks} blocks, N={args[0].max_nodes}, "
            f"variant G=4/{kern.block_threads}): {err:.3e}", flush=True)
    return worst


def bench_recompute(torch, testing, SimConfig, ThermalModel, day_adjoint, dtype):
    """The bench city's day (trbdf2_refresh k=2): chip_smoke.recompute_gap,
    the largest |d| between the adjoint's hour-start states and the forward
    kernel's at the same hours, node and zone T.  Returns (gap T, gap zT,
    the adjoint's f32 day-launch ms or None)."""
    from chip_smoke import event_ms, recompute_gap

    kw = dict(mode="trbdf2_refresh", substeps=8, refresh_every=2)
    tm = ThermalModel(testing.build_city_model(1000, 10), n=1, config=SimConfig(dtype=dtype), device="cuda")
    r24 = tm.fast_runner(hours=24, **kw)
    T, zT = r24.to_blocked(tm.initial_state())
    hi = r24.kernel_inputs(testing.bench_inputs(tm.building, 24, device="cuda"), interp_weather=True)[0]
    adj = day_adjoint.make_day_adjoint(r24._bb, hours=24, **kw)
    NB, ZB = r24._bb.n_blocks, r24._bb.zones_per_block
    d_hist = torch.as_tensor(np.random.default_rng(3).normal(size=(24, NB, ZB)) / (24 * 1000), dtype=dtype,
                             device="cuda")
    cots = (torch.zeros_like(T), torch.zeros_like(zT), d_hist)
    gap_T, gap_z = recompute_gap(torch, day_adjoint, adj, r24, tm.fast_runner(hours=1, **kw), T, zT, hi, cots)
    ms = event_ms(torch, lambda: adj(r24.params, T, zT, hi, cots), 10) if dtype == torch.float32 else None
    return gap_T, gap_z, ms


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_adjoint_check: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import card_facts, ptxas_table
    from heatx_torch import SimConfig, ThermalModel, testing
    from heatx_torch.build.layout import compile_building
    from heatx_torch.ops import cuda_lib, day_adjoint, day_march

    print(card_facts(), flush=True)
    t0 = time.time()
    cuda_lib.build_many([("heatx_day_march", day_march.KERNEL_SOURCES),
                         ("heatx_day_adjoint", day_adjoint.KERNEL_SOURCES)])
    table = ptxas_table(cuda_lib.build_log("heatx_day_adjoint", day_adjoint.KERNEL_SOURCES))
    print(f"build {time.time() - t0:.1f} s; TR-BDF2 adjoint ptxas: "
          + " | ".join(e for e in table.split(" | ") if "parity=0" in e), flush=True)
    worst = check(torch, testing, SimConfig, compile_building, day_march, day_adjoint)
    print(f"torch_adjoint_check: every kind within {TOL:g} of max |ref| (worst {worst:.3e})", flush=True)
    if "--no-bench" not in sys.argv:
        for dtype in (torch.float32, torch.float64):
            gap_T, gap_z, ms = bench_recompute(torch, testing, SimConfig, ThermalModel, day_adjoint, dtype)
            print(f"bench city {str(dtype)[6:]}: the adjoint's hour starts vs the forward kernel's states, max |d| "
                  f"T {gap_T:.3e} K, zone T {gap_z:.3e} K"
                  + ("" if ms is None else f"; adjoint day-launch {ms:.3f} ms (variant "
                     f"G=4/{day_adjoint.day_adjoint_kernel.block_threads})"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

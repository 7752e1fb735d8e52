#!/usr/bin/env python3
"""The parity day adjoint kernel (heatx_torch/csrc/day_adjoint_parity.cu) on
one NVIDIA GPU: every kind in f64 against the plain adjoint, then the bench
city's recompute against the forward kernel and its day-launch.  The
quickest check after a change to the kernel.  Run from the repository root:

    python3 scripts/torch_parity_adjoint_check.py [--no-bench]

It builds both kernel libraries (printing the parity adjoint's ptxas lines
and the build time), then for each small building below in parity mode
(testing.coarse_config: 6 sub-steps an hour on the bench constructions; every
kind: free-float, thermostats with mixing, scheduled setpoints, gas cavities,
interior MRT, MRT with cavities; 1, 2 and 3 fixed no-mass iterations; no-mass
runs of one and two nodes and of three and four (Thomas); blocks of 16 lanes,
of a part warp, of 64 lanes and of 256 lanes with a 32-node wall) runs one adjoint launch on
seeded inputs, start state and cotangents (scripts/torch_adjoint_check.py
operands), then one on 72 zones with 2-node panes in one block at their 118
sub-steps an hour (the most zone rows the one-thread kernel it replaced took;
chip_smoke.parity_zone_rows), and holds every output to 1e-9 of the plain
adjoint's largest magnitude.  On
the bench city in parity mode (f32 and f64, 118 sub-steps an hour, one
no-mass iteration, 24 h) it prints the largest gap between the adjoint's
recomputed hour-start states and the forward kernel's states at the same
hours (the forward marched hour by hour; its 24 one-hour launches are first
checked bit-equal to its one-day launch), and the f32 adjoint day-launch
(CUDA events, 2 reps) with its launch variant.  Exits non-zero on a failed
check.
"""

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_adjoint_check import TOL, check  # noqa: E402


def cases(torch, testing, SimConfig):
    def coarse(iters, **kw):
        return testing.coarse_config(torch.float64, iters, **kw)

    parity = ("parity", None)
    return [  # name, model, config, (mode, k), block size, hours, sub-steps (None: the building's), scheduled
        ("4-zone city, 1 iteration, 16 lanes", testing.build_city_model(4, 10), coarse(1), parity, 16, 2, None,
         False),
        ("4-zone city, 2 iterations", testing.build_city_model(4, 10), coarse(2), parity, None, 2, None, False),
        ("4-zone city, 3 iterations, 10 lanes (part-warp blocks)", testing.build_city_model(4, 10), coarse(3),
         parity, 10, 2, None, False),
        ("mixed boundaries, 2 iterations", testing.build_mixed_model(), coarse(2), parity, None, 2, None, False),
        ("no-mass runs of 3 and 4 nodes, 1 iteration", testing.build_nomass_run_model(), coarse(1), parity, None, 2,
         None, False),
        ("no-mass runs of 3 and 4 nodes, 3 iterations", testing.build_nomass_run_model(), coarse(3), parity, None,
         2, None, False),
        ("thermostats and mixing, 2 iterations", testing.build_thermostat_model(), coarse(2), parity, None, 2, None,
         False),
        ("thermostats, scheduled, 1 iteration", testing.build_thermostat_model(), coarse(1), parity, None, 2, None,
         True),
        ("cavity model, 1 iteration", testing.build_cavity_model(), coarse(1), parity, None, 2, None, False),
        ("cavity model, 3 iterations", testing.build_cavity_model(), coarse(3), parity, None, 2, None, False),
        ("glazed city, 2 iterations", testing.build_glazed_city(4, 3), coarse(2), parity, None, 2, None, False),
        ("two-zone MRT, 2 iterations", testing.build_two_zone_model(), coarse(2, interior_mrt=True), parity, None, 2,
         None, False),
        ("glazed city with MRT, 1 iteration", testing.build_glazed_city(4, 3), coarse(1, interior_mrt=True), parity,
         None, 2, None, False),
        ("50 surfaces, 1 iteration", testing.build_wide_zone_model(50), coarse(1), parity, None, 2, None, False),
        ("50 surfaces, thermostat, 2 iterations", testing.build_wide_zone_model(50, thermostat=True), coarse(2),
         parity, None, 2, None, False),
        ("256 surfaces, 1 iteration", testing.build_wide_zone_model(), coarse(1), parity, None, 2, None, False),
    ]


def bench_recompute(torch, testing, SimConfig, ThermalModel, day_adjoint, dtype):
    """The bench city's parity day (chip_smoke.parity_recompute_gap): the
    largest |d| between the adjoint's hour-start states and the forward
    kernel's at the same hours, node and zone T; and in f32 the adjoint's
    day-launch ms.  Returns (gap T, gap zT, ms or None)."""
    from chip_smoke import event_ms, parity_recompute_gap

    model = testing.build_city_model(1000, 10)
    gap_T, gap_z = parity_recompute_gap(torch, testing, SimConfig, ThermalModel, day_adjoint, model, dtype)
    ms = None
    if dtype == torch.float32:
        tm = ThermalModel(model, n=1, config=SimConfig(dtype=dtype, nomass_fixed_iters=1), device="cuda")
        r24 = tm.fast_runner(mode="parity", hours=24)
        T, zT = r24.to_blocked(tm.initial_state())
        hi = r24.kernel_inputs(testing.bench_inputs(tm.building, 24, device="cuda"), interp_weather=True)[0]
        adj = day_adjoint.make_day_adjoint(r24._bb, substeps=tm.dt_subdivisions, mode="parity", hours=24)
        NB, ZB = r24._bb.n_blocks, r24._bb.zones_per_block
        d_hist = torch.as_tensor(np.random.default_rng(3).normal(size=(24, NB, ZB)) / (24 * NB * ZB), dtype=dtype,
                                 device="cuda")
        cots = (torch.zeros_like(T), torch.zeros_like(zT), d_hist)
        ms = event_ms(torch, lambda: adj(r24.params, T, zT, hi, cots), 2)
    return gap_T, gap_z, ms


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_parity_adjoint_check: no CUDA device", file=sys.stderr)
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
    print(f"build {time.time() - t0:.1f} s; parity adjoint ptxas: "
          + " | ".join(e for e in table.split(" | ") if "parity=1" in e), flush=True)
    worst = check(torch, testing, SimConfig, compile_building, day_march, day_adjoint, cases=cases)
    from chip_smoke import PARITY_CHAIN_ZONES, parity_zone_rows

    chain, (lanes, zones, nodes, sub, variant) = parity_zone_rows(torch, day_adjoint, testing, ThermalModel, SimConfig)
    print(f"{PARITY_CHAIN_ZONES} zones ({lanes} lanes, {zones} zone slots, N={nodes}) at {sub} sub-steps, one "
          f"iteration (variant {variant}): {chain:.3e}", flush=True)
    worst = max(worst, chain)
    print(f"torch_parity_adjoint_check: every kind within {TOL:g} of max |ref| (worst {worst:.3e})", flush=True)
    if "--no-bench" not in sys.argv:
        for dtype in (torch.float32, torch.float64):
            gap_T, gap_z, ms = bench_recompute(torch, testing, SimConfig, ThermalModel, day_adjoint, dtype)
            print(f"bench city parity {str(dtype)[6:]}: the adjoint's hour starts vs the forward kernel's states, "
                  f"max |d| T {gap_T:.3e} K, zone T {gap_z:.3e} K"
                  + ("" if ms is None else f"; adjoint day-launch {ms:.3f} ms (variant "
                     f"G=4/{day_adjoint.day_adjoint_kernel.block_threads})"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

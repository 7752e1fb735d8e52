#!/usr/bin/env python3
"""The TR-BDF2 day-march kernel (heatx_torch/csrc/day_march_tr.cu) on one
NVIDIA GPU, every kind at every group size, in f64 against its plain
version: the quickest check after a change to the kernel.  Run from the
repository root:

    python3 scripts/torch_tr_check.py

It builds the day-march library (printing the ptxas lines of the TR-BDF2
instantiations and the build time), then for each small building and
cadence below (blocks of whole warps and of a part warp, more zones than
warps in a block), each kind (free-float, thermostats and mixing, schedules,
gas cavities, interior MRT with the h/q and operative histories, MRT with
cavities, the in-run shading and ventilation gates, one zone of 50
surfaces (a 64-lane block) and one of 256 surfaces, each with a 32-node
wall, free-float and with a thermostat) and each
group size of ``day_march.GROUP_MAX_THREADS`` (the wrapper takes 4 where a
group does not fit the block), marches 3 h on the card and on the plain
version from the same state and inputs and holds every output to 1e-9 K
(loads to 1e-9 of their largest magnitude).  Exits non-zero on a failed
check.  ~2 min on an H100, most of it the build and the plain versions.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

TOL = 1e-9
HOURS = 3


def cases(torch, testing, SimConfig):
    f64 = dict(dtype=torch.float64)
    k2 = dict(mode="trbdf2_refresh", substeps=8, refresh_every=2)
    frozen = dict(mode="trbdf2", substeps=8)
    bench = (testing.bench_inputs, dict(interp_weather=True), {})
    demand = (testing.demand_inputs, {}, {})
    return [
        ("4-zone city, k=2, 16 lanes", testing.build_city_model(4, 10), f64, dict(k2, block_size=16), bench),
        ("4-zone city, frozen", testing.build_city_model(4, 10), f64, frozen, bench),
        ("4-zone city, 10 lanes (part-warp blocks)", testing.build_city_model(4, 10), f64, dict(k2, block_size=10),
         bench),
        ("20 zones of 2 surfaces, 16 zones a block", testing.build_city_model(20, 2), f64, k2, bench),
        ("thermostats and mixing, k=2", testing.build_thermostat_model(), f64, k2, demand),
        ("thermostats, scheduled, frozen", testing.build_thermostat_model(False), f64,
         dict(frozen, scheduled_setpoints=True), demand),
        ("glazed city, k=2", testing.build_glazed_city(4, 10), f64, k2, bench),
        ("cavity model, k=1", testing.build_cavity_model(), f64, dict(k2, refresh_every=1), bench),
        ("two-zone MRT with histories, k=2", testing.build_two_zone_model(), dict(f64, interior_mrt=True),
         dict(k2, collect_operative=True, collect_fluxes=True), bench),
        ("4-zone city, h/q history only", testing.build_city_model(4, 10), f64, dict(k2, collect_fluxes=True), bench),
        ("glazed city with MRT, k=2", testing.build_glazed_city(2, 6), dict(f64, interior_mrt=True),
         dict(k2, collect_operative=True), bench),
        ("controlled city (shading, gates), k=2", testing.build_controlled_city(2, 3), f64, k2,
         (testing.controlled_city_inputs, {}, dict(shade_sp=20.0))),
        ("50 surfaces, 32 nodes, k=2", testing.build_wide_zone_model(50), f64, k2, bench),
        ("256 surfaces, 32 nodes, k=2", testing.build_wide_zone_model(), f64, k2, bench),
        ("256 surfaces, 32 nodes, thermostat, frozen", testing.build_wide_zone_model(thermostat=True), f64,
         frozen, demand),
    ]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_tr_check: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import card_facts, ptxas_table
    from heatx_torch import SimConfig, ThermalModel, testing
    from heatx_torch.ops import cuda_lib, day_march

    print(card_facts(), flush=True)
    t0 = time.time()
    day_march.load_kernel()
    table = ptxas_table(cuda_lib.build_log("heatx_day_march", day_march.KERNEL_SOURCES))
    print(f"build {time.time() - t0:.1f} s; TR-BDF2 ptxas: "
          + " | ".join(e for e in table.split(" | ") if "parity=0" in e), flush=True)
    kern = day_march.day_march_kernel
    worst = 0.0
    for name, model, cfg, kw, (inputs, runkw, extra) in cases(torch, testing, SimConfig):
        tm = ThermalModel(model, n=1, config=SimConfig(**cfg), device="cuda")
        r = tm.fast_runner(hours=HOURS, **kw)
        seq = inputs(tm.building, HOURS, device="cuda").replace(**extra)
        T, zT = r.to_blocked(tm.initial_state())
        hi = r.kernel_inputs(seq, **runkw)[0]
        ops, gates = r.hour_march._operands(r.params, T, zT, hi)
        ref = day_march.plain_day_march(r.params, *ops, **r.hour_march._kw(), **gates)
        row = []
        for group in day_march.GROUP_MAX_THREADS:
            kern.group = group
            before = kern.launches
            got = kern(r.params, *ops, **r.hour_march._kw(), **gates)
            torch.cuda.synchronize()
            if kern.launches != before + 1:
                raise AssertionError(f"{name}: the kernel did not launch")
            err = 0.0
            for i, (x, y) in enumerate(zip(got, ref)):
                if (x is None) != (y is None):
                    raise AssertionError(f"{name}: output {i} present on one side only")
                if x is None:
                    continue
                d = float((x - y).abs().max())
                if i == 5:  # the load history, W: relative to its largest magnitude
                    d /= max(float(y.abs().max()), 1e-30)
                err = max(err, d)
            if not err <= TOL:
                raise AssertionError(f"{name}, G={group}: kernel vs plain max |d| {err:.3e} > {TOL:g}")
            used = day_march.threads_per_surface(r.params.block_size, group)
            row.append(f"G={group}" + (f" (ran {used})" if used != group else "") + f" {err:.3e}")
            worst = max(worst, err)
        kern.group = None
        print(f"{name} ({r.params.block_size} lanes x {r.params.n_blocks} blocks, N={r.params.max_nodes}): "
              + ", ".join(row), flush=True)
    print(f"torch_tr_check: every kind at every group within {TOL:g} (worst {worst:.3e})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

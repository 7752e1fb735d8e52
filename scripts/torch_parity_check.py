#!/usr/bin/env python3
"""The parity day-march kernel (heatx_torch/csrc/day_march_parity.cu) on one
NVIDIA GPU, every kind in f64 against its plain version: the quickest check
after a change to the kernel.  Run from the repository root:

    python3 scripts/torch_parity_check.py [--only TEXT]

It builds the day-march library (printing the ptxas lines of the parity
instantiations and the build time), then for each small building below
(blocks of whole warps and of a part warp, no-mass runs of three and four
nodes, gas cavities, thermostats and mixing, interior MRT with the h/q and
operative histories, the in-run shading and ventilation gates, one zone of
50 surfaces (a 64-lane block) and one of 256 (a 1024-thread block)) and
each no-mass loop (one iteration, two, and the adaptive loop), marches 2 h
at the coarse discretization (6 sub-steps an hour; the zones' wall then has
8 nodes), and the 256-surface zone 1 h at the default one (118 sub-steps,
a 32-node wall), on the card and on the plain version from the same state and inputs
and holds every output to 1e-9 K (loads to 1e-9 of their largest
magnitude).  ``--only TEXT`` runs only the cases whose name holds TEXT.
Exits non-zero on a failed check.  ~2 min on an H100, most of it the build
and the plain versions.
"""

import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

TOL = 1e-9
HOURS = 2
#: The no-mass loops: a fixed iteration count, or None for the adaptive loop.
LOOPS = (1, 2, None)


def cases(testing):
    bench = (testing.bench_inputs, dict(interp_weather=True), {})
    demand = (testing.demand_inputs, {}, {})
    return [
        ("4-zone city, 16 lanes", lambda: testing.build_city_model(4, 10), {}, dict(block_size=16), bench),
        ("4-zone city, 10 lanes (part-warp blocks)", lambda: testing.build_city_model(4, 10), {},
         dict(block_size=10), bench),
        ("mixed building", testing.build_mixed_model, {}, {}, bench),
        ("no-mass runs of 3 and 4 nodes", testing.build_nomass_run_model, {}, {}, bench),
        ("thermostats and mixing", testing.build_thermostat_model, {}, {}, demand),
        ("thermostats, scheduled", lambda: testing.build_thermostat_model(False), {},
         dict(scheduled_setpoints=True), demand),
        ("glazed city", lambda: testing.build_glazed_city(4, 10), {}, {}, bench),
        ("cavity model", testing.build_cavity_model, {}, {}, bench),
        ("two-zone MRT with histories", testing.build_two_zone_model, dict(interior_mrt=True),
         dict(collect_operative=True, collect_fluxes=True), bench),
        ("glazed city with MRT", lambda: testing.build_glazed_city(2, 6), dict(interior_mrt=True),
         dict(collect_operative=True), bench),
        ("controlled city (shading, gates)", lambda: testing.build_controlled_city(2, 3), {}, {},
         (testing.controlled_city_inputs, {}, dict(shade_sp=20.0))),
        ("50 surfaces, 8 nodes", lambda: testing.build_wide_zone_model(50), {}, {}, bench),
        ("256 surfaces, 8 nodes", testing.build_wide_zone_model, {}, {}, bench),
        ("256 surfaces, 8 nodes, thermostat", lambda: testing.build_wide_zone_model(thermostat=True), {}, {},
         demand),
        # Without the adaptive loop: on this wall's back face it runs to its
        # cap on a slowly decaying oscillation and amplifies round-off (the
        # plain version moved by 1e-12 K at the start ends the hour 1.7e-2 K
        # away from itself; ROADMAP C2).
        ("256 surfaces, 32 nodes at 118 sub-steps an hour, 1 h", testing.build_wide_zone_model,
         dict(full=True, loops=(1, 2)), {}, bench),
    ]


def check(torch, testing, ThermalModel, SimConfig, day_march, device="cuda", only="", loops=LOOPS, log=print):
    """Every case x loop, kernel against plain in f64; returns the worst gap."""
    kern = day_march.day_march_kernel
    worst = 0.0
    for name, build, cfg, kw, (inputs, runkw, extra) in cases(testing):
        if only not in name:
            continue
        row = []
        cfg = dict(cfg)
        full = cfg.pop("full", False)  # the default discretization, an hour
        allowed = cfg.pop("loops", loops)
        for iters in [i for i in loops if i in allowed]:
            config = (SimConfig(dtype=torch.float64, nomass_fixed_iters=iters) if full else
                      testing.coarse_config(torch.float64, iters, **cfg))
            hours = 1 if full else HOURS
            tm = ThermalModel(build(), config=config, device=device)
            r = tm.fast_runner(mode="parity", hours=hours, **kw)
            seq = inputs(tm.building, hours, device=device).replace(**extra)
            T, zT = r.to_blocked(tm.initial_state())
            hi = r.kernel_inputs(seq, **runkw)[0]
            ops, gates = r.hour_march._operands(r.params, T, zT, hi)
            ref = day_march.plain_day_march(r.params, *ops, **r.hour_march._kw(), **gates)
            before = kern.launches
            got = kern(r.params, *ops, **r.hour_march._kw(), **gates)
            if device != "cpu":
                torch.cuda.synchronize()
            if kern.launches != before + 1:
                raise AssertionError(f"{name}: the kernel did not launch")
            err = 0.0
            for i, (x, y) in enumerate(zip(got, ref)):
                if (x is None) != (y is None):
                    raise AssertionError(f"{name}: output {i} present on one side only")
                if x is None:
                    continue
                if isinstance(x, tuple):
                    x, y = torch.stack(x), torch.stack(y)
                d = float((x - y).abs().max())
                if i == 5:  # the load history, W: relative to its largest magnitude
                    d /= max(float(y.abs().max()), 1e-30)
                err = max(err, d)
            loop = "adaptive" if iters is None else f"{iters} iteration{'s' * (iters > 1)}"
            if not err <= TOL:
                raise AssertionError(f"{name}, {loop}: kernel vs plain max |d| {err:.3e} > {TOL:g}")
            row.append(f"{loop} {err:.3e}")
            worst = max(worst, err)
        log(f"{name} ({r.params.block_size} lanes x {r.params.n_blocks} blocks, N={r.params.max_nodes}, "
            f"{kern.block_threads} threads a block): " + ", ".join(row), flush=True)
    return worst


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_parity_check: no CUDA device", file=sys.stderr)
        return 2
    os.environ["HEATX_KERNEL_WHILE"] = "1"  # the adaptive loop, as heatx gates it
    from chip_smoke import card_facts, ptxas_table
    from heatx_torch import SimConfig, ThermalModel, testing
    from heatx_torch.ops import cuda_lib, day_march

    args = sys.argv[1:]
    only = args[args.index("--only") + 1] if "--only" in args else ""
    print(card_facts(), flush=True)
    t0 = time.time()
    day_march.load_kernel()
    table = ptxas_table(cuda_lib.build_log("heatx_day_march", day_march.KERNEL_SOURCES))
    print(f"build {time.time() - t0:.1f} s; parity ptxas: "
          + " | ".join(e for e in table.split(" | ") if "parity=1" in e), flush=True)
    worst = check(torch, testing, ThermalModel, SimConfig, day_march, only=only)
    print(f"torch_parity_check: every kind in every loop within {TOL:g} (worst {worst:.3e})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where the TR-BDF2 day-march kernel's time goes, on one NVIDIA GPU, f32,
the bench city (testing.build_city_model, synthetic weather) at the
kernel's default threads per surface.  Run from the repository root:

    python3 scripts/torch_tr_costs.py

1. One day-launch (CUDA events, 10 reps after a warm-up) at sub-steps per
   hour x refresh cadence (4, 2), (8, 1), (8, 2), (8, 4), (8, 8), (16, 2),
   and a least-squares fit ms = c0 + c_sub * sub-steps + c_ref * operator
   builds per launch: the price of a sub-step and of an operator build.
2. The k=2 day-launch at 1000, 396, 264 and 132 zones (334, 132, 88 and 44
   blocks of 32 lanes on 132 SMs): whether the time follows the blocks (the
   SMs' issue) or stays with one block's chain.
3. The annual run (8760 h, trbdf2_refresh k=2, 8 sub-steps, FastRunner.run,
   the main path) by the host clock, then once more under torch.profiler:
   the device's busy time as a share of the first run's wall (as
   chip_smoke.py's phase 11c), the kernel's part of it, and the host's time
   per simulated day beyond the device's.

Prints the card's name and power limit first.  ~2 min on an H100.
"""

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_tr_costs: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import card_facts, device_time, event_ms
    from heatx_torch import SimConfig, ThermalModel, testing
    from heatx_torch.ops import day_march

    print(card_facts(), flush=True)
    day_march.load_kernel()
    cfg = SimConfig(dtype=torch.float32)

    def launch_ms(tm, substeps, k, reps=10):
        r = tm.fast_runner(mode="trbdf2_refresh", substeps=substeps, hours=24, refresh_every=k)
        T, zT = r.to_blocked(tm.initial_state())
        hi = r.kernel_inputs(testing.bench_inputs(tm.building, 24, device="cuda"), interp_weather=True)[0]
        return event_ms(torch, lambda: r.hour_march(r.params, T, zT, hi), reps), r

    tm = ThermalModel(testing.build_city_model(1000, 10), config=cfg, device="cuda")
    rows = []
    for sub, k in ((4, 2), (8, 1), (8, 2), (8, 4), (8, 8), (16, 2)):
        ms, r = launch_ms(tm, sub, k)
        rows.append((24 * sub, 24 * sub // k, ms))
    A = np.array([[1.0, s, b] for s, b, _ in rows])
    y = np.array([ms for *_, ms in rows])
    coef, *_ = np.linalg.lstsq(A, y, rcond=None)
    resid = float(np.abs(A @ coef - y).max())
    group = day_march.threads_per_surface(r.layout.block_size)
    print(f"1. bench city f32, {r.layout.n_blocks} blocks x {r.layout.block_size} lanes, {group} threads per "
          "surface; day-launch ms by (sub-steps, operator builds): "
          + ", ".join(f"({s}, {b}) {ms:.3f}" for s, b, ms in rows)
          + f"; fit: {coef[0] * 1e3:.1f} us + {coef[1] * 1e3:.3f} us per sub-step + {coef[2] * 1e3:.3f} us per "
          f"operator build (largest residual {resid * 1e3:.1f} us)", flush=True)

    by_zones = []
    for zones in (1000, 396, 264, 132):
        tz = ThermalModel(testing.build_city_model(zones, 10), config=cfg, device="cuda")
        ms, rz = launch_ms(tz, 8, 2)
        by_zones.append(f"{zones} zones, {rz.layout.n_blocks} blocks: {ms:.3f} ms")
    print("2. k=2 day-launch by city size: " + "; ".join(by_zones), flush=True)

    runner = tm.fast_runner(mode="trbdf2_refresh", substeps=8, hours=24, refresh_every=2)
    state0 = tm.initial_state()
    inputs = testing.bench_inputs(tm.building, 8760, device="cuda")
    runner.run(state0, testing.bench_inputs(tm.building, 48, device="cuda"), interp_weather=True)
    torch.cuda.synchronize()
    t0 = time.time()
    runner.run(state0, inputs, interp_weather=True)
    torch.cuda.synchronize()
    wall = time.time() - t0
    busy, kern = device_time(torch, lambda: runner.run(state0, inputs, interp_weather=True))
    print(f"3. annual run (8760 h, k=2, 8 sub-steps, f32): {wall:.3f} s (host clock); torch.profiler over a "
          f"second run: device busy {busy:.1f} ms = {100 * busy / 1e3 / wall:.1f} % of that wall, day_march "
          f"{kern['day_march']:.1f} ms ({kern['day_march'] / 365:.3f} ms a day-launch); the host's time beyond "
          f"the device {(wall - busy / 1e3) / 365 * 1e3:.3f} ms per simulated day", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

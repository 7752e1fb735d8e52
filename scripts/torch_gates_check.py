#!/usr/bin/env python3
"""The in-run passive controls of heatx_torch on one NVIDIA GPU, alone: a
short check of the day march's gates (zone shading, ventilation gates) that
needs none of chip_smoke.py's other phases.  Run from the repository root:

    python3 scripts/torch_gates_check.py

It builds both kernel libraries (one nvcc per source, together; prints the
time and every instantiation's ptxas registers, stack and spills), runs
chip_smoke.py's phase 21 (every day-march kind with shading, gates or both,
f64 kernel against plain twin, and the +1e9 and no-op properties), and times
one f32 day-launch (CUDA events, 10 reps) of the controlled city and of the
ungated bench city at full width (build_city_model(1000, 10), trbdf2_refresh
k=2 at 8 sub-steps), in TR-BDF2 and in parity mode (118 sub-steps/h, 3
reps), so the gates' cost per launch shows beside the launch they extend.
"""

import sys
import time
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_gates_check: no CUDA device", file=sys.stderr)
        return 2
    from heatx_torch import SimConfig, ThermalModel, testing
    from heatx_torch.ops import cuda_lib, day_adjoint, day_march

    smi = cs.card_facts()
    print(smi, flush=True)
    t0 = time.time()
    cuda_lib.build_many([("heatx_day_march", day_march.KERNEL_SOURCES),
                         ("heatx_day_adjoint", day_adjoint.KERNEL_SOURCES)])
    day_march.load_kernel()
    day_adjoint.load_kernel()
    print(f"build {time.time() - t0:.1f} s; day_march ptxas: "
          f"{cs.ptxas_table(cuda_lib.build_log('heatx_day_march', day_march.KERNEL_SOURCES))}", flush=True)
    print(f"day_adjoint ptxas: {cs.ptxas_table(cuda_lib.build_log('heatx_day_adjoint', day_adjoint.KERNEL_SOURCES))}",
          flush=True)
    ctx = SimpleNamespace(day_march=day_march, day_adjoint=day_adjoint, testing=testing, SimConfig=SimConfig,
                          ThermalModel=ThermalModel, smi=smi)
    t0 = time.time()
    worst, cases, shares, equal = cs.phase21_gates_f64(torch, ctx)
    print(f"phase 21: {cases} cases, kernel vs plain max |d| {worst:.3e} K; shares {shares}; +1e9 bit-equal; "
          f"no-op gate {equal} ({time.time() - t0:.1f} s)", flush=True)

    ms = {}
    cities = (("bench city", lambda: testing.build_city_model(1000, 10)),
              ("controlled city", lambda: testing.build_controlled_city(1000, 10, setpoints=cs.CITY_SHADE_SETPOINTS)))
    for label, build in cities:
        for mode, kw, cfg, reps in (
                ("trbdf2_refresh", dict(substeps=8, refresh_every=2), SimConfig(dtype=torch.float32), 10),
                ("parity", {}, SimConfig(dtype=torch.float32, nomass_fixed_iters=cs.PARITY_ITERS), 3)):
            tm = ThermalModel(build(), config=cfg, device="cuda")
            fr = tm.fast_runner(mode=mode, hours=24, **kw)
            T, zT = fr.to_blocked(tm.initial_state())
            hi = fr.kernel_inputs(testing.controlled_city_inputs(tm.building, 24, device="cuda"),
                                  interp_weather=True)[0]
            ms[(label, mode)] = cs.event_ms(torch, lambda: fr.hour_march(fr.params, T, zT, hi), reps)
    print(f"one f32 day-launch on {smi} (CUDA events): " + ", ".join(
        f"{label} {mode} {v:.3f} ms" for (label, mode), v in ms.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""chip_smoke.py's phase 3d alone (ROADMAP B1: components past 256 surfaces
as thread-block clusters, walls past 32 nodes at G = 8), on one card.

Builds both kernel libraries from the checkout as chip_smoke.py does (one
nvcc per source, all started together), prints ptxas's lines of the cluster
variant's instantiations, checks the G = 4 variants on phases 3 and 3b, then
runs phase 3d: (a) and (b), every body of both kernels on the wide zone, the
47-node wall and the office block against its plain version, and with
``--campus`` (c), the 32-building office campus's 48 h on the f32 kernel.

    python3 scripts/torch_b1_check.py [--campus]
"""

import argparse
import os
import sys
import time
from types import SimpleNamespace

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--campus", action="store_true", help="also phase 3d(c), the office campus")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_b1_check: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from heatx_torch import SimConfig, ThermalModel, testing
    from heatx_torch.build.layout import compile_building
    from heatx_torch.ops import cuda_lib, day_adjoint, day_march

    t_start = time.time()
    smi = chip_smoke.card_facts()
    print(smi, flush=True)
    t0 = time.time()
    cuda_lib.build_many([("heatx_day_march", day_march.KERNEL_SOURCES),
                         ("heatx_day_adjoint", day_adjoint.KERNEL_SOURCES)])
    day_march.load_kernel()
    day_adjoint.load_kernel()
    print(f"build: {time.time() - t0:.1f} s for both kernel libraries", flush=True)
    for name, src in (("heatx_day_march", day_march.KERNEL_SOURCES), ("heatx_day_adjoint", day_adjoint.KERNEL_SOURCES)):
        rows = chip_smoke.ptxas_table(cuda_lib.build_log(name, src)).split(" | ")
        print(f"{name} ptxas, the G = 8 instantiations: " + " | ".join(r for r in rows if "G=8" in r), flush=True)
    ctx = SimpleNamespace(SimConfig=SimConfig, ThermalModel=ThermalModel, smi=smi, day_march=day_march,
                          day_adjoint=day_adjoint, testing=testing)
    e3 = chip_smoke.phase3_f64_check(torch, day_march, testing, SimConfig, compile_building)
    e3b = chip_smoke.phase3b_b1_edge(torch, day_march, day_adjoint, testing, ThermalModel, SimConfig)
    print(f"phase 3: {e3:.3e}; phase 3b: f64 {e3b[0]:.3e}, f32 {e3b[1]:.3e}, adjoint {e3b[2]:.3e}; "
          f"{e3b[3]}", flush=True)
    t0 = time.time()
    w64, w32, wadj, lines, _ = chip_smoke.phase3d_b1_cases(torch, ctx)
    print(f"phase 3d(a, b) {time.time() - t0:.1f} s: f64 kernel vs plain {w64:.3e} K, f32 vs f64 plain "
          f"{w32:.3e} K, adjoint kernels vs plain {wadj:.3e}; " + "; ".join(lines), flush=True)
    if args.campus:
        t0 = time.time()
        print(chip_smoke.phase3d_campus(torch, ctx).text, flush=True)
        print(f"phase 3d(c) {time.time() - t0:.1f} s", flush=True)
    print(f"torch_b1_check: {time.time() - t_start:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

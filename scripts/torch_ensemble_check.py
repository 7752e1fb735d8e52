"""chip_smoke.py's phase 28 alone, then the ensemble sweep, on one card.

Builds both kernel libraries from the checkout as chip_smoke.py does (one
nvcc per source, all started together), runs phase 28 (the ensemble:
``heatx_torch.ensemble`` through the day march and the day adjoint, the two
ported examples at full settings, the weather groups), then
``scripts/torch_ensemble_sweep.py`` up to ``--max-e`` members.

    python3 scripts/torch_ensemble_check.py [--max-e 4096]
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
    ap.add_argument("--max-e", type=int, default=4096)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_ensemble_check: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from heatx_torch import SimConfig, ThermalModel, testing
    from heatx_torch.ops import cuda_lib, day_adjoint, day_march

    smi = chip_smoke.card_facts()
    print(smi, flush=True)
    t0 = time.time()
    cuda_lib.build_many([("heatx_day_march", day_march.KERNEL_SOURCES),
                         ("heatx_day_adjoint", day_adjoint.KERNEL_SOURCES)])
    day_march.load_kernel()
    day_adjoint.load_kernel()
    print(f"build: {time.time() - t0:.1f} s for both kernel libraries", flush=True)
    ctx = SimpleNamespace(SimConfig=SimConfig, ThermalModel=ThermalModel, smi=smi, day_march=day_march,
                          day_adjoint=day_adjoint, testing=testing)
    chip_smoke.phase28_ensemble(torch, ctx)
    sweep = chip_smoke.load_module("scripts/torch_ensemble_sweep.py", "torch_ensemble_sweep")
    sweep.main(["--max-e", str(args.max_e)])
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The examples of examples_torch/ on one card: chip_smoke.py's phase 29.

Builds both kernel libraries from the checkout as chip_smoke.py does (one
nvcc per source, all started together), then runs chip_smoke's phase 29: the
nine examples beside the ensemble's two, each ``main()`` on the card with its
day-march and adjoint launches counted and held to the counts its settings
give, ``calibrate`` in float64 and with ``--f32`` (an example whose own
closing assert fails is reported, the others still run, and the script exits
1); the gradient examples' first value and gradient on the f64 kernels
against their plain versions, ``optimal_control``'s finite-difference gate
on every zone of its 2-zone variant, and the f32 calibration gradient
against the f64 one.  Each
example's time (host clock) and launches are printed, and
``optimal_control``'s phase 1 (autograd through ``imp_march``, no kernel)
apart from its phase 2.  ``--out DIR`` writes each example's whole output
to ``DIR/<name>.txt``.

    python3 scripts/torch_examples_check.py            # every example at its full settings
    python3 scripts/torch_examples_check.py --phase29  # chip_smoke's own settings (calibrate at
                                                       # its smoke settings, optimal_control's
                                                       # phase 2 alone)
"""

import argparse
import os
import re
import sys
import time
from types import SimpleNamespace

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase29", action="store_true", help="chip_smoke's settings instead of full ones")
    ap.add_argument("--out", default=None, help="a directory for each example's whole output")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_examples_check: no CUDA device", file=sys.stderr)
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
    if args.phase29:
        p = chip_smoke.phase29_examples(torch, ctx, record_asserts=True)
    else:
        p = chip_smoke.phase29_examples(torch, ctx, full=chip_smoke.EXAMPLES_FULL + chip_smoke.EXAMPLES_FAST,
                                        record_asserts=True, args={})

    if args.out:
        os.makedirs(args.out, exist_ok=True)
    print(f"examples on {smi} ({'chip_smoke settings' if args.phase29 else 'full settings'}; host clock):")
    for name, r in p.runs.items():
        if args.out:
            with open(os.path.join(args.out, f"{name}.txt"), "w") as f:
                f.write(r.text)
        print(f"  {name:<18} {r.wall:9.2f} s  {r.launches[0]:5d} day-march launches ({r.parity} parity), "
              f"{r.launches[1]:4d} adjoint launches{'; ' + r.failed if r.failed else ''}", flush=True)
    for m in re.finditer(r"phase (\d) \(([^)]*)\): ([0-9.]+)s", p.runs["optimal_control"].text):
        print(f"  optimal_control phase {m.group(1)} ({m.group(2)}): {m.group(3)} s")
    print(f"phase 29: {p.seconds:.1f} s; the whole script {time.time() - t0:.1f} s", flush=True)
    failed = [name for name, r in p.runs.items() if r.failed]
    if failed:
        print(f"closing asserts failed: {', '.join(failed)}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where a day adjoint's time goes, by ablation: copies of this checkout's
heatx_torch, each with one part of an adjoint kernel (csrc/day_adjoint_tr.cu,
csrc/day_adjoint_parity.cu) cut out or one launch choice changed, timed
against the whole kernel on f32 day-launches in one command.  The cut copies
compute wrong cotangents: they measure time only.  Run from the repository
root on a card:

    python3 scripts/torch_adjoint_ablate.py [--only TEXT] [CUT ...]

It writes each copy to build/ablate/<cut> (build/ is not committed) and runs
``scripts/torch_launch_ab.py --adjoint --adjoint-lib --only TEXT`` (default
"bench k=2") over the whole kernel and the copies in turns (whole,
copies..., copies..., whole).  The cuts (by default the TR-BDF2 ones, the
parity ones where TEXT holds "parity"):

  pass1    pass 1 (the march of the day that stores each hour's start) not
           marched: every hour starts from the day's start
  reverse  the reverse sweep of every hour dropped (the rebuilds, the
           sub-steps backwards): passes 1 and 2's marches only
  blocks2  not a cut: the 128-thread f32 variant asks for two blocks an SM
           instead of three (its registers no longer capped at 168)
  parity-pass1    the parity adjoint's pass 1 not marched
  parity-reverse  the parity adjoint's reverse sweep of every hour dropped
                  (the recompute of each sub-step and its reverse)
  parity-tape     the parity adjoint's tape not written, and each reversed
                  sub-step recomputed from the hour's end state instead of
                  its taped start: the tape's device-memory traffic
"""

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# cut -> (file, [(text in it, its replacement)])
PARITY = "heatx_torch/csrc/day_adjoint_parity.cu"
CUTS = {
    "pass1": ("heatx_torch/csrc/day_adjoint_tr.cu", [("    march_hour(h, false);\n", "")]),
    "reverse": ("heatx_torch/csrc/day_adjoint_tr.cu", [("    for (int i0 = ((sub - 1) / k) * k; i0 >= 0; i0 -= k) {",
                                                        "    for (int i0 = -1; i0 >= 0; i0 -= k) {")]),
    "blocks2": ("heatx_torch/csrc/day_march_args.cuh", [("kAdjLaunchVariants[] = {{32, 128, 3},",
                                                         "kAdjLaunchVariants[] = {{32, 128, 2},")]),
    "parity-pass1": (PARITY, [("    march_hour(h, false);\n", "")]),
    "parity-reverse": (PARITY, [("    for (int i = sub - 1; i >= 0; --i) {", "    for (int i = -1; i >= 0; --i) {")]),
    "parity-tape": (PARITY, [("tape[(static_cast<size_t>(c) * M + j) * TP] = x[j];", "(void)x;"),
                             ("x[j] = tape[(static_cast<size_t>(c) * M + j) * TP];", "x[j] = Tn[j];")]),
}


def main() -> int:
    args = sys.argv[1:]
    only = "bench k=2"
    if "--only" in args:
        only = args[args.index("--only") + 1]
        del args[args.index("--only"):args.index("--only") + 2]
    cuts = args or [c for c in CUTS if c.startswith("parity-") == ("parity" in only)]
    trees = []
    for cut in cuts:
        path, edits = CUTS[cut]
        dst = ROOT / "build" / "ablate" / cut
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(ROOT / "heatx_torch", dst / "heatx_torch", ignore=shutil.ignore_patterns("_build"))
        shutil.copy(ROOT / "chip_smoke.py", dst / "chip_smoke.py")
        text = (dst / path).read_text()
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"torch_adjoint_ablate: the {cut} cut does not match {path}")
            text = text.replace(old, new)
        (dst / path).write_text(text)
        trees.append(str(dst))
    cmd = [sys.executable, str(ROOT / "scripts" / "torch_launch_ab.py"), "--adjoint", "--adjoint-lib", "--only", only,
           str(ROOT), *trees, *trees, str(ROOT)]
    return subprocess.call(cmd, cwd=ROOT)


if __name__ == "__main__":
    sys.exit(main())

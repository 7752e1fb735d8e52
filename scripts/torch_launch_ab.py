#!/usr/bin/env python3
"""One day-launch of each existing day-march kind, timed in two or more
checkouts of heatx_torch on the same card in one command, so that a change
to the shared kernel code is measured against its parent and not against
another day's clocks.  Run from the repository root with the checkouts to
compare (each a directory holding heatx_torch/), in the order to time them:

    python3 scripts/torch_launch_ab.py [--f64] [--only TEXT] [--march-only] [--adjoint] [--adjoint-lib] \
        build/parent . . build/parent

It builds each distinct checkout's kernel libraries (one nvcc per source, all
started together, into that checkout's heatx_torch/_build; prints every
ptxas line of a later checkout that differs from the first's, and the first's
lines that a later checkout no longer has), then, one process
per argument in the order given, times with CUDA events (after a warm-up
launch) one day-launch of bench.py's workloads at full width, each on its
first day's inputs: the bench city in trbdf2_refresh k=2 at 8 sub-steps
(free-float kind, 10 reps) and in parity mode at 118 sub-steps/h with one
no-mass iteration (3 reps) and with heatx's adaptive no-mass loop (3 reps),
the demand city in trbdf2 at 8 sub-steps (thermostats, 10 reps), the glazed
city in trbdf2_refresh k=2 (gas cavities, 10 reps) and in parity (3 reps),
the bench city with interior MRT in trbdf2_refresh k=2 (10 reps) and in
parity (3 reps), the glazed city with interior MRT in both modes (MRT and
cavities), chip_smoke.py's controlled city (the in-run controls) in both
modes, and one zone of 50 surfaces (a 64-lane block) free-float in k=2 and
with a thermostat in trbdf2, and one of 256 surfaces in k=2, each with a
32-node wall.  ``--f64`` times each kind in f64 as well, ``--only TEXT``
times only the kinds whose name holds TEXT, and ``--march-only`` builds the
day-march library alone (no adjoint ptxas lines).  ``--adjoint`` times the
day adjoint's day-launch of each kind instead (at most 2 reps; the
controlled city's in-run controls and the adaptive no-mass loop have no
adjoint): the cotangent of the day's zone history seeded, of its loads where
the kind has thermostats; ``--adjoint-lib`` builds the adjoint library alone.  It prints one line per
checkout and a table of each kind's ms per run and the change of the mean of
each later checkout's runs against the first's.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

TIMER = r"""
import json, os, sys
import numpy as np
import torch
from heatx_torch import SimConfig, ThermalModel, testing
from heatx_torch.ops import day_march

opts = json.loads(sys.argv[1])
kern = day_march.day_march_kernel
os.environ["HEATX_KERNEL_WHILE"] = "1"  # heatx's gate of the adaptive loop

def event_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps

k2 = dict(mode="trbdf2_refresh", substeps=8, refresh_every=2)
parity = dict(mode="parity")
f32 = dict(dtype=torch.float32)
p32 = dict(dtype=torch.float32, nomass_fixed_iters=1)
from chip_smoke import CITY_SHADE_SETPOINTS

def controlled(n, s):
    return testing.build_controlled_city(n, s, setpoints=CITY_SHADE_SETPOINTS)

cases = [
    ("bench k=2", testing.build_city_model, f32, k2, testing.bench_inputs, 10),
    ("bench parity", testing.build_city_model, p32, parity, testing.bench_inputs, 3),
    ("bench parity adaptive", testing.build_city_model, dict(f32, nomass_fixed_iters=None), parity,
     testing.bench_inputs, 3),
    ("demand trbdf2", testing.build_demand_city, f32, dict(mode="trbdf2", substeps=8), testing.demand_inputs, 10),
    ("glazed k=2", testing.build_glazed_city, f32, k2, testing.bench_inputs, 10),
    ("glazed parity", testing.build_glazed_city, p32, parity, testing.bench_inputs, 3),
    ("MRT k=2", testing.build_city_model, dict(f32, interior_mrt=True), k2, testing.bench_inputs, 10),
    ("MRT parity", testing.build_city_model, dict(p32, interior_mrt=True), parity, testing.bench_inputs, 3),
    ("glazed MRT k=2", testing.build_glazed_city, dict(f32, interior_mrt=True), k2, testing.bench_inputs, 10),
    ("glazed MRT parity", testing.build_glazed_city, dict(p32, interior_mrt=True), parity, testing.bench_inputs, 3),
    ("controlled k=2", controlled, f32, k2, testing.controlled_city_inputs, 10),
    ("controlled parity", controlled, p32, parity, testing.controlled_city_inputs, 3),
    ("wide 50 k=2", lambda n, s: testing.build_wide_zone_model(50), f32, k2, testing.bench_inputs, 10),
    ("wide 50 thermostat trbdf2", lambda n, s: testing.build_wide_zone_model(50, thermostat=True), f32,
     dict(mode="trbdf2", substeps=8), testing.demand_inputs, 10),
    ("wide 256 k=2", lambda n, s: testing.build_wide_zone_model(), f32, k2, testing.bench_inputs, 10),
]
out = {}
for name, build, cfg, kw, inputs, reps in cases:
    # The in-run controls and the adaptive loop have no adjoint.
    if opts["only"] not in name or (opts["adjoint"] and (name.startswith("controlled") or "adaptive" in name)):
        continue
    for dt in ("f32", "f64") if opts["f64"] else ("f32",):
        tm = ThermalModel(build(1000, 10), config=SimConfig(**dict(cfg, dtype=getattr(torch, dt.replace("f", "float")))),
                          device="cuda")
        fr = tm.fast_runner(hours=24, **kw)
        T, zT = fr.to_blocked(tm.initial_state())
        hi = fr.kernel_inputs(inputs(tm.building, 24, device="cuda"), interp_weather=True)[0]
        if hasattr(kern, "group"):
            kern.group = None  # a checkout with a choice of threads per surface: its default
        fn = lambda: fr.hour_march(fr.params, T, zT, hi)
        if opts["adjoint"]:
            from heatx_torch.ops import day_adjoint
            akw = dict(kw, substeps=tm.dt_subdivisions) if kw["mode"] == "parity" else kw
            adj = day_adjoint.make_day_adjoint(fr._bb, hours=24, **akw)
            NB, ZB = fr._bb.n_blocks, fr._bb.zones_per_block
            rng = np.random.default_rng(3)
            cot = lambda: torch.as_tensor(rng.normal(size=(24, NB, ZB)) / (24 * NB * ZB), dtype=T.dtype, device="cuda")
            cots = (torch.zeros_like(T), torch.zeros_like(zT), cot()) + ((cot(),) if fr.params.ctl is not None else ())
            fn = lambda: adj(fr.params, T, zT, hi, cots)
        out[name + ("" if dt == "f32" else " f64")] = event_ms(fn, min(reps, 2) if opts["adjoint"] else reps)
print(json.dumps(out))
"""

BUILDER = r"""
import json, sys
from chip_smoke import ptxas_table
from heatx_torch.ops import cuda_lib, day_adjoint, day_march
libs = [("day_march", "heatx_day_march", day_march), ("day_adjoint", "heatx_day_adjoint", day_adjoint)]
libs = {"march": libs[:1], "adjoint": libs[1:]}.get(sys.argv[1], libs)
cuda_lib.build_many([(lib, mod.KERNEL_SOURCES) for _, lib, mod in libs])
print(json.dumps({name: ptxas_table(cuda_lib.build_log(lib, mod.KERNEL_SOURCES)) for name, lib, mod in libs}))
"""


def main() -> int:
    args = sys.argv[1:]
    opts = {"f64": "--f64" in args, "only": "", "adjoint": "--adjoint" in args}
    which = "march" if "--march-only" in args else "adjoint" if "--adjoint-lib" in args else "both"
    if "--only" in args:
        opts["only"] = args[args.index("--only") + 1]
        del args[args.index("--only"):args.index("--only") + 2]
    args = [a for a in args if a not in ("--f64", "--march-only", "--adjoint", "--adjoint-lib")]
    trees = [str(Path(t).resolve()) for t in args] or ["."]
    t0 = time.time()
    builds = {t: subprocess.Popen([sys.executable, "-c", BUILDER, which], cwd=t, stdout=subprocess.PIPE, text=True)
              for t in dict.fromkeys(trees)}
    ptxas = {}
    for t, p in builds.items():
        out, _ = p.communicate()
        if p.returncode:
            print(f"torch_launch_ab: the build in {t} failed", file=sys.stderr)
            return 1
        ptxas[t] = {k: dict(e.split(": ", 1) for e in v.split(" | ")) for k, v in
                    json.loads(out.strip().splitlines()[-1]).items()}
    print(f"builds {time.time() - t0:.1f} s", flush=True)
    first = trees[0]
    for t in ptxas:
        if t != first:
            for lib, lines in ptxas[t].items():
                moved = [f"{k}: {ptxas[first][lib].get(k, 'absent')} -> {v}" for k, v in lines.items()
                         if ptxas[first][lib].get(k) != v]
                gone = [f"{k}: {v}" for k, v in ptxas[first][lib].items() if k not in lines]
                print(f"ptxas {lib}, {t} against {first}: "
                      + ("every line equal" if not moved else "; ".join(moved))
                      + ("" if not gone else "; no longer built: " + "; ".join(gone)), flush=True)
    runs = []
    for t in trees:
        res = subprocess.run([sys.executable, "-c", TIMER, json.dumps(opts)], cwd=t, capture_output=True,
                             text=True)
        if res.returncode:
            print(res.stderr[-3000:], file=sys.stderr)
            return 1
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(f"{t}: " + ", ".join(f"{k} {v:.3f} ms" for k, v in runs[-1].items()), flush=True)
    names = list(dict.fromkeys(k for r in runs for k in r))
    for name in names:
        base = [r[name] for t, r in zip(trees, runs) if t == first and name in r]
        for tree in dict.fromkeys(t for t in trees if t != first):
            other = [r[name] for t, r in zip(trees, runs) if t == tree and name in r]
            if base and other:
                b, o = sum(base) / len(base), sum(other) / len(other)
                print(f"{name}: {first} " + " / ".join(f"{x:.3f}" for x in base) + f" ms, {tree} "
                      + " / ".join(f"{x:.3f}" for x in other) + f" ms: {100 * (o / b - 1):+.2f} %", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

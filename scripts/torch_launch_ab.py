#!/usr/bin/env python3
"""One f32 day-launch of each existing day-march kind, timed in two or more
checkouts of heatx_torch on the same card in one command, so that a change
to the shared kernel code is measured against its parent and not against
another day's clocks.  Run from the repository root with the checkouts to
compare (each a directory holding heatx_torch/), in the order to time them:

    python3 scripts/torch_launch_ab.py [--groups 4,8,16] [--f64] [--only TEXT] build/parent . . build/parent

It builds each distinct checkout's kernel libraries (one nvcc per source, all
started together, into that checkout's heatx_torch/_build; prints every
ptxas line of a later checkout that differs from the first's, and the first's
lines that a later checkout no longer has), then, one process
per argument in the order given, times with CUDA events (after a warm-up
launch) one day-launch of bench.py's workloads at full width, each on its
first day's inputs: the bench city in trbdf2_refresh k=2 at 8 sub-steps
(free-float kind, 10 reps) and in parity mode at 118 sub-steps/h with one
no-mass iteration (3 reps), the demand city in trbdf2 at 8 sub-steps
(thermostats, 10 reps), the glazed city in trbdf2_refresh k=2 (gas
cavities, 10 reps) and in parity (3 reps), the bench city with interior
MRT in trbdf2_refresh k=2 (10 reps) and in parity (3 reps), the glazed city
with interior MRT in trbdf2_refresh k=2 (MRT and cavities, 10 reps), and,
in a checkout that has it, chip_smoke.py's controlled city (the in-run
controls) in both modes, and, in a checkout that has
``testing.build_wide_zone_model``, one zone of 50 surfaces (a 64-lane block)
free-float in k=2 and with a thermostat in trbdf2, and one of 256 surfaces
in k=2, each with a 32-node wall.  ``--groups`` times each TR-BDF2 kind at
each of those threads per surface in a checkout whose kernel takes a group
size (``day_march.day_march_kernel.group``; the wrapper takes 4 where a
group does not fit the block), ``--f64`` times each TR-BDF2 kind in f64 as
well, and ``--only TEXT`` times only the kinds whose name holds TEXT.  It
prints one line per checkout and a table of each kind's ms per run and the
change of the mean of the later checkouts' runs against the first's (a
timing with a group size against the first checkout's of the same kind and
type).
"""

import json
import subprocess
import sys
import time
from pathlib import Path

TIMER = r"""
import json, sys
import torch
from heatx_torch import SimConfig, ThermalModel, testing
from heatx_torch.ops import day_march

opts = json.loads(sys.argv[1])
kern = day_march.day_march_kernel
grouped = hasattr(kern, "group")

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
cases = [
    ("bench k=2", testing.build_city_model, f32, k2, testing.bench_inputs, 10),
    ("bench parity", testing.build_city_model, p32, parity, testing.bench_inputs, 3),
    ("demand trbdf2", testing.build_demand_city, f32, dict(mode="trbdf2", substeps=8), testing.demand_inputs, 10),
    ("glazed k=2", testing.build_glazed_city, f32, k2, testing.bench_inputs, 10),
    ("glazed parity", testing.build_glazed_city, p32, parity, testing.bench_inputs, 3),
    ("MRT k=2", testing.build_city_model, dict(f32, interior_mrt=True), k2, testing.bench_inputs, 10),
    ("MRT parity", testing.build_city_model, dict(p32, interior_mrt=True), parity, testing.bench_inputs, 3),
    ("glazed MRT k=2", testing.build_glazed_city, dict(f32, interior_mrt=True), k2, testing.bench_inputs, 10),
]
if hasattr(testing, "build_controlled_city"):
    from chip_smoke import CITY_SHADE_SETPOINTS

    def controlled(n, s):
        return testing.build_controlled_city(n, s, setpoints=CITY_SHADE_SETPOINTS)

    cases += [("controlled k=2", controlled, f32, k2, testing.controlled_city_inputs, 10),
              ("controlled parity", controlled, p32, parity, testing.controlled_city_inputs, 3)]
if hasattr(testing, "build_wide_zone_model"):
    cases += [("wide 50 k=2", lambda n, s: testing.build_wide_zone_model(50), f32, k2, testing.bench_inputs, 10),
              ("wide 50 thermostat trbdf2", lambda n, s: testing.build_wide_zone_model(50, thermostat=True), f32,
               dict(mode="trbdf2", substeps=8), testing.demand_inputs, 10),
              ("wide 256 k=2", lambda n, s: testing.build_wide_zone_model(), f32, k2, testing.bench_inputs, 10)]
out = {}
for name, build, cfg, kw, inputs, reps in cases:
    if opts["only"] not in name:
        continue
    tr = kw["mode"] != "parity"
    for dt in ("f32", "f64") if tr and opts["f64"] else ("f32",):
        tm = ThermalModel(build(1000, 10), config=SimConfig(**dict(cfg, dtype=getattr(torch, dt.replace("f", "float")))),
                          device="cuda")
        fr = tm.fast_runner(hours=24, **kw)
        T, zT = fr.to_blocked(tm.initial_state())
        hi = fr.kernel_inputs(inputs(tm.building, 24, device="cuda"), interp_weather=True)[0]
        for group in opts["groups"] if tr and grouped and opts["groups"] else [None]:
            if grouped:
                kern.group = group
            key = name + ("" if dt == "f32" else " f64") + ("" if group is None else f" G={group}")
            out[key] = event_ms(lambda: fr.hour_march(fr.params, T, zT, hi), reps)
        if grouped:
            kern.group = None
print(json.dumps(out))
"""

BUILDER = r"""
import json
from chip_smoke import ptxas_table
from heatx_torch.ops import cuda_lib, day_adjoint, day_march
cuda_lib.build_many([("heatx_day_march", day_march.KERNEL_SOURCES),
                     ("heatx_day_adjoint", day_adjoint.KERNEL_SOURCES)])
print(json.dumps({name: ptxas_table(cuda_lib.build_log(lib, mod.KERNEL_SOURCES))
                  for name, lib, mod in (("day_march", "heatx_day_march", day_march),
                                         ("day_adjoint", "heatx_day_adjoint", day_adjoint))}))
"""


def main() -> int:
    args = sys.argv[1:]
    opts = {"groups": [], "f64": "--f64" in args, "only": ""}
    if "--only" in args:
        opts["only"] = args[args.index("--only") + 1]
        del args[args.index("--only"):args.index("--only") + 2]
    if "--groups" in args:
        opts["groups"] = [int(g) for g in args[args.index("--groups") + 1].split(",")]
        del args[args.index("--groups"):args.index("--groups") + 2]
    args = [a for a in args if a != "--f64"]
    trees = [str(Path(t).resolve()) for t in args] or ["."]
    t0 = time.time()
    builds = {t: subprocess.Popen([sys.executable, "-c", BUILDER], cwd=t, stdout=subprocess.PIPE, text=True)
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
        base_name = name.split(" G=")[0]
        base = [r[base_name] for t, r in zip(trees, runs) if t == first and base_name in r]
        other = [r[name] for t, r in zip(trees, runs) if t != first and name in r]
        if base and other and (name != base_name or name in runs[0]):
            b, o = sum(base) / len(base), sum(other) / len(other)
            print(f"{name}: {first} " + " / ".join(f"{x:.3f}" for x in base) + " ms, other "
                  + " / ".join(f"{x:.3f}" for x in other) + f" ms: {100 * (o / b - 1):+.2f} %", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""What the day kernels' cluster variant costs against the G = 4 variant on
the same blocks, on one NVIDIA GPU, f32 (ROADMAP B1).  Run from the
repository root:

    python3 scripts/torch_cluster_costs.py

The cluster variant (day_march.LAUNCH_VARIANTS[3]: G = 8 threads a surface,
64 rows, CTAs of 128 lanes, every barrier a cluster barrier, the zone sums
reading each face from its CTA over distributed shared memory) takes every
component past 256 lanes or 32 rows.  On components that the G = 4 variant
also takes, the script launches both on the same operands, forcing the
variant through ``day_march.launch_shape`` (the one place the host picks it):

1. 128-lane components (testing.build_office_block(1, 20, 2) with a 200 mm
   concrete wall, 25 nodes; BUILDINGS copies): G = 4 in one CTA of 512
   threads against the cluster variant at C = 1 (one CTA of 1,024 threads):
   what G = 8 and the 64-row columns cost without a second CTA.
2. 256-lane components (build_office_block(2, 23, 2), the same wall): G = 4
   in one CTA of 1,024 threads against the cluster variant at C = 2: what
   two CTAs, their cluster barriers and remote face reads add to (1).

For each, the four bodies on the first bench day: the TR-BDF2 day march
(k=2, 8 sub-steps), its adjoint, the parity march (the building's own
sub-steps, one no-mass iteration) and its adjoint, each day-launch by CUDA
events after a warm-up; the two variants' outputs side by side (zone
history max |d|, the adjoints' worst relative L2).  Prints the card's name
and power limit first.
"""

import contextlib
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

#: 200 mm of concrete between 20 mm of polystyrene: 25 nodes per surface.
WALL = (("poly", 0.02), ("concrete", 0.20), ("poly", 0.02))
#: (floors, rooms a floor, windows a room): components of 119 and 251 surfaces.
CASES = ((1, 20, 2), (2, 23, 2))
#: One component a CTA of the G = 4 variant, one CTA an SM on 132 SMs.
BUILDINGS = 132
CLUSTER = 3  # the cluster variant's index in day_march.LAUNCH_VARIANTS


@contextlib.contextmanager
def forced_variant(day_march, index):
    """Launch every block in variant ``index`` (None: the host's own choice),
    as whole CTAs of it."""
    if index is None:
        yield
        return
    chosen = day_march.launch_shape
    var = day_march.LAUNCH_VARIANTS[index]

    def shape(lanes, max_nodes):
        chosen(lanes, max_nodes)  # the same refusals
        ctas = 1 if lanes <= var.lanes else lanes // var.lanes
        return day_march.LaunchShape(index, var, ctas, lanes // ctas)

    day_march.launch_shape = shape
    try:
        yield
    finally:
        day_march.launch_shape = chosen


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_cluster_costs: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import card_facts, event_ms, flat_grads, variant_text
    from heatx_torch import SimConfig, ThermalModel, testing
    from heatx_torch.ops import cuda_lib, day_adjoint, day_march

    print(card_facts(), flush=True)
    t0 = time.time()
    cuda_lib.build_many([("heatx_day_march", day_march.KERNEL_SOURCES),
                         ("heatx_day_adjoint", day_adjoint.KERNEL_SOURCES)])
    day_march.load_kernel()
    day_adjoint.load_kernel()
    print(f"build: {time.time() - t0:.1f} s for both kernel libraries", flush=True)
    km, ka = day_march.day_march_kernel, day_adjoint.day_adjoint_kernel
    for floors, rooms, windows in CASES:
        model = testing.build_office_block(floors, rooms, windows, wall=WALL, buildings=BUILDINGS)
        tm = ThermalModel(model, n=1, config=SimConfig(dtype=torch.float32, nomass_fixed_iters=1), device="cuda")
        b, st0, sub = tm.building, tm.initial_state(), tm.dt_subdivisions
        bodies = (("trbdf2_refresh k=2, 8 sub-steps", dict(mode="trbdf2_refresh", substeps=8, refresh_every=2),
                   dict(substeps=8, mode="trbdf2_refresh", refresh_every=2)),
                  (f"parity, {sub} sub-steps", dict(mode="parity"), dict(substeps=sub, mode="parity")))
        for label, rkw, akw in bodies:
            r = tm.fast_runner(hours=24, **rkw)
            T, zT = r.to_blocked(st0)
            hi = r.kernel_inputs(testing.bench_inputs(b, 24, device="cuda"))[0]
            NB, ZB = r._bb.n_blocks, r._bb.zones_per_block
            rng = np.random.default_rng(5)
            d_hist = torch.as_tensor(rng.normal(size=(24, NB, ZB)) / (24 * b.n_zones), dtype=torch.float32,
                                     device="cuda")
            cots = (torch.zeros_like(T), torch.zeros_like(zT), d_hist)
            adj = day_adjoint.make_day_adjoint(r._bb, hours=24, **akw)
            runs = {}
            for forced in (None, CLUSTER):
                with forced_variant(day_march, forced):
                    out = r.hour_march(r.params, T, zT, hi)
                    fwd_variant = variant_text(km)
                    ms = event_ms(torch, lambda: r.hour_march(r.params, T, zT, hi), 3)
                    g = flat_grads(adj(r.params, T, zT, hi, cots))
                    adj_variant = variant_text(ka)
                    adj_ms = event_ms(torch, lambda: adj(r.params, T, zT, hi, cots), 1)
                finite = bool(torch.isfinite(out[3]).all()) and all(bool(torch.isfinite(v).all()) for v in g.values())
                runs[forced] = dict(zt=out[3], g=g, ms=ms, adj_ms=adj_ms, fwd=fwd_variant, adj=adj_variant,
                                    finite=finite)
            g4, cl = runs[None], runs[CLUSTER]
            zt_gap = float((g4["zt"] - cl["zt"]).abs().max())
            rel = max(float((cl["g"][k] - v).norm() / max(float(v.norm()), 1e-30)) for k, v in g4["g"].items())
            print(f"{floors} x {rooms} x {windows} office x {BUILDINGS} ({b.n_surfaces} surfaces, "
                  f"{r.params.block_size}-lane blocks, {r.params.max_nodes} nodes), {label}, one day-launch, f32: "
                  f"march {g4['fwd']} {g4['ms']:.3f} ms vs {cl['fwd']} {cl['ms']:.3f} ms "
                  f"(x{cl['ms'] / g4['ms']:.3f}); adjoint {g4['adj']} {g4['adj_ms']:.3f} ms vs {cl['adj']} "
                  f"{cl['adj_ms']:.3f} ms (x{cl['adj_ms'] / g4['adj_ms']:.3f}); the variants' zone histories "
                  f"max |d| {zt_gap:.3e} K, adjoints worst relative L2 {rel:.3e}; finite "
                  f"{g4['finite'] and cl['finite']}", flush=True)
            del runs, g4, cl, adj
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

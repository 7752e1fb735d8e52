#!/usr/bin/env python3
"""The f32 TR-BDF2 day adjoint on the demand city taken apart (chip_smoke.py
phase 11a's day): how far the f32 adjoint kernel and the f32 plain adjoint
each are from the f64 plain adjoint, per output, and where.  Run from the
repository root on a card:

    python3 scripts/torch_adjoint_f32_diag.py [--tree PATH] [--zones N]

One demand day (build_demand_city(N, 10), N = 1000 by default, trbdf2_refresh
k=2, 8 sub-steps, the demand rows' inputs, phase 11a's seeded cotangents of
the zone history and the loads).  It prints the relative L2 gap per output of
the f32 adjoint kernel and of the f32 plain adjoint against the f64 plain
adjoint, and of the kernel against the f32 plain adjoint; for the worst
output, the share of the kernel's squared gap on its 10 largest lanes; the
zone-sub-steps whose thermostat branch (the load's sign, a capacity) differs
between the f32 and the f64 plain marches; and the zone-hours whose mean load
is 0 in one of the f32 forward kernel and the f64 plain march and not in the
other, with their loads and zone temperatures around that hour; and the
kernel's gap to the f64 plain adjoint re-run from the f32 forward kernel's
hour starts (chip_smoke.py phase 11a's held reference), with the zone-hours
whose loads part between the kernel and the f64 plain hours from those
starts.  ``--tree
PATH`` imports heatx_torch from another checkout (its kernel, its plain
versions) for the same day, without the last two lines (they need this
checkout's ``plain_day_adjoint(starts=...)``).
"""

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    args = sys.argv[1:]
    tree = ROOT
    if "--tree" in args:
        tree = Path(args[args.index("--tree") + 1]).resolve()
    zones = int(args[args.index("--zones") + 1]) if "--zones" in args else 1000
    sys.path.insert(0, str(tree))
    sys.path.insert(1, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("torch_adjoint_f32_diag: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import card_facts, flat_grads, forward_hour_starts, hour_slices
    from heatx_torch import SimConfig, ThermalModel, testing
    from heatx_torch.ops import day_adjoint

    print(card_facts(), f"heatx_torch from {tree}", flush=True)
    kw = dict(mode="trbdf2_refresh", substeps=8, hours=24, refresh_every=2)
    out, fwd, masks = {}, {}, {}
    for dtype in (torch.float32, torch.float64):
        tm = ThermalModel(testing.build_demand_city(zones, 10), n=1, config=SimConfig(dtype=dtype), device="cuda")
        r = tm.fast_runner(**kw)
        T, zT = r.to_blocked(tm.initial_state())
        hi = r.kernel_inputs(testing.demand_inputs(tm.building, 24, device="cuda"))[0]
        adj = day_adjoint.make_day_adjoint(r._bb, substeps=8, mode="trbdf2_refresh", hours=24, refresh_every=2)
        shape = (24, r._bb.n_blocks, r._bb.zones_per_block)
        rng = np.random.default_rng(4)
        cots = (torch.zeros_like(T), torch.zeros_like(zT),
                torch.as_tensor(rng.normal(size=shape) / (24 * 1000), dtype=dtype, device="cuda"),
                torch.as_tensor(rng.normal(size=shape) / (24 * 1000 * 1e3), dtype=dtype, device="cuda"))
        out[dtype, "plain"] = flat_grads(adj.plain(r.params, T, zT, hi, cots))
        out[dtype, "kernel"] = flat_grads(adj(r.params, T, zT, hi, cots))
        fwd[dtype, "kernel"] = r.hour_march(r.params, T, zT, hi)
        r1 = tm.fast_runner(**dict(kw, hours=1))
        if tree == ROOT and dtype == torch.float32:
            starts = forward_hour_starts(torch, r, r1, T, zT, hi)
        elif tree == ROOT:  # the f64 plain adjoint and march from the f32 forward kernel's hour starts
            out[dtype, "from kernel starts"] = flat_grads(adj.plain(r.params, T, zT, hi, cots, starts=starts))
            fwd[dtype, "from kernel starts"] = torch.cat([
                r1.hour_march.plain(r1.params, t.double(), z.double(), hour_slices(hi, h, 8))[-1]
                for h, (t, z) in enumerate(starts)])
        with testing.BranchCounter() as c:
            fwd[dtype, "plain"] = r.hour_march.plain(r.params, T, zT, hi)
        heat_sp = r.params.ctl[0]
        masks[dtype] = torch.stack(c.masks)
        torch.cuda.synchronize()
    ref = out[torch.float64, "plain"]

    def gaps(got, base):
        res = {}
        for name, b in base.items():
            g = got[name].to(b.dtype)
            norm = float(b.norm())
            res[name] = float((g - b).norm()) / norm if norm else float(g.abs().max())
        return res

    def line(what, gap):
        worst = max(gap, key=gap.get)
        print(f"{what}: worst {gap[worst]:.3e} ({worst}); " + ", ".join(f"{n} {v:.2e}" for n, v in gap.items()),
              flush=True)
        return worst

    worst = line("f32 adjoint kernel vs f64 plain adjoint", gaps(out[torch.float32, "kernel"], ref))
    line("f32 plain adjoint vs f64 plain adjoint", gaps(out[torch.float32, "plain"], ref))
    line("f32 adjoint kernel vs f32 plain adjoint", gaps(out[torch.float32, "kernel"], out[torch.float32, "plain"]))
    line("f64 adjoint kernel vs f64 plain adjoint", gaps(out[torch.float64, "kernel"], ref))
    if tree == ROOT:
        line("f32 adjoint kernel vs f64 plain adjoint from the f32 forward kernel's hour starts",
             gaps(out[torch.float32, "kernel"], out[torch.float64, "from kernel starts"]))
        l32, lk = fwd[torch.float32, "kernel"][-1], fwd[torch.float64, "from kernel starts"]
        zero = (l32 == 0) != (lk == 0)
        print(f"hourly loads, f32 kernel march vs the f64 plain hours from its hour starts: {int(zero.sum())} of "
              f"{zero.numel()} zone-hours are 0 on one side only (zone-hours {zero.nonzero().tolist()[:10]}); "
              f"max |d| {float((l32.double() - lk).abs().max()):.3e} W", flush=True)
    d = (out[torch.float32, "kernel"][worst].double() - ref[worst]).reshape(-1, ref[worst].shape[-1])
    per_lane = (d ** 2).sum(0)
    top = torch.topk(per_lane, 10)
    print(f"{worst}: {100 * float(top.values.sum() / per_lane.sum()):.1f} % of the kernel's squared gap on lanes "
          f"{top.indices.tolist()}", flush=True)
    m32, m64 = masks[torch.float32], masks[torch.float64].to(masks[torch.float32].dtype)
    differ = (m32 != m64).any(dim=1)
    print(f"thermostat branches, f32 vs f64 plain march: {int(differ.sum())} of {differ.numel()} zone-sub-steps "
          f"differ", flush=True)
    for what in ("kernel", "plain"):
        l32, l64 = fwd[torch.float32, what][-1], fwd[torch.float64, "plain"][-1]
        zero = (l32 == 0) != (l64 == 0)
        print(f"hourly loads, f32 {what} march vs f64 plain: {int(zero.sum())} of {zero.numel()} zone-hours are 0 "
              f"on one side only; max |d| {float((l32.double() - l64).abs().max()):.3e} W", flush=True)
        for h, b, z in zero.nonzero().tolist():
            zt32, zt64 = fwd[torch.float32, what][3][:, b, z], fwd[torch.float64, "plain"][3][:, b, z]
            print(f"  hour {h}, block {b}, zone slot {z} (lanes {b * r._bb.block_size}..): mean load f32 "
                  f"{float(l32[h, b, z]):.6e} W, f64 {float(l64[h, b, z]):.6e} W; heating setpoint "
                  f"{float(heat_sp.reshape(l64.shape[1:])[b, z]):.6f} C; hourly zone T f32 - f64 (K) "
                  + " ".join(f"{float(x):.2e}" for x in (zt32.double() - zt64)[max(0, h - 2):h + 3])
                  + "; f64 zone T - setpoint (K) "
                  + " ".join(f"{float(x) - float(heat_sp.reshape(l64.shape[1:])[b, z]):.3e}"
                             for x in zt64[max(0, h - 2):h + 3]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

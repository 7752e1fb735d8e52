#!/usr/bin/env python3
"""How far the glazed city's f32 parity adjoint is from the f64 one, and how
far an adjoint that drops the gas-cavity U's temperature dependence is:
the plain versions of heatx_torch (no kernel), so it runs on the CPU too.
Run from the repository root:

    python3 scripts/torch_cavity_f32_diag.py [--zones 20] [--hours 24] [--mode parity|trbdf2_refresh]
                                             [--device cuda|cpu]

The city is ``testing.build_glazed_city(zones, 10)`` (one argon double-glazed
window per zone) at the gradient workload's scales (seg_u x 1.2,
front_alphas x 0.8), in parity mode (118 sub-steps per hour,
``nomass_fixed_iters=1``) or in trbdf2_refresh (k=2, 8 sub-steps), on the
bench weather with the luminaires off, from the initial state: chip_smoke.py's
phase 16 days at a narrower width.  The cotangent is the workload's loss on
the zone history.  For each variant it
prints the relative L2 gap per adjoint output against the f64 plain adjoint,
worst over all lanes, over the cavity lanes alone and over the others, and
the lanes that carry most of the worst output's gap:

- ``f32``: the f32 plain adjoint;
- ``f32_u64``: the same with the cavity U evaluated in f64 (and rounded);
- ``f64_no_dudt``: f64 with the cavity U's cotangent dropped (U still moves
  with the temperatures forward), the control that a limit on the f32
  kernel's gap has to fail.

On an H100 each parity variant takes ~2.5 min at 1,000 zones (the plain
adjoint is bound by the host's operation issue, not by the width).  On the
CPU each parity variant takes ~3 min at 20 zones (one thread), a
trbdf2_refresh one ~5 s.
"""

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
import heatx_torch.engine.surface as surface  # noqa: E402
from heatx_torch import SimConfig, ThermalModel, testing  # noqa: E402
from heatx_torch.ops import day_adjoint, day_march  # noqa: E402

VARIANTS = ("f64", "f32", "f32_u64", "f64_no_dudt")


def cavity_u(variant):
    """The cavity U-value function segment_u calls in ``variant``."""
    plain = surface.cavity_u_value
    if variant == "f32_u64":
        def u64(gas, *args):
            return plain(type(gas)(*(f.double() for f in gas)), *(a.double() for a in args)).to(args[-1].dtype)
        return u64
    if variant == "f64_no_dudt":
        return lambda *args: plain(*args).detach()
    return plain


def day(dtype, zones, hours, device, mode):
    """The day's runner and launch operands in ``dtype``."""
    tm = ThermalModel(testing.build_glazed_city(zones, 10), n=1,
                      config=SimConfig(dtype=dtype, nomass_fixed_iters=1), device=device)
    b = tm.building
    sb = dataclasses.replace(b.surfaces, seg_u=b.surfaces.seg_u * 1.2, front_alphas=b.surfaces.front_alphas * 0.8)
    tm = ThermalModel.from_building(dataclasses.replace(b, surfaces=sb), device=device)
    kw = dict(mode="parity") if mode == "parity" else dict(mode=mode, substeps=8, refresh_every=2)
    fr = tm.fast_runner(hours=hours, **kw)
    seq = testing.bench_inputs(tm.building, hours, device=device)
    hi = fr.kernel_inputs(seq.replace(lum_power=torch.zeros_like(seq.lum_power)))[0]
    T, zT = fr.to_blocked(tm.initial_state())
    return fr, T, zT, hi


def adjoint(variant, d, d_hist):
    """The variant's plain parity adjoint of day ``d`` on the zone-history
    cotangent ``d_hist``."""
    fr, T, zT, hi = d
    hm = fr.hour_march
    kw = dict(mode="parity") if hm.parity else dict(mode="trbdf2_refresh", refresh_every=hm.refresh_every)
    adj = day_adjoint.make_day_adjoint(fr._bb, substeps=hm.substeps, hours=hm.hours, device=T.device, **kw)
    cot = (torch.zeros_like(T), torch.zeros_like(zT), d_hist.to(T.dtype))
    saved = surface.cavity_u_value
    surface.cavity_u_value = cavity_u(variant)
    try:
        return cs.flat_grads(adj.plain(fr.params, T, zT, hi, cot))
    finally:
        surface.cavity_u_value = saved


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--zones", type=int, default=20)
    ap.add_argument("--hours", type=int, default=24)
    ap.add_argument("--mode", default="parity", choices=("parity", "trbdf2_refresh"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    torch.set_num_threads(1)
    print(f"glazed city {args.zones} zones x 10 surfaces, {args.mode}, {args.hours} h, plain adjoints on "
          f"{args.device}", flush=True)
    days = {dtype: day(dtype, args.zones, args.hours, args.device, args.mode)
            for dtype in (torch.float32, torch.float64)}
    fr, T, zT, hi = days[torch.float64]
    # The workload's loss on the f64 zone history: one cotangent for all.
    hist = fr.hour_march.plain(fr.params, T, zT, hi)[3]
    NB, ZB = fr._bb.n_blocks, fr._bb.zones_per_block
    valid = torch.as_tensor(np.asarray(fr.layout.zone_table).reshape(NB, ZB) >= 0, device=args.device)
    d_hist = 2.0 * (hist - 21.0) * valid / (args.hours * 1000)
    cav = day_march.bit_rows(fr.params, "cav_bits").any(0)
    ref = None
    for variant in VARIANTS:
        t0 = time.time()
        g = adjoint(variant, days[torch.float32 if variant.startswith("f32") else torch.float64], d_hist)
        if ref is None:
            ref = g
            print(f"{variant}: {time.time() - t0:.1f} s (the reference)", flush=True)
            continue
        groups = {"all lanes": None, "cavity lanes": cav, "other lanes": ~cav}
        gaps = {k: cs.rel_l2_gaps(torch, g, ref, variant, float("inf"), lanes=v) for k, v in groups.items()}
        worst = max(gaps["all lanes"], key=gaps["all lanes"].get)
        d = (g[worst].double() - ref[worst]).reshape(-1, cav.shape[0]).norm(dim=0)
        top = torch.argsort(d, descending=True)[:4].tolist()
        share = ", ".join(f"{lane}{' (cavity)' if bool(cav[lane]) else ''} {float(d[lane] ** 2 / (d ** 2).sum()):.0%}"
                          for lane in top)
        print(f"{variant}: {time.time() - t0:.1f} s; relative L2 against f64, worst: "
              + "; ".join(f"{k} {cs.worst_of(v)}" for k, v in gaps.items())
              + f"; lanes with the largest share of {worst}'s squared gap: {share}", flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Parity mode of heatx_torch on one NVIDIA GPU, taken apart: where the f32
and f64 marches, and each kernel and its plain version, stay together at full
width (the bench city, 118 sub-steps per hour, ``nomass_fixed_iters=1``) and
where they part.  Run from the repository root, with the sections wanted
(all of them without arguments, ~15 min on an H100):

    python3 scripts/torch_parity_diag.py [A B C D E F G H]

It builds both kernel libraries (prints the time) and prints

A. one bench day: f32 and f64 kernel and plain twin against one another, by
   node kind (massive, no-mass), and the zone history's gap per hour;
B. horizons of 2, 6 and 12 h: forward kernel vs plain twin, adjoint kernel vs
   plain adjoint (f32 and f64), and the plain adjoint's time;
C. at those horizons the f32 adjoint kernel against the f64 plain adjoint;
D. one day's adjoint on seeded hourly cotangents, f32 kernel against f64
   kernel, with each output's size;
E. bench.py's gradient objective in parity mode over 2, 6 and 30 days, f32
   and f64 on the kernels, and over 73 days in one chunk (one of the annual
   run's five) in f32, by the host clock;
F. one day-launch of either parity kernel in f32 and f64 (CUDA events);
G. 1, 2 and 3 relaxed no-mass iterations per sub-step at the conductance
   scales 1.0 and 1.2: the 2-day gradient of bench.py's objective in f32 and
   f64 on the kernels, and how far the f64 kernel carries a start state moved
   by 1e-9 K over one and two days (a 2-cycling face gives orders of
   magnitude more than 1);
H. the first day-launch of the gradient workload (conductance scale 1.2,
   solar-absorptance scale 0.8; 24 h x 118 sub-steps), the operands on which
   chip_smoke.py holds both parity kernels against their plain versions: the
   forward gaps by node kind and per hour, the f32 adjoint kernel against the
   f32 and the f64 plain adjoints, and hour by hour the lowest film
   coefficient on a no-mass face, at that scale and at 1.0.

chip_smoke.py's parity bounds (its ``PARITY_*`` constants) rest on A-H.
"""

import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from heatx_torch import SimConfig, ThermalModel, testing  # noqa: E402
from heatx_torch.ops import cuda_lib, day_adjoint, day_march  # noqa: E402

DTYPES = {"f32": torch.float32, "f64": torch.float64}


def nomass_faces(params):
    """(front, back): which lanes end on a no-mass node at either face."""
    nodes = day_march.bit_rows(params, "node_bits")
    mass = day_march.bit_rows(params, "mass_bits")
    count = nodes.sum(dim=0)
    last = (count - 1).clamp(min=0)[None]
    return nodes[0] & ~mass[0], (count > 0) & ~mass.gather(0, last)[0]


def section_g(gw_args):
    """No-mass iterations x conductance scale: the 2-day gradient, and the
    f64 kernel's sensitivity to its start state."""
    eps = 1e-9
    for iters in (1, 2, 3):
        for u in (1.0, 1.2):
            gw = dict(mode="parity", config_kw=dict(nomass_fixed_iters=iters), u_scale=u)
            vals = {}
            for name, dtype in DTYPES.items():
                run, fr, seq = cs.grad_workload(*gw_args, dtype, 2, 1, **gw)
                t0 = time.time()
                vals[name] = run()
                torch.cuda.synchronize()
                vals[name + "_s"] = time.time() - t0
                del run
            # fr: the f64 runner, holding the scaled parameter rows
            T, zT = fr.to_blocked(fr._tm.initial_state())
            noise = torch.as_tensor(np.random.default_rng(13).normal(size=tuple(T.shape)), device="cuda")
            Tm, zTm = T + eps * noise * day_march.bit_rows(fr.params, "node_bits"), zT
            growth = []
            for hi in fr.kernel_inputs(seq):
                T, zT = fr.hour_march(fr.params, T, zT, hi)[:2]
                Tm, zTm = fr.hour_march(fr.params, Tm, zTm, hi)[:2]
                growth.append((float((T - Tm).abs().max()) / eps, float((zT - zTm).abs().max()) / eps))
            print(f"G nomass_fixed_iters={iters}, u_scale {u}: 2-day loss / dL/du / dL/dalpha f32 "
                  + " / ".join(f"{x:.8g}" for x in vals["f32"]) + f" ({vals['f32_s']:.1f} s), f64 "
                  + " / ".join(f"{x:.8g}" for x in vals["f64"]) + f" ({vals['f64_s']:.1f} s); f64 kernel started "
                  f"{eps:g} K apart: nodes {growth[0][0]:.3g} x, zones {growth[0][1]:.3g} x after day 1, nodes "
                  f"{growth[1][0]:.3g} x, zones {growth[1][1]:.3g} x after day 2", flush=True)
            del fr, seq
            torch.cuda.empty_cache()


def section_h(gw_args):
    """The gradient workload's first day-launch: kernels vs plain versions,
    and the film coefficients on no-mass faces hour by hour."""
    gw = dict(mode="parity", config_kw=dict(nomass_fixed_iters=1))
    side = {}
    for name, dtype in DTYPES.items():
        run, fr, seq = cs.grad_workload(*gw_args, dtype, 1, 1, **gw)
        run()  # blocks the scaled parameter rows into fr.params
        T, zT = fr.to_blocked(fr._tm.initial_state())
        side[name] = (fr, seq, T, zT, fr.kernel_inputs(seq)[0])
    fr, seq, T, zT, hi = side["f32"]
    hm, params = fr.hour_march, fr.params
    got, ref = hm(params, T, zT, hi), hm.plain(params, T, zT, hi)
    mass = day_march.bit_rows(params, "mass_bits")
    nomass = day_march.bit_rows(params, "node_bits") & ~mass
    dT = (got[0] - ref[0]).abs()
    print(f"H forward, f32 kernel vs f32 plain twin over 24 h: T massive {float(dT[mass].max()):.3e}, T no-mass "
          f"{float(dT[nomass].max()):.3e}, zT {float((got[1] - ref[1]).abs().max()):.3e}, h/q "
          + " ".join(f"{float((a - b).abs().max()):.2e}" for a, b in zip(got[2], ref[2]))
          + "; zt_hist per hour: " + " ".join(f"{float(x):.1e}" for x in (got[3] - ref[3]).abs().amax(dim=(1, 2))),
          flush=True)
    print("H sensitivity of that launch (chip_smoke.parity_sensitivity): nodes %.3g x, zones %.3g x"
          % cs.parity_sensitivity(torch, hm, params, T, zT, hi), flush=True)
    sub = fr._substeps
    valid = torch.as_tensor(np.asarray(fr.layout.zone_table).reshape(got[3].shape[1:]) >= 0, device="cuda")
    d_hist = 2.0 * (got[3] - 21.0) * valid / (24 * 1000)
    del ref
    grads = {}
    for name in DTYPES:
        f, _, Tn, zn, hn = side[name]
        adj = day_adjoint.make_day_adjoint(f._bb, substeps=sub, mode="parity", hours=24)
        cots = (torch.zeros_like(Tn), torch.zeros_like(zn), d_hist.to(Tn.dtype))
        if name == "f32":
            grads["kernel"] = cs.flat_grads(adj(f.params, Tn, zn, hn, cots))
        t0 = time.time()
        grads[name] = cs.flat_grads(adj.plain(f.params, Tn, zn, hn, cots))
        torch.cuda.synchronize()
        grads[name + "_s"] = time.time() - t0
    for name in DTYPES:
        gaps = {n: float((grads["kernel"][n].double() - v.double()).norm()) / float(v.norm())
                for n, v in grads[name].items() if float(v.norm()) > 0}
        worst = max(gaps, key=gaps.get)
        print(f"H adjoint, f32 kernel vs {name} plain adjoint ({grads[name + '_s']:.1f} s), the loss's own "
              f"cotangent: worst relative L2 {gaps[worst]:.3e} ({worst}); "
              + ", ".join(f"{n} {v:.2e}" for n, v in gaps.items()), flush=True)
    del grads
    torch.cuda.empty_cache()

    # Film coefficients at the hour ends, through hours=1 launches
    r1 = fr._tm.fast_runner(mode="parity", hours=1)
    front, back = nomass_faces(params)
    for label, p in (("u_scale 1.2", params), ("u_scale 1.0", r1.params)):
        Th, zh, lows = T, zT, []
        for h1 in r1.kernel_inputs(seq):
            Th, zh, hq = r1.hour_march(p, Th, zh, h1)[:3]
            h = torch.cat((hq[0][front], hq[1][back]))
            lows.append((float(h.min()), int((h < 0.6).sum()), int((h < 0.32).sum())))
        print(f"H no-mass faces ({int(front.sum()) + int(back.sum())}), {label}: lowest film coefficient at each "
              "hour's end (faces under 0.6 / under 0.32 W/m2K): "
              + " ".join(f"{lo:.2f}({a}/{b})" for lo, a, b in lows), flush=True)


def main():
    want = set(sys.argv[1:]) or set("ABCDEFGH")
    if not torch.cuda.is_available():
        print("torch_parity_diag: no CUDA device", file=sys.stderr)
        return 2
    print(cs.card_facts(), flush=True)
    t0 = time.time()
    cuda_lib.build_many([("heatx_day_march", [day_march.KERNEL_SOURCE]),
                         ("heatx_day_adjoint", [day_adjoint.KERNEL_SOURCE])])
    day_march.load_kernel()
    day_adjoint.load_kernel()
    print(f"build {time.time() - t0:.1f} s (flags: {' '.join(cuda_lib.nvcc_flags())})", flush=True)
    gw_args = (torch, ThermalModel, SimConfig, testing)
    if "G" in want:
        section_g(gw_args)
    if "H" in want:
        section_h(gw_args)
    if want & set("ABCDEF"):
        sections_a_to_f(want)
    return 0


def sections_a_to_f(want):
    model = testing.build_city_model(1000, 10)
    tms = {n: ThermalModel(model, n=1, config=SimConfig(dtype=d, nomass_fixed_iters=1), device="cuda")
           for n, d in DTYPES.items()}

    def setup(name, hours):
        tm = tms[name]
        r = tm.fast_runner(mode="parity", hours=hours)
        T, zT = r.to_blocked(tm.initial_state())
        hi = r.kernel_inputs(testing.bench_inputs(tm.building, hours, device="cuda"), interp_weather=True)[0]
        return r, T, zT, hi

    def rel_l2(a, b):
        return float((a.double() - b.double()).norm()) / float(b.norm())

    # A. one day forward
    r, T, zT, hi = setup("f32", 24)
    r64, T64, zT64, hi64 = setup("f64", 24)
    pairs = ()
    if "A" in want:
        got, ref = r.hour_march(r.params, T, zT, hi), r.hour_march.plain(r.params, T, zT, hi)
        ref64 = r64.hour_march.plain(r64.params, T64, zT64, hi64)
        got64 = r64.hour_march(r64.params, T64, zT64, hi64)
        torch.cuda.synchronize()
        pairs = (("f32 kernel vs f32 plain", got, ref), ("f32 kernel vs f64 plain", got, ref64),
                 ("f32 plain vs f64 plain", ref, ref64), ("f64 kernel vs f64 plain", got64, ref64))
    mass = day_march.bit_rows(r.params, "mass_bits")
    nomass = day_march.bit_rows(r.params, "node_bits") & ~mass
    for what, a, b in pairs:
        dT = (a[0].double() - b[0].double()).abs()
        dz = (a[3].double() - b[3].double()).abs().amax(dim=(1, 2))
        print(f"A {what}: T massive {float(dT[mass].max()):.3e}, T no-mass {float(dT[nomass].max()):.3e} "
              f"({int((dT[nomass] > 1e-3).sum())} no-mass nodes apart by > 1e-3 K), zT final "
              f"{float((a[1].double() - b[1].double()).abs().max()):.3e}; zt_hist per hour: "
              + " ".join(f"{float(x):.1e}" for x in dz), flush=True)

    # B, C. horizons before the first 2-cycle
    d_hist = np.random.default_rng(3).normal(size=(24, r._bb.n_blocks, r._bb.zones_per_block)) / (24 * 1000)
    for H in (2, 6, 12) if want & set("BC") else ():
        out = {}
        for name in DTYPES:
            rh, Th, zh, hih = setup(name, H)
            adj = day_adjoint.make_day_adjoint(rh._bb, substeps=rh._substeps, mode="parity", hours=H)
            cots = (torch.zeros_like(Th), torch.zeros_like(zh),
                    torch.as_tensor(d_hist[:H], dtype=Th.dtype, device="cuda"))
            fk, fp = rh.hour_march(rh.params, Th, zh, hih), rh.hour_march.plain(rh.params, Th, zh, hih)
            gk = cs.flat_grads(adj(rh.params, Th, zh, hih, cots))
            t0 = time.time()
            gp = cs.flat_grads(adj.plain(rh.params, Th, zh, hih, cots))
            torch.cuda.synchronize()
            plain_s = time.time() - t0
            out[name] = (fk, gk, gp)
            worst_abs = max(float((gk[n] - v).abs().max()) / max(float(v.abs().max()), 1e-300) for n, v in gp.items())
            worst_l2 = max(rel_l2(gk[n], v) for n, v in gp.items() if float(v.norm()) > 0)
            print(f"B {H} h {name}: forward kernel vs plain max |d| T {float((fk[0] - fp[0]).abs().max()):.3e}, "
                  f"zt_hist {float((fk[3] - fp[3]).abs().max()):.3e}; adjoint kernel vs plain worst max |d| / "
                  f"max |ref| {worst_abs:.3e}, worst relative L2 {worst_l2:.3e}; plain adjoint {plain_s:.1f} s",
                  flush=True)
        gaps = {n: rel_l2(out["f32"][1][n], v) for n, v in out["f64"][2].items() if float(v.norm()) > 0}
        worst = max(gaps, key=gaps.get)
        print(f"C {H} h: f32 adjoint kernel vs f64 plain adjoint, worst relative L2 {gaps[worst]:.3e} ({worst})",
              flush=True)
        del out
        torch.cuda.empty_cache()

    # D. one day's adjoint through the evening's 2-cycles
    if not want & set("DEF"):
        return
    adj32 = day_adjoint.make_day_adjoint(r._bb, substeps=r._substeps, mode="parity", hours=24)
    adj64 = day_adjoint.make_day_adjoint(r64._bb, substeps=r._substeps, mode="parity", hours=24)
    c32 = (torch.zeros_like(T), torch.zeros_like(zT), torch.as_tensor(d_hist, dtype=torch.float32, device="cuda"))
    c64 = tuple(c.double() for c in c32)
    g32 = cs.flat_grads(adj32(r.params, T, zT, hi, c32))
    g64 = cs.flat_grads(adj64(r64.params, T64, zT64, hi64, c64))
    finite = all(bool(torch.isfinite(v).all()) for v in (*g32.values(), *g64.values()))
    print(f"D 24 h adjoint, f32 kernel vs f64 kernel (all finite: {finite}), relative L2 (|ref|, max |ref|): "
          + ", ".join(f"{n} {rel_l2(g32[n], v):.2e} ({float(v.norm()):.2e}, {float(v.abs().max()):.2e})"
                      for n, v in g64.items() if float(v.norm()) > 0), flush=True)

    # F. day-launch times
    for name, (rr, TT, zz, hh, adj, cc) in (("f32", (r, T, zT, hi, adj32, c32)),
                                            ("f64", (r64, T64, zT64, hi64, adj64, c64))):
        fwd = cs.event_ms(torch, lambda: rr.hour_march(rr.params, TT, zz, hh), 2)
        rev = cs.event_ms(torch, lambda: adj(rr.params, TT, zz, hh, cc), 1)
        print(f"F {name}: parity day-launch {fwd:.3f} ms, parity adjoint day-launch {rev:.3f} ms (CUDA events)",
              flush=True)

    # E. bench.py's gradient objective
    gw = dict(mode="parity", config_kw=dict(nomass_fixed_iters=1))
    for days, chunks in ((2, 1), (6, 2), (30, 2), (73, 1)) if "E" in want else ():
        for name, dtype in DTYPES.items():
            if days == 73 and name == "f64":
                continue
            run, _, _ = cs.grad_workload(torch, ThermalModel, SimConfig, testing, dtype, days, chunks, **gw)
            t0 = time.time()
            v = run()
            torch.cuda.synchronize()
            print(f"E {days} days in {chunks} chunk(s), {name}: loss {v[0]:.8g}, dL/du {v[1]:.8g}, dL/dalpha "
                  f"{v[2]:.8g} ({time.time() - t0:.1f} s)", flush=True)
            del run
            torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())

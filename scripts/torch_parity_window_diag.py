#!/usr/bin/env python3
"""How far the glazed city's f32 parity adjoint is from the f64 one over
chip_smoke.py's daytime window (phase 16b, hours 8-14), where that gap sits,
and how far it moves with the round-off of the window's start state.  Run
from the repository root on a card:

    python3 scripts/torch_parity_window_diag.py [--old-states FILE]
    python3 scripts/torch_parity_window_diag.py --tree DIR --save-states FILE

The glazed city (``testing.build_glazed_city(1000, 10)``) in parity mode
(118 sub-steps an hour, one no-mass iteration) on its gradient workload's
parameters (seg_u x 1.2, front_alphas x 0.8, blocked as
``FastRunner.chunk_forward`` blocks them) and inputs (the bench weather's
first day, luminaires off).  From each start state it marches the f32 adjoint
kernel (and, where marked, the f32 plain adjoint) and the f64 adjoint kernel
over the window with the loss's cotangent on the f32 forward's zone history,
and prints the relative L2 gap per output against the f64 one, over all lanes
and over the cavity lanes.  The start states: the f32 kernel's at 8 h, and
moved by +-1 ulp (``--seeds`` draws); the f64 kernel's at 8 h rounded to f32,
and moved likewise; the f32 kernel's at 6, 7, 9 and 10 h (the window then
starts there).  For the first two it splits the squared gap of
``d_ir_front`` by cavity lane and hour; over the window it records the
branch decisions of the f32 and f64 plain marches from the f32 kernel's
state (the TARP natural h: near zero, sign, the MIN_H floor; the cavity:
the faces' order, the Ra bands, the Nusselt maximum) and prints where they
differ.  ``--tree DIR --save-states FILE`` imports ``heatx_torch`` from
another checkout (an older commit unpacked with ``git archive``), and saves
its f32 kernel's states at 6-10 h; ``--old-states FILE`` evaluates those
here too, with seeds at 8 h.  About 8 min on an H100.
"""

import argparse
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

import torch

INF = float("inf")
W0, H = 8, 6  # chip_smoke.py PARITY_WINDOW_START, PARITY_PLAIN_HOURS
LOSS_SCALE = 2 * 24 * 1000  # mean((zt - 21)^2) over 2 days of 1,000 zones


def log(t0, *a):
    print(f"[{time.time() - t0:6.1f} s]", *a, flush=True)


def hour_window(hi, start, hours, sub):
    """Hours ``start`` to ``start + hours`` of a day-launch's hour inputs
    (weather rows by sub-step, the rest by hour)."""
    return tuple((x[start * sub:(start + hours) * sub] if i < 3 else x[start:start + hours]).contiguous()
                 for i, x in enumerate(hi))


def flat(g):
    out = {k: v for k, v in g.items() if k != "d_params"}
    out.update(g["d_params"])
    return out


def gaps(got, ref, lanes=None):
    """Relative L2 gap per output (``lanes`` keeps those columns of the
    per-lane outputs)."""
    out = {}
    for name, r in ref.items():
        g = got[name]
        if lanes is not None:
            if r.shape[-1] != lanes.shape[0]:
                continue
            r, g = r[..., lanes], g[..., lanes]
        norm = float(r.norm())
        out[name] = float((g.to(r.dtype) - r).norm()) / norm if norm else float(g.abs().max())
    return out


def worst(d):
    name = max(d, key=d.get)
    return f"{d[name]:.3e} ({name})"


def ulp_noise(x, seed):
    """``x`` with every nonzero entry moved one ulp up or down at random."""
    gen = torch.Generator().manual_seed(seed)
    up = (torch.rand(x.shape, generator=gen) < 0.5).to(x.device)
    y = torch.nextafter(x, torch.where(up, torch.full_like(x, INF), torch.full_like(x, -INF)))
    return torch.where(x != 0, y, x)


def runner(ThermalModel, SimConfig, testing, dtype):
    """The gradient workload's parity runner, its blocked start state and the
    first day's hour inputs."""
    tm = ThermalModel(testing.build_glazed_city(1000, 10), n=1, device="cuda",
                      config=SimConfig(dtype=dtype, nomass_fixed_iters=1))
    b = tm.building
    fr = tm.fast_runner(mode="parity", hours=24)
    sb = b.surfaces
    scale = {k: torch.tensor(v, dtype=dtype, device="cuda") for k, v in (("u", 1.2), ("a", 0.8))}
    sb = dataclasses.replace(sb, seg_u=torch.as_tensor(sb.seg_u, device="cuda") * scale["u"],
                             front_alphas=torch.as_tensor(sb.front_alphas, device="cuda") * scale["a"])
    with torch.no_grad():
        fr.params = fr._blocked_params(dataclasses.replace(b, surfaces=sb))
    seq = testing.bench_inputs(b, 48, device="cuda")
    seq = seq.replace(lum_power=torch.zeros_like(seq.lum_power))
    from heatx_torch.engine.adjoint import tree_map

    hi = fr.kernel_inputs(tree_map(lambda v: v[:24] if v.ndim and v.shape[0] == 48 else v, seq))[0]
    T, zT = fr.to_blocked(tm.initial_state())
    return fr, T, zT, hi


def build(cuda_lib, day_march, day_adjoint=None):
    """The kernels' sources, one nvcc each, all started together."""
    cuda_lib.build_many([("heatx_day_march", day_march.KERNEL_SOURCES)]
                        + ([("heatx_day_adjoint", day_adjoint.KERNEL_SOURCES)] if day_adjoint else []))
    day_march.load_kernel()
    if day_adjoint:
        day_adjoint.load_kernel()


def save_states(args, t0):
    sys.path.insert(0, str(Path(args.tree).resolve()))
    from heatx_torch import SimConfig, ThermalModel, testing
    from heatx_torch.ops import cuda_lib, day_march

    build(cuda_lib, day_march)
    fr, T, zT, hi = runner(ThermalModel, SimConfig, testing, torch.float32)
    states = {}
    for w in range(6, 11):
        lead = day_march.hour_march_for(fr._bb, mode="parity", hours=w)
        states[w] = tuple(x.cpu() for x in lead(fr.params, T, zT, hour_window(hi, 0, w, fr._substeps))[:2])
    torch.save(states, args.save_states)
    log(t0, f"saved the f32 kernel's states at 6-10 h of {args.tree} to {args.save_states}")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--tree", help="with --save-states: the checkout whose heatx_torch marches")
    ap.add_argument("--save-states")
    ap.add_argument("--old-states")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_parity_window_diag: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.time()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    if args.save_states:
        return save_states(args, t0)
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from heatx_torch import SimConfig, ThermalModel, testing
    from heatx_torch.engine import surface as surf_mod
    from heatx_torch.ops import cuda_lib, day_adjoint, day_march
    from heatx_torch.physics import gas as gas_mod

    build(cuda_lib, day_march, day_adjoint)
    fr, T0, zT0, hi = runner(ThermalModel, SimConfig, testing, torch.float32)
    fr64, _, _, hi64 = runner(ThermalModel, SimConfig, testing, torch.float64)
    sub, p, p64 = fr._substeps, fr.params, fr64.params
    cav = day_march.bit_rows(p, "cav_bits").any(0)
    NB, ZB = fr._bb.n_blocks, fr._bb.zones_per_block
    valid = torch.as_tensor(fr.layout.zone_table, device="cuda").reshape(NB, ZB) >= 0
    cot_hist = (2.0 * (fr.hour_march(p, T0, zT0, hi)[3] - 21.0) * valid / LOSS_SCALE).contiguous()
    adj = day_adjoint.make_day_adjoint(fr._bb, substeps=sub, mode="parity", hours=H, device="cuda")
    adj64 = day_adjoint.make_day_adjoint(fr64._bb, substeps=sub, mode="parity", hours=H, device="cuda")

    def state(w, dtype=torch.float32):
        r, pp, h = (fr, p, hi) if dtype == torch.float32 else (fr64, p64, hi64)
        lead = day_march.hour_march_for(r._bb, mode="parity", hours=w)
        return tuple(x.float() for x in lead(pp, T0.to(dtype), zT0.to(dtype), hour_window(h, 0, w, sub))[:2])

    def grads(T, zT, w, plain=False):
        cot = (torch.zeros_like(T), torch.zeros_like(zT), cot_hist[w:w + H].contiguous())
        hw, hw64 = hour_window(hi, w, H, sub), hour_window(hi64, w, H, sub)
        g = flat(adj(p, T, zT, hw, cot))
        g64 = flat(adj64(p64, T.double(), zT.double(), hw64, tuple(c.double() for c in cot)))
        return g, g64, (flat(adj.plain(p, T, zT, hw, cot)) if plain else None)

    def line(g, g64, gp=None):
        s = f"the f32 adjoint kernel {worst(gaps(g, g64))}, cavity lanes {worst(gaps(g, g64, cav))}"
        if gp is not None:
            s += f"; the f32 plain adjoint {worst(gaps(gp, g64))}, cavity lanes {worst(gaps(gp, g64, cav))}"
        return s

    def seeds(T, zT, w):
        vals = [gaps(*grads(ulp_noise(T, s), ulp_noise(zT, 1000 + s), w)[:2], cav)["d_ir_front"]
                for s in range(1, args.seeds + 1)]
        return (", ".join(f"{v:.3e}" for v in vals)
                + f" (min {min(vals):.3e}, max {max(vals):.3e}, {sum(v > 5e-3 for v in vals)} above 5e-3)")

    def split(name, g, g64):
        e = (g["d_ir_front"].double() - g64["d_ir_front"])[..., cav]
        e2 = e.pow(2) / e.pow(2).sum()
        lane, hour = e2.sum(0), e2.sum(1)
        top = torch.argsort(lane, descending=True)[:5]
        lanes = cav.nonzero().squeeze(1)[top].tolist()
        log(t0, f"{name}: the squared gap of d_ir_front on the cavity lanes by hour "
            + ", ".join(f"{W0 + i} h {float(x):.3f}" for i, x in enumerate(hour))
            + "; its five largest lanes " + ", ".join(f"{l} {float(lane[j]):.3f}" for l, j in zip(lanes, top)))
        return lanes

    Tk, zTk = state(W0)
    g, g64, _ = grads(Tk, zTk, W0)
    log(t0, f"from the f32 kernel's state at {W0} h: {line(g, g64)}")
    top = split("from the f32 kernel's state", g, g64)
    Tr, zTr = state(W0, torch.float64)
    g, g64, _ = grads(Tr, zTr, W0)
    log(t0, f"from the f64 kernel's state at {W0} h, rounded: {line(g, g64)}")
    split("from the f64 kernel's state", g, g64)
    log(t0, f"d_ir_front on the cavity lanes from the f32 kernel's state moved by +-1 ulp: {seeds(Tk, zTk, W0)}")
    log(t0, f"d_ir_front on the cavity lanes from the f64 kernel's state (rounded) moved by +-1 ulp: "
        f"{seeds(Tr, zTr, W0)}")
    g, g64, gp = grads(ulp_noise(Tk, 1), ulp_noise(zTk, 1001), W0, plain=True)
    log(t0, f"from the f32 kernel's state moved by +-1 ulp (seed 1): {line(g, g64, gp)}")
    for w in (6, 7, 9, 10):
        g, g64, gp = grads(*state(w), w, plain=w in (7, 9))
        log(t0, f"hours {w}-{w + H} from the f32 kernel's state at {w} h: {line(g, g64, gp)}")
    if args.old_states:
        old = torch.load(args.old_states)
        To, zTo = (x.cuda() for x in old[W0])
        log(t0, f"--old-states at {W0} h against this kernel's: max |d T| {float((To - Tk).abs().max()):.3e} K")
        for w, (To, zTo) in sorted(old.items()):
            To, zTo = To.cuda(), zTo.cuda()
            g, g64, gp = grads(To, zTo, w, plain=w == W0)
            log(t0, f"hours {w}-{w + H} from the --old-states state at {w} h: {line(g, g64, gp)}")
            if w == W0:
                log(t0, f"d_ir_front on the cavity lanes from it moved by +-1 ulp: {seeds(To, zTo, w)}")

    # The branch decisions of the plain marches over the window, f32 and f64.
    rec = {}
    tarp0, ray0, nu0 = surf_mod.tarp_natural_convection_coefficient, gas_mod.rayleigh, gas_mod._nu_90

    def tarp(air, surf, cos, coeffs=None):
        h = tarp0(air, surf, cos, coeffs)
        dt = air - surf
        rec.setdefault("tarp", []).append(torch.stack(torch.broadcast_tensors(
            (dt.abs() < 1e-3) | (cos.abs() < 1e-3), dt * cos > 0, h <= 0.1)).reshape(3, -1))
        rec.setdefault("adt", []).append(dt.abs().reshape(-1).double())
        return h

    def ray(gas, tf, tb, thickness):
        ra = ray0(gas, tf, tb, thickness)
        rec.setdefault("cavity", []).append(torch.stack((tf > tb, ra > 1e4, ra >= 5e4)).reshape(3, -1))
        return ra

    def nu90(ra, a_gi):
        nu1 = torch.where(ra <= 1e4, 1.0 + 1.7596678e-10 * ra**2.2984755,
                          torch.where(ra < 5e4, 0.028154 * ra**0.4134, 0.0673838 * ra ** (1.0 / 3.0)))
        rec.setdefault("nusselt", []).append((nu1 >= 0.242 * (ra / a_gi) ** 0.272).reshape(1, -1))
        return nu0(ra, a_gi)

    runs = {}
    surf_mod.tarp_natural_convection_coefficient, gas_mod.rayleigh, gas_mod._nu_90 = tarp, ray, nu90
    try:
        for name, r, pp, T, zT, h in (("f32", fr, p, Tk, zTk, hi), ("f64", fr64, p64, Tk.double(), zTk.double(), hi64)):
            rec = {}
            with torch.no_grad():
                day_march.hour_march_for(r._bb, mode="parity", hours=H).plain(pp, T, zT, hour_window(h, W0, H, sub))
            runs[name] = rec
    finally:
        surf_mod.tarp_natural_convection_coefficient, gas_mod.rayleigh, gas_mod._nu_90 = tarp0, ray0, nu0
    SP = cav.numel()
    for key, kinds in (("tarp", ("near zero", "same sign", "MIN_H floor")),
                       ("cavity", ("front warmer", "Ra > 1e4", "Ra >= 5e4")), ("nusselt", ("nu1 >= nu2",))):
        a, b = torch.stack(runs["f32"][key]), torch.stack(runs["f64"][key])
        mis = a != b
        s = ", ".join(f"{k} {int(mis[:, i].sum())} (the f64 march flips it {int((b[1:, i] != b[:-1, i]).sum())} times)"
                      for i, k in enumerate(kinds))
        log(t0, f"the plain marches over hours {W0}-{W0 + H} from the f32 kernel's state, {key}: decisions that "
            f"differ between f32 and f64, {s}")
        if key == "tarp":
            per_lane = mis[:, 2].reshape(-1, SP).sum(0)
            adt = torch.stack(runs["f64"]["adt"]).reshape(-1, 2, SP)  # each evaluation: front, back
            log(t0, f"  lanes where the MIN_H floor differs: {int((per_lane > 0).sum())}, "
                f"{int((per_lane[cav] > 0).sum())} of them cavity lanes; the gap's five largest lanes: "
                + "; ".join(f"{l}: {int(per_lane[l])} differing decisions, the f64 march's least |dT| "
                            f"front {float(adt[:, 0, l].min()):.2e} K, back {float(adt[:, 1, l].min()):.2e} K"
                            for l in top))
    return 0


if __name__ == "__main__":
    sys.exit(main())

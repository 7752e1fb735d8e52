#!/usr/bin/env python3
"""The adaptive no-mass loop on the bench city's 2-cycles, on one NVIDIA GPU.

With one relaxed no-mass iteration per sub-step (bench.py's parity rows,
``nomass_fixed_iters=1``), weakly coupled no-mass faces of the bench city
(``build_city_model(1000, 10)``, conductance scale 1.0, 118 sub-steps per
hour) 2-cycle on the bench day's evening, and the march then amplifies
round-off; two iterations remove the cycle.  This script asks what heatx's
default, the adaptive loop (``nomass_fixed_iters=None``), does there.  Run
from the repository root (~3 min on an H100):

    python3 scripts/torch_adaptive_diag.py [--start 18] [--hours 6]

It builds the day-march kernel, marches the bench day's first ``start``
hours on the f64 kernel with one iteration, and from that state marches the
window of ``hours`` on the f64 plain version with 1 and 2 iterations and
with the adaptive loop, keeping each sub-step's no-mass face temperatures
(the no-mass solve's output at node 0 and the last node).  A face 2-cycles
where, over the window's last two hours, its sub-step differences change
sign at nine steps in ten and average more than 1e-4 K.  It prints

* the faces that 2-cycle with one iteration, and whether they still do
  with two and with the adaptive loop;
* the adaptive loop's stopping iterations on those faces' runs and on the
  others (mean, p99, max, the shares that stop on the increase-break and
  that reach the 100-iteration escalation and the 500 cap);
* the adaptive and 1-iteration windows against the 2-iteration one on
  those faces and elsewhere, with the faces' alternating swing, and the
  adaptive f64 kernel against its plain version over the window: on every
  lane, and off the runs whose closest stop decision in the plain version
  lay within a margin of its threshold (the mean error to the tolerance, the
  error to the last accepted one) and off their zones, for margins from
  1e-12 to 1e-4 K; on the faces that still 2-cycle with the adaptive loop
  and off them; and hour by hour, each from its own state, with one and two
  iterations as well, beside the plain version's first hour from a start
  state moved by 1e-12 K;
* how far one f64 day-launch of each carries a start state moved by 1e-3 K
  (``chip_smoke.parity_sensitivity``).
"""

import argparse
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from heatx_torch import SimConfig, ThermalModel, testing  # noqa: E402
from heatx_torch.engine import surface as surf  # noqa: E402
from heatx_torch.ops import day_march  # noqa: E402

#: A 2-cycling face: the share of its sub-step differences that change sign,
#: and their mean size, K, over the window's last two hours.
ALTERNATION = 0.9
MIN_STEP = 1e-4
#: The margins (K) of a stop decision to its threshold that count as near.
MARGINS = (1e-12, 1e-10, 1e-8, 1e-6, 1e-4)
#: The move of the start state (K) that stands for round-off.
EPS = 1e-12


def face_trajectory(hm, params, T, zT, hi):
    """The plain march of ``hi`` from (T, zT), with each sub-step's no-mass
    solve output at the two faces ``[sub-steps, 2, SP]`` and the stopping
    iterations of its runs (``surf.NomassStops``)."""
    faces = []
    orig = surf.march_nomass

    def kept(sb, T0, *a, **k):
        out = orig(sb, T0, *a, **k)
        faces.append(torch.stack([out[0], surf._last_node(sb, out)]))
        return out

    surf.march_nomass = kept
    try:
        with surf.record_nomass_stops() as rec:
            outs = hm.plain(params, T, zT, hi)
    finally:
        surf.march_nomass = orig
    return outs, torch.stack(faces), rec


def cycling(traj, sub):
    """[2, SP] bool: the faces that 2-cycle over the trajectory's last two
    hours (see the module docstring)."""
    d = torch.diff(traj[-2 * sub:], dim=0)
    flips = (d[1:] * d[:-1] < 0).double().mean(dim=0)
    return (flips > ALTERNATION) & (d.abs().mean(dim=0) > MIN_STEP)


def run_stats(it, present, broke, where):
    runs, brk = it[present & where], broke[present & where]
    if runs.size == 0:
        return "no runs"
    return (f"{runs.size:,} runs x sub-steps: mean {runs.mean():.3f}, p99 {np.percentile(runs, 99):.0f}, max "
            f"{int(runs.max())}, increase-break {brk.mean():.2e}, >= 101 {(runs >= 101).mean():.2e}, "
            f"500 {(runs >= 500).mean():.2e}")


def near_stops(runner, got, ref, stops, hours):
    """Print the adaptive f64 kernel's window ``got`` against its plain
    version ``ref``: on every lane, and off the runs whose closest stop
    decision lay within each of MARGINS of its threshold and off their
    zones (``chip_smoke.clean_lanes``)."""
    err = max(float((got[i] - ref[i]).abs().max()) for i in (0, 1, 3))
    print(f"adaptive f64 kernel vs its plain version over the window: max |d| {err:.3e} K", flush=True)
    _, present, _, closest = stops
    nodes = day_march.bit_rows(runner.params, "node_bits").any(0)
    zinv = runner._zinv
    dT = (got[0] - ref[0]).abs()
    dh = (got[3] - ref[3]).reshape(hours, -1)[:, zinv].abs()
    for margin in MARGINS:
        near = (closest <= margin) & present
        lanes, zones = cs.clean_lanes(runner, runner._tm.building, nodes & torch.as_tensor(
            ~near.any(axis=(0, 1)), device=nodes.device))
        off_T = float(dT[:, lanes].max()) if bool(lanes.any()) else 0.0
        off_h = float(dh[:, torch.as_tensor(zones, device=dh.device)].max()) if zones.any() else 0.0
        print(f"  closest stop decision within {margin:g} K of its threshold: {int(near.sum()):,} runs x sub-steps, "
              f"{int((nodes & ~lanes).sum()):,} lanes and {int((~zones).sum()):,} zones left out; off them max |d T| "
              f"{off_T:.3e} K, zone history {off_h:.3e} K", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--start", type=int, default=18, help="hour of the bench day the window starts at")
    ap.add_argument("--hours", type=int, default=6, help="the window's length, hours")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_adaptive_diag: no CUDA device", file=sys.stderr)
        return 2
    os.environ["HEATX_KERNEL_WHILE"] = "1"
    print(cs.card_facts(), flush=True)
    t0 = time.time()
    day_march.load_kernel()
    print(f"built the day march in {time.time() - t0:.1f} s", flush=True)

    model = testing.build_city_model(1000, 10)
    runners = {}
    for name, iters in (("1 iteration", 1), ("2 iterations", 2), ("adaptive", None)):
        tm = ThermalModel(model, config=SimConfig(dtype=torch.float64, nomass_fixed_iters=iters), device="cuda")
        runners[name] = tm.fast_runner(mode="parity", hours=24)
    r1 = runners["1 iteration"]
    sub = r1._substeps
    T, zT = r1.to_blocked(r1._tm.initial_state())
    hi = r1.kernel_inputs(testing.bench_inputs(r1._tm.building, 24, device="cuda"), interp_weather=True)[0]
    lead = day_march.hour_march_for(r1._bb, mode="parity", hours=args.start)
    Ts, zTs = lead(r1.params, T, zT, cs.hour_window(hi, 0, args.start, sub))[:2]
    hiw = cs.hour_window(hi, args.start, args.hours, sub)
    W = (args.start, args.start + args.hours)

    outs, trajs, stops = {}, {}, None
    for name, r in runners.items():
        hm = day_march.hour_march_for(r._bb, mode="parity", hours=args.hours)
        t0 = time.time()
        outs[name], trajs[name], rec = face_trajectory(hm, r.params, Ts, zTs, hiw)
        torch.cuda.synchronize()
        print(f"{name}: the f64 plain window, hours {W[0]}-{W[1]}, {time.time() - t0:.1f} s", flush=True)
        if name == "adaptive":
            stops = rec.stacked()
            got = hm(r.params, Ts, zTs, hiw)
            near_stops(r, got, outs[name], stops, args.hours)

    faces = {name: cycling(tr, sub) for name, tr in trajs.items()}
    cyc = faces["1 iteration"]
    n_faces = int(cyc.sum())
    lanes = cyc.any(dim=0)
    print(f"faces that 2-cycle with 1 iteration over hours {W[1] - 2}-{W[1]}: {n_faces} ({int(lanes.sum())} lanes); "
          f"of them still cycling with 2 iterations {int((faces['2 iterations'] & cyc).sum())}, with the "
          f"adaptive loop {int((faces['adaptive'] & cyc).sum())}; cycling faces anywhere: 2 iterations "
          f"{int(faces['2 iterations'].sum())}, adaptive {int(faces['adaptive'].sum())}", flush=True)

    # Where the f64 kernel parts from its plain version: the faces that
    # still 2-cycle with the adaptive loop (their swing beside it), or not.
    ra = runners["adaptive"]
    acyc = faces["adaptive"].any(dim=0)
    dT = (got[0] - outs["adaptive"][0]).abs().amax(dim=0)
    off, zones = cs.clean_lanes(ra, ra._tm.building, ~acyc)
    last = trajs["adaptive"][-2 * sub:]
    swing = ((last[2:] - 2 * last[1:-1] + last[:-2]).abs().amax(dim=0) / 4).amax(dim=0)
    worst = int(torch.argmax(dT))
    print(f"adaptive f64 kernel vs its plain version at hour {W[1]}: max |d T| on the {int(acyc.sum())} lanes that "
          f"2-cycle with the adaptive loop {float(dT[acyc].max()) if bool(acyc.any()) else 0.0:.3e} K (their "
          f"largest swing {float(swing[acyc].max()) if bool(acyc.any()) else 0.0:.3e} K), off them and their "
          f"{int((~zones).sum())} zones {float(dT[off].max()):.3e} K; the largest gap's lane "
          f"{'cycles' if bool(acyc[worst]) else 'does not cycle'}, swing {float(swing[worst]):.3e} K", flush=True)

    # How the gap grows: the kernel and the plain version, hour by hour,
    # each from its own state, with the adaptive loop and with fixed
    # iterations (no stop decision at all).
    mask = day_march.bit_rows(ra.params, "node_bits")
    noise = torch.as_tensor(np.random.default_rng(13).normal(size=tuple(Ts.shape)), dtype=Ts.dtype, device=Ts.device)
    for name, r in runners.items():
        h1 = day_march.hour_march_for(r._bb, mode="parity", hours=1)
        (Tk, zk), (Tp, zp), row = (Ts, zTs), (Ts, zTs), []
        for h in range(args.hours):
            x = cs.hour_window(hiw, h, 1, sub)
            Tk, zk = h1(r.params, Tk, zk, x)[:2]
            with surf.record_nomass_stops() as rec_h:
                Tp, zp = h1.plain(r.params, Tp, zp, x)[:2]
            d = (Tk - Tp).abs().amax(dim=0)
            row.append(f"{W[0] + h + 1} h {float(d.max()):.3e} K ({int((d > 1e-9).sum())} lanes > 1e-9 K, "
                       f"{int((d[acyc] > 1e-9).sum())} of them 2-cycling with the adaptive loop)")
            if h == 0:  # the plain version's stops in the first hour, on the lanes apart and the others
                it_h, pres_h, broke_h, closest_h = rec_h.stacked()
                apart = np.broadcast_to((d > 1e-9).cpu().numpy(), it_h.shape)
                first = [f"{what}: {run_stats(it_h, pres_h, broke_h, where)}, closest stop decision "
                         f"{float(closest_h[pres_h & where].min()) if (pres_h & where).any() else np.inf:.3e} K"
                         for what, where in (("apart", apart), ("the others", ~apart))]
                # The plain version against itself from a start state moved by round-off.
                Tm = h1.plain(r.params, Ts + EPS * noise * mask, zTs, x)[0]
                dm = (Tm - Tp).abs().amax(dim=0)
                moved = (f"the plain version from a start moved by {EPS:g} K (seeded, valid nodes): "
                         f"{float(dm.max()):.3e} K after the hour, {int((dm > 1e-9).sum())} lanes > 1e-9 K, "
                         f"{int(((dm > 1e-9) & (d > 1e-9)).sum())} of them apart kernel vs plain")
        print(f"{name}: the f64 kernel vs its plain version, hour by hour: " + "; ".join(row)
              + f"; {moved}; the first hour's runs on the lanes {'; '.join(first)}", flush=True)

    it, present, broke, _ = stops
    on = np.broadcast_to(lanes.cpu().numpy(), it.shape)
    print(f"adaptive stops on the cycling lanes: {run_stats(it, present, broke, on)}", flush=True)
    print(f"adaptive stops on the other lanes: {run_stats(it, present, broke, ~on)}", flush=True)

    ref = outs["2 iterations"]
    for name in ("1 iteration", "adaptive"):
        dT = (outs[name][0] - ref[0]).abs()
        dz = (outs[name][3] - ref[3]).abs()
        last = trajs[name][-2 * sub:]
        amp = (last[2:] - 2 * last[1:-1] + last[:-2]).abs().amax(dim=0) / 4  # a 2-cycle's half-swing
        print(f"{name} vs 2 iterations at hour {W[1]}: max |d T| on the cycling lanes "
              f"{float(dT[:, lanes].max()) if n_faces else 0.0:.3e} K, elsewhere {float(dT[:, ~lanes].max()):.3e} K; "
              f"zone history max |d| {float(dz.max()):.3e} K; the cycling faces' alternating swing (a quarter of "
              f"the largest second difference) over the last two hours {float(amp[cyc].max()) if n_faces else 0.0:.3e} "
              f"K", flush=True)

    for name, r in runners.items():
        growth = cs.parity_sensitivity(torch, r.hour_march, r.params, T, zT, hi)
        print(f"{name}: one f64 bench-day launch carries a start state moved by {cs.PARITY_EPS:g} K to "
              f"{growth[0]:.3g} x on the nodes, {growth[1]:.3g} x on the zones", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

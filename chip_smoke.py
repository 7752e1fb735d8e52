#!/usr/bin/env python3
"""Smoke test of heatx_torch on one NVIDIA GPU: the quickest proof that the
port still builds, runs and agrees with itself on the card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (one output line each, then a JSON line per contract):

1. device: the CUDA device's name, and its name and power limit as
   ``nvidia-smi`` reports them.  Exits non-zero without a CUDA device.
2. build: compiles the day-march kernel (heatx_torch/csrc/day_march.cu)
   from the checkout with nvcc and prints the build time.
3. f64 check on a 4-zone city (40 surfaces), 3 h, modes trbdf2_refresh
   (k=2, k=8) and trbdf2: the CUDA kernel against its plain PyTorch twin on
   the same inputs, max |dT| <= 1e-9 K on T, zT and the zone history (the
   two differ only in summation order and fused multiply-adds).
4. the main path at full width: build_city_model(1000, 10) (10,000
   surfaces, 1,000 zones), trbdf2_refresh k=2, 8 sub-steps, hours=24,
   bench weather, 48 h through ThermalModel(..., device="cuda")
   .fast_runner(...).run: f32 on the kernel (which must launch exactly
   twice), f64 on the plain twin; every value finite, the [48, 1000] zone
   temperatures within 1e-2 K (f32 round-off against f64).
5. timing on the card, f32 at full width: 30 days through the kernel path,
   one day-kernel launch (CUDA events) at several lanes per block, and one
   day through the plain twin; the kernel against the plain twin on the
   same day's inputs (max |dT| <= 1e-2 K, f32 summation-order round-off).

6. build (the adjoint): the day-adjoint kernel (heatx_torch/csrc/
   day_adjoint.cu), compiled by its own nvcc started together with phase 2's;
   its ptxas registers/stack/spill lines.
7. f64 on the 4-zone city, 3 h, k=2, k=8 and frozen: the adjoint kernel
   against its plain PyTorch version (autograd through the plain day march)
   on seeded cotangents, max |d| <= 1e-9 max |ref| for every output; and a
   second oracle that shares nothing with the plain version: central finite
   differences of the forward KERNEL along seeded directions of T0, seg_u
   and front_alphas, relative error <= 1e-5.  Then the kernel against the
   plain version on testing.build_mixed_model (tilted roof, ground floor,
   partition, ambient back face), k=1, k=2 and frozen.
8. the gradient path at full width (bench city, f32, trbdf2_refresh k=2, 8
   sub-steps, hours=24): one day's adjoint on the kernel against the f64
   plain adjoint (relative L2 gap per output <= 1e-2); bench.py's
   run_grad_bench workload (its inputs, conductance and solar-absorptance
   scales, mean((zt - 21)^2)) through chunked_value_and_grad with
   FastRunner.chunk_forward/chunk_grad over 30 days in 2 chunks, f32 against
   f64, both on the kernels, with exactly 30 forward + 30 recompute day-march
   launches and 30 adjoint launches, every value finite and both gradients
   nonzero; the annual run (5 chunks of 73 days, host clock, once); the
   adjoint's ms per day-launch (CUDA events) and the f32 plain adjoint's
   time for one day.

9. thermostats, f64, small: testing.build_thermostat_model (4 zones, all
   controlled, one with 300 W of heating that the demand exceeds, one with
   100 W of cooling, a bidirectional mixing pair and a one-way flow; and the
   variant with an uncontrolled zone), 3 h, k=2, k=8 and frozen, compiled
   and scheduled setpoints: the forward kernel against its plain twin (T,
   zT, zone history <= 1e-9 K, load history <= 1e-9 of max |ref|) with the
   zone-sub-steps per branch printed; the adjoint kernel against the plain
   adjoint with a seeded load cotangent (every output, d_ctl_*/d_sp_*
   included, <= 1e-9 of max |ref|); central differences of the forward
   kernel for a loss on the loads, zone history and final state along
   ctl_heat_sp, a setpoint schedule and seg_u (<= 1e-5 relative), the
   branch masks checked equal at both ends of every difference.
10. the demand path at full width (bench.py run_demand_bench: the bench city
   with 1,000 thermostats at 20/26 C, luminaires at 150 W, f32, mode trbdf2,
   8 sub-steps, hours=24, collect_loads=True): 48 h on the kernel against
   the f64 plain twin (exactly 2 launches, all finite, zone T <= 1e-2 K,
   loads within LOAD_F32_RTOL of max |load|, heating kWh per zone > 0); the
   annual run twice by the host clock with the heating and cooling kWh per
   zone; one day-launch of the thermostat kernel (CUDA events).
11. the demand gradient at full width (bench.py _grad_demand_variant:
   u_scale on seg_u, sp_shift on ctl_heat_sp, loss mean((ld/1e3)^2)/C +
   1e-4 mean(zt)/C, trbdf2_refresh k=2): 30 days in 2 chunks, f32 against
   f64 on the kernels, exactly 60 day-march and 30 adjoint launches, dL/dsp
   != 0; one day's f32 adjoint (seeded load cotangent) against the f64
   plain adjoint; the annual run in 5 chunks of 73 days once by the host
   clock, and once under torch.profiler for the device's busy share and
   each kernel's part of it.

12. parity mode, f64, small (``testing.coarse_config``: 6 stability
   sub-steps per hour): the 4-zone city, testing.build_mixed_model,
   testing.build_nomass_run_model (no-mass runs of 3 and 4 nodes) and
   testing.build_thermostat_model, 1, 2 and 3 no-mass iterations, 2 h at the
   building's own dt_subdivisions: the parity forward kernel against its
   plain twin (T, zT, zone history, h/q <= 1e-9 K; loads <= 1e-9 of max
   |ref|), the parity adjoint kernel against the plain parity adjoint (every
   output <= 1e-9 of max |ref|) and, on the free-float buildings, against
   central differences of the forward kernel along T0, seg_u, mass and
   front_alphas (<= 1e-5 relative).
13. parity mode at full width: the bench city, f32, mode="parity", 118
   sub-steps per hour (the building's dt_subdivisions), nomass_fixed_iters=1,
   hours=24: 48 h on the kernel (exactly 2 launches, all finite) against the
   f64 plain twin (zone T <= 3e-2 K: on the bench day's evening the relaxed
   no-mass iteration 2-cycles on some faces and amplifies round-off, see
   PARITY_* below), and against the port's own trbdf2_refresh k=2 f32 run of
   the same 48 h (printed: the card-side stand-in for the accuracy gate until
   the EPW file is in the repository); one launch on the bench day timed
   (CUDA events), checked finite and measured for how far it carries a
   perturbation of its start state; the plain twin with and without flushing
   tiny RK4 stage values, 2 h f32 (printed); the annual run once by the host
   clock; ptxas registers, stack and spills of every instantiation (phases 2
   and 6).
14. the parity gradient at full width: bench.py's run_grad_bench objective
   in mode="parity", 30 days in 2 chunks in f32, exactly 60 day-march and 30
   adjoint launches, all of them the parity kernels, gradients finite and
   nonzero; 6 days in 2 chunks, f32 against f64 on the kernels.  Then both
   parity kernels against their plain versions at the shape that path
   launches, 24 h x 118 sub-steps, on the operands of its first day-launch
   (the conductance scale 1.2 keeps every face off the 2-cycle, which the
   phase measures): the day march on T, zT and the zone history (<= 2e-4 K)
   and on h/q (<= 1e-3), the adjoint on the loss's own cotangent, every output
   (relative L2 <= 2e-4 against the f32 plain adjoint).  The bench day's adjoint launch is
   timed and checked finite.  (The f64 plain adjoint, longer gradients and the
   2-cycles taken apart: scripts/torch_parity_diag.py; 73 days, one chunk of
   bench.py's five, take ~140 s on an H100.)

The line before the last is the kernels JSON line.  ``launches`` is each
kernel's count on this slice's main path, the 30-day parity gradient of
phase 14 (for the TR-BDF2 entries: the 30-day demand gradient of phase
11); ``launches_by_path`` lists every driven path (phases 4, 8b, 10, 11,
13, 14), each counted from 0.  ``ms`` is one f32 free-float bench-day launch
(CUDA events), ``plain_ms`` its f32 plain version on the same inputs,
``max_abs_err`` the f32 kernel against that plain version, ``bound_ms`` the
bound from this run's shapes; ``thermostat`` holds the same five numbers
for the thermostat instantiation on the demand city's day (same mode, k=2).
The two ``*_parity`` entries are the parity kernels on the first day-launch
of the 30-day parity gradient (24 h x 118 sub-steps, phase 14b), held against
their f32 plain versions there; ``ms_bench_day`` is the same launch on the
bench day's own operands.  The last line is ``{"ok": true, "device": {...}}``;
any failed check raises and the script exits non-zero.
"""

import copy
import dataclasses
import json
import subprocess
import sys
import time

from types import SimpleNamespace

import numpy as np

F64_TOL = 1e-9  # K: kernel vs plain twin, f64, same inputs
F32_TOL = 1e-2  # K: f32 against f64, or f32 kernel vs f32 twin, full width
BLOCK_SIZES = (32, 64, 128, 256)
ADJ_F64_RTOL = 1e-9  # of max |ref|: adjoint kernel vs plain adjoint, f64, same inputs
FD_RTOL = 1e-5  # central differences of the f64 forward kernel vs the adjoint kernel
# f32 adjoint kernel vs f64 plain adjoint, one bench day, relative L2 per
# output: f32 round-off carried through 192 sub-steps of forward and
# reverse sweeps; 2.3e-3 at most measured on an H100 80GB HBM3 at 700 W (PERF.md), bound 4x that.
ADJ_F32_RL2 = 1e-2
# The 30-day value_and_grad, f32 against f64 on the kernels, relative.  The
# two marches part where the windward test (facade normal . wind > 0) flips
# under f32 rounding: the synthetic weather blows exactly along the facades
# at hours 90 and 270 (cos(wd) is +-1e-16 in f64, -+4e-8 in f32), the forced
# film coefficient halves or doubles for that hour, and zone T moves by up to
# ~0.5 K (phase 8b prints it).  The loss and gradients then differ by 8.6e-3
# at most, measured on an H100 80GB HBM3 at 700 W (PERF.md); bound ~3.5x that.
GRAD_F32_RTOL = 3e-2
# Thermostats at full width, f32 kernel against f64 plain twin, 48 h: after a
# landing zT equals the setpoint to round-off and zT (1 + em) - t_set cancels,
# and an f32 zone-sub-step may take another branch than the f64 one (both
# continuous in the zone temperature, not in that sub-step's load).  The bound
# is relative to max |load| over the run.  Measured on an H100 80GB HBM3 at
# 700 W: 2.4e-5 over the 48 h of phase 10 (0.027 W of 1111 W; every zone
# heats or idles there, none sits on a capacity) and 2.6e-6 over one day in
# phase 11a; the bound leaves ~40x for a zone-sub-step that changes branch.
LOAD_F32_RTOL = 1e-3
# The thermostat adjoint, f32 kernel against the f64 plain adjoint, one demand
# day with a seeded load cotangent, relative L2 per output: 6.9e-3 at most
# (d_sol_back) measured on an H100 80GB HBM3 at 700 W, against the free-float
# day's 2.2e-3 (a zone held on its setpoint passes little of the zone
# cotangent on to the surfaces, so their outputs are small differences;
# presumed, not examined); bound ~3x the measurement.
ADJ_F32_RL2_TSTAT = 2e-2
# Parity mode at full width (nomass_fixed_iters=1, 118 sub-steps per hour).
# With one relaxed no-mass iteration per sub-step the iteration runs on from
# sub-step to sub-step, and it is not a contraction everywhere: K's diagonal
# holds U + h but not the linearized radiation, which sits in q at the old
# temperature, so the iterate moves by 1/2 - rad / (2 (U + h)) per sub-step.
# On the inner face of the bench city's insulated walls (U 1.26, rad ~5.5
# W/m2K) that is below -1 once the film coefficient h falls under ~0.6, and
# the face temperature settles on a 2-cycle.  From hour 19 of the first bench
# day on, two marches that differ by round-off (f32 and f64, kernel and plain
# twin, even the f64 kernel and the f64 twin) can sit on opposite phases of
# it: ~190 no-mass nodes then differ by up to 0.39 K and the zones by up to
# 4e-3 K, and the adjoint through such an episode amplifies round-off to
# order 1 (scripts/torch_parity_diag.py prints all of it).  heatx's scheme,
# not the port's: it is a property of the bench day's operands, not of the
# launch.  So each parity kernel is held against its plain version at the
# launch shape of the main path (24 h x 118 sub-steps, every lane of the
# bench city) on the operands of the gradient workload's first day, where
# the conductance scale 1.2 (U 1.51) lets no face settle on the 2-cycle (a
# face's film coefficient still touches its floor as it changes sign, too
# briefly to matter): phase 14b measures that (a start state moved by
# PARITY_EPS must end the day no more than PARITY_GROWTH_MAX times as far
# apart; 0.37 x measured, and 382 x on the bench day itself).  Two or more
# no-mass iterations per sub-step remove the cycle at either scale
# (scripts/torch_parity_diag.py G); bench.py's parity rows run one.  The bench day's own launches are timed and checked
# finite, and its 48 h get a bound that allows for the 2-cycles: 6.2e-3 K
# measured on zone T, f32 kernel vs f64 twin, on an H100 80GB HBM3 at 700 W.
PARITY_ITERS = 1  # bench.py's parity rows: nomass_fixed_iters=1
# f32 kernel vs f32 twin over the main path's first day; measured on an H100
# 80GB HBM3 at 700 W: 3.8e-5 K on T, 1.1e-5 K on the zone history, 2.1e-4 W/m2
# on q_front (a film coefficient of ~5 W/m2K times the surface's gap), and
# 1.9e-5 relative L2 at most on the adjoint's outputs (d_sol_back)
PARITY_DAY_TOL = 2e-4  # K: T, zT, the zone history
PARITY_HQ_TOL = 1e-3  # W/m2K and W/m2: h and q of the day's last sub-step
PARITY_ADJ_F32_RL2 = 2e-4  # f32 adjoint kernel vs f32 plain adjoint, relative L2 per output
PARITY_EPS = 1e-3  # K: the perturbation of parity_sensitivity
PARITY_GROWTH_MAX = 2.0
PARITY_F32_TOL = 3e-2  # K: zone T over 48 h of the bench days, f32 kernel vs f64 twin
PARITY_F64_DAYS = 6  # the f32-vs-f64 gradient comparison's depth
# Published H100 SXM rates (NVIDIA H100 datasheet): HBM bytes/s and the
# f32 FLOP/s outside the tensor cores (the kernels run no matrix products).
HBM_BPS = 3.35e12
PEAK_F32_FLOPS = 67e12


def card_facts():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def phase3_f64_check(torch, day_march, testing, SimConfig, compile_building):
    """Kernel vs plain twin, f64, 4-zone city, 3 h, three cadences."""
    hours, sub = 3, 8
    building = compile_building(
        testing.build_city_model(4, 10), n=1, config=SimConfig(dtype=torch.float64)
    )
    bb = day_march.block_building(building, block_size=16)
    lay = bb.layout
    S, SP = building.n_surfaces, lay.padded_surfaces
    rng = np.random.default_rng(0)
    solf = rng.uniform(0.0, 400.0, (hours, S))
    irf = rng.uniform(250.0, 400.0, (hours, S))
    weather = [rng.uniform(lo, hi, hours * sub) for lo, hi in ((-5, 15), (0, 8), (0, 6.28))]
    gains = np.zeros(building.n_zones)
    np.add.at(gains, building.hvac_pair_space, 500.0)
    np.add.at(gains, building.lum_space, 150.0)
    node_T = np.where(building.surfaces.node_mask, 22.0, 0.0)

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float64), device="cuda")

    hi = tuple(dev(w) for w in weather) + (
        dev(np.stack([lay.surfaces_to_blocked(solf[h]) for h in range(hours)])),
        dev(np.zeros((hours, SP))),
        dev(np.stack([lay.surfaces_to_blocked(irf[h]) for h in range(hours)])),
        dev(np.zeros((hours, SP))),
        dev(np.stack([lay.zones_to_blocked(gains)] * hours)),
        dev(np.zeros((hours, bb.n_blocks, bb.zones_per_block))),
    )
    T0 = dev(lay.surfaces_to_blocked(node_T))
    zT0 = dev(lay.zones_to_blocked(np.full(building.n_zones, 22.0)))
    worst = 0.0
    for mode, k in (("trbdf2_refresh", 2), ("trbdf2_refresh", 8), ("trbdf2", None)):
        hm, params = day_march.make_hour_march(
            bb, substeps=sub, mode=mode, hours=hours, refresh_every=k,
            collect_bad=True, device="cuda",
        )
        got = hm(params, T0, zT0, hi)
        ref = hm.plain(params, T0, zT0, hi)
        torch.cuda.synchronize()
        for name, i in (("T", 0), ("zT", 1), ("zt_hist", 3)):
            err = float((got[i] - ref[i]).abs().max())
            check(err <= F64_TOL, f"f64 {mode} k={k} {name}: max |d| {err} > {F64_TOL}")
            worst = max(worst, err)
        check(float(got[4].sum()) == 0.0, f"f64 {mode}: non-finite state in the kernel")
    return worst


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def day_work(params, hours, sub, k):
    """Operations of one day-march launch, counted from day_march.cu on this
    run's shapes (transcendentals count as one): per valid node and sub-step
    32 (two fused right-hand-side/forward sweeps and two back
    substitutions), per valid node and refresh 12 (K row, stage row, Thomas
    factor), per lane and sub-step 10 (face sums), per lane and refresh 50
    (film coefficients and linearized radiation), per zone and sub-step 20
    (zone sums and update); with thermostat rows 45 more per zone and
    sub-step (the landing power, the clamp, the second exponential update,
    the load sum), and 12 per mixing entry and sub-step."""
    import torch

    bits = params.field("node_bits").to(torch.int64)
    valid = int(sum(int(((bits >> i) & 1).sum()) for i in range(params.max_nodes)))
    lanes = params.surf.shape[1]
    zones = params.zone_volume.numel()
    per_sub = 32 * valid + 10 * lanes + 20 * zones
    if params.ctl is not None:
        per_sub += 45 * zones
    if params.mix is not None:
        per_sub += 12 * params.mix.src.numel()
    per_refresh = 12 * valid + 50 * lanes
    return hours * (sub * per_sub + (sub // k) * per_refresh), valid, lanes, zones


def adjoint_work(params, hours, sub, k):
    """Operations the day's adjoint needs, counted from day_adjoint.cu: one
    forward march of the day, then the reverse sweep's own work, per valid
    node and sub-step 60 (two transposed solves, two band cotangents, the
    right-hand sides and forcing backwards), per valid node and refresh 12
    (K's band backwards), per lane and sub-step 20, per lane and refresh 100
    (the operator build backwards), per zone and sub-step 30 (zone update
    backwards, face sums); with thermostat rows 90 more per zone and
    sub-step (the branch recomputed, the landing power backwards), and 20
    per mixing entry and sub-step.  The kernel's recomputation (the taped
    re-march of each hour, the operators rebuilt in the reverse) trades
    operations for memory and is not counted."""
    fwd, valid, lanes, zones = day_work(params, hours, sub, k)
    per_sub = 60 * valid + 20 * lanes + 30 * zones
    if params.ctl is not None:
        per_sub += 90 * zones
    if params.mix is not None:
        per_sub += 20 * params.mix.src.numel()
    per_refresh = 12 * valid + 100 * lanes
    return fwd + hours * (sub * per_sub + (sub // k) * per_refresh)


def param_tensors(params):
    """Every tensor of a DayMarchParams a launch reads (thermostat rows and
    mixing lists included, where the building has them)."""
    out = [params.node, params.surf, params.lane, params.zone_volume, params.zone_ptr, params.zone_faces]
    if params.ctl is not None:
        out.append(params.ctl)
    if params.mix is not None:
        m = params.mix
        out += [m.ptr, m.src, m.vol, m.t_ptr, m.t_dst, m.t_vol]
    return out


def bound(bytes_moved, ops):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and
    operations over the f32 peak."""
    t_bytes, t_ops = bytes_moved / HBM_BPS * 1e3, ops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_time(torch, fn):
    """Run ``fn`` once under torch.profiler: (the device's busy ms, {kernel:
    its ms}) for the day_march and day_adjoint kernels.  One stream, so the
    sum of the device events is the busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy, kern = 0.0, {"day_march": 0.0, "day_adjoint": 0.0}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.self_device_time_total
        busy += us
        for name in kern:
            if f"{name}_kernel" in e.key:
                kern[name] += us
    return busy / 1e3, {k: v / 1e3 for k, v in kern.items()}


def flat_grads(g):
    out = {k: v for k, v in g.items() if k != "d_params"}
    out.update(g["d_params"])
    return out


def adjoint_vs_plain(torch, adj, params, T0, zT0, hi, cots, what):
    """The adjoint kernel's outputs (flattened) after holding each against
    the plain adjoint's: max |d| <= ADJ_F64_RTOL max |ref|.  Returns them
    and the worst ratio."""
    got = flat_grads(adj(params, T0, zT0, hi, cots))
    ref = flat_grads(adj.plain(params, T0, zT0, hi, cots))
    worst = 0.0
    for name, r in ref.items():
        check(bool(torch.isfinite(got[name]).all()), f"adjoint {what} {name}: non-finite")
        scale = float(r.abs().max())
        err = float((got[name] - r).abs().max())
        check(err <= ADJ_F64_RTOL * scale, f"adjoint {what} {name}: max |d| {err} > {ADJ_F64_RTOL} x {scale}")  # exact where the reference is 0
        worst = max(worst, err / scale if scale else err)
    return got, worst


def phase7_adjoint_f64(torch, day_march, day_adjoint, testing, SimConfig, compile_building):
    """Adjoint kernel vs plain adjoint, and vs central differences of the
    forward kernel, f64, 4-zone city, 3 h, three cadences; then kernel vs
    plain on the mixed-boundary building (tilted roof, ground floor,
    partition, ambient back face: the branches the city lacks)."""
    hours, sub = 3, 8
    building = compile_building(
        testing.build_city_model(4, 10), n=1, config=SimConfig(dtype=torch.float64)
    )
    bb = day_march.block_building(building, block_size=16)
    lay = bb.layout
    S, N = building.n_surfaces, bb.max_nodes
    rng = np.random.default_rng(0)

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float64), device="cuda")

    def lanes(a):
        return dev(np.stack([lay.surfaces_to_blocked(x) for x in a]))

    def zones(a):
        return dev(np.stack([lay.zones_to_blocked(x) for x in a]))

    mask = building.surfaces.node_mask
    hi = tuple(dev(rng.uniform(lo, hi, hours * sub)) for lo, hi in ((-5, 15), (0, 8), (0, 6.28))) + (
        lanes(rng.uniform(0, 400, (hours, S))), lanes(rng.uniform(0, 50, (hours, S))),
        lanes(rng.uniform(250, 400, (hours, S))), lanes(rng.uniform(250, 400, (hours, S))),
        zones(rng.uniform(0, 900, (hours, building.n_zones))),
        zones(rng.uniform(0, 50, (hours, building.n_zones))),
    )
    # A random start state: away from the |dT| = 0 kink of the cube root, so
    # central differences see a smooth function.
    T0 = dev(lay.surfaces_to_blocked(np.where(mask, rng.uniform(15, 25, mask.shape), 0.0)))
    zT0 = dev(lay.zones_to_blocked(rng.uniform(18, 24, building.n_zones)))
    W_T = dev(lay.surfaces_to_blocked(rng.normal(size=mask.shape)))
    W_z = dev(lay.zones_to_blocked(rng.normal(size=building.n_zones)))
    W_h = zones(rng.normal(size=(hours, building.n_zones)))
    D_T = dev(lay.surfaces_to_blocked(np.where(mask, rng.normal(size=mask.shape), 0.0)))
    D_node = dev(lay.surfaces_to_blocked(rng.normal(size=mask.shape)))
    worst, worst_fd = 0.0, 0.0
    for mode, k in (("trbdf2_refresh", 2), ("trbdf2_refresh", 8), ("trbdf2", None)):
        hm, params = day_march.make_hour_march(bb, substeps=sub, mode=mode, hours=hours, refresh_every=k)
        adj = day_adjoint.make_day_adjoint(bb, substeps=sub, mode=mode, hours=hours, refresh_every=k)
        got, w = adjoint_vs_plain(torch, adj, params, T0, zT0, hi, (W_T, W_z, W_h), f"{mode} k={k}")
        worst = max(worst, w)

        def loss(p, T):
            Tn, zTn, _, hist = hm(p, T, zT0, hi)[:4]
            return float((Tn * W_T).sum() + (zTn * W_z).sum() + (hist * W_h).sum())

        def perturbed(row, d):
            node = params.node.clone()
            node[row] += d * params.node[row]
            return dataclasses.replace(params, node=node)

        eps = 1e-6
        fd_cases = {
            "T0": (got["dT0"], D_T, lambda e: loss(params, T0 + e * D_T)),
            "seg_u": (got["seg_u"], D_node * params.node[0], lambda e: loss(perturbed(0, e * D_node), T0)),
            "front_alphas": (got["front_alphas"], D_node * params.node[2],
                             lambda e: loss(perturbed(2, e * D_node), T0)),
        }
        for name, (grad, direction, f) in fd_cases.items():
            fd = (f(eps) - f(-eps)) / (2 * eps)
            an = float((grad * direction).sum())
            rel = abs(fd - an) / max(abs(an), 1e-300)
            check(rel <= FD_RTOL, f"adjoint {mode} k={k} d/d{name}: FD {fd} vs adjoint {an} (rel {rel})")
            worst_fd = max(worst_fd, rel)

    mixed = compile_building(testing.build_mixed_model(), n=1, config=SimConfig(dtype=torch.float64))
    bb = day_march.block_building(mixed)
    lay, S, mask = bb.layout, mixed.n_surfaces, mixed.surfaces.node_mask
    hours, sub = 2, 4
    hi = tuple(dev(rng.uniform(lo, hi, hours * sub)) for lo, hi in ((-5, 15), (0, 8), (0, 6.28))) + (
        lanes(rng.uniform(0, 400, (hours, S))), lanes(rng.uniform(0, 50, (hours, S))),
        lanes(rng.uniform(250, 400, (hours, S))), lanes(rng.uniform(250, 400, (hours, S))),
        zones(rng.uniform(0, 900, (hours, mixed.n_zones))), zones(rng.uniform(0, 50, (hours, mixed.n_zones))),
    )
    T0 = dev(lay.surfaces_to_blocked(np.where(mask, rng.uniform(15, 25, mask.shape), 0.0)))
    zT0 = dev(lay.zones_to_blocked(rng.uniform(18, 24, mixed.n_zones)))
    cots = (dev(lay.surfaces_to_blocked(rng.normal(size=mask.shape))),
            dev(lay.zones_to_blocked(rng.normal(size=mixed.n_zones))),
            zones(rng.normal(size=(hours, mixed.n_zones))))
    for mode, k in (("trbdf2_refresh", 1), ("trbdf2_refresh", 2), ("trbdf2", None)):
        _, params = day_march.make_hour_march(bb, substeps=sub, mode=mode, hours=hours, refresh_every=k)
        adj = day_adjoint.make_day_adjoint(bb, substeps=sub, mode=mode, hours=hours, refresh_every=k)
        got, w = adjoint_vs_plain(torch, adj, params, T0, zT0, hi, cots, f"mixed building {mode} k={k}")
        worst = max(worst, w)
        for name in ("cos_tilt", "front_temp", "back_temp", "fixed_h_front"):
            check(float(got[name].abs().max()) > 0, f"mixed building: d {name} is 0, the branch was not taken")
    return worst, worst_fd


def grad_workload(torch, ThermalModel, SimConfig, testing, dtype, days, chunks, demand=False,
                  mode="trbdf2_refresh", config_kw=None, u_scale=1.2):
    """bench.py's gradient rows through the port: returns (a callable running
    the chunked value_and_grad, the runner, its input sequence).

    ``run_grad_bench`` (bench.py:199-308): the bench city on the grad row's
    inputs (bench weather and solar factors, 500 W HVAC, luminaires off), a
    conductance scale and a solar-absorptance scale, ``mean((zt - 21)^2)``.
    ``demand=True`` is ``_grad_demand_variant`` (bench.py:311-399): the city
    with a thermostat per zone on the demand rows' inputs (luminaires at
    150 W, scheduled units at 0 W), a conductance scale and a shift of the
    compiled heating setpoint, the metered-energy loss on the load history.
    ``mode="parity"`` runs either at the building's stability sub-step count
    (``config_kw`` then carries ``nomass_fixed_iters``).  ``u_scale`` is
    the conductance scale the run starts from (bench.py: 1.2)."""
    from heatx_torch.engine.adjoint import chunked_value_and_grad, tree_map

    build = testing.build_demand_city if demand else testing.build_city_model
    tm = ThermalModel(build(1000, 10), n=1, config=SimConfig(dtype=dtype, **(config_kw or {})))
    b = tm.building
    T = days * 24
    if demand:
        seq = testing.demand_inputs(b, T, device="cuda")
    else:
        seq = testing.bench_inputs(b, T, device="cuda")
        seq = seq.replace(lum_power=torch.zeros_like(seq.lum_power))  # the grad row leaves luminaires off

    def chunkize(v):
        if v.ndim and v.shape[0] == T:
            return v.reshape((chunks, T // chunks) + tuple(v.shape[1:]))
        return torch.broadcast_to(v, (chunks,) + tuple(v.shape))

    xs = tree_map(chunkize, seq)
    sb0 = b.surfaces
    seg_u0 = torch.as_tensor(sb0.seg_u, device="cuda")
    alphas0 = torch.as_tensor(sb0.front_alphas, device="cuda")
    heat0 = torch.as_tensor(b.ctl_heat_sp, device="cuda")
    second = "sp_shift" if demand else "alpha_scale"

    def with_params(p):
        if demand:
            sb = dataclasses.replace(sb0, seg_u=seg_u0 * p["u_scale"])
            return dataclasses.replace(b, surfaces=sb, ctl_heat_sp=heat0 + p["sp_shift"])
        sb = dataclasses.replace(sb0, seg_u=seg_u0 * p["u_scale"], front_alphas=alphas0 * p["alpha_scale"])
        return dataclasses.replace(b, surfaces=sb)

    def loss_zt(zt, xs):
        return torch.mean((zt - 21.0) ** 2) / chunks

    def loss_demand(zt, ld, xs):
        return torch.mean((ld / 1e3) ** 2) / chunks + 1e-4 * torch.mean(zt) / chunks

    loss_fn = loss_demand if demand else loss_zt
    if mode == "parity":
        fr = tm.fast_runner(mode="parity", hours=24)
    else:
        fr = tm.fast_runner(mode=mode, refresh_every=2, substeps=8, hours=24)
    kf = fr.chunk_forward(with_params, loss_fn, collect_loads=demand)
    kb = fr.chunk_grad(with_params, loss_fn, collect_loads=demand)
    st = tm.initial_state()
    params = {"u_scale": torch.tensor(u_scale, dtype=dtype, device="cuda"),
              second: torch.tensor(0.5 if demand else 0.8, dtype=dtype, device="cuda")}

    def run():
        val, g = chunked_value_and_grad(None, params, st, xs, forward_fn=kf, backward_fn=kb)
        return float(val), float(g["u_scale"]), float(g[second])

    return run, fr, seq


def phase9_thermostats_f64(torch, day_march, day_adjoint, testing, SimConfig, compile_building,
                           device="cuda"):
    """Both kernels' thermostat instantiation against their plain versions,
    f64, on testing.build_thermostat_model (see the module docstring); then
    central differences of the forward kernel.  Returns the worst forward
    temperature gap (K), load gap and adjoint gap (of max |ref|), the worst
    finite-difference error, and the branch counts summed over the cases."""
    hours, sub = 3, 8
    rng = np.random.default_rng(9)
    worst = dict(T=0.0, load=0.0, adj=0.0, fd=0.0)
    total = {}

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device)

    for uncontrolled in (False, True):
        building = compile_building(
            testing.build_thermostat_model(uncontrolled), n=1, config=SimConfig(dtype=torch.float64)
        )
        bb = day_march.block_building(building)
        lay, S, Z = bb.layout, building.n_surfaces, building.n_zones
        mask = building.surfaces.node_mask

        def lanes(a):
            return dev(np.stack([lay.surfaces_to_blocked(x) for x in a]))

        def zones(a):
            return dev(np.stack([lay.zones_to_blocked(x) for x in a]))

        hi9 = tuple(dev(rng.uniform(lo, hi, hours * sub)) for lo, hi in ((-5, 30), (0, 8), (0, 6.28))) + (
            lanes(rng.uniform(0, 400, (hours, S))), lanes(rng.uniform(0, 50, (hours, S))),
            lanes(rng.uniform(250, 400, (hours, S))), lanes(rng.uniform(250, 400, (hours, S))),
            zones(rng.uniform(0, 900, (hours, Z))), zones(rng.uniform(0, 50, (hours, Z))),
        )
        # Per-hour setpoints around the compiled ones (heating below cooling).
        sp = (zones(np.array([20.0, 21.0, 19.0, 22.0]) + rng.uniform(-1, 1, (hours, Z))),
              zones(np.array([26.0, 25.0, 23.0, 24.0]) + rng.uniform(-1, 1, (hours, Z))))
        # Cold, cool and hot zones: heating (z1 beyond its 300 W), cooling (z2
        # beyond its 100 W) and the deadband all occur in the first hour.
        T0 = dev(lay.surfaces_to_blocked(np.where(mask, rng.uniform(10, 30, mask.shape), 0.0)))
        zT0 = dev(lay.zones_to_blocked(np.array([18.0, 19.0, 27.0, 21.0])))
        cots = (dev(lay.surfaces_to_blocked(rng.normal(size=mask.shape))),
                dev(lay.zones_to_blocked(rng.normal(size=Z))),
                zones(rng.normal(size=(hours, Z))), zones(rng.normal(size=(hours, Z)) * 1e-2))
        D_sp = zones(rng.normal(size=(hours, Z)))
        D_ctl = dev(lay.zones_to_blocked(rng.normal(size=Z)))
        D_u = dev(lay.surfaces_to_blocked(rng.normal(size=mask.shape)))

        for scheduled in (False, True):
            hi = hi9 + sp if scheduled else hi9
            for mode, k in (("trbdf2_refresh", 2), ("trbdf2_refresh", 8), ("trbdf2", None)):
                what = (f"thermostats {'uncontrolled z3 ' if uncontrolled else ''}"
                        f"{'scheduled ' if scheduled else ''}{mode} k={k}")
                kw = dict(substeps=sub, mode=mode, hours=hours, refresh_every=k, device=device,
                          scheduled_setpoints=scheduled)
                hm, params = day_march.make_hour_march(bb, collect_bad=True, **kw)
                adj = day_adjoint.make_day_adjoint(bb, **kw)
                got = hm(params, T0, zT0, hi)
                with testing.BranchCounter() as base:
                    ref = hm.plain(params, T0, zT0, hi)
                for name, n in base.counts.items():
                    total[name] = total.get(name, 0) + n
                check(base.counts["ties"] == 0, f"{what}: {base.counts['ties']} zone-sub-steps on a tie")
                for name, i in (("T", 0), ("zT", 1), ("zt_hist", 3)):
                    err = float((got[i] - ref[i]).abs().max())
                    check(err <= F64_TOL, f"{what} {name}: max |d| {err} > {F64_TOL}")
                    worst["T"] = max(worst["T"], err)
                check(float(got[4].sum()) == 0.0, f"{what}: non-finite state in the kernel")
                scale = float(ref[5].abs().max())
                err = float((got[5] - ref[5]).abs().max())
                check(scale > 0 and err <= F64_TOL * scale, f"{what} ld_hist: max |d| {err} > {F64_TOL} x {scale}")
                worst["load"] = max(worst["load"], err / scale)
                g, w = adjoint_vs_plain(torch, adj, params, T0, zT0, hi, cots, what)
                worst["adj"] = max(worst["adj"], w)
                if k != 2:
                    continue

                # Central differences of the forward KERNEL; the plain twin,
                # run at both ends, says whether a branch changed between them.
                def loss_of(out):
                    return float((out[0] * cots[0]).sum() + (out[1] * cots[1]).sum()
                                 + (out[3] * cots[2]).sum() + (out[5] * cots[3]).sum())

                def moved(e, name):
                    if name == "seg_u":
                        node = params.node.clone()
                        node[0] += e * D_u * params.node[0]
                        return dataclasses.replace(params, node=node), hi
                    if name == "schedule":
                        return params, hi[:9] + (hi[9] + e * D_sp, hi[10])
                    ctl = params.ctl.clone()
                    ctl[0] += e * D_ctl
                    return dataclasses.replace(params, ctl=ctl), hi

                cases = {"seg_u": float((g["seg_u"] * D_u * params.node[0]).sum())}
                if scheduled:
                    cases["schedule"] = float((g["d_sp_heat"] * D_sp).sum())
                else:
                    cases["ctl_heat_sp"] = float((g["d_ctl_heat"] * D_ctl).sum())
                eps = 1e-6
                for name, an in cases.items():
                    ends = []
                    for e in (eps, -eps):
                        p_e, hi_e = moved(e, name)
                        with testing.BranchCounter() as c:
                            hm.plain(p_e, T0, zT0, hi_e)
                        check(c.same_branches(base), f"{what} d/d{name}: a branch changes within +-{eps}")
                        ends.append(loss_of(hm(p_e, T0, zT0, hi_e)))
                    fd = (ends[0] - ends[1]) / (2 * eps)
                    rel = abs(fd - an) / max(abs(an), 1e-300)
                    check(an != 0 and rel <= FD_RTOL, f"{what} d/d{name}: FD {fd} vs adjoint {an} (rel {rel})")
                    worst["fd"] = max(worst["fd"], rel)
    for name in ("heating", "cooling", "clamped", "deadband"):
        check(total[name] > 0, f"phase 9 never took the {name} branch: {total}")
    return worst, total


def event_ms(torch, fn, reps):
    """ms per call of ``fn`` by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ptxas_table(log: str) -> str:
    """ptxas's lines of a build log, one entry per kernel instantiation:
    ``f32 ext=0 parity=1: 96 registers, 1200 B stack, spills 0/0 B``."""
    import re

    out, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            sym = m.group(1)
            t = re.search(r"kernelI([fd])((?:Lb[01]E)+)", sym)
            flags = re.findall(r"Lb([01])E", t.group(2)) if t else []
            kind = "parity_adjoint" if "parity_adjoint" in sym else ""
            name = (f"{'f32' if t and t.group(1) == 'f' else 'f64'} ext={flags[0] if flags else '?'}"
                    + (f" parity={flags[1]}" if len(flags) > 1 else (" parity=1" if kind else "")))
            entry = {"name": name}
            out.append(entry)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:  # the entry's own line comes first; its library calls' lines follow
            out[-1].setdefault("stack", m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[-1]["regs"] = m.group(1)
    return " | ".join(
        f"{e['name']}: {e.get('regs', '?')} registers, {e.get('stack', ('?',) * 3)[0]} B stack, spills "
        f"{e.get('stack', ('?',) * 3)[1]}/{e.get('stack', ('?',) * 3)[2]} B" for e in out
    )


def parity_day_work(params, hours, sub, iters):
    """Operations of one parity day-march launch, counted from day_parity.cuh
    on this run's shapes: per valid node and sub-step 65 + 16 per no-mass
    iteration (K's row 6; the forcing 10, once for RK4 and once per
    iteration; the no-mass factor 5 and its two sweeps 6 per iteration; four
    RK4 stages of 8 and their 12 combinations), per lane and sub-step 125
    (two film evaluations, the linearized radiation, the forced term, the
    face sums), per zone and sub-step 20 (45 more with thermostat rows, 12
    per mixing entry)."""
    import torch

    bits = params.field("node_bits").to(torch.int64)
    valid = int(sum(int(((bits >> i) & 1).sum()) for i in range(params.max_nodes)))
    lanes = params.surf.shape[1]
    zones = params.zone_volume.numel()
    per_sub = (65 + 16 * iters) * valid + 125 * lanes + 20 * zones
    if params.ctl is not None:
        per_sub += 45 * zones
    if params.mix is not None:
        per_sub += 12 * params.mix.src.numel()
    return hours * sub * per_sub, valid, lanes, zones


def parity_adjoint_work(params, hours, sub, iters):
    """Operations the parity day's adjoint needs, counted from
    day_adjoint.cu: one forward march of the day, then per valid node and
    sub-step 100 + 24 per no-mass iteration (four transposed RK4 stages of 14
    with their band cotangents, the forcing backwards twice, per iteration a
    transposed solve, its band cotangent and the forcing backwards), per lane
    and sub-step 250 (both film evaluations and the radiation backwards), per
    zone and sub-step 30 (90 more with thermostat rows, 20 per mixing entry).
    The kernel's recomputation (the second march of each hour, each
    sub-step's intermediates, the iterations re-marched to learn their
    masks) is not counted."""
    fwd, valid, lanes, zones = parity_day_work(params, hours, sub, iters)
    per_sub = (100 + 24 * iters) * valid + 250 * lanes + 30 * zones
    if params.ctl is not None:
        per_sub += 90 * zones
    if params.mix is not None:
        per_sub += 20 * params.mix.src.numel()
    return fwd + hours * sub * per_sub


def phase12_parity_f64(torch, day_march, day_adjoint, testing, ThermalModel, device="cuda"):
    """Both parity kernels against their plain versions, f64, small
    buildings at the coarse discretization; central differences of the
    forward kernel on the free-float ones.  Returns the worst gaps."""
    hours = 2
    rng = np.random.default_rng(12)
    worst = dict(T=0.0, load=0.0, adj=0.0, fd=0.0)
    models = {
        "4-zone city": (lambda: testing.build_city_model(4, 10), testing.bench_inputs),
        "mixed building": (testing.build_mixed_model, testing.bench_inputs),
        "no-mass runs": (testing.build_nomass_run_model, testing.bench_inputs),
        "thermostat building": (testing.build_thermostat_model, testing.demand_inputs),
    }
    cases = 0
    for label, (build, inputs) in models.items():
        for iters in (1, 2, 3):
            what = f"parity {label} iters={iters}"
            tm = ThermalModel(build(), config=testing.coarse_config(torch.float64, iters), device=device)
            r = tm.fast_runner(mode="parity", hours=hours)
            sub = r._substeps
            check(sub == tm.dt_subdivisions <= 8, f"{what}: {sub} sub-steps")
            seq = inputs(tm.building, hours, device=device)
            # The bench weather starts at midnight: give the two hours some sun.
            sun = rng.uniform(50.0, 400.0, (hours, tm.building.n_surfaces))
            seq = seq.replace(sol_front=torch.as_tensor(sun, device=device))
            hi = r.kernel_inputs(seq, interp_weather=True)[0]
            st0 = tm.initial_state()
            if r._has_loads:  # a cold, a cool and a hot zone: heating, the clamp, cooling
                st0 = dataclasses.replace(st0, zone_T=torch.as_tensor([18.0, 19.0, 27.0, 21.0], device=device))
            T0, zT0 = r.to_blocked(st0)
            mask = day_march.bit_rows(r.params, "node_bits")
            NB, ZB = r.params.n_blocks, r.params.zones_per_block

            def rand(shape, scale=1.0):
                return torch.as_tensor(rng.normal(size=tuple(shape)) * scale, device=device)

            # A random start state: off the |dT| = 0 kink of the cube root.
            T0 = T0 + rand(T0.shape, 2.0) * mask
            zT0 = zT0 + rand(zT0.shape, 0.5)
            hm, params = r.hour_march, r.params
            got = hm(params, T0, zT0, hi)
            ref = hm.plain(params, T0, zT0, hi)
            for name, a, b in (("T", got[0], ref[0]), ("zT", got[1], ref[1]), ("zt_hist", got[3], ref[3]),
                               *((f"hq{j}", got[2][j], ref[2][j]) for j in range(4))):
                err = float((a - b).abs().max())
                check(err <= F64_TOL, f"{what} {name}: max |d| {err} > {F64_TOL}")
                worst["T"] = max(worst["T"], err)
            check(float(got[4].sum()) == 0.0, f"{what}: non-finite state in the kernel")
            check(float((got[1] - zT0).abs().max()) > 0.05, f"{what}: the march did not move the zones")
            cots = [rand(T0.shape) * mask, rand((NB, ZB)), rand((hours, NB, ZB))]
            if r._has_loads:
                scale = float(ref[5].abs().max())
                err = float((got[5] - ref[5]).abs().max())
                check(scale > 0 and err <= F64_TOL * scale, f"{what} ld_hist: max |d| {err} > {F64_TOL} x {scale}")
                worst["load"] = max(worst["load"], err / scale)
                cots.append(rand((hours, NB, ZB), 1e-2))
            adj = day_adjoint.make_day_adjoint(r._bb, substeps=sub, mode="parity", hours=hours, device=device)
            g, w = adjoint_vs_plain(torch, adj, params, T0, zT0, hi, cots, what)
            worst["adj"] = max(worst["adj"], w)
            cases += 1
            if r._has_loads:
                continue  # finite differences across thermostat branches: phase 9's business

            def loss(p, T):
                out = hm(p, T, zT0, hi)
                return float((out[0] * cots[0]).sum() + (out[1] * cots[1]).sum() + (out[3] * cots[2]).sum())

            def perturbed(row, d):
                node = params.node.clone()
                node[row] += d * params.node[row]
                return dataclasses.replace(params, node=node)

            D_T, D_node = rand(T0.shape) * mask, rand(T0.shape)
            eps = 1e-6
            fd_cases = {"T0": (g["dT0"], D_T, lambda e: loss(params, T0 + e * D_T))}
            for name, row in (("seg_u", 0), ("mass", 1), ("front_alphas", 2)):
                fd_cases[name] = (g[name], D_node * params.node[row],
                                  lambda e, row=row: loss(perturbed(row, e * D_node), T0))
            for name, (grad, direction, f) in fd_cases.items():
                fd = (f(eps) - f(-eps)) / (2 * eps)
                an = float((grad * direction).sum())
                rel = abs(fd - an) / max(abs(an), 1e-300)
                check(an != 0 and rel <= FD_RTOL, f"{what} d/d{name}: FD {fd} vs adjoint {an} (rel {rel})")
                worst["fd"] = max(worst["fd"], rel)
    return worst, cases


def parity_sensitivity(torch, hm, params, T, zT, hi):
    """How far one day-launch carries a perturbation of its start state:
    the launch is repeated from ``T + PARITY_EPS x noise`` (seeded, valid nodes
    only) and the gaps at the end of the day are returned as multiples of
    PARITY_EPS, ``(node T, zone T)``.  A march that damps gives well under 1;
    one whose no-mass faces 2-cycle gives hundreds on the nodes."""
    from heatx_torch.ops import day_march

    mask = day_march.bit_rows(params, "node_bits")
    noise = torch.as_tensor(np.random.default_rng(13).normal(size=tuple(T.shape)), dtype=T.dtype, device=T.device)
    base = hm(params, T, zT, hi)
    moved = hm(params, T + PARITY_EPS * noise * mask, zT, hi)
    return (float((base[0] - moved[0]).abs().max()) / PARITY_EPS,
            float((base[1] - moved[1]).abs().max()) / PARITY_EPS)


def phase13_parity_run(torch, ctx):
    """Parity mode at full width through FastRunner.run (see the module
    docstring).  Returns what the kernels line and PERF.md need."""
    day_march, testing, SimConfig, ThermalModel = ctx.day_march, ctx.testing, ctx.SimConfig, ctx.ThermalModel
    smi = ctx.smi
    cfg = dict(nomass_fixed_iters=PARITY_ITERS)
    tm32 = ThermalModel(ctx.model, n=1, config=SimConfig(dtype=torch.float32, **cfg), device="cuda")
    rp = tm32.fast_runner(mode="parity", hours=24)
    sub = rp._substeps
    check(sub == tm32.dt_subdivisions and rp.hour_march.dt == tm32.dt, "parity sub-steps are not the building's")
    inputs48 = testing.bench_inputs(tm32.building, 48, device="cuda")
    st0 = tm32.initial_state()
    k = day_march.day_march_kernel
    k.launches = k.parity_launches = 0
    t0 = time.time()
    fin32, z32 = rp.run(st0, inputs48, interp_weather=True)
    torch.cuda.synchronize()
    run48_s = time.time() - t0
    launches = (k.launches, k.parity_launches)
    check(launches == (2, 2), f"parity main path: {launches} (all, parity) day-kernel launches, expected (2, 2)")

    tm64 = ThermalModel(ctx.model, n=1, config=SimConfig(dtype=torch.float64, **cfg), device="cuda")
    t0 = time.time()
    _, z64 = tm64.fast_runner(mode="parity", hours=24, use_kernel=False).run(
        tm64.initial_state(), testing.bench_inputs(tm64.building, 48, device="cuda"), interp_weather=True)
    torch.cuda.synchronize()
    plain48_s = time.time() - t0
    check(tuple(z32.shape) == (48, 1000), f"parity zone_T shape {tuple(z32.shape)}")
    for name, t in (("zone_T", z32), ("node_T", fin32.node_T), ("zone_T f64", z64)):
        check(bool(torch.isfinite(t).all()), f"parity {name} has non-finite values")
    err_main = float((z32.double() - z64).abs().max())
    check(err_main <= PARITY_F32_TOL, f"parity f32 kernel vs f64 twin zone_T: max |d| {err_main} > {PARITY_F32_TOL}")
    gap = (z32 - ctx.z32_trbdf2).abs()
    gap_rmse = float((gap.double() ** 2).mean().sqrt())
    print(f"phase 13a parity run on {smi}: 10,000 surfaces x 48 h at {sub} sub-steps/h "
          f"(dt {tm32.dt:.4g} s, nomass_fixed_iters={PARITY_ITERS}), {launches[0]} kernel launches "
          f"({launches[1]} parity), f32 run {run48_s:.3f} s; f32 kernel vs f64 plain twin max |d zone_T| "
          f"{err_main:.3e} K (<= {PARITY_F32_TOL:g}; the f64 plain twin took {plain48_s:.1f} s); against the port's "
          f"trbdf2_refresh k=2 f32 run of the same 48 h: max |d zone_T| {float(gap.max()):.3e} K, RMSE "
          f"{gap_rmse:.3e} K; zone_T range [{float(z32.min()):.2f}, {float(z32.max()):.2f}] C", flush=True)

    # One launch on the bench day itself: its time, that it is finite, and how
    # far it carries a perturbation (its evening's 2-cycles: PARITY_* above);
    # a twin that flushes tiny stage values
    T, zT = rp.to_blocked(st0)
    hi = rp.kernel_inputs(testing.bench_inputs(tm32.building, 24, device="cuda"), interp_weather=True)[0]
    kernel_ms = event_ms(torch, lambda: rp.hour_march(rp.params, T, zT, hi), 3)
    growth = parity_sensitivity(torch, rp.hour_march, rp.params, T, zT, hi)
    check(all(np.isfinite(growth)), f"the bench day's parity launch is not finite: {growth}")
    r2 = tm32.fast_runner(mode="parity", hours=2)
    hi2 = r2.kernel_inputs(testing.bench_inputs(tm32.building, 2, device="cuda"), interp_weather=True)[0]
    keep = r2.hour_march.plain(r2.params, T, zT, hi2)
    flushing = copy.copy(r2.hour_march)
    flushing.config = flushing.config.replace(flush_tiny=True)
    flushed = flushing.plain(r2.params, T, zT, hi2)
    flush_gap = max(float((keep[i] - flushed[i]).abs().max()) for i in (0, 1, 3))
    check(flush_gap <= 1e-4, f"flushing tiny RK4 stage values moves the f32 march by {flush_gap} K")

    inputs_year = testing.bench_inputs(tm32.building, 8760, device="cuda")
    torch.cuda.synchronize()
    t0 = time.time()
    _, zy = rp.run(st0, inputs_year, interp_weather=True)
    torch.cuda.synchronize()
    wall = time.time() - t0
    check(bool(torch.isfinite(zy).all()), "annual parity zone_T has non-finite values")
    del inputs_year, zy
    print(f"phase 13b on {smi}: annual parity run (8760 h, f32) {wall:.3f} s (host clock, one run); one parity "
          f"launch on the bench day {kernel_ms:.3f} ms (CUDA events, 3 reps; trbdf2_refresh k=2 "
          f"{ctx.kernel_ms:.3f} ms), finite; a start state moved by {PARITY_EPS:g} K ends that day "
          f"{growth[0]:.3g} x as far apart on the nodes and {growth[1]:.3g} x on the zones (the evening's "
          f"2-cycles: phase 14b holds the kernels on a day without them); plain twin with vs without "
          f"flushing RK4 stage values below 1e-25, 2 h f32: max |d| {flush_gap:.3e} K", flush=True)
    return SimpleNamespace(launches=launches, kernel_ms=kernel_ms, wall=wall, sub=sub, runner=rp, hi=hi, T=T,
                           zT=zT, growth=growth)


def phase14_parity_grad(torch, ctx, p13):
    """The parity gradient at full width, and both parity kernels against
    their plain versions on its first day-launch (see the module docstring)."""
    day_march, day_adjoint, testing = ctx.day_march, ctx.day_adjoint, ctx.testing
    SimConfig, ThermalModel, smi = ctx.SimConfig, ctx.ThermalModel, ctx.smi
    km, ka = day_march.day_march_kernel, day_adjoint.day_adjoint_kernel
    gw = dict(mode="parity", config_kw=dict(nomass_fixed_iters=PARITY_ITERS))
    days, chunks = 30, 2
    run32, fr32, seq32 = grad_workload(torch, ThermalModel, SimConfig, testing, torch.float32, days, chunks, **gw)
    km.launches = km.parity_launches = ka.launches = ka.parity_launches = 0
    t0 = time.time()
    v32 = run32()
    torch.cuda.synchronize()
    grad30_s = time.time() - t0
    counts = (km.launches, km.parity_launches, ka.launches, ka.parity_launches)
    check(counts == (60, 60, 30, 30),
          f"30-day parity value_and_grad: (day march, its parity, adjoint, its parity) launches {counts}, "
          f"expected (60, 60, 30, 30)")
    check(all(np.isfinite(v32)) and v32[1] != 0 and v32[2] != 0, f"30-day parity value_and_grad: {v32}")
    # f32 against f64 on the kernels, at a depth the f64 kernels reach quickly
    short = {}
    for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        run, _, _ = grad_workload(torch, ThermalModel, SimConfig, testing, dtype, PARITY_F64_DAYS, chunks, **gw)
        t0 = time.time()
        short[name] = run()
        torch.cuda.synchronize()
        short[name + "_s"] = time.time() - t0
        del run
    for name, a, b in zip(("loss", "dL/du", "dL/dalpha"), short["f32"], short["f64"]):
        check(np.isfinite(a) and np.isfinite(b), f"{PARITY_F64_DAYS}-day parity {name} not finite: {a}, {b}")
        check(abs(a - b) <= GRAD_F32_RTOL * abs(b), f"{PARITY_F64_DAYS}-day parity {name}: f32 {a} vs f64 {b}")
    print(f"phase 14a parity grad workload, {days} days in {chunks} chunks (this slice's main path): {counts[0]} "
          f"day-march launches (30 forward + 30 recompute; {counts[1]} parity), {counts[2]} adjoint launches "
          f"({counts[3]} parity), {grad30_s:.3f} s f32; loss / dL/du / dL/dalpha {v32[0]:.6g} / {v32[1]:.6g} / "
          f"{v32[2]:.6g}; {PARITY_F64_DAYS} days in {chunks} chunks, f32 ({short['f32_s']:.1f} s) "
          + " / ".join(f"{x:.6g}" for x in short["f32"]) + f" vs f64 ({short['f64_s']:.1f} s) "
          + " / ".join(f"{x:.6g}" for x in short["f64"]) + f" (relative <= {GRAD_F32_RTOL:g})", flush=True)

    # 14b. The main path's first day-launch, on its own operands: the runner
    # holds the parameter rows that run32 blocked (u_scale 1.2, alpha_scale
    # 0.8), the state is the initial one, the inputs are day 0 of the
    # workload's (hourly weather held over the sub-steps, luminaires off).
    sub = p13.sub
    T, zT = fr32.to_blocked(fr32._tm.initial_state())
    hi = fr32.kernel_inputs(tree_head(seq32, days * 24, 24))[0]
    hm, params = fr32.hour_march, fr32.params
    check(hm.hours == 24 and hm.substeps == sub, f"the main path's launch is {hm.hours} h x {hm.substeps}")
    kernel_ms = event_ms(torch, lambda: hm(params, T, zT, hi), 3)
    got = hm(params, T, zT, hi)
    torch.cuda.synchronize()
    t0 = time.time()
    ref = hm.plain(params, T, zT, hi)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    fwd_gaps = {name: float((a - b).abs().max()) for name, a, b in (
        ("T", got[0], ref[0]), ("zT", got[1], ref[1]), ("zt_hist", got[3], ref[3]),
        *((n, got[2][j], ref[2][j]) for j, n in enumerate(("h_front", "h_back", "q_front", "q_back"))))}
    for name, err in fwd_gaps.items():
        tol = PARITY_HQ_TOL if name[:2] in ("h_", "q_") else PARITY_DAY_TOL
        check(err <= tol, f"parity f32 kernel vs plain twin over the main path's day, {name}: max |d| {err} > {tol}")
    err32 = max(fwd_gaps.values())
    growth = parity_sensitivity(torch, hm, params, T, zT, hi)
    check(growth[0] <= PARITY_GROWTH_MAX,
          f"the main path's first day carries a perturbation {growth[0]} x on the nodes: a no-mass face 2-cycles")
    del ref

    # The loss's own cotangent on that day's zone history
    NB, ZB = fr32._bb.n_blocks, fr32._bb.zones_per_block
    valid = torch.as_tensor(np.asarray(fr32.layout.zone_table).reshape(NB, ZB) >= 0, device="cuda")
    d_hist = 2.0 * (got[3] - 21.0) * valid / (days * 24 * 1000)
    cots = (torch.zeros_like(T), torch.zeros_like(zT), d_hist.contiguous())
    adj = day_adjoint.make_day_adjoint(fr32._bb, substeps=sub, mode="parity", hours=24)
    g32 = flat_grads(adj(params, T, zT, hi, cots))
    adj_ms = event_ms(torch, lambda: adj(params, T, zT, hi, cots), 2)
    t0 = time.time()
    g32p = flat_grads(adj.plain(params, T, zT, hi, cots))
    torch.cuda.synchronize()
    adj_plain_ms = (time.time() - t0) * 1e3
    gaps = {}
    for name, ref in g32p.items():
        check(bool(torch.isfinite(g32[name]).all()), f"f32 parity adjoint {name}: non-finite")
        norm = float(ref.norm())
        gaps[name] = float((g32[name] - ref).norm()) / norm if norm else float(g32[name].abs().max())
        check(gaps[name] <= PARITY_ADJ_F32_RL2,
              f"f32 parity adjoint kernel vs f32 plain adjoint over the main path's day, {name}: relative L2 "
              f"{gaps[name]} > {PARITY_ADJ_F32_RL2}")
    worst_gap = max(gaps, key=gaps.get)
    adj32_abs = max(float((g32[n] - ref).abs().max()) for n, ref in g32p.items())
    check(float(g32["seg_u"].abs().max()) > 0 and float(g32["front_alphas"].abs().max()) > 0,
          "the main path's day adjoint gives no gradient on seg_u or front_alphas")
    del g32p
    torch.cuda.empty_cache()

    # The bench day itself (phase 13's operands): the adjoint's time, and that
    # it is finite through the evening's 2-cycles, where nothing can be compared
    rp = p13.runner
    seeded = np.random.default_rng(3).normal(size=(24, NB, ZB)) / (24 * 1000)
    cots_b = (torch.zeros_like(T), torch.zeros_like(zT), torch.as_tensor(seeded, dtype=torch.float32, device="cuda"))
    adj_b = day_adjoint.make_day_adjoint(rp._bb, substeps=sub, mode="parity", hours=24)
    bench_adj_ms = event_ms(torch, lambda: adj_b(rp.params, p13.T, p13.zT, p13.hi, cots_b), 1)
    g_day = flat_grads(adj_b(rp.params, p13.T, p13.zT, p13.hi, cots_b))
    for name, v in g_day.items():
        check(bool(torch.isfinite(v).all()), f"f32 parity bench-day adjoint {name}: non-finite")
    day_max = max(float(v.abs().max()) for v in g_day.values())
    del g_day
    print(f"phase 14b the main path's first day-launch (24 h x {sub} sub-steps, u_scale 1.2, alpha_scale 0.8), "
          f"f32, each parity kernel against its plain version: day march {kernel_ms:.3f} ms vs plain twin "
          f"{plain_ms:.1f} ms (host clock), max |d| " + ", ".join(f"{n} {v:.2e}" for n, v in fwd_gaps.items())
          + f" (<= {PARITY_DAY_TOL:g} K, h/q <= {PARITY_HQ_TOL:g}); a start state moved by {PARITY_EPS:g} K ends the day {growth[0]:.3g} x as "
          f"far apart on the nodes, {growth[1]:.3g} x on the zones (<= {PARITY_GROWTH_MAX:g}: no face 2-cycles); "
          f"adjoint, the loss's own cotangent: {adj_ms:.3f} ms vs f32 plain adjoint {adj_plain_ms:.1f} ms "
          f"(autograd per hour, host clock), max |d| {adj32_abs:.3e}, relative L2 worst {gaps[worst_gap]:.3e} "
          f"({worst_gap}; <= {PARITY_ADJ_F32_RL2:g}), " + ", ".join(f"{n} {v:.2e}" for n, v in gaps.items())
          + f"; on the bench day (u_scale 1, seeded hourly cotangents): adjoint launch {bench_adj_ms:.3f} ms "
          f"(trbdf2_refresh k=2 {ctx.adj_ms:.3f} ms), all finite, largest |value| {day_max:.3e} against "
          f"{max(float(v.abs().max()) for v in g32.values()):.3e} on the main path's day", flush=True)

    return SimpleNamespace(
        counts=counts, kernel_ms=kernel_ms, plain_ms=plain_ms, err32=err32, adj_ms=adj_ms,
        adj_plain_ms=adj_plain_ms, adj32_abs=adj32_abs, adj32_rel=gaps[worst_gap], bench_adj_ms=bench_adj_ms,
        growth=growth, params=params, T=T, zT=zT, hi=hi, got=got, cots=cots, g32=g32,
    )


def tree_head(seq, T, hours):
    """The first ``hours`` of an input sequence whose time series have ``T``
    leading rows (the rest is passed on as it is)."""
    from heatx_torch.engine.adjoint import tree_map

    return tree_map(lambda v: v[:hours] if v.ndim and v.shape[0] == T else v, seq)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    try:
        from heatx_torch import SimConfig, ThermalModel, testing
        from heatx_torch.build.layout import compile_building
        from heatx_torch.ops import cuda_lib, day_adjoint, day_march
    except ImportError as e:
        print(f"chip_smoke: heatx_torch is not importable here ({e})", file=sys.stderr)
        return 2

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = card_facts()
    print(smi)
    print(f"phase 1 device: torch sees {kind!r} x{torch.cuda.device_count()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # 2. build: one nvcc per kernel source, all started together
    t0 = time.time()
    cuda_lib.build_many([
        ("heatx_day_march", [day_march.KERNEL_SOURCE]),
        ("heatx_day_adjoint", [day_adjoint.KERNEL_SOURCE]),
    ])
    day_march.load_kernel()
    day_adjoint.load_kernel()
    build_s = time.time() - t0
    ptxas = ptxas_table(cuda_lib.build_log("heatx_day_march", [day_march.KERNEL_SOURCE]))
    print(f"phase 2 build: {build_s:.1f} s for both kernels (nvcc sm_90a, in parallel); "
          f"day_march ptxas: {ptxas}", flush=True)

    # 3. f64 algorithm check on the card
    err64 = phase3_f64_check(torch, day_march, testing, SimConfig, compile_building)
    print(f"phase 3 f64 4-zone 3 h kernel vs plain twin: max |d| {err64:.3e} K "
          f"(<= {F64_TOL:g}) in trbdf2_refresh k=2, k=8 and trbdf2", flush=True)

    # 4. the main path at full width
    model = testing.build_city_model(1000, 10)
    kw = dict(mode="trbdf2_refresh", substeps=8, hours=24, refresh_every=2)
    tm32 = ThermalModel(model, n=1, config=SimConfig(dtype=torch.float32), device="cuda")
    runner = tm32.fast_runner(**kw)
    inputs48 = testing.bench_inputs(tm32.building, 48, device="cuda")
    state0 = tm32.initial_state()
    day_march.day_march_kernel.launches = 0
    t0 = time.time()
    fin32, z32 = runner.run(state0, inputs48, interp_weather=True)
    torch.cuda.synchronize()
    run32_s = time.time() - t0
    launches = day_march.day_march_kernel.launches
    check(launches == 2, f"main path launched the day kernel {launches} times, expected 2")

    tm64 = ThermalModel(model, n=1, config=SimConfig(dtype=torch.float64), device="cuda")
    runner64 = tm64.fast_runner(use_kernel=False, **kw)
    fin64, z64 = runner64.run(
        tm64.initial_state(), testing.bench_inputs(tm64.building, 48, device="cuda"),
        interp_weather=True,
    )
    torch.cuda.synchronize()
    check(tuple(z32.shape) == (48, 1000), f"zone_T shape {tuple(z32.shape)}")
    for name, t in (("zone_T", z32), ("node_T", fin32.node_T), ("zone_T f64", z64)):
        check(bool(torch.isfinite(t).all()), f"{name} has non-finite values")
    err_main = float((z32.double() - z64).abs().max())
    check(err_main <= F32_TOL, f"f32 kernel vs f64 twin zone_T: max |d| {err_main} > {F32_TOL}")
    print(f"phase 4 main path 10,000 surfaces x 48 h: {launches} kernel launches, "
          f"f32 run {run32_s:.3f} s; f32 kernel vs f64 plain twin max |d zone_T| "
          f"{err_main:.3e} K (<= {F32_TOL:g}); zone_T range "
          f"[{float(z32.min()):.2f}, {float(z32.max()):.2f}] C", flush=True)

    # 5. timing on the card (f32, full width)
    inputs30 = testing.bench_inputs(tm32.building, 720, device="cuda")
    torch.cuda.synchronize()
    t0 = time.time()
    _, z30 = runner.run(state0, inputs30, interp_weather=True)
    torch.cuda.synchronize()
    wall30 = time.time() - t0
    check(bool(torch.isfinite(z30).all()), "30-day zone_T has non-finite values")

    inputs24 = testing.bench_inputs(tm32.building, 24, device="cuda")

    def day_operands(r):
        """Day 0's blocked kernel inputs for runner ``r``."""
        T, zT = r.to_blocked(state0)
        return T, zT, r.kernel_inputs(inputs24, interp_weather=True)[0]

    T, zT, hi = day_operands(runner)
    kernel_ms = event_ms(torch, lambda: runner.hour_march(runner.params, T, zT, hi), 10)
    plain_ms = event_ms(torch, lambda: runner.hour_march.plain(runner.params, T, zT, hi), 1)
    got = runner.hour_march(runner.params, T, zT, hi)
    ref = runner.hour_march.plain(runner.params, T, zT, hi)
    torch.cuda.synchronize()
    err32 = max(float((got[i] - ref[i]).abs().max()) for i in (0, 1, 3))
    check(err32 <= F32_TOL, f"f32 day kernel vs plain twin: max |d| {err32} > {F32_TOL}")

    sweep = {}
    for bs in BLOCK_SIZES:
        r = tm32.fast_runner(block_size=bs, **kw)
        Tb, zTb, hib = day_operands(r)
        sweep[bs] = (r.layout.n_blocks, event_ms(torch, lambda: r.hour_march(r.params, Tb, zTb, hib), 10))
    print(f"phase 5 timing on {smi}: 30 days kernel path {wall30:.3f} s "
          f"({wall30 / 30 * 1e3:.2f} ms/day, host clock); one day-kernel launch "
          f"{kernel_ms:.3f} ms vs plain twin {plain_ms:.1f} ms (CUDA events, default {runner.layout.block_size} lanes/block); "
          f"f32 kernel vs plain max |d| {err32:.3e} K; lanes/block -> (blocks, ms/day): "
          + ", ".join(f"{bs}: ({nb}, {ms:.3f})" for bs, (nb, ms) in sweep.items()),
          flush=True)

    # 6. the adjoint kernel's build (it ran in parallel with phase 2's)
    ptxas_adj = ptxas_table(cuda_lib.build_log("heatx_day_adjoint", [day_adjoint.KERNEL_SOURCE]))
    print(f"phase 6 build day_adjoint.cu (with phase 2's, {build_s:.1f} s for both); "
          f"ptxas: {ptxas_adj}", flush=True)

    # 7. f64: adjoint kernel vs plain adjoint, and vs finite differences of the forward kernel
    adj_err64, fd_err = phase7_adjoint_f64(torch, day_march, day_adjoint, testing, SimConfig, compile_building)
    print(f"phase 7 f64 4-zone 3 h adjoint kernel vs plain adjoint: worst max |d| / max |ref| "
          f"{adj_err64:.3e} (<= {ADJ_F64_RTOL:g}); central differences of the forward kernel "
          f"along T0, seg_u, front_alphas: worst relative error {fd_err:.3e} (<= {FD_RTOL:g}); "
          f"trbdf2_refresh k=2, k=8 and trbdf2", flush=True)

    # 8a. one bench day: f32 adjoint kernel vs f64 plain adjoint
    tm64 = ThermalModel(model, n=1, config=SimConfig(dtype=torch.float64), device="cuda")
    r64 = tm64.fast_runner(**kw)
    adj_kw = dict(substeps=8, mode="trbdf2_refresh", hours=24, refresh_every=2)
    adj32 = day_adjoint.make_day_adjoint(runner._bb, **adj_kw)
    adj64 = day_adjoint.make_day_adjoint(r64._bb, **adj_kw)
    NB, ZB = runner._bb.n_blocks, runner._bb.zones_per_block
    d_hist = np.random.default_rng(3).normal(size=(24, NB, ZB)) / (24 * 1000)
    T, zT, hi = day_operands(runner)
    cots32 = (torch.zeros_like(T), torch.zeros_like(zT), torch.as_tensor(d_hist, dtype=torch.float32, device="cuda"))
    T64, zT64 = r64.to_blocked(tm64.initial_state())
    hi64 = r64.kernel_inputs(testing.bench_inputs(tm64.building, 24, device="cuda"), interp_weather=True)[0]
    cots64 = tuple(c.double() for c in cots32)
    g32 = flat_grads(adj32(runner.params, T, zT, hi, cots32))
    g64p = flat_grads(adj64.plain(r64.params, T64, zT64, hi64, cots64))
    gaps = {}
    for name, ref in g64p.items():
        check(bool(torch.isfinite(g32[name]).all()), f"f32 adjoint {name}: non-finite")
        norm = float(ref.norm())
        gaps[name] = float((g32[name].double() - ref).norm()) / norm if norm else float(g32[name].abs().max())
        check(gaps[name] <= ADJ_F32_RL2, f"f32 adjoint kernel vs f64 plain {name}: relative L2 {gaps[name]} > {ADJ_F32_RL2}")
    worst_gap = max(gaps, key=gaps.get)
    adj_ms = event_ms(torch, lambda: adj32(runner.params, T, zT, hi, cots32), 10)
    t0 = time.time()
    g32p = flat_grads(adj32.plain(runner.params, T, zT, hi, cots32))
    torch.cuda.synchronize()
    adj_plain_ms = (time.time() - t0) * 1e3  # the f32 plain adjoint, as the kernel's ms is f32
    adj32_abs = max(float((g32[n] - ref).abs().max()) for n, ref in g32p.items())
    adj32_rel = max(float((g32[n] - ref).abs().max()) / max(float(ref.abs().max()), 1e-300)
                    for n, ref in g32p.items())
    print(f"phase 8a one bench day, f32 adjoint kernel vs f64 plain adjoint: relative L2 gap "
          f"worst {gaps[worst_gap]:.3e} ({worst_gap}; <= {ADJ_F32_RL2:g}), "
          + ", ".join(f"{n} {v:.2e}" for n, v in gaps.items()), flush=True)

    # 8b. the gradient main path: 30 days in 2 chunks, f32 and f64 on the kernels
    run32, fr32, seq32 = grad_workload(torch, ThermalModel, SimConfig, testing, torch.float32, 30, 2)
    run64, fr64, seq64 = grad_workload(torch, ThermalModel, SimConfig, testing, torch.float64, 30, 2)
    day_march.day_march_kernel.launches = 0
    day_adjoint.day_adjoint_kernel.launches = 0
    t0 = time.time()
    v32 = run32()
    torch.cuda.synchronize()
    grad30_s = time.time() - t0
    launches_fwd = day_march.day_march_kernel.launches
    launches_adj = day_adjoint.day_adjoint_kernel.launches
    check(launches_fwd == 60 and launches_adj == 30,
          f"30-day value_and_grad launched the day march {launches_fwd} times (expected 30 "
          f"forward + 30 recompute) and the adjoint {launches_adj} times (expected 30)")
    v64 = run64()
    zt_gap = float((fr32.run(fr32._tm.initial_state(), seq32)[1].double()
                    - fr64.run(fr64._tm.initial_state(), seq64)[1]).abs().max())
    for name, a, b in zip(("loss", "dL/du", "dL/dalpha"), v32, v64):
        check(np.isfinite(a) and np.isfinite(b), f"30-day {name} not finite: {a}, {b}")
        check(abs(a - b) <= GRAD_F32_RTOL * abs(b), f"30-day {name}: f32 {a} vs f64 {b}")
    check(v32[1] != 0 and v32[2] != 0, f"30-day gradients are zero: {v32}")
    print(f"phase 8b bench grad workload, 30 days in 2 chunks (main path): {launches_fwd} day-march "
          f"launches (30 forward + 30 recompute), {launches_adj} adjoint launches, {grad30_s:.3f} s f32; "
          f"loss / dL/du / dL/dalpha f32 {v32[0]:.6g} / {v32[1]:.6g} / {v32[2]:.6g} vs f64 "
          f"{v64[0]:.6g} / {v64[1]:.6g} / {v64[2]:.6g} (relative <= {GRAD_F32_RTOL:g}); "
          f"30-day zone T f32 vs f64 through run: max |d| {zt_gap:.3e} K", flush=True)

    # 8c. the annual value_and_grad (run_grad_bench: 5 chunks of 73 days),
    # host clock, once: phase 11 times its annual run twice and profiles it.
    run_year, _, _ = grad_workload(torch, ThermalModel, SimConfig, testing, torch.float32, 365, 5)
    t0 = time.time()
    vy = run_year()
    torch.cuda.synchronize()
    wall_year = time.time() - t0
    check(all(np.isfinite(vy)) and vy[1] != 0 and vy[2] != 0, f"annual value_and_grad: {vy}")
    del run_year
    print(f"phase 8c on {smi}: annual value_and_grad (8760 h, 5 chunks of 73 days, f32) "
          f"{wall_year:.3f} s (host clock, one run); loss {vy[0]:.6g}, dL/du {vy[1]:.6g}, "
          f"dL/dalpha {vy[2]:.6g}; adjoint day-launch "
          f"{adj_ms:.3f} ms (CUDA events, 10 reps) vs f32 plain adjoint {adj_plain_ms:.1f} ms for one "
          f"day (host clock); f32 adjoint kernel vs f32 plain max |d| {adj32_abs:.3e} "
          f"({adj32_rel:.2e} of max |ref|)", flush=True)

    # 9. thermostats, schedules and mixing: both kernels vs their plain versions, f64
    w9, branches = phase9_thermostats_f64(torch, day_march, day_adjoint, testing, SimConfig, compile_building)
    print(f"phase 9 f64 thermostat building (4 zones, 3 h; k=2, k=8, frozen; compiled and scheduled "
          f"setpoints; with and without an uncontrolled zone): forward kernel vs plain twin max |d| "
          f"{w9['T']:.3e} K (<= {F64_TOL:g}), loads {w9['load']:.3e} of max |ref| (<= {F64_TOL:g}); "
          f"adjoint kernel vs plain adjoint {w9['adj']:.3e} of max |ref| (<= {ADJ_F64_RTOL:g}); central "
          f"differences of the forward kernel along ctl_heat_sp, a setpoint schedule and seg_u: worst "
          f"relative error {w9['fd']:.3e} (<= {FD_RTOL:g}), branch masks equal at both ends; "
          f"zone-sub-steps per branch: " + ", ".join(f"{k} {v}" for k, v in branches.items()), flush=True)

    # 10. the demand path at full width (bench.py run_demand_bench)
    demand_model = testing.build_demand_city(1000, 10)
    kw_demand = dict(mode="trbdf2", substeps=8, hours=24)
    tmd32 = ThermalModel(demand_model, n=1, config=SimConfig(dtype=torch.float32), device="cuda")
    rd32 = tmd32.fast_runner(**kw_demand)
    std32 = tmd32.initial_state()
    day_march.day_march_kernel.launches = 0
    t0 = time.time()
    find32, zd32, ld32 = rd32.run(std32, testing.demand_inputs(tmd32.building, 48, device="cuda"),
                                  collect_loads=True)
    torch.cuda.synchronize()
    demand48_s = time.time() - t0
    launches_demand = day_march.day_march_kernel.launches
    check(launches_demand == 2, f"demand path launched the day kernel {launches_demand} times, expected 2")
    tmd64 = ThermalModel(demand_model, n=1, config=SimConfig(dtype=torch.float64), device="cuda")
    rd64 = tmd64.fast_runner(use_kernel=False, **kw_demand)
    with testing.BranchCounter() as c48:
        _, zd64, ld64 = rd64.run(tmd64.initial_state(),
                                 testing.demand_inputs(tmd64.building, 48, device="cuda"), collect_loads=True)
    torch.cuda.synchronize()
    check(tuple(zd32.shape) == (48, 1000) and tuple(ld32.shape) == (48, 1000),
          f"demand zone_T {tuple(zd32.shape)}, loads {tuple(ld32.shape)}")
    for name, t in (("zone_T", zd32), ("loads", ld32), ("node_T", find32.node_T), ("loads f64", ld64)):
        check(bool(torch.isfinite(t).all()), f"demand {name} has non-finite values")
    err_dz = float((zd32.double() - zd64).abs().max())
    check(err_dz <= F32_TOL, f"demand f32 kernel vs f64 twin zone_T: max |d| {err_dz} > {F32_TOL}")
    ld_scale = float(ld64.abs().max())
    err_ld = float((ld32.double() - ld64).abs().max())
    check(err_ld <= LOAD_F32_RTOL * ld_scale,
          f"demand f32 kernel vs f64 twin loads: max |d| {err_ld} W > {LOAD_F32_RTOL} x {ld_scale} W")
    heat48 = float(ld32.clamp(min=0).sum()) / 1000.0 / 1000
    check(heat48 > 0, "demand: no heating in 48 h")

    inputs_year = testing.demand_inputs(tmd32.building, 8760, device="cuda")
    demand_walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.time()
        _, zy, ly = rd32.run(std32, inputs_year, collect_loads=True)
        heat_y = float(ly.clamp(min=0).sum()) / 1000.0 / tmd32.building.n_zones
        cool_y = abs(float(ly.clamp(max=0).sum())) / 1000.0 / tmd32.building.n_zones
        demand_walls.append(time.time() - t0)
        check(np.isfinite(heat_y) and np.isfinite(cool_y) and heat_y > 0, f"annual demand: {heat_y}, {cool_y}")
    del inputs_year, zy, ly
    inputs24d = testing.demand_inputs(tmd32.building, 24, device="cuda")
    Td, zTd = rd32.to_blocked(std32)
    hid = rd32.kernel_inputs(inputs24d)[0]
    demand_ms = event_ms(torch, lambda: rd32.hour_march(rd32.params, Td, zTd, hid), 10)
    free_frozen = tm32.fast_runner(**kw_demand)
    Tf, zTf, hif = day_operands(free_frozen)
    free_frozen_ms = event_ms(torch, lambda: free_frozen.hour_march(free_frozen.params, Tf, zTf, hif), 10)
    print(f"phase 10 demand path on {smi}: bench city + 1,000 thermostats, 48 h, {launches_demand} kernel "
          f"launches, f32 run {demand48_s:.3f} s; f32 kernel vs f64 plain twin max |d zone_T| {err_dz:.3e} K "
          f"(<= {F32_TOL:g}), max |d load| {err_ld:.3e} W = {err_ld / ld_scale:.3e} of max |load| "
          f"{ld_scale:.1f} W (<= {LOAD_F32_RTOL:g}); f64 zone-sub-steps per branch over 48 h: "
          + ", ".join(f"{k} {v}" for k, v in c48.counts.items())
          + f"; annual demand run (8760 h, collect_loads) {demand_walls[0]:.3f} s and {demand_walls[1]:.3f} s "
          f"(host clock), heating {heat_y:.1f} kWh/zone, cooling {cool_y:.1f} kWh/zone; one day-launch "
          f"(mode trbdf2, CUDA events) with thermostats {demand_ms:.3f} ms vs free-float {free_frozen_ms:.3f} ms",
          flush=True)

    # 11a. one demand day, k=2: the thermostat kernels vs their plain versions
    # (f32), and the f32 adjoint vs the f64 plain adjoint with a load cotangent
    run_d32, frd32, seqd32 = grad_workload(torch, ThermalModel, SimConfig, testing, torch.float32, 30, 2, demand=True)
    run_d64, frd64, seqd64 = grad_workload(torch, ThermalModel, SimConfig, testing, torch.float64, 30, 2, demand=True)
    Tt, zTt = frd32.to_blocked(frd32._tm.initial_state())
    hit = frd32.kernel_inputs(testing.demand_inputs(frd32._tm.building, 24, device="cuda"))[0]
    tstat_ms = event_ms(torch, lambda: frd32.hour_march(frd32.params, Tt, zTt, hit), 10)
    tstat_plain_ms = event_ms(torch, lambda: frd32.hour_march.plain(frd32.params, Tt, zTt, hit), 1)
    got_t = frd32.hour_march(frd32.params, Tt, zTt, hit)
    ref_t = frd32.hour_march.plain(frd32.params, Tt, zTt, hit)
    torch.cuda.synchronize()
    tstat_err = max(float((got_t[i] - ref_t[i]).abs().max()) for i in (0, 1, 3))
    tstat_ld_err = float((got_t[5] - ref_t[5]).abs().max())
    tstat_ld_scale = float(ref_t[5].abs().max())
    check(tstat_err <= F32_TOL, f"f32 thermostat day kernel vs plain twin: max |d| {tstat_err} > {F32_TOL}")
    check(tstat_ld_err <= LOAD_F32_RTOL * tstat_ld_scale,
          f"f32 thermostat day kernel vs plain twin loads: {tstat_ld_err} W > {LOAD_F32_RTOL} x {tstat_ld_scale} W")

    adjd32 = day_adjoint.make_day_adjoint(frd32._bb, **adj_kw)
    adjd64 = day_adjoint.make_day_adjoint(frd64._bb, **adj_kw)
    # Cotangents at the scale the loss gives them: 1e-4 / (24 x 1000) per
    # zone-hour of temperature, ~2 ld / 1e6 / (24 x 1000) per W of load.
    shape_d = (24, frd32._bb.n_blocks, frd32._bb.zones_per_block)
    rng_d = np.random.default_rng(4)
    cots_d32 = (torch.zeros_like(Tt), torch.zeros_like(zTt),
                torch.as_tensor(rng_d.normal(size=shape_d) / (24 * 1000), dtype=torch.float32, device="cuda"),
                torch.as_tensor(rng_d.normal(size=shape_d) / (24 * 1000 * 1e3), dtype=torch.float32, device="cuda"))
    Tt64, zTt64 = frd64.to_blocked(frd64._tm.initial_state())
    hit64 = frd64.kernel_inputs(testing.demand_inputs(frd64._tm.building, 24, device="cuda"))[0]
    gd32 = flat_grads(adjd32(frd32.params, Tt, zTt, hit, cots_d32))
    gd64p = flat_grads(adjd64.plain(frd64.params, Tt64, zTt64, hit64, tuple(c.double() for c in cots_d32)))
    gaps_d = {}
    for name, ref in gd64p.items():
        check(bool(torch.isfinite(gd32[name]).all()), f"f32 demand adjoint {name}: non-finite")
        norm = float(ref.norm())
        gaps_d[name] = float((gd32[name].double() - ref).norm()) / norm if norm else float(gd32[name].abs().max())
        check(gaps_d[name] <= ADJ_F32_RL2_TSTAT,
              f"f32 demand adjoint kernel vs f64 plain {name}: relative L2 {gaps_d[name]} > {ADJ_F32_RL2_TSTAT}")
    worst_gap_d = max(gaps_d, key=gaps_d.get)
    tstat_adj_ms = event_ms(torch, lambda: adjd32(frd32.params, Tt, zTt, hit, cots_d32), 10)
    t0 = time.time()
    gd32p = flat_grads(adjd32.plain(frd32.params, Tt, zTt, hit, cots_d32))
    torch.cuda.synchronize()
    tstat_adj_plain_ms = (time.time() - t0) * 1e3
    tstat_adj_abs = max(float((gd32[n] - ref).abs().max()) for n, ref in gd32p.items())
    print(f"phase 11a one demand day (k=2), f32: thermostat day-launch {tstat_ms:.3f} ms vs plain twin "
          f"{tstat_plain_ms:.1f} ms (free-float {kernel_ms:.3f} ms), kernel vs plain max |d| {tstat_err:.3e} K, "
          f"loads {tstat_ld_err:.3e} W of max {tstat_ld_scale:.1f} W; thermostat adjoint day-launch "
          f"{tstat_adj_ms:.3f} ms vs f32 plain adjoint {tstat_adj_plain_ms:.1f} ms (free-float {adj_ms:.3f} ms); "
          f"f32 adjoint kernel vs f64 plain adjoint, seeded load cotangent: relative L2 gap worst "
          f"{gaps_d[worst_gap_d]:.3e} ({worst_gap_d}; <= {ADJ_F32_RL2_TSTAT:g}), d_ctl_heat "
          f"{gaps_d['d_ctl_heat']:.2e}, d_zone_volume {gaps_d['d_zone_volume']:.2e}, seg_u {gaps_d['seg_u']:.2e}",
          flush=True)

    # 11b. the demand gradient main path: 30 days in 2 chunks, f32 and f64 on the kernels
    day_march.day_march_kernel.launches = 0
    day_adjoint.day_adjoint_kernel.launches = 0
    t0 = time.time()
    d32 = run_d32()
    torch.cuda.synchronize()
    dgrad30_s = time.time() - t0
    launches_dfwd = day_march.day_march_kernel.launches
    launches_dadj = day_adjoint.day_adjoint_kernel.launches
    check(launches_dfwd == 60 and launches_dadj == 30,
          f"30-day demand gradient launched the day march {launches_dfwd} times (expected 30 forward + "
          f"30 recompute) and the adjoint {launches_dadj} times (expected 30)")
    d64 = run_d64()
    for name, a, b in zip(("loss", "dL/du", "dL/dsp"), d32, d64):
        check(np.isfinite(a) and np.isfinite(b), f"30-day demand {name} not finite: {a}, {b}")
        check(abs(a - b) <= GRAD_F32_RTOL * abs(b), f"30-day demand {name}: f32 {a} vs f64 {b}")
    check(d32[2] != 0 and d32[1] != 0, f"30-day demand gradients are zero: {d32}")
    del run_d64, frd64, seqd64
    print(f"phase 11b demand gradient, 30 days in 2 chunks (main path): {launches_dfwd} day-march launches "
          f"(30 forward + 30 recompute), {launches_dadj} adjoint launches, {dgrad30_s:.3f} s f32; "
          f"loss / dL/du / dL/dsp f32 {d32[0]:.6g} / {d32[1]:.6g} / {d32[2]:.6g} vs f64 "
          f"{d64[0]:.6g} / {d64[1]:.6g} / {d64[2]:.6g} (relative <= {GRAD_F32_RTOL:g})", flush=True)

    # 11c. the annual demand gradient (5 chunks of 73 days), by the host
    # clock once, then once under torch.profiler for the device's busy share
    run_dyear, _, _ = grad_workload(torch, ThermalModel, SimConfig, testing, torch.float32, 365, 5, demand=True)
    t0 = time.time()
    dy = run_dyear()
    torch.cuda.synchronize()
    wall_dyear = time.time() - t0
    check(all(np.isfinite(dy)) and dy[1] != 0 and dy[2] != 0, f"annual demand gradient: {dy}")
    dev_ms, kern_ms = device_time(torch, run_dyear)
    share = (f"device busy {dev_ms:.1f} ms = {dev_ms / (wall_dyear * 1e3):.1%} of that wall; day_adjoint "
             f"{kern_ms['day_adjoint']:.1f} ms ({kern_ms['day_adjoint'] / dev_ms:.1%} of device time), "
             f"day_march {kern_ms['day_march']:.1f} ms ({kern_ms['day_march'] / dev_ms:.1%})"
             if dev_ms > 0 else "device time not measured (the profiler recorded none)")
    print(f"phase 11c on {smi}: annual demand gradient (8760 h, 5 chunks of 73 days, f32) "
          f"{wall_dyear:.3f} s (host clock, one run); loss {dy[0]:.6g}, dL/du {dy[1]:.6g}, "
          f"dL/dsp {dy[2]:.6g}; torch.profiler over a second run: {share}", flush=True)

    # 12-14. parity mode: both kernels' parity bodies (see the module docstring)
    w12, n12 = phase12_parity_f64(torch, day_march, day_adjoint, testing, ThermalModel)
    print(f"phase 12 f64 parity kernels, {n12} cases (4-zone city, mixed building, no-mass runs of 3 and 4 "
          f"nodes, thermostat building; 1, 2, 3 no-mass iterations; 2 h at 6 sub-steps): forward kernel vs "
          f"plain twin max |d| {w12['T']:.3e} K on T, zT, zone history, h/q (<= {F64_TOL:g}), loads "
          f"{w12['load']:.3e} of max |ref|; adjoint kernel vs plain parity adjoint {w12['adj']:.3e} of max |ref| "
          f"(<= {ADJ_F64_RTOL:g}); central differences of the forward kernel along T0, seg_u, mass, "
          f"front_alphas: worst relative error {w12['fd']:.3e} (<= {FD_RTOL:g})", flush=True)
    ctx = SimpleNamespace(
        day_march=day_march, day_adjoint=day_adjoint, testing=testing, SimConfig=SimConfig,
        ThermalModel=ThermalModel, smi=smi, model=model, z32_trbdf2=z32, kernel_ms=kernel_ms, adj_ms=adj_ms,
    )
    p13 = phase13_parity_run(torch, ctx)
    p14 = phase14_parity_grad(torch, ctx, p13)

    # The kernels line: bounds from this run's shapes (f32 bench day; the
    # thermostat instantiation on the demand city's day, same mode).
    def march_bound(params, T, zT, hi, outs):
        ops, *_ = day_work(params, 24, 8, 2)
        moved = nbytes(*param_tensors(params), T, zT, *hi) + nbytes(
            outs[0], outs[1], *outs[2], *[o for o in outs[3:] if o is not None])
        return (ops, moved) + bound(moved, ops)

    def adjoint_bound(params, T, zT, hi, cots, grads):
        ops = adjoint_work(params, 24, 8, 2)
        moved = nbytes(*param_tensors(params), T, zT, *hi, *cots) + nbytes(*grads.values())
        return (ops, moved) + bound(moved, ops)

    ops_fwd, bytes_fwd, fwd_bound, fwd_by = march_bound(runner.params, T, zT, hi, got)
    ops_adj, bytes_adj, adj_bound, adj_by = adjoint_bound(runner.params, T, zT, hi, cots32, g32)
    ops_tf, bytes_tf, tf_bound, tf_by = march_bound(frd32.params, Tt, zTt, hit, got_t)
    ops_ta, bytes_ta, ta_bound, ta_by = adjoint_bound(frd32.params, Tt, zTt, hit, cots_d32, gd32)
    ops_pf = parity_day_work(p14.params, 24, p13.sub, PARITY_ITERS)[0]
    bytes_pf = nbytes(*param_tensors(p14.params), p14.T, p14.zT, *p14.hi) + nbytes(
        p14.got[0], p14.got[1], *p14.got[2], *p14.got[3:])
    pf_bound, pf_by = bound(bytes_pf, ops_pf)
    ops_pa = parity_adjoint_work(p14.params, 24, p13.sub, PARITY_ITERS)
    bytes_pa = nbytes(*param_tensors(p14.params), p14.T, p14.zT, *p14.hi, *p14.cots) + nbytes(*p14.g32.values())
    pa_bound, pa_by = bound(bytes_pa, ops_pa)
    print(f"bounds (f32 bench day, published H100 SXM rates): day_march {bytes_fwd / 1e6:.2f} MB, "
          f"{ops_fwd / 1e9:.3f} GFLOP -> {fwd_bound * 1e3:.2f} us ({fwd_by}); day_adjoint "
          f"{bytes_adj / 1e6:.2f} MB, {ops_adj / 1e9:.3f} GFLOP -> {adj_bound * 1e3:.2f} us ({adj_by}); "
          f"with thermostats: day_march {bytes_tf / 1e6:.2f} MB, {ops_tf / 1e9:.3f} GFLOP -> "
          f"{tf_bound * 1e3:.2f} us ({tf_by}); day_adjoint {bytes_ta / 1e6:.2f} MB, {ops_ta / 1e9:.3f} GFLOP "
          f"-> {ta_bound * 1e3:.2f} us ({ta_by}); parity, 24 h at {p13.sub} sub-steps/h: day_march "
          f"{bytes_pf / 1e6:.2f} MB, {ops_pf / 1e9:.3f} GFLOP -> {pf_bound * 1e3:.2f} us ({pf_by}); day_adjoint "
          f"{bytes_pa / 1e6:.2f} MB, {ops_pa / 1e9:.3f} GFLOP -> {pa_bound * 1e3:.2f} us ({pa_by})", flush=True)

    print(json.dumps({"kernels": [
        {
            "name": "day_march",
            "route": "cuda",
            "source": "heatx_torch/csrc/day_march.cu",
            "replaces": "heatx/ops/pallas_step.py:1976",
            "launches": launches_dfwd,
            "launches_by_path": {
                "run, 48 h (phase 4)": launches,
                "value_and_grad, 30 days (phase 8b)": launches_fwd,
                "demand run, 48 h (phase 10)": launches_demand,
                "demand gradient, 30 days (phase 11b)": launches_dfwd,
                "parity run, 48 h (phase 13a)": p13.launches[0],
                "parity value_and_grad, 30 days (phase 14a)": p14.counts[0],
            },
            "max_abs_err": err32,
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": fwd_bound,
            "bound_by": fwd_by,
            "library_ms": None,
            "thermostat": {"ms": tstat_ms, "plain_ms": tstat_plain_ms, "max_abs_err": tstat_err,
                           "max_abs_err_load_w": tstat_ld_err, "bound_ms": tf_bound, "bound_by": tf_by},
        },
        {
            "name": "day_adjoint",
            "route": "cuda",
            "source": "heatx_torch/csrc/day_adjoint.cu",
            "replaces": "heatx/ops/pallas_adjoint.py:717",
            "launches": launches_dadj,
            "launches_by_path": {
                "value_and_grad, 30 days (phase 8b)": launches_adj,
                "demand gradient, 30 days (phase 11b)": launches_dadj,
                "parity value_and_grad, 30 days (phase 14a)": p14.counts[2],
            },
            "max_abs_err": adj32_abs,
            "ms": adj_ms,
            "plain_ms": adj_plain_ms,
            "bound_ms": adj_bound,
            "bound_by": adj_by,
            "library_ms": None,
            "thermostat": {"ms": tstat_adj_ms, "plain_ms": tstat_adj_plain_ms, "max_abs_err": tstat_adj_abs,
                           "bound_ms": ta_bound, "bound_by": ta_by},
        },
        {
            "name": "day_march_parity",
            "route": "cuda",
            "source": "heatx_torch/csrc/day_march.cu (body: heatx_torch/csrc/day_parity.cuh)",
            "replaces": "heatx/ops/pallas_step.py:1976 (body _hour_body, pallas_step.py:633)",
            "launches": p14.counts[1],
            "launches_by_path": {
                "parity run, 48 h (phase 13a)": p13.launches[1],
                "parity value_and_grad, 30 days (phase 14a)": p14.counts[1],
            },
            "ms_bench_day": p13.kernel_ms,
            "max_abs_err": p14.err32,
            "ms": p14.kernel_ms,
            "plain_ms": p14.plain_ms,
            "bound_ms": pf_bound,
            "bound_by": pf_by,
            "library_ms": None,
        },
        {
            "name": "day_adjoint_parity",
            "route": "cuda",
            "source": "heatx_torch/csrc/day_adjoint.cu (body: heatx_torch/csrc/day_parity.cuh)",
            "replaces": "heatx/ops/pallas_adjoint.py:717 (body _hour_body(unroll=True), pallas_adjoint.py:573)",
            "launches": p14.counts[3],
            "launches_by_path": {"parity value_and_grad, 30 days (phase 14a)": p14.counts[3]},
            "ms_bench_day": p14.bench_adj_ms,
            "max_abs_err": p14.adj32_abs,
            "rel_l2_err": p14.adj32_rel,
            "ms": p14.adj_ms,
            "plain_ms": p14.adj_plain_ms,
            "bound_ms": pa_bound,
            "bound_by": pa_by,
            "library_ms": None,
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

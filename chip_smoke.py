#!/usr/bin/env python3
"""Smoke test of heatx_torch on one NVIDIA GPU: the quickest proof that the
port still builds, runs and agrees with itself on the card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (one output line each, then a JSON line per contract):

1. device: the CUDA device's name, and its name and power limit as
   ``nvidia-smi`` reports them.  Exits non-zero without a CUDA device.
2. build: compiles the day-march kernels (the TR-BDF2 body in
   heatx_torch/csrc/day_march_tr.cu, the parity body in day_march_parity.cu,
   each four threads per surface in three launch variants, and the C entry
   in day_march.cu) from the checkout with nvcc and prints the build time
   and every instantiation's ptxas line.
3. f64 check on a 4-zone city (40 surfaces), 3 h, modes trbdf2_refresh
   (k=2, k=8) and trbdf2: the CUDA kernel against its plain PyTorch twin on
   the same inputs, max |dT| <= 1e-9 K on T, zT and the zone history (the
   two differ only in summation order and fused multiply-adds).
3b. B1's edge (testing.build_wide_zone_model: one zone bounded by 256
   surfaces, one block of 256 lanes, and a 32-node wall; and one bounded by
   50, a 64-lane block), 3 h, free-float in k=2 and with a thermostat in
   trbdf2: the TR-BDF2 kernel (4 threads per surface, 1024 and 256 a block)
   in f64 against its plain twin, every output <= 1e-9 K, and in f32 against
   the f64 plain twin, temperatures <= 1e-2 K and loads <= 1e-3 of their
   largest magnitude; then the same buildings at the coarse discretization
   (testing.coarse_config: 6 sub-steps an hour, an 8-node wall) in parity
   mode, one no-mass iteration, 2 h, free-float and with the thermostat,
   held to the same bounds: every launch variant of both kernels on the
   card in both types.  Both adjoint kernels on the f64 launches (TR-BDF2
   k=2 free-float and frozen with the thermostat, parity free-float and with
   the thermostat; their 1024- and 256-thread variants) against the plain
   adjoint on seeded cotangents, every output <= 1e-9 of its max |ref|.
3c. each adjoint with the most zone rows of an hour a block held
   (testing.build_zone_chain_model, 2-node panes, a thermostat each): the
   TR-BDF2 adjoint on 64 zones in one 64-lane block at 144 sub-steps an
   hour, k=2 and frozen, 2 h; the parity adjoint on 72 zones in one 96-lane
   block at the chain's own 118 sub-steps, one no-mass iteration, 1 h; f64,
   against the plain adjoint, every output <= 1e-9 of its max |ref|.
4. the main path at full width: build_city_model(1000, 10) (10,000
   surfaces, 1,000 zones), trbdf2_refresh k=2, 8 sub-steps, hours=24,
   bench weather, 48 h through ThermalModel(..., device="cuda")
   .fast_runner(...).run: f32 on the kernel (which must launch exactly
   twice), f64 on the plain twin; every value finite, the [48, 1000] zone
   temperatures within 1e-2 K (f32 round-off against f64).
5. timing on the card, f32 at full width: 30 days through the kernel path,
   one day-kernel launch (CUDA events) and one day through the plain twin;
   the kernel against the plain twin on the same day's inputs (max |dT| <=
   1e-2 K, f32 summation-order round-off); the launch variant it ran in.

6. build (the adjoint): the day-adjoint kernels (the TR-BDF2 body in
   heatx_torch/csrc/day_adjoint_tr.cu and the parity body in
   day_adjoint_parity.cu, each four threads per surface in three launch
   variants and with its kMrt unit, and the C entry in day_adjoint.cu), one
   nvcc per unit started together with phase 2's; their ptxas
   registers/stack/spill lines.
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
   plain adjoint (relative L2 gap per output <= 1e-2), the largest gap
   between the adjoint's recomputed hour starts and the forward kernel's
   states at the same hours (f32 and f64, printed), and its launch variant;
   bench.py's
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
   plain adjoint re-run from the forward kernel's hour starts, every zone
   (relative L2 <= 2e-2; along the f64 march's own printed; at most
   TSTAT_PARTED_MAX zones whose hourly loads part from f64, each within
   FLIP_MARGIN of a setpoint); the annual run in 5 chunks of 73 days once by
   the host clock, and once under torch.profiler for the device's busy share
   and each kernel's part of it.

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
   in mode="parity", 10 days in 2 chunks in f32 (PARITY_GRAD_DAYS), exactly 20
   day-march and 10 adjoint launches, all of them the parity kernels, gradients finite and
   nonzero; 6 days in 2 chunks, f32 against f64 on the kernels.  Then both
   parity kernels against their plain versions at the shape that path
   launches, 24 h x 118 sub-steps, on the operands of its first day-launch
   (the conductance scale 1.2 keeps every face off the 2-cycle, which the
   phase measures): the day march on T, zT and the zone history (<= 2e-4 K)
   and on h/q (<= 1e-3), the adjoint on the loss's own cotangent, every output
   (relative L2 <= 2e-4 against the f32 plain adjoint re-run from the forward
   kernel's hour starts).  The bench day's adjoint launch is
   timed and checked finite; its recomputed hour starts are the forward
   kernel's states at the same hours, f32 and f64, to the bit.  (The f64 plain adjoint, longer gradients and the
   2-cycles taken apart: scripts/torch_parity_diag.py; 73 days, one chunk of
   bench.py's five, take ~140 s on an H100.)

15. gas cavities, f64, small: testing.build_cavity_model (cavities in every
   tilt band of the ISO 15099 correlation, heat flowing either way) and the
   4-zone glazed city (testing.build_glazed_city: the office's argon double
   glazing in every window); all four cavity bodies (trbdf2, trbdf2_refresh
   k=2 at 8 sub-steps over 3 h; parity with 1 and 2 no-mass iterations at the
   coarse discretization over 2 h): the forward kernel against its plain twin
   (<= 1e-9 K), the adjoint kernel against the plain adjoint (<= 1e-9 of max
   |ref|, seg_u's cotangent exactly 0 on every cavity segment), central
   differences of the forward kernel along T0 and seg_u (<= 1e-5); and how far
   the live cavity U moves the zones from the static U.
16. the glazed city at full width (build_glazed_city(1000, 10): 10,000
   surfaces, 1,000 argon double-glazed windows), f32: 48 h of trbdf2_refresh
   k=2 through FastRunner.run against the f64 plain twin (exactly 2 cavity
   launches, zone T <= 1e-2 K); one bench-day launch of the march and of its
   adjoint timed, the adjoint against the f64 and the f32 plain adjoint
   (relative L2 <= 2e-2, over all lanes and over the cavity lanes alone);
   bench.py's gradient workload on the glazed city in TR-BDF2 and in
   parity mode, 2 days in 2 chunks each (exact launch counts, all on cavity
   lanes); then both parity cavity bodies against their f32 plain versions
   at the main path's width and sub-step count over the daytime window
   PARITY_WINDOW (both sides from the kernel's state at its start; the day-
   launch, 24 h x 118 sub-steps, timed whole) on the parity
   workload's first-day operands (u_scale 1.2, alpha_scale 0.8), the
   forward (CAV_WINDOW_T_TOL, CAV_WINDOW_HQ_TOL) and the adjoint
   (CAV_WINDOW_ADJ_RL2, over all lanes and over the cavity lanes alone)
   against their f32 plain versions (the plain adjoint re-run from the f32
   forward kernel's hour starts); both f32 versions against the f64
   kernel from the same state, the kernel held to CAV_WINDOW_T_TOL on T, zT
   and the zone history; the gradient path's two parity adjoint launches
   (day 1 from the initial state, day 2 from the f32 forward kernel's state
   at midnight) against the f64 adjoint kernel from the same states, held to
   CAV_PARITY_ADJ_F32_RL2; the window's f32 adjoint kernel from the f32
   kernel's state against the f64 plain adjoint re-run from the f32 forward
   kernel's hour starts, held to CAV_PARITY_ADJ_F32_RL2 (ROADMAP C1); the
   window's f32 adjoint kernel and f32 plain adjoint from the f32 kernel's
   state, and the adjoint kernel from the f64 kernel's state (rounded),
   against the f64 adjoint kernel, printed; the day-launches timed.
17. the office IDF workflow (bench.py run_office_bench): a seeded synthetic
   EPW file at Santiago's location (testing.write_synthetic_epw, written to a
   temporary directory), examples/data/office.idf through load_idf, its
   inputs as bench.py builds them (testing.office_inputs: computed solar,
   hourly schedules, airflows, monthly ground temperatures), an annual f32
   run (trbdf2, 8 sub-steps, scheduled setpoints, ground_hourly,
   collect_loads) twice by the host clock: exactly 365 cavity launches in 12
   dispatches (one per soil temperature), finite, heating and cooling kWh;
   48 h of it against the f64 plain twin (zone T <= 1e-2 K, loads <= 1e-3 of
   max |load|).
18. interior MRT, f64, small: testing.build_two_zone_model (a partition on
   both zones' networks) and the 4-zone city with ``interior_mrt`` (trbdf2,
   trbdf2_refresh k=1 and k=2 at 8 sub-steps over 3 h; parity with 1 and 2
   no-mass iterations at the coarse discretization over 2 h), and the office
   (gas cavities and MRT; k=2 and parity with 2): the forward kernel against
   its plain twin with the h/q and operative histories (<= 1e-9 K), the
   adjoint kernel against the plain adjoint, ``mrt_eps_*`` included (<= 1e-9
   of max |ref|), central differences of the forward kernel along T0,
   ``mrt_eps_b``, and ``eps_back`` and ``area`` through the network's statics
   (``day_march.mrt_eps_blocked``; <= 1e-5); the histories without MRT
   physics (the operative temperature alone, the h/q history alone on a
   building without the network's statics), forward against plain.
19. the MRT city at full width (build_city_model(1000, 10) with
   ``interior_mrt``: 10,000 network faces in 1,000 ten-face networks), f32:
   48 h of trbdf2_refresh k=2 through ``run(collect_operative=True)`` against
   the f64 plain twin (zone and operative T, MRT_F32_TOL; exactly 2 MRT
   launches); one bench-day launch with and without the operative history and
   its adjoint timed, the launch held against the f64 plain version
   (MRT_F32_TOL) and compared with the f32 one, the adjoint held against its
   f32 plain version; the annual run
   with the operative history (exactly 365 MRT launches); 30 days with the h/q
   history and the device memory it holds; the gradient workload with a scale
   of eps_back as a third parameter, 2 days f32 against f64 with exact launch
   counts; the same in parity mode (f32, launch counts), and both parity MRT
   kernels against their f32 plain versions over the daytime window
   PARITY_WINDOW of its first day (the bounds of phase 14b; the plain adjoint
   re-run from the forward kernel's hour starts), each day-launch timed
   whole.
20. the office IDF workflow with ``interior_mrt`` (gas cavities and MRT): the
   annual run with loads and the operative history (exactly 365 launches,
   each a cavity and an MRT launch), heating and cooling kWh beside phase
   17's, the operative range, 48 h f32 against the f64 plain twin; one
   day-launch of each cavity-and-MRT body (TR-BDF2 forward and adjoint,
   parity forward and adjoint at the coarse discretization) counted, timed and
   held against its f32 plain version.

21. the in-run passive controls, f64, small: testing.build_controlled_city(2,
   3) (one window shaded on its own zone's temperature, one on the other
   zone's; ventilation gates in both zones), trbdf2_refresh k=2 at 8
   sub-steps and parity at the coarse discretization, x {free-float,
   thermostats, gas cavities, MRT with the operative history} x {shading,
   ventilation gates, both}, GATE_CASE_HOURS in one launch each: the kernel
   against its plain twin on every output (<= 1e-9 K), the launch counted as
   gated (and as parity, cavity or MRT), each control toggling (between 5 and
   95 % of its decisions on, rebuilt from the zone history); a +1e9 shading
   setpoint series bit-equal to the uncontrolled building, a no-op
   ventilation control within 1e-12 K of the ungated one, in both bodies.
22. the controlled city at full width (testing.build_controlled_city(1000,
   10): 1,000 shaded windows, 100 of them read by the next zone, ventilation
   gates in every zone, outdoor and wind gates in some), f32: 48 h of
   trbdf2_refresh k=2 through FastRunner.run against the f64 plain twin,
   every decision rebuilt from both zone histories: a flip must lie within
   FLIP_MARGIN of its threshold (round-off), the zones where all agree are
   held to F32_TOL; one day-launch timed beside the ungated bench city's and
   held against its f32 plain version the same way; the year (exactly 365
   gated launches, finite); parity: 48 h through run (2 gated parity
   launches), one day-launch timed, the kernel against its f32 plain version
   over PARITY_WINDOW with the bounds of phase 14b.
23. the controlled office IDF (testing.controlled_office_idf: the argon
   window's OnIfHighZoneAirTemperature shade on a schedule, ventilation
   limits; with cavities and thermostats): the year on the synthetic EPW of
   phase 17 with its shading setpoint series (365 launches, each a cavity
   and a gated one; heating and cooling kWh beside phase 17's), 48 h f32
   against the f64 plain twin as in 22.

24. the adaptive no-mass loop (heatx's default ``nomass_fixed_iters=None``,
   run by the kernels with ``HEATX_KERNEL_WHILE=1``), f64, small, in every
   kind's parity body: the 4-zone city (free-float), the controlled city
   (2, 3) (``kExt``, gated), testing.build_cavity_model (``kCav``),
   testing.build_two_zone_model with ``interior_mrt`` (``kMrt``) and the
   cavity building with it (``kMrt`` + ``kCav``), ADAPTIVE_HOURS at the
   coarse discretization: the kernel against its plain twin from a scattered
   state (<= F64_TOL on T, zT, the zone history, h/q; the launch counted in
   its kind, the runs' stopping iterations printed), and the kernel route
   (FastRunner.run) against the port's XLA path (ThermalModel.run) on the
   card from the initial state (<= ADAPTIVE_XLA_TOL, heatx's own bound).
25. the adaptive loop at full width: the bench city, f32, 118 sub-steps/h:
   48 h through FastRunner.run (exactly 2 parity launches, finite); one
   bench-day launch timed (CUDA events) between two of phase 13's
   fixed-iteration launch on the same operands; over PARITY_WINDOW, every
   side from the kernel's state at its start: the f64 kernel against the
   f64 plain version off the runs with a stop decision within ADAPTIVE_NEAR
   of its threshold and off their zones (<= F64_TOL), the f64 kernels with
   one and two iterations beside it (they must fail that bound); the f32
   kernel against the f64 plain version (zone-T RMSE <= ADAPTIVE_RMSE; off
   the runs whose stopping iteration differs between the f32 and the f64
   plain versions, T <= PARITY_DAY_TOL and the zone history of the zones
   they do not touch <= CAV_WINDOW_T_TOL, which the one- and two-iteration
   kernels must fail on T) and the f32 plain version, the differing runs
   counted, and the distribution of the iterations (f64: mean, p99, max, the
   shares that reach 100 and 500 and that stop on the increase-break).
26. ThermalModel.run, the XLA-path integrators, at full width: the bench
   city, f32, ADAPTIVE_RUN_HOURS from midnight in each mode (parity with the
   adaptive loop and with one iteration, trbdf2, trbdf2_refresh k=2, exp),
   its wall time (host clock), finite; the one-iteration parity run and the
   k=2 run held against the kernel route on the same inputs (<= F32_TOL).
27. the command line and sizing on the card, in-process
   (heatx_torch.cli.main, so the launches are counted): (a) ``simulate
   examples/data/office.idf <synthetic EPW, seed 0> --engine kernel --mode
   trbdf2`` for the whole year in f32 with CLI_WARMUP_DAYS warm-up days,
   ``--loads-csv``, ``--comfort-csv`` (the operative history: the kMrt
   instantiation with gas cavities), ``--fluxes-csv`` and
   ``--summary-json``: exit code 0, exactly 365 day-march launches plus the
   warm-up repeats it reports, every one on the cavity-and-MRT kind, every
   CSV finite; the wall time, heating and cooling kWh printed; (b) the same
   command in f64 over 48 h on the card and with ``--platform cpu`` (the
   plain versions): every CSV to one unit of its last printed digit, the
   summary JSON within 1e-9 relative (but the wall clock); (c)
   ``sizing.annual_peak_loads(engine="kernel")`` on the office: the f32 year
   on the card (365 launches plus the warm-up repeats it reports, peaks
   finite, host clock), and f64 over a SIZING_CUT_HOURS cut of the weather
   (at most SIZING_CUT_WARMUP warm-up days) on the card and on
   ``device="cpu"`` (loads within 1e-9 of max |load|); (d)
   ``FastRunner.update_building`` on the bench city: seg_u x 1.2 swapped
   into the f32 runner of phase 4's mode, one day bit for bit equal to a
   runner built on the scaled building; (e) ``FastRunner(hours=1).march``
   on the bench city in f64, 24 times: exactly 24 launches, within F64_TOL
   of one ``run`` of that day on a 24-hour runner; (f) ``size
   examples/data/office.idf <the same EPW> --annual`` in f32: exit code 0,
   the design days on the parity kind with cavities and MRT (the adaptive
   no-mass loop; warm-up repeats + 1 launches a day) and the year on the
   TR-BDF2 one, counted, every peak finite, the host-clock time printed;
   then the winter design day in f64 at the coarse discretization
   (SIZING_DD_WARMUP warm-up repeats): the kernel route on the card against
   ``ThermalModel.run`` on the CPU, within 1e-9 of max |load|.

Phases 16b and 19c hold the parity kernels against their plain versions over
the daytime window PARITY_WINDOW (hours 8-14) of the day-launch; 16b held the
whole day until the MRT phases came (its plain parity adjoint alone took 3.5
min).  Phase 14b holds the whole day.

The line before the last is the kernels JSON line.  ``launches`` is each
kernel's count on this slice's main path: for the four ``*_cavity``
entries the office workflow (phase 17) and the glazed city's gradient paths
(phase 16), for the two parity entries the parity gradient of phase 14, for
the TR-BDF2 entries the 30-day demand gradient of phase 11;
``launches_by_path`` lists every driven path (phases 4, 8b, 10, 11, 13, 14,
16, 17), each counted from 0.  The ``*_cavity`` entries' ``ms``,
``plain_ms``, ``max_abs_err`` and ``bound_ms`` are the glazed city's
(phase 16).  ``ms`` is one f32 free-float bench-day launch
(CUDA events), ``plain_ms`` its f32 plain version on the same inputs,
``max_abs_err`` the f32 kernel against that plain version, ``bound_ms`` the
bound from this run's shapes; ``thermostat`` holds the same five numbers
for the thermostat instantiation on the demand city's day (same mode, k=2).
Each day-march entry timed at full width names its launch ``variant``
(``G=4/<threads a block>``, as the wrapper read it back).
The two ``*_parity`` entries are the parity kernels on the first day-launch
of the 10-day parity gradient (24 h x 118 sub-steps, phase 14b), held against
their f32 plain versions there; ``ms_bench_day`` is the same launch on the
bench day's own operands.  The parity cavity entries are held over
PARITY_WINDOW (``plain_hours``: first and last hour), their ``plain_ms`` the
plain versions' time for it.  The eight ``*_mrt`` entries are the MRT
instantiations: the MRT city's (phase 19; the parity ones held over
PARITY_WINDOW, ``plain_hours``) and, with gas cavities, the office's
(phase 20); ``day_march_cavity_mrt`` also lists phase 27's command-line
and sizing years, ``day_march`` phase 27's update_building day and its 24
one-hour launches.  The two ``day_march_gated*`` entries are the controlled
city's (phase 22): its annual run's launches (TR-BDF2) and its 48 h parity
run's, the day-launch timed beside ``ms_ungated_bench_day``, the parity one
held over PARITY_WINDOW.  ``day_march_parity_adaptive`` is the parity body
with the adaptive loop on the bench city (phase 25): its 48 h run's
launches, the bench-day launch beside the fixed-iteration one
(``ms_fixed_iters``), held and its plain version timed over PARITY_WINDOW,
the bound's operations scaled by the window's mean iterations.  The last line is ``{"ok": true, "device": {...}}``;
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
ADJ_F64_RTOL = 1e-9  # of max |ref|: adjoint kernel vs plain adjoint, f64, same inputs
FD_RTOL = 1e-5  # central differences of the f64 forward kernel vs the adjoint kernel
# Phase 3c's sub-steps an hour, even for k=2: the one-thread TR-BDF2 adjoint
# took at most 145 on a block of 64 zones and 64 lanes with a thermostat each
# in f64 (its shared memory, 8 (64 (3 substeps + 11) + 6 x 64) bytes, passes a
# block's 227 KB on the H100 at 146; its tape, (substeps + 1) x 2 nodes, 384).
ZONE_ROWS_SUBSTEPS = 144
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
# presumed, not examined); bound ~3x the measurement.  A thermostat branch is
# a decision as FLIP_MARGIN's are: the f32 adjoint differentiates the f32
# forward kernel's march, whose zone may land on its setpoint a sub-step
# before or after the f64 march's where the f64 free-float temperature passes
# within f32 round-off of the setpoint (the bench day: one zone, 5.0e-5 K
# above it at the end of hour 18, the f32 zone 8.9e-5 K lower), and there the
# two adjoints take different branches' derivatives (2.2e-2 over the day).
# So the bound holds, on every zone and lane, the f64 plain adjoint re-run
# from the forward kernel's hour starts (the march the f32 adjoint
# differentiates); the gap along the f64 plain march's own is printed, and a
# zone whose f32 kernel and f64 hourly loads part (0 on one side only) must
# have come within FLIP_MARGIN of a setpoint in the f64 march, as phases 22-23
# hold the controls' flips, and at most TSTAT_PARTED_MAX zones may part.
ADJ_F32_RL2_TSTAT = 2e-2
# The most of phase 11a's 1,000 thermostat zones whose f32 and f64 decisions
# may part: 1 measured on an H100 80GB HBM3 at 700 W (PERF.md), of the 204
# that come within FLIP_MARGIN of a setpoint.
TSTAT_PARTED_MAX = 5
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
# The parity gradient's depth in phase 14a (30 days until the cavity phases
# came: cut to keep the command near its time).
PARITY_GRAD_DAYS = 10
# Gas cavities (phases 15-17).  One cavity U, counted from day_common.cuh
# cavity_u: ~50 operations for the value, ~40 more for its two partial
# derivatives in an adjoint.
CAV_OPS = 50
CAV_ADJ_OPS = 40
# The glazed city's one-day f32 TR-BDF2 adjoint against the f64 plain adjoint
# and against the f32 plain adjoint, relative L2 per output, over all lanes and
# over the cavity lanes alone.  Measured on an H100 80GB HBM3 at 700 W: 1.0e-2
# and 2.6e-3 (d_sol_back; the bench city's 2.2e-3 in phase 8a), 2.9e-3 and
# 4.9e-4 on the cavity lanes.  An adjoint that drops the cavity U's dU/dT
# parts from the full one by 3.2e-2, and by 0.67 on the cavity lanes
# (scripts/torch_cavity_f32_diag.py --mode trbdf2_refresh, 20 zones, f64):
# the cavity lanes' check is the one that fails it.
CAV_ADJ_F32_RL2 = 2e-2
CAV_GRAD_DAYS = 2  # the glazed city's gradient paths, in 2 chunks
# The glazed city's parity adjoint at 24 h x 118 sub-steps, f32 kernel against
# its f32 plain version and against the f64 kernel, relative L2 per output,
# over all lanes and over the cavity lanes alone.  Measured on an H100 80GB
# HBM3 at 700 W: 1.6e-3 and 1.5e-3 (d_ir_front), 2.9e-3 and 2.8e-3 on the
# cavity lanes, ~85x the bench city's 1.9e-5 (phase 14b); the f32 plain
# adjoint is 5.0e-4 (9.0e-4) from the f64 kernel.  The gap is f32 round-off
# that grows with the width and sits on a few windows: the f32 plain adjoint
# against the f64 plain one is 8.3e-5 at 20 zones and 1.3e-3 at 1,000, 90 % of
# it on one window (scripts/torch_cavity_f32_diag.py).  An adjoint that drops
# the cavity U's dU/dT parts from the full one by 3.4e-2, 5.0e-2 on the cavity
# lanes (the same script, 1,000 zones, f64): the bound fails it 6-10x over,
# where 2e-4 would fail the f32 plain version itself.  Phase 16b holds the
# gradient path's two adjoint launches to it against the f64 adjoint kernel
# from the same start states: day 1 from the initial state, day 2 from the
# f32 forward kernel's state at midnight (with the one-thread parity adjoint
# 2.750e-3 and 4.190e-5 on the cavity lanes, d_ir_front; with the four-thread
# one 1.015e-3 and 4.152e-5).  It also holds the daytime window, from the f32
# kernel's state at 8 h, against the f64 plain adjoint re-run from the f32
# forward kernel's hour starts (ROADMAP C1): the four-thread adjoint, whose
# recompute is the forward kernel's march, reads 2.067e-3 there (2.727e-3 on
# the cavity lanes) and 2.789e-3 against the f64 kernel from the same state;
# the one-thread adjoint, whose recompute was another f32 march, read 6.361e-3
# on the cavity lanes against the f64 kernel, the f32 plain adjoint 7.840e-3
# (measured on an H100 80GB HBM3 at 700 W).  There the gap was the f32
# round-off of a branch, heatx's MIN_H
# floor of the TARP natural h on the glazing's room face, max(1.31
# |dT|^(1/3), 0.1), whose derivative drops from ~75 W/m2K2 to 0 at |dT| =
# 4.4e-4 K: the inner pane passes the zone air at about 9 h, and the f32
# and f64 marches take the floor on different sub-steps (157 decisions on
# 86 lanes; no other branch differs).  99.6 % of the squared gap falls in
# that hour, 81 % on one lane.  The unchanged adjoint's gap over the window
# moves with the start state's last bit: 1.4e-3 to 8.5e-3 as the f32
# kernel's state moves by one ulp, 2.2e-3 to 1.1e-2 for the f64 kernel's
# rounded state, 2.2e-3 to 1.7e-2 for the one-thread parity kernel's state,
# which also gives 1.6e-2 to 2.0e-2 from 6, 7 and 9 h; the f32 plain
# adjoint was further in 5 of 6 states and 4 % nearer in one
# (scripts/torch_parity_window_diag.py; measured on an H100 80GB HBM3 at
# 700 W).
CAV_PARITY_ADJ_F32_RL2 = 5e-3
# Phase 16b's daytime window (hours 8-14) of the glazed city, the f32 kernels
# against their f32 plain versions, both from the kernel's state at 8 h.
# Measured on an H100 80GB HBM3 at 700 W in two runs, with the one-thread
# parity kernel: T 2.44e-4 K both times, q_front 9.4e-4 and 1.0e-3 W/m2, the adjoint 3.9e-3 and 1.9e-3
# relative L2 over all lanes, 5.2e-3 and 2.5e-3 on the cavity lanes
# (d_ir_front).  Against the f64 kernel from the same state both f32 versions
# part alike: T 2.08e-4 K (kernel, both runs) and 1.87e-4 and 2.08e-4 K
# (plain); the adjoint 2.43e-3 (kernel, both runs) and 4.5e-3 and 2.4e-3
# (plain).  It is the f32 round-off of the sunlit glazing, which the bounds
# above, read where the day's sun has decayed, do not allow for; the plain
# version's f32 zone sums (index_add_) move it from run to run.  The f32
# kernel against the f64 kernel, both deterministic, is held too on T, zT
# and the zone history (CAV_WINDOW_T_TOL): a fault of the forward kernel's
# own in daylight fails there.  The window's f32 adjoints against the f64
# one are printed (see CAV_PARITY_ADJ_F32_RL2).  The four-thread parity
# adjoint differentiates the f32 forward kernel's own march (its hour starts
# are the kernel's to the bit), where the f32 plain adjoint re-marched each
# hour from its own hour starts and took the glazing's MIN_H floor on other
# sub-steps: against that plain adjoint it read 6.404e-3 and 8.447e-3 on the
# cavity lanes (d_ir_front; the f32 plain adjoint itself 5.984e-3 and 7.893e-3
# from the f64 kernel, the kernel 2.114e-3 and 2.789e-3), so the adjoint is
# held against the f32 plain adjoint re-run from the f32 forward kernel's
# hour starts (plain_day_adjoint's ``starts``), as phase 11a's thermostat day
# is (measured on an H100 80GB HBM3 at 700 W).
CAV_WINDOW_T_TOL = 5e-4  # K: T, zT, the zone history
CAV_WINDOW_HQ_TOL = 2e-3  # W/m2K and W/m2: h and q
CAV_WINDOW_ADJ_RL2 = 1e-2  # relative L2 per adjoint output, all lanes and the cavity lanes
# Phases 16b and 19c compare the parity kernels with their f32 plain versions
# over PARITY_PLAIN_HOURS of the day-launch only, from hour
# PARITY_WINDOW_START, both sides started from the kernel's state there (a
# whole day of the plain parity adjoint took 207 s on the glazed city on an
# H100): the sun is up through the whole window on the bench weather, so the
# solar terms and their cotangents are in the comparison.  The launches are
# timed whole; phase 14b compares the whole day.  Four hours (8-12) end at
# the glazing's midday, where the f32 kernel and its plain twin part by
# 5.6e-4 K on T against CAV_WINDOW_T_TOL (measured on an H100 80GB HBM3 at
# 700 W): the window ends at 14 h.
PARITY_PLAIN_HOURS = 6
PARITY_WINDOW_START = 8
PARITY_WINDOW = [PARITY_WINDOW_START, PARITY_WINDOW_START + PARITY_PLAIN_HOURS]  # the kernels line's plain_hours
# Interior MRT (phases 18-20).  The Carroll network's fixed point, counted
# from day_tr.cuh mrt_face_node: ~12 operations per network face and
# iteration (the linearized conductance and its cube, w ts, the face's share
# of its zone's two sums and the gather of the node), MRT_ITERS iterations
# per evaluation; its reverse (day_tr_adj.cuh mrt_face_node_adj) ~20 more per
# face and iteration.
MRT_OPS = 12
MRT_ADJ_OPS = 20
MRT_ITERS = 4
# The MRT city's f32 kernel against the f64 plain version (zone and
# operative T, 48 h) and on one day (T, zT, the zone history), K.
# Measured on an H100 80GB HBM3 at 700 W, the same in two runs: 6.2e-5 on
# zone T, 6.4e-5 on operative T, 5.3e-5 kernel vs plain (the one-thread
# kernel, which shared the f32 plain version's operation order).
MRT_F32_TOL = 2e-4
# The MRT adjoints (the city's TR-BDF2 day, the office's TR-BDF2 and parity
# days) against their f32 plain versions, relative L2 per output.  Measured
# on the same card in two runs: 2.5e-3 and 3.2e-3 (the city), 2.1e-4 and
# 2.6e-4, 7.1e-4 and 1.1e-3 (the office): the plain adjoint's f32 zone sums
# (index_add_) move from run to run.
MRT_ADJ_F32_RL2 = 1e-2
# In-run passive controls (phases 21-23).  Operations the gates add to a
# day-launch, counted from day_march_tr.cu and day_march_parity.cu (gate_work).
GATE_LANE_OPS = 1
GATE_PANE_OPS = 3
GATE_ZONE_OPS = 6
# Each small case's hours (one launch): long enough for every device and
# vent to open and close.  A case must have this share of its decisions on.
GATE_CASE_HOURS = 12
GATE_SHARE = (0.05, 0.95)
# A decision that two runs (f32 and f64, or the kernel and its plain version)
# take apart must lie within round-off of its threshold: a first flip in a
# zone group farther than this from it is a fault (phases 22-23).  Zones
# where every decision agrees are held to the bounds of the ungated paths.
FLIP_MARGIN = 1e-3  # K
# The full-width controlled city's shading setpoints, spread over the range
# its zones cross on the bench weather (12.8-23.1 C over 48 h).
CITY_SHADE_SETPOINTS = (16.0, 26.0)
# The adaptive no-mass loop (phases 24-26; heatx's default
# nomass_fixed_iters=None, run by the kernels with HEATX_KERNEL_WHILE=1).
# heatx holds its in-kernel loop to its XLA path within 5e-8 K
# (tests/test_pallas_hour.py:167-173); the port's kernel route is held to
# the port's ThermalModel.march on the card the same way.
ADAPTIVE_XLA_TOL = 5e-8  # K
ADAPTIVE_HOURS = 2  # phase 24's small buildings, at the coarse discretization
# A loop that stops on thresholds (mean |dT| < 0.01 K, an error that grew)
# can stop an iteration apart in f32 and f64 near either, which moves that
# no-mass node by up to ~tol/2: phase 25 counts those runs, and holds the
# f32 kernel's zone temperatures over the window to heatx's own f32 parity
# error against its adaptive-loop golden, 0.0065 K RMSE (BENCH_r05.json
# accuracy_parity_rmse_K: a TPU v5e record of the JAX package, not the
# port's number).
ADAPTIVE_RMSE = 0.0065  # K
# That bound passes a kernel that ignores the adaptive stop: the f64 kernels
# with one and two iterations are 5.3e-4 and 7.6e-4 K from the adaptive f64
# plain version on the window's zone history, 2.7e-3 and 5.7e-3 K on T
# (measured on an H100 80GB HBM3 at 700 W).  So phase 25 also holds the f64
# kernel to its f64 plain version at F64_TOL (5.7e-14 K measured) off the
# runs whose stop decision the plain version took within ADAPTIVE_NEAR of a
# threshold (round-off may take it the other way; none did in the window),
# and the f32 kernel to the f64 plain version off the runs whose stopping
# iteration differs between the f32 and the f64 plain versions: T at
# PARITY_DAY_TOL (7.9e-5 K measured), the zone history of the zones they do
# not touch at CAV_WINDOW_T_TOL (2.4e-4 K measured: the f32 round-off of the
# sunlit window, as in phase 16b, stop or no stop).  The one- and
# two-iteration f64 kernels, on the same window, must fail the F64_TOL bound
# and the T bound.
ADAPTIVE_NEAR = 1e-10  # K
ADAPTIVE_RUN_HOURS = 2  # phase 26: ThermalModel.run at full width, the XLA path
CLI_WARMUP_DAYS = 3  # phase 27a: the CLI year's --warmup-days
CLI_F64_HOURS = 48  # phase 27b: the CLI's f64 run, card against the CPU
SIZING_CUT_HOURS = 168  # phase 27c: the f64 sizing run, card against the CPU,
SIZING_CUT_WARMUP = 3  # with at most this many warm-up days
SIZING_DD_WARMUP = 2  # phase 27f: the f64 design day's warm-up repeats, card against the CPU
# Published H100 SXM rates (NVIDIA H100 datasheet): HBM bytes/s and the
# f32 FLOP/s outside the tensor cores (the kernels run no matrix products).
HBM_BPS = 3.35e12
PEAK_F32_FLOPS = 67e12


#: The launch variant each timed day-march kind ran in, as the wrapper read
#: it back (``G=4/<threads a block>``), by its entry on the kernels line.
VARIANTS = {}


def note_variant(day_march, name):
    VARIANTS[name] = f"G=4/{day_march.day_march_kernel.block_threads}"


def note_adjoint_variant(day_adjoint, name):
    """The day adjoint's launch variant, as its wrapper read it back."""
    VARIANTS[name] = f"G=4/{day_adjoint.day_adjoint_kernel.block_threads}"


def hour_slices(hi, h, sub):
    """Hour h of a day's kernel inputs: the weather's sub-steps, the rest's row."""
    return tuple(x[h * sub:(h + 1) * sub] if i < 3 else x[h:h + 1] for i, x in enumerate(hi))


def forward_hour_starts(torch, r24, r1, T, zT, hi):
    """The forward kernel's state at each hour's start of runner ``r24``'s
    day from (T, zT) on ``hi``: [(T [N, SP], zT [NB, ZB])] per hour, marched
    hour by hour through the one-hour runner ``r1``, whose one-hour launches
    must end bit-equal to ``r24``'s one-day launch."""
    hm = r24.hour_march
    day = hm(r24.params, T, zT, hi)
    starts, t, z = [], T, zT
    for h in range(hm.hours):
        starts.append((t, z))
        t, z = r1.hour_march(r1.params, t, z, hour_slices(hi, h, hm.substeps))[:2]
    check(torch.equal(t, day[0]) and torch.equal(z, day[1]),
          "the forward's one-hour launches do not end on its one-day launch")
    return starts


def kernel_hour_starts(torch, day_march, bb, hm, params, T, zT, hi):
    """The parity forward kernel's state at each hour's start of the launch
    ``hm`` (an hour march of the blocked building ``bb`` on ``params``) from
    (T, zT) on ``hi``: forward_hour_starts through a one-hour launch of the
    same building.  The plain adjoint re-run from them (``starts``) follows
    the march the adjoint kernel differentiates."""
    hm1 = day_march.hour_march_for(bb, mode="parity", hours=1)
    return forward_hour_starts(torch, SimpleNamespace(hour_march=hm, params=params),
                               SimpleNamespace(hour_march=hm1, params=params), T, zT, hi)


def recompute_gap(torch, day_adjoint, adj, r24, r1, T, zT, hi, cots):
    """The largest |d| between the TR-BDF2 adjoint's recomputed hour-start
    states (its hour-start workspace) and the forward kernel's states at the
    same hours (forward_hour_starts through the one-hour runner ``r1``),
    node T and zone T, for one launch of ``adj`` (the day adjoint of runner
    ``r24``) from (T, zT) on ``hi``."""
    starts = forward_hour_starts(torch, r24, r1, T, zT, hi)
    _, (T_ws, zT_ws) = day_adjoint.day_adjoint_kernel._launch(
        *adj._args(r24.params, T, zT, hi, cots), **adj._hm._kw(observables=False))
    torch.cuda.synchronize()
    gap_T = max(float((T_ws[h] - t).abs().max()) for h, (t, _) in enumerate(starts))
    gap_z = max(float((zT_ws[h] - z).abs().max()) for h, (_, z) in enumerate(starts))
    return gap_T, gap_z


def parity_recompute_gap(torch, testing, SimConfig, ThermalModel, day_adjoint, model, dtype):
    """The parity adjoint's recomputed hour-start states against the parity
    forward kernel's at the same hours (recompute_gap), on the bench day of
    ``model`` (one no-mass iteration, its own sub-steps, 24 h, seeded
    hourly cotangents), in ``dtype``: (gap T, gap zT)."""
    tm = ThermalModel(model, n=1, config=SimConfig(dtype=dtype, nomass_fixed_iters=PARITY_ITERS), device="cuda")
    r24 = tm.fast_runner(mode="parity", hours=24)
    T, zT = r24.to_blocked(tm.initial_state())
    hi = r24.kernel_inputs(testing.bench_inputs(tm.building, 24, device="cuda"), interp_weather=True)[0]
    adj = day_adjoint.make_day_adjoint(r24._bb, substeps=tm.dt_subdivisions, mode="parity", hours=24)
    NB, ZB = r24._bb.n_blocks, r24._bb.zones_per_block
    d_hist = torch.as_tensor(np.random.default_rng(3).normal(size=(24, NB, ZB)) / (24 * NB * ZB), dtype=dtype,
                             device="cuda")
    cots = (torch.zeros_like(T), torch.zeros_like(zT), d_hist)
    return recompute_gap(torch, day_adjoint, adj, r24, tm.fast_runner(mode="parity", hours=1), T, zT, hi, cots)


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


def phase3b_b1_edge(torch, day_march, day_adjoint, testing, ThermalModel, SimConfig):
    """Both day-march kernels at B1's edge and between their launch bounds:
    one zone bounded by 256 surfaces (one block of the most lanes a block
    takes, 1024 threads) and one bounded by 50 (a 64-lane block, 256
    threads), each with a 32-node wall (the most nodes per surface).  The
    TR-BDF2 kernel free-float in k=2 and with a thermostat in frozen mode
    (the extended kind), 3 h; the parity kernel at the coarse discretization
    (6 sub-steps an hour; the wall then has 8 nodes), one no-mass
    iteration, free-float and with the thermostat, 2 h.  f64 against the
    plain version (every output <= F64_TOL; loads relative to their largest
    magnitude); f32 against the f64 plain version (T, zT and the zone
    history <= F32_TOL, loads <= LOAD_F32_RTOL of their largest magnitude,
    no non-finite value).  The adjoint kernel of each body on the same f64
    launches (TR-BDF2 k=2 free-float and frozen with the thermostat, parity
    free-float and with the thermostat) against the plain adjoint on seeded
    cotangents, every output <= ADJ_F64_RTOL of its max |ref|.  Returns the
    worst f64 and f32 gaps, the worst adjoint gap and, per building and mode,
    its surfaces, its block's lanes, its nodes and the launch variants the
    launches took (the day march's and the adjoint's)."""
    worst64, worst32, worst_adj, shapes = 0.0, 0.0, 0.0, []
    modes = (
        ("trbdf2", 3, lambda dtype: SimConfig(dtype=dtype),
         ((False, dict(mode="trbdf2_refresh", substeps=8, refresh_every=2), testing.bench_inputs),
          (True, dict(mode="trbdf2", substeps=8), testing.demand_inputs))),
        ("parity", 2, lambda dtype: testing.coarse_config(dtype, 1),
         ((False, dict(mode="parity"), testing.bench_inputs), (True, dict(mode="parity"), testing.demand_inputs))),
    )
    for surfaces in (256, 50):
        for mode, hours, config, kinds in modes:
            for thermostat, kw, inputs in kinds:
                what = f"B1 edge ({surfaces} surfaces, {mode}, thermostat={thermostat})"
                model = testing.build_wide_zone_model(surfaces, thermostat=thermostat)
                outs = {}
                for dtype in (torch.float64, torch.float32):
                    tm = ThermalModel(model, n=1, config=config(dtype), device="cuda")
                    r = tm.fast_runner(hours=hours, **kw)
                    T, zT = r.to_blocked(tm.initial_state())
                    hi = r.kernel_inputs(inputs(tm.building, hours, device="cuda"))[0]
                    before = day_march.day_march_kernel.launches
                    outs[dtype] = r.hour_march(r.params, T, zT, hi)
                    if dtype == torch.float64:
                        ref = r.hour_march.plain(r.params, T, zT, hi)
                    torch.cuda.synchronize()
                    check(day_march.day_march_kernel.launches == before + 1, f"{what}: the kernel did not launch")
                    if dtype == torch.float64:
                        akw = dict(kw, substeps=tm.dt_subdivisions) if mode == "parity" else kw
                        adj = day_adjoint.make_day_adjoint(r._bb, hours=hours, **akw)
                        rng = np.random.default_rng(surfaces)
                        NB, ZB = r._bb.n_blocks, r._bb.zones_per_block

                        def cot(shape, scale=1.0):
                            return torch.as_tensor(rng.normal(size=shape) * scale, dtype=dtype, device="cuda")

                        cots = (cot(T.shape), cot(zT.shape), cot((hours, NB, ZB))) + (
                            (cot((hours, NB, ZB), 1e-3),) if thermostat else ())
                        before = day_adjoint.day_adjoint_kernel.launches
                        _, w = adjoint_vs_plain(torch, adj, r.params, T, zT, hi, cots, what)
                        check(day_adjoint.day_adjoint_kernel.launches == before + 1,
                              f"{what}: the adjoint kernel did not launch")
                        worst_adj = max(worst_adj, w)
                for i, (x, y, z) in enumerate(zip(outs[torch.float64], ref, outs[torch.float32])):
                    if isinstance(x, tuple):
                        x, y, z = torch.stack(x), torch.stack(y), torch.stack(z)
                    load = thermostat and i == len(ref) - 1  # the load history, W
                    scale = max(float(y.abs().max()), 1e-30) if load else 1.0
                    d = float((x - y).abs().max()) / scale
                    check(d <= F64_TOL, f"{what} f64 output {i}: max |d| {d} > {F64_TOL}")
                    worst64 = max(worst64, d)
                    if i in (0, 1, 3) or load:
                        d32 = float((z.double() - y).abs().max()) / scale
                        tol = LOAD_F32_RTOL if load else F32_TOL
                        check(d32 <= tol, f"{what} f32 output {i} vs f64 plain: max |d| {d32} > {tol}")
                        if not load:
                            worst32 = max(worst32, d32)
                check(bool(torch.isfinite(outs[torch.float32][0]).all())
                      and float(outs[torch.float32][4].sum()) == 0.0, f"{what} f32: non-finite state")
            shapes.append((surfaces, mode, r.params.block_size, r.params.max_nodes,
                           day_march.day_march_kernel.block_threads, day_adjoint.day_adjoint_kernel.block_threads))
    return worst64, worst32, worst_adj, shapes


def phase3c_zone_rows(torch, day_adjoint, testing, ThermalModel, SimConfig):
    """The TR-BDF2 adjoint where a block holds the most zone rows of an hour:
    testing.build_zone_chain_model (64 zones in one 64-lane block, 2-node
    panes, a thermostat per zone) at ZONE_ROWS_SUBSTEPS sub-steps an hour,
    f64, 2 h, k=2 and frozen, against the plain adjoint on seeded
    cotangents, every output <= ADJ_F64_RTOL of its max |ref|.  Returns the
    worst gap and the block's lanes, zones and nodes and the launch variants
    the two launches took."""
    tm = ThermalModel(testing.build_zone_chain_model(), n=1, config=SimConfig(dtype=torch.float64), device="cuda")
    worst, variants, hours = 0.0, [], 2
    for kw in (dict(mode="trbdf2_refresh", substeps=ZONE_ROWS_SUBSTEPS, refresh_every=2),
               dict(mode="trbdf2", substeps=ZONE_ROWS_SUBSTEPS)):
        what = f"zone chain, {kw['mode']}, {ZONE_ROWS_SUBSTEPS} sub-steps"
        r = tm.fast_runner(hours=hours, **kw)
        T, zT = r.to_blocked(tm.initial_state())
        hi = r.kernel_inputs(testing.demand_inputs(tm.building, hours, device="cuda"))[0]
        adj = day_adjoint.make_day_adjoint(r._bb, hours=hours, **kw)
        NB, ZB = r._bb.n_blocks, r._bb.zones_per_block
        rng = np.random.default_rng(ZB)
        cots = tuple(torch.as_tensor(rng.normal(size=shape) * scale, dtype=torch.float64, device="cuda")
                     for shape, scale in ((T.shape, 1.0), (zT.shape, 1.0), ((hours, NB, ZB), 1.0),
                                          ((hours, NB, ZB), 1e-3)))
        before = day_adjoint.day_adjoint_kernel.launches
        _, w = adjoint_vs_plain(torch, adj, r.params, T, zT, hi, cots, what)
        check(day_adjoint.day_adjoint_kernel.launches == before + 1, f"{what}: the adjoint kernel did not launch")
        worst = max(worst, w)
        variants.append(f"G=4/{day_adjoint.day_adjoint_kernel.block_threads}")
    return worst, (r.params.block_size, r.params.zones_per_block, r.params.max_nodes, variants)


#: Phase 3c's parity zone chain: the most zones whose block the one-thread
#: parity adjoint took at the chain's 118 sub-steps an hour (72 zones, 72 zone
#: slots, 96 lanes: its shared memory 8 (72 (3 x 118 + 11) + 6 x 96) B = 215
#: KB of the H100's 227 KB; 73 zones take 80 slots, 238 KB).
PARITY_CHAIN_ZONES = 72


def parity_zone_rows(torch, day_adjoint, testing, ThermalModel, SimConfig, device="cuda"):
    """The parity adjoint where a block holds the most zone rows of an hour
    that the one-thread kernel it replaced took: testing.build_zone_chain_model
    (PARITY_CHAIN_ZONES zones in one block, 2-node panes, a thermostat each)
    at its 118 sub-steps an hour, f64, one hour (the zone rows a block holds
    are an hour's), from the initial state on the demand
    inputs (a seeded random start puts zones on their setpoints and no-mass
    panes on the 2-cycles, where the plain adjoint itself moves by 1e-9 to
    order 1 with a 1e-12 K move of the start), seeded cotangents, every
    output <= ADJ_F64_RTOL of the plain adjoint's max |ref|.  Returns the
    worst gap and (lanes, zone slots, nodes, sub-steps, launch variant)."""
    hours = 1
    tm = ThermalModel(testing.build_zone_chain_model(PARITY_CHAIN_ZONES), n=1,
                      config=SimConfig(dtype=torch.float64, nomass_fixed_iters=PARITY_ITERS), device=device)
    r = tm.fast_runner(mode="parity", hours=hours)
    T, zT = r.to_blocked(tm.initial_state())
    hi = r.kernel_inputs(testing.demand_inputs(tm.building, hours, device=device), interp_weather=True)[0]
    adj = day_adjoint.make_day_adjoint(r._bb, substeps=tm.dt_subdivisions, mode="parity", hours=hours,
                                       device=device)
    NB, ZB = r._bb.n_blocks, r._bb.zones_per_block
    rng = np.random.default_rng(ZB)
    cots = [torch.as_tensor(rng.normal(size=shape) * scale, dtype=torch.float64, device=device)
            for shape, scale in ((T.shape, 1.0), (zT.shape, 1.0), ((hours, NB, ZB), 1.0), ((hours, NB, ZB), 1e-3))]
    args, kw = adj._args(r.params, T, zT, hi, cots), adj._hm._kw(observables=False)
    before = day_adjoint.day_adjoint_kernel.launches
    got = day_adjoint.day_adjoint_kernel(*args, **kw)
    ref = day_adjoint.plain_day_adjoint(*args, **kw)
    check(day_adjoint.day_adjoint_kernel.launches == before + 1, "the parity zone chain's adjoint did not launch")
    what = f"parity zone chain, {PARITY_CHAIN_ZONES} zones, {tm.dt_subdivisions} sub-steps"
    worst = 0.0
    for name, x, y in zip(("dT0", "d_zT0", "d_node", "d_surf", "d_zv", "d_chan", "d_a", "d_b", "d_ctl"), got, ref):
        check(bool(torch.isfinite(x).all()), f"adjoint {what} {name}: non-finite")
        scale, err = float(y.abs().max()), float((x - y).abs().max())
        check(err <= ADJ_F64_RTOL * scale, f"adjoint {what} {name}: max |d| {err} > {ADJ_F64_RTOL} x {scale}")
        worst = max(worst, err / scale if scale else err)
    return worst, (r.params.block_size, ZB, r.params.max_nodes, tm.dt_subdivisions,
                   f"G=4/{day_adjoint.day_adjoint_kernel.block_threads}")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def day_work(params, hours, sub, k):
    """Operations of one day-march launch, counted from the TR-BDF2 march's
    arithmetic on this run's shapes with the stage solves as Thomas sweeps
    (the partitioned solve of day_march_tr.cu does more; transcendentals
    count as one): per valid node and sub-step
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
    return hours * (sub * per_sub + (sub // k) * per_refresh) + gate_work(params, hours), valid, lanes, zones


def adjoint_work(params, hours, sub, k):
    """Operations the day's adjoint needs, counted from day_adjoint_tr.cu: one
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
    """Every tensor of a DayMarchParams a launch reads (thermostat rows,
    mixing lists and gas-cavity operands included, where the building has
    them)."""
    out = [params.node, params.surf, params.lane, params.zone_volume, params.zone_ptr, params.zone_faces]
    if params.ctl is not None:
        out.append(params.ctl)
    if params.mix is not None:
        m = params.mix
        out += [m.ptr, m.src, m.vol, m.t_ptr, m.t_dst, m.t_vol]
    if params.cav is not None:
        out.append(params.cav)
    if params.mrt is not None:
        out += [params.mrt, params.mrt_ptr, params.mrt_faces]
    out += [t for t in (params.shade_slot, params.shade, params.vent) if t is not None]
    return out


def bound(bytes_moved, ops):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and
    operations over the f32 peak."""
    t_bytes, t_ops = bytes_moved / HBM_BPS * 1e3, ops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_time(torch, fn):
    """Run ``fn`` once under torch.profiler: (the device's busy ms, {kernel:
    its ms}) for the day-march kernels (the TR-BDF2 and parity bodies) and
    the day adjoint's (both bodies).  One stream, so the sum of the device events is
    the busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = {"day_march": ("day_march_kernel", "day_march_tr_kernel"),
             "day_adjoint": ("day_adjoint_kernel", "day_adjoint_tr_kernel")}
    busy, kern = 0.0, dict.fromkeys(names, 0.0)
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.self_device_time_total
        busy += us
        for name, keys in names.items():
            if any(k in e.key for k in keys):
                kern[name] += us
    return busy / 1e3, {k: v / 1e3 for k, v in kern.items()}


def worst_of(gaps):
    """``gaps``' largest value and its output's name, for a report line."""
    name = max(gaps, key=gaps.get)
    return f"{gaps[name]:.3e} ({name})"


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


def rel_l2_gaps(torch, got, ref, what, bound, lanes=None):
    """Relative L2 gap per adjoint output (max |d| where the reference is
    0), each held to ``bound``, outputs finite.  ``lanes`` (a [SP] bool
    row) keeps only those lanes' columns of the per-lane outputs (last
    dimension SP) and leaves the others out.  Returns the gaps."""
    gaps = {}
    for name, r in ref.items():
        g = got[name]
        check(bool(torch.isfinite(g).all()), f"{what} {name}: non-finite")
        if lanes is not None:
            if r.shape[-1] != lanes.shape[0]:
                continue
            r, g = r[..., lanes], g[..., lanes]
        norm = float(r.norm())
        gaps[name] = float((g.to(r.dtype) - r).norm()) / norm if norm else float(g.abs().max())
    bad = {name: gap for name, gap in gaps.items() if gap > bound}
    check(not bad, f"{what}: relative L2 above {bound}: {bad}; all: {gaps}")
    return gaps


class SetpointMargins:
    """Over every ``engine.zone.zone_update`` call made while it is installed
    (``with SetpointMargins(torch) as m:`` around a plain day march), each
    zone's smallest distance of its free-float temperature from a setpoint
    its thermostat can act on (heating where max_heat > 0, cooling where
    max_cool > 0; inf for a zone with neither): ``m.margin`` [zones], K."""

    def __init__(self, torch):
        self.torch = torch
        self.margin = None

    def __enter__(self):
        from heatx_torch.engine import zone as zone_mod

        torch, orig = self.torch, zone_mod.zone_update
        self._zone_mod, self._orig = zone_mod, orig

        def recorded(zone_T, a, b, c, dt, heat_sp, cool_sp, max_heat, max_cool):
            with torch.no_grad():
                t_free = zone_mod.future_zone_temperatures(zone_T, a, b, c, dt)
                inf = torch.full_like(t_free, float("inf"))
                d = torch.minimum(torch.where(max_heat > 0, (t_free - heat_sp).abs(), inf),
                                  torch.where(max_cool > 0, (t_free - cool_sp).abs(), inf))
                d = torch.where(b.abs() > zone_mod.SMALL_B, d, inf)
                self.margin = d if self.margin is None else torch.minimum(self.margin, d)
            return orig(zone_T, a, b, c, dt, heat_sp, cool_sp, max_heat, max_cool)

        zone_mod.zone_update = recorded
        return self

    def __exit__(self, *exc):
        self._zone_mod.zone_update = self._orig


def parted_thermostat_zones(torch, r64, T, zT, hi, ld32):
    """The zones of runner ``r64``'s building whose hourly loads ``ld32`` (an
    f32 march of the day from (T, zT) on ``hi``) and the f64 plain march's
    part, 0 on one side only ([NB, ZB] bool), after checking that each came
    within FLIP_MARGIN of a setpoint in the f64 march (else a fault) and that
    at most TSTAT_PARTED_MAX part; the parted zones' margins (K); the number
    of zones within FLIP_MARGIN of a setpoint, and of zones whose thermostat
    acts at all."""
    with SetpointMargins(torch) as sm:
        ld64 = r64.hour_march.plain(r64.params, T, zT, hi)[-1]
    NB, ZB = r64._bb.n_blocks, r64._bb.zones_per_block
    margin = sm.margin.reshape(NB, ZB)
    near = margin < FLIP_MARGIN
    parted = ((ld32 == 0) != (ld64 == 0)).any(dim=0)
    check(not bool((parted & ~near).any()),
          f"zones {parted.nonzero().tolist()} part from f64 with no setpoint within {FLIP_MARGIN} K "
          f"(their margins {margin[parted].tolist()} K)")
    check(int(parted.sum()) <= TSTAT_PARTED_MAX,
          f"{int(parted.sum())} thermostat zones part from f64 (> {TSTAT_PARTED_MAX}); margins "
          f"{sorted(margin[parted].tolist())} K")
    return parted, sorted(float(x) for x in margin[parted]), int(near.sum()), int(torch.isfinite(margin).sum())


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
                  mode="trbdf2_refresh", config_kw=None, u_scale=1.2, build=None, eps_scale=None):
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
    the conductance scale the run starts from (bench.py: 1.2); ``build``
    replaces the function that builds the city (the glazed city of phase 16);
    ``eps_scale`` adds a third parameter, a scale of the back faces'
    emissivities (the interior faces of the MRT city, phase 19), which the
    callable's result then ends with."""
    from heatx_torch.engine.adjoint import chunked_value_and_grad, tree_map

    build = build or (testing.build_demand_city if demand else testing.build_city_model)
    tm = ThermalModel(build(1000, 10), n=1, config=SimConfig(dtype=dtype, **(config_kw or {})),
                      device="cuda")
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
    eps_b0 = torch.as_tensor(sb0.eps_back, device="cuda")
    heat0 = torch.as_tensor(b.ctl_heat_sp, device="cuda")
    second = "sp_shift" if demand else "alpha_scale"

    def with_params(p):
        if demand:
            sb = dataclasses.replace(sb0, seg_u=seg_u0 * p["u_scale"])
            return dataclasses.replace(b, surfaces=sb, ctl_heat_sp=heat0 + p["sp_shift"])
        sb = dataclasses.replace(sb0, seg_u=seg_u0 * p["u_scale"], front_alphas=alphas0 * p["alpha_scale"])
        if eps_scale is not None:
            sb = dataclasses.replace(sb, eps_back=eps_b0 * p["eps_scale"])
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
    if eps_scale is not None:
        params["eps_scale"] = torch.tensor(eps_scale, dtype=dtype, device="cuda")

    def run():
        val, g = chunked_value_and_grad(None, params, st, xs, forward_fn=kf, backward_fn=kb)
        out = (float(val), float(g["u_scale"]), float(g[second]))
        return out + ((float(g["eps_scale"]),) if eps_scale is not None else ())

    return run, fr, seq


def phase9_thermostats_f64(torch, day_march, day_adjoint, testing, SimConfig, compile_building):
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
        return torch.as_tensor(np.asarray(a, np.float64), device="cuda")

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
                kw = dict(substeps=sub, mode=mode, hours=hours, refresh_every=k, device="cuda",
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
    ``f32 ext=0 parity=1 G=4/128/3: 96 registers, 0 B stack, spills 0/0 B``
    (the instantiations with the gas-cavity code are marked ``cavities``,
    every kernel's launch variant ``G=<threads per surface>/<launch
    bound>/<blocks per SM>``)."""
    import re

    out, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            sym = m.group(1)
            t = re.search(r"kernelI([fd])((?:Li\d+E)*)((?:Lb[01]E)+)", sym)
            flags = re.findall(r"Lb([01])E", t.group(3)) if t else []
            ints = re.findall(r"Li(\d+)E", t.group(2)) if t else []
            group = ""
            if "day_march_tr_kernel" in sym:  # <T, G, kThreads, kMinBlocks, kExt, kCav, kMrt>
                (ext, cav, mrt), parity = (flags + ["?"] * 3)[:3], "0"
                group = " G=" + "/".join(ints)
            elif "day_march_parity_kernel" in sym:  # <T, kThreads, kMinBlocks, kExt, kCav, kMrt>, G = 4
                (ext, cav, mrt), parity = (flags + ["?"] * 3)[:3], "1"
                group = " G=4/" + "/".join(ints)
            elif "day_adjoint_tr_kernel" in sym:  # <T, kThreads, kMinBlocks, kExt, kCav, kMrt>, G = 4
                (ext, cav, mrt), parity = (flags + ["?"] * 3)[:3], "0"
                group = " G=4/" + "/".join(ints)
            else:  # the parity adjoint <T, kThreads, kMinBlocks, kCav, kMrt>, G = 4, one kind with the thermostats
                (ext, cav, mrt), parity = (["1"] + flags + ["?"] * 2)[:3], "1"
                group = " G=4/" + "/".join(ints)
            name = (f"{'f32' if t and t.group(1) == 'f' else 'f64'} ext={ext} parity={parity}{group}"
                    + (" cavities" if cav == "1" else "") + (" mrt" if mrt == "1" else ""))
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
    """Operations of one parity day-march launch, counted from the parity
    sub-step's arithmetic (the no-mass solve as Thomas sweeps) on this run's
    shapes: per valid node and sub-step 65 + 16 per no-mass
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
    return hours * sub * per_sub + gate_work(params, hours), valid, lanes, zones


def parity_adjoint_work(params, hours, sub, iters):
    """Operations the parity day's adjoint needs, counted from
    day_adjoint_parity.cu: one forward march of the day, then per valid node and
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


def phase12_parity_f64(torch, day_march, day_adjoint, testing, ThermalModel):
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
            tm = ThermalModel(build(), config=testing.coarse_config(torch.float64, iters), device="cuda")
            r = tm.fast_runner(mode="parity", hours=hours)
            sub = r._substeps
            check(sub == tm.dt_subdivisions <= 8, f"{what}: {sub} sub-steps")
            seq = inputs(tm.building, hours, device="cuda")
            # The bench weather starts at midnight: give the two hours some sun.
            sun = rng.uniform(50.0, 400.0, (hours, tm.building.n_surfaces))
            seq = seq.replace(sol_front=torch.as_tensor(sun, device="cuda"))
            hi = r.kernel_inputs(seq, interp_weather=True)[0]
            st0 = tm.initial_state()
            if r._has_loads:  # a cold, a cool and a hot zone: heating, the clamp, cooling
                st0 = dataclasses.replace(st0, zone_T=torch.as_tensor([18.0, 19.0, 27.0, 21.0], device="cuda"))
            T0, zT0 = r.to_blocked(st0)
            mask = day_march.bit_rows(r.params, "node_bits")
            NB, ZB = r.params.n_blocks, r.params.zones_per_block

            def rand(shape, scale=1.0):
                return torch.as_tensor(rng.normal(size=tuple(shape)) * scale, device="cuda")

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
            adj = day_adjoint.make_day_adjoint(r._bb, substeps=sub, mode="parity", hours=hours, device="cuda")
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
    note_variant(day_march, "day_march_parity")
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
    days, chunks = PARITY_GRAD_DAYS, 2
    run32, fr32, seq32 = grad_workload(torch, ThermalModel, SimConfig, testing, torch.float32, days, chunks, **gw)
    km.launches = km.parity_launches = ka.launches = ka.parity_launches = 0
    t0 = time.time()
    v32 = run32()
    torch.cuda.synchronize()
    grad30_s = time.time() - t0
    counts = (km.launches, km.parity_launches, ka.launches, ka.parity_launches)
    expected = (2 * days, 2 * days, days, days)
    check(counts == expected,
          f"{days}-day parity value_and_grad: (day march, its parity, adjoint, its parity) launches {counts}, "
          f"expected {expected}")
    check(all(np.isfinite(v32)) and v32[1] != 0 and v32[2] != 0, f"{days}-day parity value_and_grad: {v32}")
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
          f"day-march launches ({days} forward + {days} recompute; {counts[1]} parity), {counts[2]} adjoint launches "
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
    note_adjoint_variant(day_adjoint, "day_adjoint_parity")
    # The plain adjoint re-run from the forward kernel's hour starts (the march
    # the kernel differentiates; it skips the plain version's own march).
    starts = kernel_hour_starts(torch, day_march, fr32._bb, hm, params, T, zT, hi)
    t0 = time.time()
    g32p = flat_grads(adj.plain(params, T, zT, hi, cots, starts=starts))
    torch.cuda.synchronize()
    adj_plain_ms = (time.time() - t0) * 1e3
    gaps = rel_l2_gaps(torch, g32, g32p, "f32 parity adjoint kernel vs f32 plain adjoint from its hour starts over "
                       "the main path's day", PARITY_ADJ_F32_RL2)
    worst_gap = max(gaps, key=gaps.get)
    adj32_abs = max(float((g32[n] - ref).abs().max()) for n, ref in g32p.items())
    check(float(g32["seg_u"].abs().max()) > 0 and float(g32["front_alphas"].abs().max()) > 0,
          "the main path's day adjoint gives no gradient on seg_u or front_alphas")
    del g32p, starts
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
    # The recompute's hour starts against the forward kernel's states, f32 and
    # f64 (the adjoint differentiates the march the forward kernel took).
    gaps_hs = {str(dt)[6:]: parity_recompute_gap(torch, testing, SimConfig, ThermalModel, day_adjoint, ctx.model, dt)
               for dt in (torch.float32, torch.float64)}
    for name, (gap_T, gap_z) in gaps_hs.items():
        check(gap_T == 0.0 and gap_z == 0.0, f"the parity adjoint's {name} hour starts part from the forward "
              f"kernel's states by {gap_T} K (nodes), {gap_z} K (zones)")
    print(f"phase 14b the main path's first day-launch (24 h x {sub} sub-steps, u_scale 1.2, alpha_scale 0.8), "
          f"f32, each parity kernel against its plain version: day march {kernel_ms:.3f} ms vs plain twin "
          f"{plain_ms:.1f} ms (host clock), max |d| " + ", ".join(f"{n} {v:.2e}" for n, v in fwd_gaps.items())
          + f" (<= {PARITY_DAY_TOL:g} K, h/q <= {PARITY_HQ_TOL:g}); a start state moved by {PARITY_EPS:g} K ends the day {growth[0]:.3g} x as "
          f"far apart on the nodes, {growth[1]:.3g} x on the zones (<= {PARITY_GROWTH_MAX:g}: no face 2-cycles); "
          f"adjoint, the loss's own cotangent: {adj_ms:.3f} ms vs f32 plain adjoint from the forward kernel's hour "
          f"starts {adj_plain_ms:.1f} ms (autograd per hour, host clock), max |d| {adj32_abs:.3e}, relative L2 worst "
          f"{gaps[worst_gap]:.3e} "
          f"({worst_gap}; <= {PARITY_ADJ_F32_RL2:g}), " + ", ".join(f"{n} {v:.2e}" for n, v in gaps.items())
          + f"; on the bench day (u_scale 1, seeded hourly cotangents): adjoint launch {bench_adj_ms:.3f} ms "
          f"(trbdf2_refresh k=2 {ctx.adj_ms:.3f} ms, launch variant {VARIANTS['day_adjoint_parity']}), all finite, "
          f"largest |value| {day_max:.3e} against {max(float(v.abs().max()) for v in g32.values()):.3e} on the main "
          f"path's day; the adjoint's recomputed hour starts vs the forward kernel's states on the bench day, max |d| "
          + ", ".join(f"{n} {t:.3e} / {z:.3e} K (nodes / zones)" for n, (t, z) in gaps_hs.items())
          + " (== 0)", flush=True)

    return SimpleNamespace(
        counts=counts, kernel_ms=kernel_ms, plain_ms=plain_ms, err32=err32, adj_ms=adj_ms,
        adj_plain_ms=adj_plain_ms, adj32_abs=adj32_abs, adj32_rel=gaps[worst_gap], bench_adj_ms=bench_adj_ms,
        growth=growth, params=params, T=T, zT=zT, hi=hi, got=got, cots=cots, g32=g32,
    )


def cavity_segments(params):
    """The gas-cavity segments of a launch (the set bits of the lanes' cavity
    words)."""
    import torch

    if params.cav is None:
        return 0
    bits = params.field("cav_bits").to(torch.int64)
    return sum(int(((bits >> i) & 1).sum()) for i in range(params.max_nodes))


def cavity_work(params, builds, adjoint=False):
    """Operations of the cavity U-values over ``builds`` operator builds,
    counted from day_common.cuh ``cavity_u`` (powers and roots count as one):
    CAV_OPS per cavity segment and build, CAV_ADJ_OPS more in an adjoint
    (the two partial derivatives and their chain into the column)."""
    return cavity_segments(params) * builds * (CAV_OPS + (CAV_ADJ_OPS if adjoint else 0))


def phase15_cavity_f64(torch, ctx):
    """The four cavity bodies against their plain versions, f64, on the
    cavity building and the 4-zone glazed city; central differences of the
    forward kernels (see the module docstring).  Returns the worst gaps, the
    case count and the largest move of the zones that the live cavity U
    makes against the static one."""
    day_march, day_adjoint, testing = ctx.day_march, ctx.day_adjoint, ctx.testing
    SimConfig, ThermalModel = ctx.SimConfig, ctx.ThermalModel
    rng = np.random.default_rng(15)
    worst = dict(T=0.0, adj=0.0, fd=0.0)
    models = {"cavity building": testing.build_cavity_model,
              "glazed 4-zone city": lambda: testing.build_glazed_city(4, 10)}
    bodies = (("trbdf2", None, None), ("trbdf2_refresh", 2, None), ("parity", None, 1), ("parity", None, 2))
    cases, live = 0, 0.0
    km = day_march.day_march_kernel
    for label, build in models.items():
        for mode, k, iters in bodies:
            what = f"cavities, {label}, {mode} k={k} iters={iters}"
            parity = mode == "parity"
            cfg = testing.coarse_config(torch.float64, iters) if parity else SimConfig(dtype=torch.float64)
            tm = ThermalModel(build(), config=cfg, device="cuda")
            hours = 2 if parity else 3
            r = tm.fast_runner(mode=mode, hours=hours, substeps=None if parity else 8, refresh_every=k)
            sub = r._substeps
            seq = testing.bench_inputs(tm.building, hours, device="cuda")
            sun = rng.uniform(50.0, 400.0, (hours, tm.building.n_surfaces))
            seq = seq.replace(sol_front=torch.as_tensor(sun, device="cuda"))
            hi = r.kernel_inputs(seq, interp_weather=True)[0]
            T0, zT0 = r.to_blocked(tm.initial_state())
            mask = day_march.bit_rows(r.params, "node_bits")
            cav = day_march.bit_rows(r.params, "cav_bits")
            check(bool(cav.any()) and r.params.cav is not None, f"{what}: no gas cavity in the launch")
            NB, ZB = r.params.n_blocks, r.params.zones_per_block

            def rand(shape, scale=1.0):
                return torch.as_tensor(rng.normal(size=tuple(shape)) * scale, device="cuda")

            # A random start state: every cavity carries heat, off the kinks.
            T0 = T0 + rand(T0.shape, 4.0) * mask
            zT0 = zT0 + rand(zT0.shape, 0.5)
            hm, params = r.hour_march, r.params
            before = km.cavity_launches
            got = hm(params, T0, zT0, hi)
            check(km.cavity_launches == before + 1, f"{what}: the launch did not count as a cavity launch")
            ref = hm.plain(params, T0, zT0, hi)
            for name, a, b in (("T", got[0], ref[0]), ("zT", got[1], ref[1]), ("zt_hist", got[3], ref[3]),
                               *((f"hq{j}", got[2][j], ref[2][j]) for j in range(4))):
                err = float((a - b).abs().max())
                check(err <= F64_TOL, f"{what} {name}: max |d| {err} > {F64_TOL}")
                worst["T"] = max(worst["T"], err)
            check(float(got[4].sum()) == 0.0, f"{what}: non-finite state in the kernel")
            static = hm(dataclasses.replace(params, cav=None), T0, zT0, hi)
            live = max(live, float((static[1] - got[1]).abs().max()))
            cots = [rand(T0.shape) * mask, rand((NB, ZB)), rand((hours, NB, ZB))]
            adj = day_adjoint.make_day_adjoint(r._bb, substeps=sub, mode=mode, hours=hours, refresh_every=k,
                                               device="cuda")
            g, w = adjoint_vs_plain(torch, adj, params, T0, zT0, hi, cots, what)
            worst["adj"] = max(worst["adj"], w)
            check(float(g["seg_u"][cav].abs().max()) == 0.0, f"{what}: seg_u cotangent on a cavity segment")
            cases += 1

            def loss(p, T):
                out = hm(p, T, zT0, hi)
                return float((out[0] * cots[0]).sum() + (out[1] * cots[1]).sum() + (out[3] * cots[2]).sum())

            def moved_u(e):
                node = params.node.clone()
                node[0] += e * D_u
                return dataclasses.replace(params, node=node)

            D_T, D_u = rand(T0.shape) * mask, rand(T0.shape) * params.node[0]
            eps = 1e-6
            for name, grad, direction, f in (
                ("T0", g["dT0"], D_T, lambda e: loss(params, T0 + e * D_T)),
                ("seg_u", g["seg_u"], D_u, lambda e: loss(moved_u(e), T0)),
            ):
                fd = (f(eps) - f(-eps)) / (2 * eps)
                an = float((grad * direction).sum())
                rel = abs(fd - an) / max(abs(an), 1e-300)
                check(an != 0 and rel <= FD_RTOL, f"{what} d/d{name}: FD {fd} vs adjoint {an} (rel {rel})")
                worst["fd"] = max(worst["fd"], rel)
    check(live > 1e-3, f"the cavity U moved no zone against the static one ({live} K)")
    return worst, cases, live


def phase16_glazed_city(torch, ctx):
    """The glazed city at full width, f32 (see the module docstring)."""
    day_march, day_adjoint, testing = ctx.day_march, ctx.day_adjoint, ctx.testing
    SimConfig, ThermalModel, smi = ctx.SimConfig, ctx.ThermalModel, ctx.smi
    km, ka = day_march.day_march_kernel, day_adjoint.day_adjoint_kernel
    model = testing.build_glazed_city(1000, 10)
    kw = dict(mode="trbdf2_refresh", substeps=8, hours=24, refresh_every=2)
    tm32 = ThermalModel(model, n=1, config=SimConfig(dtype=torch.float32), device="cuda")
    r32 = tm32.fast_runner(**kw)
    st0 = tm32.initial_state()
    km.launches = km.cavity_launches = 0
    t0 = time.time()
    fin32, z32 = r32.run(st0, testing.bench_inputs(tm32.building, 48, device="cuda"), interp_weather=True)
    torch.cuda.synchronize()
    run48_s = time.time() - t0
    run_launches = km.cavity_launches
    check((km.launches, run_launches) == (2, 2), f"glazed city 48 h: {km.launches} launches, {run_launches} with cavities")
    tm64 = ThermalModel(model, n=1, config=SimConfig(dtype=torch.float64), device="cuda")
    _, z64 = tm64.fast_runner(use_kernel=False, **kw).run(
        tm64.initial_state(), testing.bench_inputs(tm64.building, 48, device="cuda"), interp_weather=True)
    for name, v in (("zone_T", z32), ("node_T", fin32.node_T), ("zone_T f64", z64)):
        check(bool(torch.isfinite(v).all()), f"glazed city {name} has non-finite values")
    err48 = float((z32.double() - z64).abs().max())
    check(err48 <= F32_TOL, f"glazed city f32 kernel vs f64 twin zone_T: max |d| {err48} > {F32_TOL}")

    # One bench day: the TR-BDF2 cavity launch and its adjoint.
    T, zT = r32.to_blocked(st0)
    hi = r32.kernel_inputs(testing.bench_inputs(tm32.building, 24, device="cuda"), interp_weather=True)[0]
    ms = event_ms(torch, lambda: r32.hour_march(r32.params, T, zT, hi), 10)
    plain_ms = event_ms(torch, lambda: r32.hour_march.plain(r32.params, T, zT, hi), 1)
    got = r32.hour_march(r32.params, T, zT, hi)
    ref = r32.hour_march.plain(r32.params, T, zT, hi)
    torch.cuda.synchronize()
    err32 = max(float((got[i] - ref[i]).abs().max()) for i in (0, 1, 3))
    check(err32 <= F32_TOL, f"glazed city f32 day kernel vs plain twin: max |d| {err32} > {F32_TOL}")
    r64 = tm64.fast_runner(**kw)
    adj_kw = dict(substeps=8, mode="trbdf2_refresh", hours=24, refresh_every=2)
    adj32 = day_adjoint.make_day_adjoint(r32._bb, device="cuda", **adj_kw)
    adj64 = day_adjoint.make_day_adjoint(r64._bb, device="cuda", **adj_kw)
    NB, ZB = r32._bb.n_blocks, r32._bb.zones_per_block
    d_hist = np.random.default_rng(16).normal(size=(24, NB, ZB)) / (24 * 1000)
    cots = (torch.zeros_like(T), torch.zeros_like(zT), torch.as_tensor(d_hist, dtype=torch.float32, device="cuda"))
    T64, zT64 = r64.to_blocked(tm64.initial_state())
    hi64 = r64.kernel_inputs(testing.bench_inputs(tm64.building, 24, device="cuda"), interp_weather=True)[0]
    g32 = flat_grads(adj32(r32.params, T, zT, hi, cots))
    g64p = flat_grads(adj64.plain(r64.params, T64, zT64, hi64, tuple(c.double() for c in cots)))
    what = "glazed city f32 adjoint kernel vs f64 plain adjoint"
    cav_lanes = day_march.bit_rows(r32.params, "cav_bits").any(0)
    gaps = rel_l2_gaps(torch, g32, g64p, what, CAV_ADJ_F32_RL2)
    cgaps = rel_l2_gaps(torch, g32, g64p, what + ", cavity lanes", CAV_ADJ_F32_RL2, lanes=cav_lanes)
    del g64p
    adj_ms = event_ms(torch, lambda: adj32(r32.params, T, zT, hi, cots), 5)
    note_adjoint_variant(day_adjoint, "day_adjoint_cavity")
    t0 = time.time()
    g32p = flat_grads(adj32.plain(r32.params, T, zT, hi, cots))
    torch.cuda.synchronize()
    adj_plain_ms = (time.time() - t0) * 1e3
    adj_abs = max(float((g32[n] - r).abs().max()) for n, r in g32p.items())
    what = "glazed city f32 adjoint kernel vs f32 plain adjoint"
    gaps32 = rel_l2_gaps(torch, g32, g32p, what, CAV_ADJ_F32_RL2)
    cgaps32 = rel_l2_gaps(torch, g32, g32p, what + ", cavity lanes", CAV_ADJ_F32_RL2, lanes=cav_lanes)
    cav = day_march.bit_rows(r32.params, "cav_bits")
    check(float(g32["seg_u"][cav].abs().max()) == 0.0, "glazed city adjoint: seg_u cotangent on a cavity segment")
    del g32p
    worst = max(gaps, key=gaps.get)
    print(f"phase 16a glazed city on {smi}: 10,000 surfaces (1,000 argon double-glazed windows) x 48 h, "
          f"trbdf2_refresh k=2, {run_launches} cavity launches, f32 run {run48_s:.3f} s; f32 kernel vs f64 plain "
          f"twin max |d zone_T| {err48:.3e} K (<= {F32_TOL:g}); one bench-day launch {ms:.3f} ms vs plain twin "
          f"{plain_ms:.1f} ms (CUDA events; bench city {ctx.kernel_ms:.3f} ms), max |d| {err32:.3e} K; adjoint "
          f"{adj_ms:.3f} ms vs f32 plain adjoint {adj_plain_ms:.1f} ms (bench city {ctx.adj_ms:.3f} ms), f32 kernel "
          f"vs f64 plain adjoint relative L2 worst {gaps[worst]:.3e} ({worst}; <= {CAV_ADJ_F32_RL2:g}), seg_u "
          f"{gaps['seg_u']:.2e}, dT0 {gaps['dT0']:.2e}, on the cavity lanes alone {worst_of(cgaps)}; vs the f32 "
          f"plain adjoint {worst_of(gaps32)} (<= {CAV_ADJ_F32_RL2:g}), max |d| {adj_abs:.3e}, on the cavity lanes "
          f"{worst_of(cgaps32)}", flush=True)

    # The gradient paths on the glazed city: TR-BDF2 and parity, 2 days in 2
    # chunks each; the parity runner's first day-launch is then where both
    # parity cavity bodies are held against their f32 plain versions.
    counts = {}
    runners = {}
    for name, gw in (("trbdf2", {}), ("parity", dict(mode="parity", config_kw=dict(nomass_fixed_iters=PARITY_ITERS)))):
        run, fr, seq = grad_workload(torch, ThermalModel, SimConfig, testing, torch.float32, CAV_GRAD_DAYS, 2,
                                     build=testing.build_glazed_city, **gw)
        km.launches = km.cavity_launches = km.parity_cavity_launches = 0
        ka.launches = ka.cavity_launches = ka.parity_cavity_launches = 0
        t0 = time.time()
        v = run()
        torch.cuda.synchronize()
        counts[name] = dict(wall=time.time() - t0, value=v, march=(km.launches, km.cavity_launches,
                                                                    km.parity_cavity_launches),
                            adjoint=(ka.launches, ka.cavity_launches, ka.parity_cavity_launches))
        check(all(np.isfinite(v)) and v[1] != 0 and v[2] != 0, f"glazed city {name} value_and_grad: {v}")
        runners[name] = (fr, seq)
    n = CAV_GRAD_DAYS
    check(counts["trbdf2"]["march"] == (2 * n, 2 * n, 0) and counts["trbdf2"]["adjoint"] == (n, n, 0),
          f"glazed city gradient launches: {counts['trbdf2']}")
    check(counts["parity"]["march"] == (2 * n, 2 * n, 2 * n) and counts["parity"]["adjoint"] == (n, n, n),
          f"glazed city parity gradient launches: {counts['parity']}")

    fr, seq = runners["parity"]
    sub = fr._substeps
    Tp, zTp = fr.to_blocked(fr._tm.initial_state())
    hip = fr.kernel_inputs(tree_head(seq, CAV_GRAD_DAYS * 24, 24))[0]
    hm, params = fr.hour_march, fr.params
    check(hm.hours == 24 and sub == fr._tm.dt_subdivisions, f"the parity launch is {hm.hours} h x {sub}")
    # The day-launches are timed whole; the plain versions, which take minutes
    # a day here, are compared over the daytime window (daytime_window).
    p_ms = event_ms(torch, lambda: hm(params, Tp, zTp, hip), 3)
    note_variant(day_march, "day_march_parity_cavity")
    got24 = hm(params, Tp, zTp, hip)
    H, W0 = PARITY_PLAIN_HOURS, PARITY_WINDOW_START
    hm6 = day_march.hour_march_for(fr._bb, mode="parity", hours=H)
    Tw, zTw, hip6 = daytime_window(day_march, fr._bb, params, Tp, zTp, hip, sub)
    gotp = hm6(params, Tw, zTw, hip6)
    torch.cuda.synchronize()
    t0 = time.time()
    refp = hm6.plain(params, Tw, zTw, hip6)
    torch.cuda.synchronize()
    p_plain_ms = (time.time() - t0) * 1e3
    # The same hours on the f64 kernel, on the workload's scaled parameters
    # (seg_u x 1.2, front_alphas x 0.8) blocked directly, the same inputs and
    # the same start state: how much of each gap below is the f32 kernel's
    # round-off, and how much the f32 plain version's.
    b64 = ThermalModel(testing.build_glazed_city(1000, 10), n=1, device="cuda",
                       config=SimConfig(dtype=torch.float64, nomass_fixed_iters=PARITY_ITERS)).building
    sb64 = dataclasses.replace(b64.surfaces, seg_u=b64.surfaces.seg_u * 1.2,
                               front_alphas=b64.surfaces.front_alphas * 0.8)
    tmp64 = ThermalModel.from_building(dataclasses.replace(b64, surfaces=sb64), device="cuda")
    fr64 = tmp64.fast_runner(mode="parity", hours=24)
    check(fr64._substeps == sub, f"the f64 parity runner takes {fr64._substeps} sub-steps, not {sub}")
    seq64 = testing.bench_inputs(tmp64.building, CAV_GRAD_DAYS * 24, device="cuda")
    seq64 = seq64.replace(lum_power=torch.zeros_like(seq64.lum_power))  # as grad_workload's
    hid64 = fr64.kernel_inputs(tree_head(seq64, CAV_GRAD_DAYS * 24, 24))[0]
    hip64 = hour_window(hid64, W0, H, sub)
    got64 = day_march.hour_march_for(fr64._bb, mode="parity", hours=H)(fr64.params, Tw.double(), zTw.double(),
                                                                          hip64)
    # The f64 kernel's own state at W0 h, rounded to f32: where the f32
    # adjoints are held to the f64 one (see CAV_PARITY_ADJ_F32_RL2).
    lead64 = day_march.hour_march_for(fr64._bb, mode="parity", hours=W0)
    Ts, zTs = (x.float() for x in lead64(fr64.params, Tp.double(), zTp.double(), hour_window(hid64, 0, W0, sub))[:2])

    def outs(o):
        return (("T", o[0]), ("zT", o[1]), ("zt_hist", o[3]),
                *zip(("h_front", "h_back", "q_front", "q_back"), o[2]))

    def max_gaps(a, b):
        return {n: float((x.to(y.dtype) - y).abs().max()) for (n, x), (_, y) in zip(outs(a), outs(b))}

    fwd_gaps = max_gaps(gotp, refp)
    k64_gaps, p64_gaps = max_gaps(gotp, got64), max_gaps(refp, got64)
    del got64
    for name, err in fwd_gaps.items():
        tol = CAV_WINDOW_HQ_TOL if name[:2] in ("h_", "q_") else CAV_WINDOW_T_TOL
        check(err <= tol, f"glazed city parity f32 kernel vs plain twin, {name}: max |d| {err} > {tol}")
    for name in ("T", "zT", "zt_hist"):
        check(k64_gaps[name] <= CAV_WINDOW_T_TOL,
              f"glazed city parity f32 kernel vs f64 kernel, {name}: max |d| {k64_gaps[name]} > {CAV_WINDOW_T_TOL}")
    del refp
    growth = parity_sensitivity(torch, hm, params, Tp, zTp, hip)
    check(growth[0] <= PARITY_GROWTH_MAX, f"the glazed city's parity day carries a perturbation {growth[0]} x")
    NBp, ZBp = fr._bb.n_blocks, fr._bb.zones_per_block
    valid = torch.as_tensor(np.asarray(fr.layout.zone_table).reshape(NBp, ZBp) >= 0, device="cuda")
    cot24 = (torch.zeros_like(Tp), torch.zeros_like(zTp),
             (2.0 * (got24[3] - 21.0) * valid / (CAV_GRAD_DAYS * 24 * 1000)).contiguous())
    adjp24 = day_adjoint.make_day_adjoint(fr._bb, substeps=sub, mode="parity", hours=24, device="cuda")
    gp24 = flat_grads(adjp24(params, Tp, zTp, hip, cot24))
    pa_ms = event_ms(torch, lambda: adjp24(params, Tp, zTp, hip, cot24), 1)
    note_adjoint_variant(day_adjoint, "day_adjoint_parity_cavity")
    cotp = (cot24[0], cot24[1], cot24[2][W0:W0 + H].contiguous())
    adjp = day_adjoint.make_day_adjoint(fr._bb, substeps=sub, mode="parity", hours=H, device="cuda")
    gp = flat_grads(adjp(params, Tw, zTw, hip6, cotp))
    check(float(gp["front_alphas"].abs().max()) > 0, "glazed city parity adjoint: no front_alphas gradient "
          "over the daytime window")
    # The f32 plain adjoint re-run from the f32 forward kernel's hour starts,
    # the march the kernel differentiates (its one-hour launches end on its
    # window launch): from its own march's it takes the MIN_H floor of the
    # glazing's room face on other sub-steps (ROADMAP C1).
    starts = kernel_hour_starts(torch, day_march, fr._bb, hm6, params, Tw, zTw, hip6)
    t0 = time.time()
    gpp = flat_grads(adjp.plain(params, Tw, zTw, hip6, cotp, starts=starts))
    torch.cuda.synchronize()
    pa_plain_ms = (time.time() - t0) * 1e3
    what = "glazed city f32 parity adjoint kernel vs f32 plain adjoint from its hour starts"
    cav_lanes = day_march.bit_rows(params, "cav_bits").any(0)
    pgaps = rel_l2_gaps(torch, gp, gpp, what, CAV_WINDOW_ADJ_RL2)
    pgaps_cav = rel_l2_gaps(torch, gp, gpp, what + ", cavity lanes", CAV_WINDOW_ADJ_RL2, lanes=cav_lanes)
    pa_abs = max(float((gp[n] - r).abs().max()) for n, r in gpp.items())
    # The gradient path's two adjoint launches, each held against the f64
    # adjoint kernel from the same start state (see CAV_PARITY_ADJ_F32_RL2):
    # day 1 from the initial state (gp24 above), day 2 from the f32 forward
    # kernel's state at midnight, each with the loss's cotangent on its own
    # day's zone history.
    t_held = time.time()
    adjp64_24 = day_adjoint.make_day_adjoint(fr64._bb, substeps=sub, mode="parity", hours=24, device="cuda")

    def dbl(xs):
        return tuple(x.double() for x in xs)

    g64 = flat_grads(adjp64_24(fr64.params, Tp.double(), zTp.double(), hid64, dbl(cot24)))
    what = "glazed city f32 parity adjoint kernel vs f64 kernel, the gradient path's day 1"
    day_gaps = [rel_l2_gaps(torch, gp24, g64, what, CAV_PARITY_ADJ_F32_RL2),
                rel_l2_gaps(torch, gp24, g64, what + ", cavity lanes", CAV_PARITY_ADJ_F32_RL2, lanes=cav_lanes)]
    T24, zT24 = got24[0], got24[1]
    hip2 = fr.kernel_inputs(tree_rows(seq, CAV_GRAD_DAYS * 24, 24, 24))[0]
    hid64_2 = fr64.kernel_inputs(tree_rows(seq64, CAV_GRAD_DAYS * 24, 24, 24))[0]
    cot2 = (torch.zeros_like(Tp), torch.zeros_like(zTp),
            (2.0 * (hm(params, T24, zT24, hip2)[3] - 21.0) * valid / (CAV_GRAD_DAYS * 24 * 1000)).contiguous())
    g2 = flat_grads(adjp24(params, T24, zT24, hip2, cot2))
    g64 = flat_grads(adjp64_24(fr64.params, T24.double(), zT24.double(), hid64_2, dbl(cot2)))
    what = "glazed city f32 parity adjoint kernel vs f64 kernel, the gradient path's day 2"
    day_gaps += [rel_l2_gaps(torch, g2, g64, what, CAV_PARITY_ADJ_F32_RL2),
                 rel_l2_gaps(torch, g2, g64, what + ", cavity lanes", CAV_PARITY_ADJ_F32_RL2, lanes=cav_lanes)]
    # Printed: the daytime window's f32 adjoints against the f64 one from the
    # f32 kernel's state at W0 h and from the f64 kernel's state (rounded).
    adjp64 = day_adjoint.make_day_adjoint(fr64._bb, substeps=sub, mode="parity", hours=H, device="cuda")
    cot64 = dbl(cotp)
    # Held (ROADMAP C1): the window's f32 adjoint kernel against the f64 plain
    # adjoint re-run from the f32 forward kernel's hour starts.
    g64s = flat_grads(adjp64.plain(fr64.params, Tw.double(), zTw.double(), hip64, cot64, starts=starts))
    what = "glazed city f32 parity adjoint kernel over the window vs the f64 plain adjoint from its hour starts"
    c1_gaps = [rel_l2_gaps(torch, gp, g64s, what, CAV_PARITY_ADJ_F32_RL2),
               rel_l2_gaps(torch, gp, g64s, what + ", cavity lanes", CAV_PARITY_ADJ_F32_RL2, lanes=cav_lanes)]
    del g64s, starts
    win = {}
    for start, (T_, zT_), outs_ in (("f32", (Tw, zTw), (("kernel", gp), ("plain", gpp))),
                                    ("f64", (Ts, zTs), (("kernel", None),))):
        g64 = flat_grads(adjp64(fr64.params, T_.double(), zT_.double(), hip64, cot64))
        for who, x in outs_:
            x = x if x is not None else flat_grads(adjp(params, T_, zT_, hip6, cotp))
            win[start, who] = [rel_l2_gaps(torch, x, g64, "window", float("inf"), lanes=m) for m in (None, cav_lanes)]
    held_s = time.time() - t_held
    del g64, g2, fr64, tmp64, b64
    check(float(gp["seg_u"][day_march.bit_rows(params, "cav_bits")].abs().max()) == 0.0,
          "glazed city parity adjoint: seg_u cotangent on a cavity segment")
    del gpp
    torch.cuda.empty_cache()
    pworst = max(pgaps, key=pgaps.get)
    c_t, c_p = counts["trbdf2"], counts["parity"]
    print(f"phase 16b glazed city gradients, {n} days in 2 chunks (u_scale 1.2, alpha_scale 0.8): trbdf2_refresh k=2 "
          f"{c_t['wall']:.3f} s, day march (all, cavity, parity cavity) {c_t['march']}, adjoint {c_t['adjoint']}, "
          f"loss / dL/du / dL/dalpha " + " / ".join(f"{x:.6g}" for x in c_t["value"])
          + f"; parity {c_p['wall']:.3f} s, day march {c_p['march']}, adjoint {c_p['adjoint']}, "
          + " / ".join(f"{x:.6g}" for x in c_p["value"])
          + f"; its first day-launch (24 h x {sub} sub-steps), f32, {p_ms:.3f} ms, over hours {W0}-{W0 + H} against "
          f"the plain versions (both from the kernel's state at {W0} h): day march {p_plain_ms:.1f} ms (host clock, "
          f"the plain version's {H} h), max |d| "
          + ", ".join(f"{k} {v:.2e}" for k, v in fwd_gaps.items())
          + f" (<= {CAV_WINDOW_T_TOL:g} K, h/q <= {CAV_WINDOW_HQ_TOL:g}); against the f64 kernel from the same state, the "
          f"f32 kernel " + ", ".join(f"{k} {v:.2e}" for k, v in k64_gaps.items()) + f" (T, zT, zone history <= "
          f"{CAV_WINDOW_T_TOL:g} K), the f32 plain version "
          + ", ".join(f"{k} {v:.2e}" for k, v in p64_gaps.items())
          + f"; a start state moved by {PARITY_EPS:g} K ends the "
          f"day {growth[0]:.3g} x as far apart on the nodes (<= {PARITY_GROWTH_MAX:g}); adjoint {pa_ms:.3f} ms a "
          f"day, the plain adjoint's {H} h from the forward kernel's hour starts {pa_plain_ms:.1f} ms, relative L2 "
          f"worst {pgaps[pworst]:.3e} ({pworst}; <= {CAV_WINDOW_ADJ_RL2:g}), "
          f"max |d| {pa_abs:.3e}, on the cavity lanes alone {worst_of(pgaps_cav)}; the gradient path's adjoint "
          f"launches against the f64 kernel from the same start states (<= {CAV_PARITY_ADJ_F32_RL2:g}): day 1 "
          f"{worst_of(day_gaps[0])}, cavity lanes {worst_of(day_gaps[1])}; day 2 {worst_of(day_gaps[2])}, cavity "
          f"lanes {worst_of(day_gaps[3])}; over hours {W0}-{W0 + H} from the f32 kernel's state, the f32 adjoint kernel "
          f"against the f64 plain adjoint re-run from the f32 forward kernel's hour starts (<= "
          f"{CAV_PARITY_ADJ_F32_RL2:g}, ROADMAP C1) {worst_of(c1_gaps[0])}, cavity lanes {worst_of(c1_gaps[1])}; "
          f"over the same hours against the f64 kernel (not held; these comparisons with the gradient path's took "
          f"{held_s:.1f} s): "
          + "; ".join(f"from the {st} kernel's state, the f32 {who} adjoint {worst_of(v[0])}, cavity lanes "
                      f"{worst_of(v[1])}" for (st, who), v in win.items())
          + " (the f32 plain adjoint from the f32 forward kernel's hour starts)", flush=True)

    def bounds(p, hours, sub, builds, fwd_ops, adj_ops, T_, zT_, hi_, outs, cots_, grads):
        ops_f = fwd_ops + cavity_work(p, builds)
        bytes_f = nbytes(*param_tensors(p), T_, zT_, *hi_) + nbytes(
            outs[0], outs[1], *outs[2], *[o for o in outs[3:] if o is not None])
        ops_a = adj_ops + cavity_work(p, builds) + cavity_work(p, builds, adjoint=True)
        bytes_a = nbytes(*param_tensors(p), T_, zT_, *hi_, *cots_) + nbytes(*grads.values())
        return (ops_f, bytes_f) + bound(bytes_f, ops_f), (ops_a, bytes_a) + bound(bytes_a, ops_a)

    b_tr = bounds(r32.params, 24, 8, 24 * 8 // 2, day_work(r32.params, 24, 8, 2)[0],
                  adjoint_work(r32.params, 24, 8, 2), T, zT, hi, got, cots, g32)
    pb_builds = 24 * sub * (PARITY_ITERS + 1)
    b_pa = bounds(params, 24, sub, pb_builds, parity_day_work(params, 24, sub, PARITY_ITERS)[0],
                  parity_adjoint_work(params, 24, sub, PARITY_ITERS), Tp, zTp, hip, got24, cot24, gp24)
    return SimpleNamespace(
        run_launches=run_launches, counts=counts, ms=ms, plain_ms=plain_ms, err32=err32, err48=err48,
        adj_ms=adj_ms, adj_plain_ms=adj_plain_ms, adj_abs=adj_abs, adj_rel=gaps[worst], p_ms=p_ms,
        p_plain_ms=p_plain_ms, p_err=max(fwd_gaps.values()), pa_ms=pa_ms, pa_plain_ms=pa_plain_ms,
        pa_abs=pa_abs, pa_rel=pgaps[pworst], bounds=dict(march=b_tr[0], adjoint=b_tr[1], parity=b_pa[0],
                                                         parity_adjoint=b_pa[1]),
    )


def phase17_office(torch, ctx):
    """bench.py's office IDF workflow on the card (see the module
    docstring)."""
    import os
    import tempfile

    from heatx_torch.model.idf import load_idf
    from heatx_torch.weather.epw import read_epw

    testing, SimConfig, ThermalModel, smi = ctx.testing, ctx.SimConfig, ctx.ThermalModel, ctx.smi
    km = ctx.day_march.day_march_kernel
    with tempfile.TemporaryDirectory() as d:
        w = read_epw(testing.write_synthetic_epw(os.path.join(d, "santiago_synthetic.epw"), seed=0))
    t0 = time.time()
    loaded = load_idf(os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", "data", "office.idf"))
    tm32 = ThermalModel(loaded.model, n=1, config=SimConfig(dtype=torch.float32), device="cuda")
    b = tm32.building
    check(b.surfaces.has_cavity, "the office has no gas cavity")
    kw = dict(mode="trbdf2", substeps=8, hours=24, scheduled_setpoints="heat_sp" in loaded.hourly_channels(24))
    fr = tm32.fast_runner(**kw)
    seq, ground = testing.office_inputs(loaded, tm32, w, 8760)
    check(ground is not None, "the office has no ground face")
    setup_s = time.time() - t0
    st = tm32.initial_state()
    walls = []
    for _ in range(2):
        km.launches = km.cavity_launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        final, zt, loads = fr.run(st, seq, ground_hourly=ground, collect_loads=True)
        heat = float(loads.clamp(min=0).sum()) / 1000.0
        cool = float(-loads.clamp(max=0).sum()) / 1000.0
        walls.append(time.time() - t0)
    launches = (km.launches, km.cavity_launches)
    dispatches = len(fr.dispatch_starts)
    check(launches == (365, 365), f"office year: {launches} (all, cavity) day-march launches, expected 365")
    check(dispatches == 12, f"office year: {dispatches} dispatches, expected one per month")
    for name, v in (("zone_T", zt), ("loads", loads), ("node_T", final.node_T)):
        check(bool(torch.isfinite(v).all()), f"office year {name} has non-finite values")
    check(heat > 0 and cool > 0 and np.isfinite(heat + cool), f"office year: heating {heat}, cooling {cool} kWh")

    seq48, g48 = testing.office_inputs(loaded, tm32, w, 48)
    _, z32, l32 = fr.run(st, seq48, ground_hourly=g48, collect_loads=True)
    tm64 = ThermalModel(loaded.model, n=1, config=SimConfig(dtype=torch.float64), device="cuda")
    s64, g64 = testing.office_inputs(loaded, tm64, w, 48)
    _, z64, l64 = tm64.fast_runner(use_kernel=False, **kw).run(tm64.initial_state(), s64, ground_hourly=g64,
                                                              collect_loads=True)
    err_z = float((z32.double() - z64).abs().max())
    l_scale = float(l64.abs().max())
    err_l = float((l32.double() - l64).abs().max())
    check(err_z <= F32_TOL, f"office f32 kernel vs f64 twin zone_T: max |d| {err_z} > {F32_TOL}")
    check(l_scale > 0 and err_l <= LOAD_F32_RTOL * l_scale,
          f"office f32 kernel vs f64 twin loads: max |d| {err_l} W > {LOAD_F32_RTOL} x {l_scale} W")
    print(f"phase 17 office IDF workflow on {smi}: examples/data/office.idf ({b.n_zones} zones, {b.n_surfaces} "
          f"surfaces, {cavity_segments(fr.params)} gas cavities) on a synthetic Santiago EPW (seed 0), set-up "
          f"{setup_s:.2f} s; annual run (8760 h, trbdf2, 8 sub-steps, scheduled setpoints, monthly ground "
          f"temperatures, collect_loads, f32) {walls[0]:.3f} s and {walls[1]:.3f} s (host clock), {dispatches} "
          f"dispatches, {launches[0]} day-march launches ({launches[1]} with cavities); heating {heat:.1f} kWh, "
          f"cooling {cool:.1f} kWh; 48 h f32 kernel vs f64 plain twin: max |d zone_T| {err_z:.3e} K "
          f"(<= {F32_TOL:g}), max |d load| {err_l:.3e} W = {err_l / l_scale:.3e} of max |load| {l_scale:.1f} W "
          f"(<= {LOAD_F32_RTOL:g})", flush=True)
    return SimpleNamespace(launches=launches[1], walls=walls, heat=heat, cool=cool, dispatches=dispatches,
                           err_z=err_z, err_l=err_l)


def mrt_network_faces(params):
    """The network faces of a launch (0 without the MRT statics)."""
    return 0 if params.mrt is None else int(params.mrt_ptr[-1])


def mrt_work(params, evaluations, adjoint=False):
    """Operations of the MRT network over ``evaluations`` evaluations,
    counted from day_tr.cuh ``mrt_face_node``: MRT_OPS per network face and
    iteration, MRT_ITERS iterations each, MRT_ADJ_OPS more per face and
    iteration in an adjoint (day_tr_adj.cuh ``mrt_face_node_adj``)."""
    per = MRT_OPS + (MRT_ADJ_OPS if adjoint else 0)
    return mrt_network_faces(params) * MRT_ITERS * evaluations * per


def hour_window(hi, start, hours, sub):
    """Hours ``start`` to ``start + hours`` of a day-launch's hour inputs
    (weather rows by sub-step, the rest by hour)."""
    return tuple((x[start * sub:(start + hours) * sub] if i < 3 else x[start:start + hours]).contiguous()
                 for i, x in enumerate(hi))


def daytime_window(day_march, bb, params, T, zT, hi, sub):
    """The parity kernel's state at PARITY_WINDOW_START h of a day-launch from
    (T, zT) on the hour inputs ``hi``, and the inputs of the
    PARITY_PLAIN_HOURS after it: the window over which phases 16b and 19c
    hold the parity kernels against their plain versions, both sides started
    from that state."""
    s = PARITY_WINDOW_START
    lead = day_march.hour_march_for(bb, mode="parity", hours=s, scheduled_shade_sp=bb.shade is not None)
    Ts, zTs = lead(params, T, zT, hour_window(hi, 0, s, sub))[:2]
    return Ts, zTs, hour_window(hi, s, PARITY_PLAIN_HOURS, sub)


def mrt_rows(torch, day_march, bb, surf):
    """The Carroll network's rows [2, SP] of the blocked surface rows
    ``surf`` (day_march.mrt_eps_blocked, differentiable)."""
    f = day_march.SURF_FIELDS.index
    oh = [torch.as_tensor(o, dtype=surf.dtype, device=surf.device) for o in (bb.front_oh, bb.back_oh)]
    part = torch.as_tensor(bb.mrt_part, device=surf.device)
    return torch.stack(day_march.mrt_eps_blocked(surf[f("area")], surf[f("eps_front")], surf[f("eps_back")],
                                                 part, *oh, bb.n_blocks, bb.zones_per_block))


def office_model():
    from heatx_torch.model.idf import load_idf

    import os
    return load_idf(os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", "data",
                                 "office.idf")).model


def mrt_bounds(p, hours, evals, fwd_ops, adj_ops, T_, zT_, hi_, outs, cots_, grads, cav_builds=None):
    """((ops, bytes, bound_ms, bound_by) of the day march, the same of its
    adjoint) for one MRT day-launch: ``fwd_ops``/``adj_ops`` the launch's
    work without the network, ``evals`` the network's evaluations,
    ``cav_builds`` the cavity U's (default ``evals``)."""
    import torch

    cb = evals if cav_builds is None else cav_builds
    ops_f = fwd_ops + mrt_work(p, evals) + cavity_work(p, cb)
    bytes_f = nbytes(*param_tensors(p), T_, zT_, *hi_) + nbytes(
        outs[0], outs[1], *outs[2], *[o for o in outs[3:] if isinstance(o, torch.Tensor)])
    ops_a = (adj_ops + mrt_work(p, evals) + mrt_work(p, evals, adjoint=True) + cavity_work(p, cb)
             + cavity_work(p, cb, adjoint=True))
    bytes_a = nbytes(*param_tensors(p), T_, zT_, *hi_, *[c for c in cots_ if c is not None]) + nbytes(
        *grads.values())
    return (ops_f, bytes_f) + bound(bytes_f, ops_f), (ops_a, bytes_a) + bound(bytes_a, ops_a)


def phase18_mrt_f64(torch, ctx):
    """The MRT bodies against their plain versions, f64, on the two-zone
    building, the 4-zone city and the office (cavities and MRT); central
    differences of the forward kernels (see the module docstring).  Returns
    the worst gaps, the case count, how far the network moves the zones, and
    the launch counts by instantiation."""
    import dataclasses as dc

    day_march, day_adjoint, testing = ctx.day_march, ctx.day_adjoint, ctx.testing
    SimConfig, ThermalModel = ctx.SimConfig, ctx.ThermalModel
    km, ka = day_march.day_march_kernel, day_adjoint.day_adjoint_kernel
    rng = np.random.default_rng(18)
    worst = dict(T=0.0, adj=0.0, fd=0.0)
    models = {"two-zone building": testing.build_two_zone_model,
              "4-zone city": lambda: testing.build_city_model(4, 10), "office": office_model}
    bodies = (("trbdf2", None, None), ("trbdf2_refresh", 1, None), ("trbdf2_refresh", 2, None),
              ("parity", None, 1), ("parity", None, 2))
    cases, live = 0, 0.0
    for label, build in models.items():
        for mode, k, iters in bodies:
            if label == "office" and (k == 1 or iters == 1):
                continue
            what = f"MRT, {label}, {mode} k={k} iters={iters}"
            parity = mode == "parity"
            cfg = (testing.coarse_config(torch.float64, iters, interior_mrt=True) if parity
                   else SimConfig(dtype=torch.float64, interior_mrt=True))
            tm = ThermalModel(build(), config=cfg, device="cuda")
            hours = 2 if parity else 3
            r = tm.fast_runner(mode=mode, hours=hours, substeps=None if parity else 8, refresh_every=k,
                               collect_operative=True, collect_fluxes=True)
            sub, bb = r._substeps, r._bb
            seq = testing.bench_inputs(tm.building, hours, device="cuda")
            sun = rng.uniform(50.0, 400.0, (hours, tm.building.n_surfaces))
            seq = seq.replace(sol_front=torch.as_tensor(sun, device="cuda"))
            hi = r.kernel_inputs(seq, interp_weather=True)[0]
            T0, zT0 = r.to_blocked(tm.initial_state())
            mask = day_march.bit_rows(r.params, "node_bits")
            NB, ZB = r.params.n_blocks, r.params.zones_per_block

            def rand(shape, scale=1.0):
                return torch.as_tensor(rng.normal(size=tuple(shape)) * scale, device="cuda")

            T0 = T0 + rand(T0.shape, 4.0) * mask
            zT0 = zT0 + rand(zT0.shape, 0.5)
            hm, params = r.hour_march, r.params
            before = (km.mrt_launches, km.cavity_launches)
            got = hm(params, T0, zT0, hi)
            check((km.mrt_launches, km.cavity_launches) == (before[0] + 1, before[1] + int(params.cav is not None)),
                  f"{what}: the launch did not count as an MRT launch")
            ref = hm.plain(params, T0, zT0, hi)
            outs = (("T", got[0], ref[0]), ("zT", got[1], ref[1]), ("zt_hist", got[3], ref[3]),
                    *((f"hq{j}", got[2][j], ref[2][j]) for j in range(4)),
                    *((f"hq_hist{j}", got[4][j], ref[4][j]) for j in range(4)), ("top", got[6], ref[6]))
            for name, a, b in outs:
                err = float((a - b).abs().max())
                check(err <= F64_TOL, f"{what} {name}: max |d| {err} > {F64_TOL}")
                worst["T"] = max(worst["T"], err)
            check(float(got[5].sum()) == 0.0, f"{what}: non-finite state in the kernel")
            off = copy.copy(hm)
            off.config = hm.config.replace(interior_mrt=False)
            live = max(live, float((off(params, T0, zT0, hi)[1] - got[1]).abs().max()))
            cots = [rand(T0.shape) * mask, rand((NB, ZB)), rand((hours, NB, ZB))]
            adj = day_adjoint.make_day_adjoint(bb, substeps=sub, mode=mode, hours=hours, refresh_every=k,
                                               device="cuda")
            n_adj = ka.mrt_launches
            g, w = adjoint_vs_plain(torch, adj, params, T0, zT0, hi, cots, what)
            check(ka.mrt_launches == n_adj + 1, f"{what}: the adjoint did not count as an MRT launch")
            worst["adj"] = max(worst["adj"], w)
            cases += 1

            def loss(p, T):
                out = hm(p, T, zT0, hi)
                return float((out[0] * cots[0]).sum() + (out[1] * cots[1]).sum() + (out[3] * cots[2]).sum())

            row = day_march.SURF_FIELDS.index
            lanes = torch.as_tensor(np.asarray(bb.layout.surf_perm) >= 0, device="cuda")

            def chained(name):
                """Move a surface row and the network rows it builds."""
                D = rand((params.surf.shape[1],)) * params.surf[row(name)] * lanes

                def at(e):
                    surf = params.surf.clone()
                    surf[row(name)] += e * D
                    return dc.replace(params, surf=surf, mrt=mrt_rows(torch, day_march, bb, surf))

                def rows_of(x):
                    surf = params.surf.clone()
                    surf[row(name)] = x
                    return mrt_rows(torch, day_march, bb, surf)

                _, dm = torch.func.jvp(rows_of, (params.surf[row(name)],), (D,))
                an = float((g[name] * D).sum() + (g["mrt_eps_f"] * dm[0]).sum() + (g["mrt_eps_b"] * dm[1]).sum())
                return an, (lambda e: loss(at(e), T0))

            D_T = rand(T0.shape) * mask
            D_m = rand((params.surf.shape[1],)) * params.mrt[1]

            def moved_mrt(e):
                mrt = params.mrt.clone()
                mrt[1] += e * D_m
                return dc.replace(params, mrt=mrt)

            eps = 1e-6
            checks = [("T0", float((g["dT0"] * D_T).sum()), lambda e: loss(params, T0 + e * D_T)),
                      ("mrt_eps_b", float((g["mrt_eps_b"] * D_m).sum()), lambda e: loss(moved_mrt(e), T0))]
            checks += [(n, *chained(n)) for n in ("eps_back", "area")]
            for name, an, f in checks:
                fd = (f(eps) - f(-eps)) / (2 * eps)
                rel = abs(fd - an) / max(abs(an), 1e-300)
                check(an != 0 and rel <= FD_RTOL, f"{what} d/d{name}: FD {fd} vs adjoint {an} (rel {rel})")
                worst["fd"] = max(worst["fd"], rel)
    # The histories without MRT physics: the operative temperature as an
    # observable alone (the network's statics, no physics), and the h/q
    # history alone on a building without them (zero network rows).
    for label, build, kw in (("two-zone building, operative only", testing.build_two_zone_model,
                              dict(collect_operative=True, collect_fluxes=True)),
                             ("4-zone city, h/q only", lambda: testing.build_city_model(4, 10),
                              dict(collect_fluxes=True))):
        tm = ThermalModel(build(), config=SimConfig(dtype=torch.float64), device="cuda")
        r = tm.fast_runner(mode="trbdf2_refresh", hours=3, substeps=8, refresh_every=2, **kw)
        hi = r.kernel_inputs(testing.bench_inputs(tm.building, 3, device="cuda"), interp_weather=True)[0]
        T0, zT0 = r.to_blocked(tm.initial_state())
        before = km.mrt_launches
        got = r.hour_march(r.params, T0, zT0, hi)
        check(km.mrt_launches == before + 1, f"{label}: not an MRT-instantiation launch")
        ref = r.hour_march.plain(r.params, T0, zT0, hi)
        flat = lambda o: [x for v in o for x in (v if isinstance(v, tuple) else (v,))]  # noqa: E731
        for j, (a, b) in enumerate(zip(flat(got), flat(ref))):
            err = float((a - b).abs().max())
            check(err <= F64_TOL, f"{label} output {j}: max |d| {err} > {F64_TOL}")
            worst["T"] = max(worst["T"], err)
        cases += 1
    check(live > 1e-3, f"the MRT network moved no zone ({live} K)")
    return worst, cases, live


def phase19_mrt_city(torch, ctx):
    """The MRT bench city at full width, f32 (see the module docstring)."""
    day_march, day_adjoint, testing = ctx.day_march, ctx.day_adjoint, ctx.testing
    SimConfig, ThermalModel, smi = ctx.SimConfig, ctx.ThermalModel, ctx.smi
    km, ka = day_march.day_march_kernel, day_adjoint.day_adjoint_kernel
    model = testing.build_city_model(1000, 10)
    kw = dict(mode="trbdf2_refresh", substeps=8, hours=24, refresh_every=2)
    tm32 = ThermalModel(model, n=1, config=SimConfig(dtype=torch.float32, interior_mrt=True), device="cuda")
    r32 = tm32.fast_runner(collect_operative=True, **kw)
    faces = mrt_network_faces(r32.params)
    check(faces == 10000, f"the MRT city has {faces} network faces, not 10,000")
    st0 = tm32.initial_state()

    # (a) 48 h: the f32 kernel against the f64 plain version, zone and operative T
    km.launches = km.mrt_launches = 0
    t0 = time.time()
    fin32, z32, op32 = r32.run(st0, testing.bench_inputs(tm32.building, 48, device="cuda"), interp_weather=True,
                               collect_operative=True)
    torch.cuda.synchronize()
    run48_s = time.time() - t0
    run48_launches = km.mrt_launches
    check((km.launches, run48_launches) == (2, 2), f"MRT city 48 h: {km.launches} launches, {run48_launches} MRT")
    tm64 = ThermalModel(model, n=1, config=SimConfig(dtype=torch.float64, interior_mrt=True), device="cuda")
    t0 = time.time()
    _, z64, op64 = tm64.fast_runner(use_kernel=False, collect_operative=True, **kw).run(
        tm64.initial_state(), testing.bench_inputs(tm64.building, 48, device="cuda"), interp_weather=True,
        collect_operative=True)
    torch.cuda.synchronize()
    plain48_s = time.time() - t0
    for name, v in (("zone_T", z32), ("operative", op32), ("node_T", fin32.node_T), ("zone_T f64", z64)):
        check(bool(torch.isfinite(v).all()), f"MRT city {name} has non-finite values")
    err_z = float((z32.double() - z64).abs().max())
    err_op = float((op32.double() - op64).abs().max())
    check(err_z <= MRT_F32_TOL and err_op <= MRT_F32_TOL,
          f"MRT city f32 kernel vs f64 plain: zone_T {err_z}, operative {err_op} > {MRT_F32_TOL}")
    moved = float((z32 - ctx.z32_trbdf2).abs().max())

    # (b) one bench day: the TR-BDF2 MRT launch and its adjoint, timed, against their f32 plain versions
    T, zT = r32.to_blocked(st0)
    hi = r32.kernel_inputs(testing.bench_inputs(tm32.building, 24, device="cuda"), interp_weather=True)[0]
    hm0 = r32.hour_march.without_observables()
    ms = event_ms(torch, lambda: hm0(r32.params, T, zT, hi), 10)
    ms_op = event_ms(torch, lambda: r32.hour_march(r32.params, T, zT, hi), 10)
    t0 = time.time()
    ref = hm0.plain(r32.params, T, zT, hi)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    got = hm0(r32.params, T, zT, hi)
    err32 = max(float((got[i] - ref[i]).abs().max()) for i in (0, 1, 3))
    # The TR-BDF2 kernel's partitioned solve rounds otherwise than the plain
    # version's Thomas sweeps, so in f32 the two part by both their round-off
    # (the f32 plain version is itself farther from f64 on the node columns
    # of this day than the kernel; both printed): the day is held to f64.
    r64 = tm64.fast_runner(**kw)
    T64, zT64 = r64.to_blocked(tm64.initial_state())
    hi64 = r64.kernel_inputs(testing.bench_inputs(tm64.building, 24, device="cuda"), interp_weather=True)[0]
    ref64 = r64.hour_march.without_observables().plain(r64.params, T64, zT64, hi64)
    err64 = max(float((got[i].double() - ref64[i]).abs().max()) for i in (0, 1, 3))
    plain64 = max(float((ref[i].double() - ref64[i]).abs().max()) for i in (0, 1, 3))
    check(err64 <= MRT_F32_TOL, f"MRT city f32 day kernel vs f64 plain: max |d| {err64} > {MRT_F32_TOL}")
    adj32 = day_adjoint.make_day_adjoint(r32._bb, device="cuda", substeps=8, mode="trbdf2_refresh", hours=24,
                                         refresh_every=2)
    NB, ZB = r32._bb.n_blocks, r32._bb.zones_per_block
    d_hist = np.random.default_rng(19).normal(size=(24, NB, ZB)) / (24 * 1000)
    cots = (torch.zeros_like(T), torch.zeros_like(zT), torch.as_tensor(d_hist, dtype=torch.float32, device="cuda"))
    g32 = flat_grads(adj32(r32.params, T, zT, hi, cots))
    adj_ms = event_ms(torch, lambda: adj32(r32.params, T, zT, hi, cots), 5)
    note_adjoint_variant(day_adjoint, "day_adjoint_mrt")
    t0 = time.time()
    g32p = flat_grads(adj32.plain(r32.params, T, zT, hi, cots))
    torch.cuda.synchronize()
    adj_plain_ms = (time.time() - t0) * 1e3
    gaps = rel_l2_gaps(torch, g32, g32p, "MRT city f32 adjoint kernel vs f32 plain adjoint", MRT_ADJ_F32_RL2)
    adj_abs = max(float((g32[n] - r).abs().max()) for n, r in g32p.items())
    del g32p
    print(f"phase 19a MRT city on {smi}: 10,000 surfaces, 10,000 network faces in 1,000 zones, trbdf2_refresh "
          f"k=2, 48 h: {run48_launches} MRT launches, f32 run {run48_s:.3f} s (f64 plain {plain48_s:.1f} s); "
          f"f32 kernel vs f64 plain max |d zone_T| {err_z:.3e} K, operative {err_op:.3e} K (<= {MRT_F32_TOL:g}); "
          f"the network moves the zones up to {moved:.3e} K against the air bath (phase 4); operative T range "
          f"[{float(op32.min()):.2f}, {float(op32.max()):.2f}] C; one bench-day launch {ms:.3f} ms, with the "
          f"operative history {ms_op:.3f} ms (CUDA events; air bath {ctx.kernel_ms:.3f} ms) vs f32 plain "
          f"{plain_ms:.1f} ms, max |d| {err32:.3e} K, against the f64 plain version {err64:.3e} K "
          f"(<= {MRT_F32_TOL:g}; the f32 plain version {plain64:.3e} K); adjoint {adj_ms:.3f} ms (air bath {ctx.adj_ms:.3f} ms) vs "
          f"f32 plain {adj_plain_ms:.1f} ms, relative L2 worst {worst_of(gaps)} (<= {MRT_ADJ_F32_RL2:g}), "
          f"d mrt_eps_b {gaps['mrt_eps_b']:.2e}, max |d| {adj_abs:.3e}", flush=True)

    # (c) the annual run with the operative history; (d) 30 days of fluxes and the memory they hold
    inputs_year = testing.bench_inputs(tm32.building, 8760, device="cuda")
    km.launches = km.mrt_launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    _, zy, opy = r32.run(st0, inputs_year, interp_weather=True, collect_operative=True)
    torch.cuda.synchronize()
    year_s = time.time() - t0
    year_launches = (km.launches, km.mrt_launches)
    check(year_launches == (365, 365), f"MRT city year: {year_launches} launches, expected 365 MRT launches")
    check(bool(torch.isfinite(opy).all()) and tuple(opy.shape) == (8760, 1000), "annual operative history")
    del inputs_year, zy, opy
    rf = tm32.fast_runner(collect_fluxes=True, **kw)
    inputs30 = testing.bench_inputs(tm32.building, 720, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    t0 = time.time()
    _, _, flux = rf.run(st0, inputs30, interp_weather=True, collect_fluxes=True)
    torch.cuda.synchronize()
    flux_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated() - base_mem
    held = sum(v.numel() * v.element_size() for v in flux.values())
    check(all(bool(torch.isfinite(v).all()) and tuple(v.shape) == (720, 10000) for v in flux.values()),
          "30-day flux history")
    del flux, inputs30

    # (e) value_and_grad over 2 days with d/d eps_back, f32 against f64, launch counts
    gw = dict(config_kw=dict(interior_mrt=True), eps_scale=0.9)
    run32, _, _ = grad_workload(torch, ThermalModel, SimConfig, testing, torch.float32, 2, 2, **gw)
    km.launches = km.mrt_launches = ka.launches = ka.mrt_launches = 0
    t0 = time.time()
    v32 = run32()
    torch.cuda.synchronize()
    grad_s = time.time() - t0
    grad_counts = (km.launches, km.mrt_launches, ka.launches, ka.mrt_launches)
    check(grad_counts == (4, 4, 2, 2), f"MRT city 2-day value_and_grad launches: {grad_counts}")
    run64, _, _ = grad_workload(torch, ThermalModel, SimConfig, testing, torch.float64, 2, 2, **gw)
    v64 = run64()
    for name, a, b in zip(("loss", "dL/du", "dL/dalpha", "dL/deps_back"), v32, v64):
        check(np.isfinite(a) and np.isfinite(b) and b != 0, f"MRT city 2-day {name}: {a}, {b}")
        check(abs(a - b) <= GRAD_F32_RTOL * abs(b), f"MRT city 2-day {name}: f32 {a} vs f64 {b}")
    print(f"phase 19b on {smi}: annual run with the operative history (8760 h, f32) {year_s:.3f} s (host clock), "
          f"{year_launches[1]} MRT launches; 30 days with the h/q history {flux_s:.3f} s, the history holds "
          f"{held / 1e6:.1f} MB, peak device memory of the run {peak / 1e6:.1f} MB above its start; 2-day "
          f"value_and_grad (u_scale 1.2, alpha_scale 0.8, eps_scale 0.9 on eps_back) {grad_s:.3f} s f32, launches "
          f"(march, MRT, adjoint, MRT) {grad_counts}; loss / dL/du / dL/dalpha / dL/deps f32 "
          + " / ".join(f"{x:.6g}" for x in v32) + " vs f64 " + " / ".join(f"{x:.6g}" for x in v64)
          + f" (relative <= {GRAD_F32_RTOL:g})", flush=True)

    # (f) parity: the gradient workload in parity mode over 2 days (launch
    # counts), then both MRT parity kernels against their f32 plain versions
    # over the daytime window (daytime_window) at the stability sub-step
    # count, on that workload's first-day operands (seg_u x 1.2, as phase
    # 14b); one day-launch of each timed
    gwp = dict(mode="parity", config_kw=dict(interior_mrt=True, nomass_fixed_iters=PARITY_ITERS), eps_scale=0.9)
    runp, fp, seqp = grad_workload(torch, ThermalModel, SimConfig, testing, torch.float32, 2, 2, **gwp)
    km.launches = km.parity_mrt_launches = ka.launches = ka.parity_mrt_launches = 0
    t0 = time.time()
    vp = runp()
    torch.cuda.synchronize()
    pgrad_s = time.time() - t0
    pgrad_counts = (km.launches, km.parity_mrt_launches, ka.launches, ka.parity_mrt_launches)
    check(pgrad_counts == (4, 4, 2, 2), f"MRT city parity 2-day value_and_grad launches: {pgrad_counts}")
    check(all(np.isfinite(vp)) and all(x != 0 for x in vp[1:]), f"MRT city parity value_and_grad: {vp}")
    sub = fp._substeps
    Tp, zTp = fp.to_blocked(fp._tm.initial_state())
    hip = fp.kernel_inputs(tree_head(seqp, 48, 24))[0]
    p_ms = event_ms(torch, lambda: fp.hour_march(fp.params, Tp, zTp, hip), 3)
    note_variant(day_march, "day_march_parity_mrt")
    H, W0 = PARITY_PLAIN_HOURS, PARITY_WINDOW_START
    hm6 = day_march.hour_march_for(fp._bb, mode="parity", hours=H)
    Tw, zTw, hi6 = daytime_window(day_march, fp._bb, fp.params, Tp, zTp, hip, sub)
    gotp = hm6(fp.params, Tw, zTw, hi6)
    torch.cuda.synchronize()
    t0 = time.time()
    refp = hm6.plain(fp.params, Tw, zTw, hi6)
    torch.cuda.synchronize()
    p_plain_ms = (time.time() - t0) * 1e3
    fwd_gaps = {name: float((a - b_).abs().max()) for name, a, b_ in (
        ("T", gotp[0], refp[0]), ("zT", gotp[1], refp[1]), ("zt_hist", gotp[3], refp[3]),
        *((nm, gotp[2][j], refp[2][j]) for j, nm in enumerate(("h_front", "h_back", "q_front", "q_back"))))}
    for name, err in fwd_gaps.items():
        tol = PARITY_HQ_TOL if name[:2] in ("h_", "q_") else PARITY_DAY_TOL
        check(err <= tol, f"MRT city parity f32 kernel vs plain, {name}: max |d| {err} > {tol}")
    del refp
    NBp, ZBp = fp._bb.n_blocks, fp._bb.zones_per_block
    valid = torch.as_tensor(np.asarray(fp.layout.zone_table).reshape(NBp, ZBp) >= 0, device="cuda")
    adj24 = day_adjoint.make_day_adjoint(fp._bb, substeps=sub, mode="parity", hours=24, device="cuda")
    got24 = fp.hour_march(fp.params, Tp, zTp, hip)
    cot24 = (torch.zeros_like(Tp), torch.zeros_like(zTp),
             (2.0 * (got24[3] - 21.0) * valid / (2 * 24 * 1000)).contiguous())
    pa_ms = event_ms(torch, lambda: adj24(fp.params, Tp, zTp, hip, cot24), 1)
    note_adjoint_variant(day_adjoint, "day_adjoint_parity_mrt")
    gp24 = flat_grads(adj24(fp.params, Tp, zTp, hip, cot24))
    adj6 = day_adjoint.make_day_adjoint(fp._bb, substeps=sub, mode="parity", hours=H, device="cuda")
    cot6 = (torch.zeros_like(Tp), torch.zeros_like(zTp), cot24[2][W0:W0 + H].contiguous())
    gp = flat_grads(adj6(fp.params, Tw, zTw, hi6, cot6))
    check(float(gp["front_alphas"].abs().max()) > 0 and float(gp["mrt_eps_b"].abs().max()) > 0,
          "MRT city parity adjoint: no front_alphas or mrt_eps_b gradient over the daytime window")
    starts = kernel_hour_starts(torch, day_march, fp._bb, hm6, fp.params, Tw, zTw, hi6)
    t0 = time.time()
    gpp = flat_grads(adj6.plain(fp.params, Tw, zTw, hi6, cot6, starts=starts))
    torch.cuda.synchronize()
    pa_plain_ms = (time.time() - t0) * 1e3
    pgaps = rel_l2_gaps(torch, gp, gpp, "MRT city f32 parity adjoint kernel vs f32 plain from its hour starts",
                        PARITY_ADJ_F32_RL2)
    pa_abs = max(float((gp[n] - r).abs().max()) for n, r in gpp.items())
    del gpp
    print(f"phase 19c MRT city in parity mode ({sub} sub-steps/h, nomass_fixed_iters={PARITY_ITERS}): 2-day "
          f"value_and_grad {pgrad_s:.3f} s, launches (march, parity MRT, adjoint, parity MRT) {pgrad_counts}, "
          f"loss / dL/du / dL/dalpha / dL/deps " + " / ".join(f"{x:.6g}" for x in vp)
          + f"; on its first day (seg_u x 1.2, front_alphas x 0.8, eps_back x 0.9): one day-launch {p_ms:.3f} ms (bench city {ctx.parity_ms:.3f} ms), adjoint "
          f"{pa_ms:.3f} ms (CUDA events); over hours {W0}-{W0 + H} x {sub} sub-steps, both from the kernel's state "
          f"at {W0} h, against the f32 plain versions: day march "
          f"max |d| " + ", ".join(f"{k} {v:.2e}" for k, v in fwd_gaps.items())
          + f" (<= {PARITY_DAY_TOL:g} K, h/q <= {PARITY_HQ_TOL:g}), plain {p_plain_ms:.1f} ms; adjoint relative "
          f"L2 worst {worst_of(pgaps)} (<= {PARITY_ADJ_F32_RL2:g}), max |d| {pa_abs:.3e}, plain {pa_plain_ms:.1f} ms",
          flush=True)

    b_tr = mrt_bounds(r32.params, 24, 24 * 8 // 2, day_work(r32.params, 24, 8, 2)[0], adjoint_work(r32.params, 24, 8, 2),
                  T, zT, hi, got, cots, g32)
    b_pa = mrt_bounds(fp.params, 24, 24 * sub, parity_day_work(fp.params, 24, sub, PARITY_ITERS)[0],
                  parity_adjoint_work(fp.params, 24, sub, PARITY_ITERS), Tp, zTp, hip, got24, cot24, gp24)
    return SimpleNamespace(
        ms=ms, ms_op=ms_op, plain_ms=plain_ms, err32=err32, err_z=err_z, err_op=err_op, adj_ms=adj_ms,
        adj_plain_ms=adj_plain_ms, adj_abs=adj_abs, adj_rel=max(gaps.values()), year_s=year_s,
        year_launches=year_launches[1], grad_counts=grad_counts, pgrad_counts=pgrad_counts, p_ms=p_ms,
        p_plain_ms=p_plain_ms,
        p_err=max(fwd_gaps.values()), pa_ms=pa_ms, pa_plain_ms=pa_plain_ms, pa_abs=pa_abs,
        pa_rel=max(pgaps.values()), peak=peak, held=held,
        bounds=dict(march=b_tr[0], adjoint=b_tr[1], parity=b_pa[0], parity_adjoint=b_pa[1]),
    )


def phase20_office_mrt(torch, ctx, p17):
    """The office IDF workflow with interior MRT (see the module docstring)."""
    import os
    import tempfile

    from heatx_torch.model.idf import load_idf
    from heatx_torch.weather.epw import read_epw

    testing, SimConfig, ThermalModel, smi = ctx.testing, ctx.SimConfig, ctx.ThermalModel, ctx.smi
    day_march, day_adjoint = ctx.day_march, ctx.day_adjoint
    km, ka = day_march.day_march_kernel, day_adjoint.day_adjoint_kernel
    with tempfile.TemporaryDirectory() as d:
        w = read_epw(testing.write_synthetic_epw(os.path.join(d, "santiago_synthetic.epw"), seed=0))
    loaded = load_idf(os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", "data", "office.idf"))
    tm32 = ThermalModel(loaded.model, n=1, config=SimConfig(dtype=torch.float32, interior_mrt=True), device="cuda")
    kw = dict(mode="trbdf2", substeps=8, hours=24, scheduled_setpoints="heat_sp" in loaded.hourly_channels(24))
    fr = tm32.fast_runner(collect_operative=True, **kw)
    faces = mrt_network_faces(fr.params)
    seq, ground = testing.office_inputs(loaded, tm32, w, 8760)
    st = tm32.initial_state()
    km.launches = km.cavity_launches = km.mrt_launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    final, zt, loads, op = fr.run(st, seq, ground_hourly=ground, collect_loads=True, collect_operative=True)
    heat = float(loads.clamp(min=0).sum()) / 1000.0
    cool = float(-loads.clamp(max=0).sum()) / 1000.0
    wall = time.time() - t0
    launches = (km.launches, km.cavity_launches, km.mrt_launches)
    check(launches == (365, 365, 365), f"office MRT year: {launches} (all, cavity, MRT) launches, expected 365")
    for name, v in (("zone_T", zt), ("loads", loads), ("operative", op), ("node_T", final.node_T)):
        check(bool(torch.isfinite(v).all()), f"office MRT year {name} has non-finite values")
    check(heat > 0 and cool > 0, f"office MRT year: heating {heat}, cooling {cool} kWh")
    seq48, g48 = testing.office_inputs(loaded, tm32, w, 48)
    _, z32, l32, o32 = fr.run(st, seq48, ground_hourly=g48, collect_loads=True, collect_operative=True)
    tm64 = ThermalModel(loaded.model, n=1, config=SimConfig(dtype=torch.float64, interior_mrt=True), device="cuda")
    s64, g64 = testing.office_inputs(loaded, tm64, w, 48)
    _, z64, l64, o64 = tm64.fast_runner(use_kernel=False, collect_operative=True, **kw).run(
        tm64.initial_state(), s64, ground_hourly=g64, collect_loads=True, collect_operative=True)
    err_z = float((z32.double() - z64).abs().max())
    err_o = float((o32.double() - o64).abs().max())
    l_scale = float(l64.abs().max())
    err_l = float((l32.double() - l64).abs().max())
    check(err_z <= F32_TOL and err_o <= F32_TOL, f"office MRT f32 vs f64: zone_T {err_z}, operative {err_o}")
    check(err_l <= LOAD_F32_RTOL * l_scale, f"office MRT f32 vs f64 loads: {err_l} W of {l_scale} W")

    # One day-launch of each cavity-and-MRT instantiation, timed, against its
    # f32 plain version (the gradient bodies and parity at the coarse
    # discretization's sub-steps), and the office's 2-day value_and_grad
    # through the TR-BDF2 adjoint.
    T, zT = fr.to_blocked(st)
    hi = fr.kernel_inputs(seq48)[0]
    hm0 = fr.hour_march.without_observables()
    ms = event_ms(torch, lambda: hm0(fr.params, T, zT, hi), 10)
    t0 = time.time()
    ref = hm0.plain(fr.params, T, zT, hi)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    got = hm0(fr.params, T, zT, hi)
    err32 = max(float((got[i] - ref[i]).abs().max()) for i in (0, 1, 3))
    check(err32 <= F32_TOL, f"office MRT day kernel vs f32 plain: {err32}")
    NB, ZB = fr._bb.n_blocks, fr._bb.zones_per_block
    adj = day_adjoint.make_day_adjoint(fr._bb, substeps=8, mode="trbdf2", hours=24, device="cuda",
                                       scheduled_setpoints=kw["scheduled_setpoints"])
    check(adj._hm.substeps == 8 and adj._hm.refresh_every == 8, "the office adjoint is not the run's body")
    cots = (torch.zeros_like(T), torch.zeros_like(zT),
            torch.as_tensor(np.random.default_rng(20).normal(size=(24, NB, ZB)) / 24, dtype=torch.float32,
                            device="cuda"),
            torch.as_tensor(np.random.default_rng(21).normal(size=(24, NB, ZB)) / 2.4e4, dtype=torch.float32,
                            device="cuda"))
    ka.launches = ka.mrt_launches = ka.cavity_launches = 0
    g32 = flat_grads(adj(fr.params, T, zT, hi, cots))
    adj_counts = (ka.launches, ka.cavity_launches, ka.mrt_launches)
    check(adj_counts == (1, 1, 1), f"office MRT adjoint launch counts {adj_counts}")
    adj_ms = event_ms(torch, lambda: adj(fr.params, T, zT, hi, cots), 5)
    note_adjoint_variant(day_adjoint, "day_adjoint_cavity_mrt")
    t0 = time.time()
    g32p = flat_grads(adj.plain(fr.params, T, zT, hi, cots))
    torch.cuda.synchronize()
    adj_plain_ms = (time.time() - t0) * 1e3
    gaps = rel_l2_gaps(torch, g32, g32p, "office MRT f32 adjoint kernel vs f32 plain", MRT_ADJ_F32_RL2)
    adj_abs = max(float((g32[n] - r).abs().max()) for n, r in g32p.items())
    tmc = ThermalModel(loaded.model, n=1, device="cuda",
                       config=testing.coarse_config(torch.float32, PARITY_ITERS, interior_mrt=True))
    fpc = tmc.fast_runner(mode="parity", hours=24, scheduled_setpoints=kw["scheduled_setpoints"])
    subc = fpc._substeps
    seqc, _ = testing.office_inputs(loaded, tmc, w, 24)
    Tc, zTc = fpc.to_blocked(tmc.initial_state())
    hic = fpc.kernel_inputs(seqc)[0]
    km.launches = km.parity_mrt_launches = km.cavity_launches = 0
    gotc = fpc.hour_march(fpc.params, Tc, zTc, hic)
    pc_counts = (km.launches, km.cavity_launches, km.parity_mrt_launches)
    check(pc_counts == (1, 1, 1), f"office MRT parity launch counts {pc_counts}")
    pc_ms = event_ms(torch, lambda: fpc.hour_march(fpc.params, Tc, zTc, hic), 5)
    note_variant(day_march, "day_march_parity_cavity_mrt")
    t0 = time.time()
    refc = fpc.hour_march.plain(fpc.params, Tc, zTc, hic)
    torch.cuda.synchronize()
    pc_plain_ms = (time.time() - t0) * 1e3
    pc_err = max(float((gotc[i] - refc[i]).abs().max()) for i in (0, 1, 3))
    check(pc_err <= F32_TOL, f"office MRT parity day kernel vs f32 plain: {pc_err}")
    adjc = day_adjoint.make_day_adjoint(fpc._bb, substeps=subc, mode="parity", hours=24, device="cuda",
                                        scheduled_setpoints=kw["scheduled_setpoints"])
    cotsc = (torch.zeros_like(Tc), torch.zeros_like(zTc)) + tuple(
        c.reshape((24,) + tuple(zTc.shape)) for c in cots[2:])
    ka.launches = ka.parity_mrt_launches = ka.cavity_launches = 0
    gc = flat_grads(adjc(fpc.params, Tc, zTc, hic, cotsc))
    pca_counts = (ka.launches, ka.cavity_launches, ka.parity_mrt_launches)
    check(pca_counts == (1, 1, 1), f"office MRT parity adjoint launch counts {pca_counts}")
    pca_ms = event_ms(torch, lambda: adjc(fpc.params, Tc, zTc, hic, cotsc), 3)
    note_adjoint_variant(day_adjoint, "day_adjoint_parity_cavity_mrt")
    t0 = time.time()
    gcp = flat_grads(adjc.plain(fpc.params, Tc, zTc, hic, cotsc))
    torch.cuda.synchronize()
    pca_plain_ms = (time.time() - t0) * 1e3
    pgaps = rel_l2_gaps(torch, gc, gcp, "office MRT f32 parity adjoint kernel vs f32 plain", MRT_ADJ_F32_RL2)
    pca_abs = max(float((gc[n] - r).abs().max()) for n, r in gcp.items())
    print(f"phase 20 office IDF workflow with interior MRT on {smi}: {tm32.building.n_zones} zones, "
          f"{tm32.building.n_surfaces} surfaces ({faces} network faces, "
          f"{cavity_segments(fr.params)} gas cavities); annual run (trbdf2, 8 sub-steps, scheduled setpoints, monthly "
          f"ground temperatures, collect_loads, collect_operative, f32) {wall:.3f} s (host clock), launches (all, "
          f"cavity, MRT) {launches}; heating {heat:.1f} kWh, cooling {cool:.1f} kWh (air bath, phase 17: "
          f"{p17.heat:.1f} / {p17.cool:.1f}); operative T range [{float(op.min()):.2f}, {float(op.max()):.2f}] C, "
          f"air [{float(zt.min()):.2f}, {float(zt.max()):.2f}] C; 48 h f32 kernel vs f64 plain: max |d zone_T| "
          f"{err_z:.3e} K, operative {err_o:.3e} K (<= {F32_TOL:g}), loads {err_l:.3e} W of {l_scale:.1f} W; "
          f"one day-launch {ms:.3f} ms vs f32 plain {plain_ms:.1f} ms (max |d| {err32:.3e} K), adjoint "
          f"{adj_ms:.3f} ms vs {adj_plain_ms:.1f} ms (relative L2 worst {worst_of(gaps)}, d mrt_eps_b "
          f"{gaps['mrt_eps_b']:.2e}); parity at {subc} sub-steps/h (coarse discretization): day-launch "
          f"{pc_ms:.3f} ms vs {pc_plain_ms:.1f} ms (max |d| {pc_err:.3e} K), adjoint {pca_ms:.3f} ms vs "
          f"{pca_plain_ms:.1f} ms (relative L2 worst {worst_of(pgaps)})", flush=True)
    b_tr = mrt_bounds(fr.params, 24, 24, day_work(fr.params, 24, 8, 8)[0], adjoint_work(fr.params, 24, 8, 8),
                      T, zT, hi, got, cots, g32)
    b_pa = mrt_bounds(fpc.params, 24, 24 * subc, parity_day_work(fpc.params, 24, subc, PARITY_ITERS)[0],
                      parity_adjoint_work(fpc.params, 24, subc, PARITY_ITERS), Tc, zTc, hic, gotc, cotsc, gc,
                      cav_builds=24 * subc * (PARITY_ITERS + 1))
    return SimpleNamespace(
        launches=launches, wall=wall, heat=heat, cool=cool, err_z=err_z, err_o=err_o, ms=ms, plain_ms=plain_ms,
        err32=err32, adj_ms=adj_ms, adj_plain_ms=adj_plain_ms, adj_abs=adj_abs, adj_counts=adj_counts,
        pc_ms=pc_ms, pc_plain_ms=pc_plain_ms, pc_err=pc_err, pc_counts=pc_counts, pca_ms=pca_ms,
        pca_plain_ms=pca_plain_ms, pca_abs=pca_abs, pca_counts=pca_counts, subc=subc,
        bounds=dict(march=b_tr[0], adjoint=b_tr[1], parity=b_pa[0], parity_adjoint=b_pa[1]),
    )



def gate_work(params, hours):
    """Operations the in-run controls add to a day-launch, counted from
    the day-march kernels: per lane and hour GATE_LANE_OPS (the controlling slot's
    test) and GATE_PANE_OPS more on a controlled pane (the compare, the
    select, the multiply); per zone and hour GATE_ZONE_OPS with ventilation
    gates (three compares, two adds, the select).  0 on ungated params."""
    ops = 0
    if params.shade_slot is not None:
        panes = int((params.shade_slot >= 0).sum())
        ops += hours * (GATE_LANE_OPS * params.surf.shape[1] + GATE_PANE_OPS * panes)
    if params.vent is not None:
        ops += hours * GATE_ZONE_OPS * params.zone_volume.numel()
    return ops


def zone_order(runner, hist):
    """Blocked per-hour zone rows [T, NB, ZB] -> [T, Z] in zone order."""
    return hist.reshape(hist.shape[0], -1)[:, runner._zinv]


def decision_flips(testing, building, zt, zt_ref, t_out, wind, shade_sp=None, zone_T0=22.0):
    """The in-run decisions of two runs of ``building`` rebuilt from their
    zone histories [T, Z] (``zt_ref`` the reference: f64, or the plain
    version), compared.  A group is a zone-connected component of blocking
    (zones joined by a face, or by a shading control whose pane reads
    another zone): one decision moves every temperature in it.  Returns
    ``(agree [Z] bool, flips)``: the zones of groups where every decision
    agrees, and for each group
    with a flip its first one as ``(hour, margin)``, the margin the
    reference's distance to the threshold there (later flips in the group
    follow from the first)."""
    kw = dict(shade_sp=shade_sp, zone_T0=zone_T0)
    from heatx_torch.build.blocking import _union_find_components

    got = testing.control_decisions(building, zt, t_out, wind, **kw)
    ref = testing.control_decisions(building, zt_ref, t_out, wind, **kw)
    group = np.asarray(_union_find_components(building))
    owners = {}
    if "shade" in ref:
        from heatx_torch.build.layout import B_SPACE

        sb = building.surfaces
        panes = np.nonzero(np.asarray(building.shade_zone) >= 0)[0]
        owners["shade"] = np.array([int(sb.back_space[s]) if int(sb.back_code[s]) == B_SPACE
                                    else int(sb.front_space[s]) for s in panes])
    if "vent" in ref:
        lim = [np.asarray(v, np.float64) for v in (building.vent_min_tin, building.vent_max_tin,
                                                   building.vent_delta, building.vent_min_tout,
                                                   building.vent_max_tout, building.vent_max_wind)]
        owners["vent"] = np.nonzero(np.any([lim[i] != d for i, d in enumerate((-100, 100, -100, -100, 100, 40))],
                                           axis=0))[0]
    first = {}
    for kind, own in owners.items():
        diff = got[kind] != ref[kind]
        for h, j in zip(*np.nonzero(diff)):
            g = group[own[j]]
            m = float(ref[kind + "_margin"][h, j])
            if g not in first or h < first[g][0] or (h == first[g][0] and m < first[g][1]):
                first[g] = (int(h), m)
    agree = ~np.isin(group, list(first))
    return agree, sorted(first.values())


def check_flips(flips, what):
    bad = [f for f in flips if f[1] > FLIP_MARGIN]
    check(not bad, f"{what}: decisions flip {bad} (hour, K from the threshold) farther than {FLIP_MARGIN} K "
                   "from their thresholds: not round-off")


def flips_text(flips):
    if not flips:
        return "no decision flips"
    return (f"{len(flips)} groups with a flip, first flips' margins "
            + ", ".join(f"{m:.2e} K (h {h})" for h, m in flips[:12]) + (" ..." if len(flips) > 12 else ""))


def phase21_gates_f64(torch, ctx):
    """The in-run controls in every day-march kind, f64, small (see the module
    docstring).  Returns the worst gap, the case count and the shares."""
    day_march, testing, ThermalModel, SimConfig = ctx.day_march, ctx.testing, ctx.ThermalModel, ctx.SimConfig
    from heatx_torch.model import building as pmb

    km = day_march.day_march_kernel
    hours = GATE_CASE_HOURS
    bodies = {"trbdf2_refresh k=2": (dict(mode="trbdf2_refresh", substeps=8, refresh_every=2), False),
              "parity": (dict(mode="parity"), True)}

    def thermostat(m):
        m.add_hvac(pmb.IdealHeaterCooler("t0", ["z0"], heat_setpoint=19.0, cool_setpoint=25.0))
        return m

    kinds = {"free-float": (lambda: None, lambda m: m, {}),
             "thermostats": (lambda: None, thermostat, {}),
             "cavities": (lambda: testing.glaze_windows(testing.build_city_model(2, 3)), lambda m: m, {}),
             "MRT": (lambda: None, lambda m: m, dict(interior_mrt=True))}
    controls = {"shading": (True, False), "gates": (False, True), "both": (True, True)}
    worst, cases, shares = 0.0, 0, {"shade": [], "vent": []}

    def model(kind, shading, gates):
        base, extra, cfg_kw = kinds[kind]
        return extra(testing.build_controlled_city(2, 3, shading=shading, gates=gates, base=base())), cfg_kw

    def config(parity, **cfg_kw):
        return (testing.coarse_config(torch.float64, 2, **cfg_kw) if parity
                else SimConfig(dtype=torch.float64, **cfg_kw))

    for body, (rkw, parity) in bodies.items():
        for kind in kinds:
            for ctl, (shading, gates) in controls.items():
                what = f"gates f64, {body}, {kind}, {ctl}"
                m, cfg_kw = model(kind, shading, gates)
                tm = ThermalModel(m, config=config(parity, **cfg_kw), device="cuda")
                mrt = kind == "MRT"
                r = tm.fast_runner(hours=hours, collect_operative=mrt, **rkw)
                seq = testing.controlled_city_inputs(tm.building, hours, device="cuda")
                hi = r.kernel_inputs(seq)[0]
                T0, zT0 = r.to_blocked(tm.initial_state())
                before = (km.launches, km.gated_launches, km.parity_gated_launches, km.cavity_launches,
                          km.mrt_launches)
                got = r.hour_march(r.params, T0, zT0, hi)
                after = (km.launches, km.gated_launches, km.parity_gated_launches, km.cavity_launches,
                         km.mrt_launches)
                expect = tuple(b + d for b, d in zip(before, (1, 1, int(parity), int(kind == "cavities"),
                                                              int(mrt))))
                check(after == expect, f"{what}: launch counts {after}, expected {expect}")
                ref = r.hour_march.plain(r.params, T0, zT0, hi)
                flat = lambda o: [x for v in o for x in (v if isinstance(v, tuple) else (v,))]  # noqa: E731
                for j, (a, b) in enumerate(zip(flat(got), flat(ref))):
                    err = float((a - b).abs().max())
                    check(err <= F64_TOL, f"{what} output {j}: max |d| {err} > {F64_TOL}")
                    worst = max(worst, err)
                d = testing.control_decisions(tm.building, zone_order(r, got[3]).cpu().numpy(),
                                              seq.t_out.cpu().numpy(), seq.wind_speed.cpu().numpy())
                for k in ("shade", "vent"):
                    if k in d:
                        share = float(d[k].mean())
                        check(GATE_SHARE[0] < share < GATE_SHARE[1],
                              f"{what}: {share:.0%} of the {k} decisions on: the case would not toggle")
                        shares[k].append(share)
                cases += 1

    # +1e9 on the kernel is the uncontrolled building bit for bit; a no-op
    # ventilation control is the ungated building within 1e-12 K.
    equal = {}
    for body, (rkw, parity) in bodies.items():
        cfg = config(parity)
        runs = {}
        for label, m in (("never", testing.build_controlled_city(2, 3, gates=False)),
                         ("uncontrolled", testing.build_city_model(2, 3)),
                         ("no-op gate", testing.build_city_model(2, 3))):
            if label == "no-op gate":
                m.add_vent_control(pmb.ZoneVentilationControl("z0"))
            tm = ThermalModel(m, config=cfg, device="cuda")
            r = tm.fast_runner(hours=hours, **rkw)
            seq = testing.controlled_city_inputs(tm.building, hours, device="cuda")
            if label == "never":
                seq = seq.replace(shade_sp=torch.full((hours, tm.building.n_surfaces), 1e9, dtype=torch.float64,
                                                      device="cuda"))
            T0, zT0 = r.to_blocked(tm.initial_state())
            runs[label] = r.hour_march(r.params, T0, zT0, r.kernel_inputs(seq)[0])
        for i, name in ((0, "T"), (1, "zT"), (3, "zt_hist")):
            check(torch.equal(runs["never"][i], runs["uncontrolled"][i]),
                  f"{body}: +1e9 shade_sp {name} is not bit-equal to the uncontrolled building: max |d| "
                  f"{float((runs['never'][i] - runs['uncontrolled'][i]).abs().max())}")
        gap = max(float((runs["no-op gate"][i] - runs["uncontrolled"][i]).abs().max()) for i in (0, 1, 3))
        check(gap <= 1e-12, f"{body}: a no-op ventilation control moves the march by {gap} K")
        equal[body] = gap
    return worst, cases, shares, equal


def agree_lanes(runner, building, agree):
    """[SP] bool: the blocked lanes whose faces bound only zones of
    ``agree`` (padded lanes and faces that bound no zone count as agreeing)."""
    import torch
    from heatx_torch.build.layout import B_SPACE

    sb = building.surfaces
    ok = np.ones(building.n_surfaces, bool)
    for code, space in ((sb.front_code, sb.front_space), (sb.back_code, sb.back_space)):
        on = np.asarray(code) == B_SPACE
        ok &= ~on | agree[np.where(on, np.asarray(space), 0)]
    dev = runner.params.surf.device
    return runner._blocker.lanes(torch.as_tensor(ok, device=dev), True)


def clean_lanes(runner, building, lanes):
    """``(lanes [SP] bool, zones [Z] bool numpy)``: the zones none of whose
    faces lies off ``lanes`` ([SP] bool), and the lanes of ``lanes`` whose
    faces bound only such zones (a face off ``lanes`` moves its zones'
    temperatures, and they move every face of the zone)."""
    import torch
    from heatx_torch.build.layout import B_SPACE

    sb = building.surfaces
    ok = lanes[runner._inv].cpu().numpy()
    zones = np.ones(building.n_zones, bool)
    for code, space in ((sb.front_code, sb.front_space), (sb.back_code, sb.back_space)):
        on = np.asarray(code) == B_SPACE
        zones[np.asarray(space)[on & ~ok]] = False
    return lanes & agree_lanes(runner, building, zones), zones


def phase22_controlled_city(torch, ctx):
    """The controlled city at full width, f32 (see the module docstring)."""
    day_march, testing, SimConfig, ThermalModel, smi = (ctx.day_march, ctx.testing, ctx.SimConfig,
                                                        ctx.ThermalModel, ctx.smi)
    km = day_march.day_march_kernel
    model = testing.build_controlled_city(1000, 10, setpoints=CITY_SHADE_SETPOINTS)
    kw = dict(mode="trbdf2_refresh", substeps=8, hours=24, refresh_every=2)
    tm32 = ThermalModel(model, n=1, config=SimConfig(dtype=torch.float32), device="cuda")
    b = tm32.building
    r32 = tm32.fast_runner(**kw)
    st0 = tm32.initial_state()
    n_zones = b.n_zones
    panes = int((r32.params.shade_slot >= 0).sum())
    own = torch.as_tensor(day_march.local_zone(r32._bb.back_oh), device="cuda")
    remote = int(((r32.params.shade_slot >= 0) & (r32.params.shade_slot != own)).sum())
    check(panes == n_zones and remote == sum(z % 10 == 1 for z in range(n_zones)),
          f"controlled city: {panes} controlled panes, {remote} remote")

    # (a) 48 h: the f32 kernel against the f64 plain version, decision by decision
    seq32 = testing.controlled_city_inputs(b, 48, device="cuda")
    km.launches = km.gated_launches = 0
    t0 = time.time()
    fin32, z32 = r32.run(st0, seq32, interp_weather=True)
    torch.cuda.synchronize()
    run48_s = time.time() - t0
    run48 = (km.launches, km.gated_launches)
    check(run48 == (2, 2), f"controlled city 48 h: {run48} (all, gated) launches, expected 2")
    tm64 = ThermalModel(model, n=1, config=SimConfig(dtype=torch.float64), device="cuda")
    seq64 = testing.controlled_city_inputs(tm64.building, 48, device="cuda")
    t0 = time.time()
    _, z64 = tm64.fast_runner(use_kernel=False, **kw).run(tm64.initial_state(), seq64, interp_weather=True)
    torch.cuda.synchronize()
    plain48_s = time.time() - t0
    for name, v in (("zone_T", z32), ("node_T", fin32.node_T), ("zone_T f64", z64)):
        check(bool(torch.isfinite(v).all()), f"controlled city {name} has non-finite values")
    t_out, wind = seq64.t_out.cpu().numpy(), seq64.wind_speed.cpu().numpy()
    agree, flips = decision_flips(testing, b, z32.double().cpu().numpy(), z64.cpu().numpy(), t_out, wind)
    check_flips(flips, "controlled city 48 h f32 vs f64")
    err_z = float((z32.double() - z64)[:, torch.as_tensor(agree, device="cuda")].abs().max())
    check(err_z <= F32_TOL, f"controlled city f32 vs f64 zone_T on agreeing zones: {err_z} > {F32_TOL}")
    d64 = testing.control_decisions(b, z64.cpu().numpy(), t_out, wind)
    shares = {k: float(d64[k].mean()) for k in ("shade", "vent")}
    for k, v in shares.items():
        check(GATE_SHARE[0] < v < GATE_SHARE[1], f"controlled city 48 h: {v:.0%} of the {k} decisions on")

    # (b) one day: the gated launch timed, against its f32 plain version
    T, zT = r32.to_blocked(st0)
    seq24 = testing.controlled_city_inputs(b, 24, device="cuda")
    hi = r32.kernel_inputs(seq24, interp_weather=True)[0]
    ms = event_ms(torch, lambda: r32.hour_march(r32.params, T, zT, hi), 10)
    t0 = time.time()
    ref = r32.hour_march.plain(r32.params, T, zT, hi)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    got = r32.hour_march(r32.params, T, zT, hi)
    t24, w24 = seq24.t_out.double().cpu().numpy(), seq24.wind_speed.double().cpu().numpy()
    agree_d, flips_d = decision_flips(testing, b, zone_order(r32, got[3]).double().cpu().numpy(),
                                      zone_order(r32, ref[3]).double().cpu().numpy(), t24, w24)
    check_flips(flips_d, "controlled city day, f32 kernel vs f32 plain")
    lanes = agree_lanes(r32, b, agree_d)
    zones = r32._blocker.zones(torch.as_tensor(agree_d, device="cuda"), True)
    err32 = max(float((got[0] - ref[0])[:, lanes].abs().max()), float((got[1] - ref[1])[zones].abs().max()),
                float((got[3] - ref[3])[:, zones].abs().max()))
    check(err32 <= F32_TOL, f"controlled city day kernel vs f32 plain: {err32} > {F32_TOL}")

    # (c) the year through FastRunner.run
    inputs_year = testing.controlled_city_inputs(b, 8760, device="cuda")
    km.launches = km.gated_launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    _, zy = r32.run(st0, inputs_year, interp_weather=True)
    torch.cuda.synchronize()
    year_s = time.time() - t0
    year = (km.launches, km.gated_launches)
    check(year == (365, 365), f"controlled city year: {year} (all, gated) launches, expected 365")
    check(bool(torch.isfinite(zy).all()) and tuple(zy.shape) == (8760, n_zones), "controlled city year zone_T")
    dy = testing.control_decisions(b, zy.double().cpu().numpy(), inputs_year.t_out.double().cpu().numpy(),
                                   inputs_year.wind_speed.double().cpu().numpy())
    year_shares = {k: float(dy[k].mean()) for k in ("shade", "vent")}
    del inputs_year, zy, dy

    # (d) parity: 48 h through FastRunner.run, one day-launch timed, the
    # kernel against its f32 plain version over the daytime window
    tmp = ThermalModel(model, n=1, config=SimConfig(dtype=torch.float32, nomass_fixed_iters=PARITY_ITERS),
                       device="cuda")
    fp = tmp.fast_runner(mode="parity", hours=24)
    sub = fp._substeps
    km.launches = km.parity_gated_launches = 0
    _, zp = fp.run(tmp.initial_state(), seq32, interp_weather=True)
    torch.cuda.synchronize()
    p_counts = (km.launches, km.parity_gated_launches)
    check(p_counts == (2, 2), f"controlled city parity 48 h: {p_counts} (all, gated parity) launches")
    check(bool(torch.isfinite(zp).all()), "controlled city parity zone_T has non-finite values")
    # The launch and the window on the gradient workload's scales (seg_u x
    # 1.2, front_alphas x 0.8), as phases 14b and 19c: with one no-mass
    # iteration the bench days' own operands put faces on the 2-cycle, which
    # amplifies the f32 round-off of either version (PARITY_* above).
    scale = torch.tensor([1.2, 1.0, 0.8, 1.0], device="cuda")[:, None, None]
    fp.params = dataclasses.replace(fp.params, node=fp.params.node * scale)
    Tp, zTp = fp.to_blocked(tmp.initial_state())
    hip = fp.kernel_inputs(seq24, interp_weather=True)[0]
    p_ms = event_ms(torch, lambda: fp.hour_march(fp.params, Tp, zTp, hip), 3)
    note_variant(day_march, "day_march_gated_parity")
    H, W0 = PARITY_PLAIN_HOURS, PARITY_WINDOW_START
    hm6 = day_march.hour_march_for(fp._bb, mode="parity", hours=H, scheduled_shade_sp=True)
    Tw, zTw, hi6 = daytime_window(day_march, fp._bb, fp.params, Tp, zTp, hip, sub)
    gotp = hm6(fp.params, Tw, zTw, hi6)
    torch.cuda.synchronize()
    t0 = time.time()
    refp = hm6.plain(fp.params, Tw, zTw, hi6)
    torch.cuda.synchronize()
    p_plain_ms = (time.time() - t0) * 1e3
    z0w = zTw.reshape(-1)[fp._zinv].double().cpu().numpy()
    agree_p, flips_p = decision_flips(testing, b, zone_order(fp, gotp[3]).double().cpu().numpy(),
                                      zone_order(fp, refp[3]).double().cpu().numpy(), t24[W0:W0 + H],
                                      w24[W0:W0 + H], zone_T0=z0w)
    check_flips(flips_p, "controlled city parity window, f32 kernel vs f32 plain")
    lanes_p = agree_lanes(fp, b, agree_p)
    zones_p = fp._blocker.zones(torch.as_tensor(agree_p, device="cuda"), True)
    fwd_gaps = {name: float(d.abs().max()) for name, d in (
        ("T", (gotp[0] - refp[0])[:, lanes_p]), ("zT", (gotp[1] - refp[1])[zones_p]),
        ("zt_hist", (gotp[3] - refp[3])[:, zones_p]),
        *((nm, (gotp[2][j] - refp[2][j])[lanes_p]) for j, nm in enumerate(("h_front", "h_back", "q_front",
                                                                          "q_back"))))}
    for name, err in fwd_gaps.items():
        tol = PARITY_HQ_TOL if name[:2] in ("h_", "q_") else PARITY_DAY_TOL
        check(err <= tol, f"controlled city parity f32 kernel vs plain, {name}: max |d| {err} > {tol}")
    del refp
    print(f"phase 22a controlled city on {smi}: {b.n_surfaces} surfaces, {n_zones} zones, {panes} shaded windows "
          f"({remote} read another zone), ventilation gates in every zone; trbdf2_refresh k=2, 48 h: {run48[1]} gated "
          f"launches, f32 run {run48_s:.3f} s (f64 plain {plain48_s:.1f} s); decisions on over 48 h (f64): "
          f"shading {shares['shade']:.1%}, ventilation {shares['vent']:.1%}; f32 kernel vs f64 plain: "
          f"{flips_text(flips)} (<= {FLIP_MARGIN:g} K), max |d zone_T| {err_z:.3e} K on the {int(agree.sum())} "
          f"agreeing zones (<= {F32_TOL:g})", flush=True)
    print(f"phase 22b controlled city on {smi}: one gated day-launch {ms:.3f} ms (CUDA events; ungated bench city "
          f"{ctx.kernel_ms:.3f} ms) vs f32 plain {plain_ms:.1f} ms, {flips_text(flips_d)}, max |d| {err32:.3e} K; "
          f"annual run (8760 h, f32) {year_s:.3f} s (host clock), {year[1]} gated launches, decisions on over "
          f"the year: shading {year_shares['shade']:.1%}, ventilation {year_shares['vent']:.1%}; parity "
          f"({sub} sub-steps/h, nomass_fixed_iters={PARITY_ITERS}): 48 h run {p_counts[1]} gated parity "
          f"launches; seg_u x 1.2, front_alphas x 0.8: one day-launch {p_ms:.3f} ms (bench city "
          f"{ctx.parity_ms:.3f} ms); over hours {W0}-{W0 + H}, "
          f"both from the kernel's state at {W0} h, against the f32 plain version ({p_plain_ms:.1f} ms): "
          f"{flips_text(flips_p)}, max |d| " + ", ".join(f"{k} {v:.2e}" for k, v in fwd_gaps.items())
          + f" (<= {PARITY_DAY_TOL:g} K, h/q <= {PARITY_HQ_TOL:g})", flush=True)
    ops_f = day_work(r32.params, 24, 8, 2)[0]
    bytes_f = nbytes(*param_tensors(r32.params), T, zT, *hi) + nbytes(got[0], got[1], *got[2], got[3], got[4])
    ops_p = parity_day_work(fp.params, 24, sub, PARITY_ITERS)[0]
    gotd = fp.hour_march(fp.params, Tp, zTp, hip)
    bytes_p = nbytes(*param_tensors(fp.params), Tp, zTp, *hip) + nbytes(gotd[0], gotd[1], *gotd[2], gotd[3], gotd[4])
    return SimpleNamespace(
        run48=run48, err_z=err_z, flips=flips, shares=shares, ms=ms, plain_ms=plain_ms, err32=err32,
        flips_d=flips_d, year_s=year_s, year_launches=year[1], year_shares=year_shares, p_counts=p_counts,
        p_ms=p_ms, p_plain_ms=p_plain_ms, p_err=max(fwd_gaps.values()), flips_p=flips_p,
        bounds=dict(march=(ops_f, bytes_f) + bound(bytes_f, ops_f), parity=(ops_p, bytes_p) + bound(bytes_p, ops_p)),
    )


def phase23_controlled_office(torch, ctx, p17):
    """The controlled office IDF workflow for a year (see the module
    docstring)."""
    import os
    import tempfile

    from heatx_torch.model.idf import load_idf
    from heatx_torch.weather.epw import read_epw

    testing, SimConfig, ThermalModel, smi = ctx.testing, ctx.SimConfig, ctx.ThermalModel, ctx.smi
    km = ctx.day_march.day_march_kernel
    with tempfile.TemporaryDirectory() as d:
        w = read_epw(testing.write_synthetic_epw(os.path.join(d, "santiago_synthetic.epw"), seed=0))
    loaded = load_idf(testing.controlled_office_idf())
    series = loaded.shading_setpoint_series(8760)
    check(series is not None, "the controlled office's shade has no schedule")
    kw = dict(mode="trbdf2", substeps=8, hours=24, scheduled_setpoints=True)

    def inputs(tm, hours):
        seq, ground = testing.office_inputs(loaded, tm, w, hours)
        sp = torch.as_tensor(series[:hours], dtype=tm.building.config.dtype, device="cuda")
        return seq.replace(shade_sp=sp), ground

    tm32 = ThermalModel(loaded.model, n=1, config=SimConfig(dtype=torch.float32), device="cuda")
    b = tm32.building
    check(b.surfaces.has_cavity and b.has_zone_shading and b.has_vent_gates and b.has_ideal_hvac,
          "the controlled office lacks cavities, shading, gates or thermostats")
    fr = tm32.fast_runner(**kw)
    seq, ground = inputs(tm32, 8760)
    st = tm32.initial_state()
    km.launches = km.cavity_launches = km.gated_launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    final, zt, loads = fr.run(st, seq, ground_hourly=ground, collect_loads=True)
    heat = float(loads.clamp(min=0).sum()) / 1000.0
    cool = float(-loads.clamp(max=0).sum()) / 1000.0
    wall = time.time() - t0
    launches = (km.launches, km.cavity_launches, km.gated_launches)
    check(launches == (365, 365, 365), f"controlled office year: {launches} (all, cavity, gated) launches")
    check(len(fr.dispatch_starts) == 12, f"controlled office year: {len(fr.dispatch_starts)} dispatches")
    for name, v in (("zone_T", zt), ("loads", loads), ("node_T", final.node_T)):
        check(bool(torch.isfinite(v).all()), f"controlled office year {name} has non-finite values")
    check(heat > 0 and cool > 0, f"controlled office year: heating {heat}, cooling {cool} kWh")
    dy = testing.control_decisions(b, zt.double().cpu().numpy(), seq.t_out.double().cpu().numpy(),
                                   seq.wind_speed.double().cpu().numpy(), shade_sp=series)
    shares = {k: float(dy[k].mean()) for k in ("shade", "vent")}
    for k, v in shares.items():
        check(GATE_SHARE[0] < v < GATE_SHARE[1], f"controlled office year: {v:.0%} of the {k} decisions on")

    seq48, g48 = inputs(tm32, 48)
    _, z32, l32 = fr.run(st, seq48, ground_hourly=g48, collect_loads=True)
    tm64 = ThermalModel(loaded.model, n=1, config=SimConfig(dtype=torch.float64), device="cuda")
    s64, g64 = inputs(tm64, 48)
    _, z64, l64 = tm64.fast_runner(use_kernel=False, **kw).run(tm64.initial_state(), s64, ground_hourly=g64,
                                                              collect_loads=True)
    agree, flips = decision_flips(testing, b, z32.double().cpu().numpy(), z64.cpu().numpy(),
                                  s64.t_out.cpu().numpy(), s64.wind_speed.cpu().numpy(), shade_sp=series[:48])
    check_flips(flips, "controlled office 48 h f32 vs f64")
    ok = torch.as_tensor(agree, device="cuda")
    err_z = float((z32.double() - z64)[:, ok].abs().max()) if agree.any() else 0.0
    l_scale = float(l64.abs().max())
    err_l = float((l32.double() - l64)[:, ok].abs().max()) if agree.any() else 0.0
    check(err_z <= F32_TOL, f"controlled office f32 vs f64 zone_T: {err_z} > {F32_TOL}")
    check(err_l <= LOAD_F32_RTOL * l_scale, f"controlled office f32 vs f64 loads: {err_l} W of {l_scale} W")
    print(f"phase 23 controlled office IDF workflow on {smi}: examples/data/office.idf with an "
          f"OnIfHighZoneAirTemperature shade (tau 0.3, 23 C, 8-18 h) on its argon window and ventilation limits "
          f"(20 C indoors, delta 1.05 K) in its {b.n_zones} zones, synthetic Santiago EPW (seed 0); annual run "
          f"(trbdf2, 8 sub-steps, scheduled setpoints and shading, monthly ground temperatures, collect_loads, "
          f"f32) {wall:.3f} s (host clock; uncontrolled, phase 17: {p17.walls[0]:.3f} s), launches (all, cavity, "
          f"gated) {launches}; heating {heat:.1f} kWh, cooling {cool:.1f} kWh (uncontrolled, phase 17: "
          f"{p17.heat:.1f} / {p17.cool:.1f}); decisions on over the year: shading {shares['shade']:.1%}, "
          f"ventilation {shares['vent']:.1%}; 48 h f32 kernel vs f64 plain: {flips_text(flips)}, max |d zone_T| "
          f"{err_z:.3e} K (<= {F32_TOL:g}), loads {err_l:.3e} W of {l_scale:.1f} W (<= {LOAD_F32_RTOL:g}) on "
          f"the {int(agree.sum())} agreeing zones", flush=True)
    return SimpleNamespace(launches=launches, wall=wall, heat=heat, cool=cool, shares=shares, err_z=err_z,
                           err_l=err_l, flips=flips)


def gate_kernel_entries(ctx, p22, p23):
    """The kernels line's entries of the gated launches (the in-run controls
    in the day march's extended instantiations)."""
    b = p22.bounds
    fwd = "heatx_torch/csrc/day_march_parity.cu (gates at the top of the hour loop; device code in day_parity_rows.cuh)"
    tr = "heatx_torch/csrc/day_march_tr.cu (gates at the top of the hour loop; device code in day_tr.cuh)"
    return [
        {"name": "day_march_gated", "route": "cuda", "source": tr,
         "replaces": "heatx/ops/pallas_step.py:1976 (body _hour_body_imp, pallas_step.py:777; zone shading "
                     ":1576-1594, ventilation gates :1614-1635)",
         "launches": p22.year_launches,
         "launches_by_path": {"controlled city annual run (phase 22b)": p22.year_launches,
                              "controlled city run, 48 h (phase 22a)": p22.run48[1],
                              "controlled office IDF year, with gas cavities (phase 23)": p23.launches[2]},
         "max_abs_err": p22.err32, "ms": p22.ms, "plain_ms": p22.plain_ms, "bound_ms": b["march"][2],
         "bound_by": b["march"][3], "library_ms": None, "ms_ungated_bench_day": ctx.kernel_ms,
         "decisions_on": p22.shares},
        {"name": "day_march_gated_parity", "plain_hours": PARITY_WINDOW, "route": "cuda",
         "source": fwd,
         "replaces": "heatx/ops/pallas_step.py:1976 (body _hour_body, pallas_step.py:633; zone shading "
                     ":1576-1594, ventilation gates :1614-1635)",
         "launches": p22.p_counts[1],
         "launches_by_path": {"controlled city parity run, 48 h (phase 22b)": p22.p_counts[1]},
         "max_abs_err": p22.p_err, "ms": p22.p_ms, "plain_ms": p22.p_plain_ms, "bound_ms": b["parity"][2],
         "bound_by": b["parity"][3], "library_ms": None, "ms_ungated_bench_day": ctx.parity_ms},
    ]


def mrt_kernel_entries(p19, p20, p27):
    """The kernels line's entries of the eight MRT instantiations (the four
    bodies, without and with gas cavities)."""
    def entry(name, source, replaces, launches, by_path, ms, plain_ms, err, b, **extra):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
                "launches_by_path": by_path, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b[2], "bound_by": b[3], "library_ms": None, **extra}

    fwd = "heatx_torch/csrc/day_march_parity_mrt.cu (network: heatx_torch/csrc/day_tr.cuh mrt_face_node)"
    tr = "heatx_torch/csrc/day_march_tr_mrt.cu (network: heatx_torch/csrc/day_tr.cuh mrt_face_node)"
    adj = "heatx_torch/csrc/day_adjoint_parity_mrt.cu (network: heatx_torch/csrc/day_tr_adj.cuh mrt_face_node_adj)"
    adj_tr = "heatx_torch/csrc/day_adjoint_tr_mrt.cu (network: heatx_torch/csrc/day_tr_adj.cuh mrt_face_node_adj)"
    k1_tr = "heatx/ops/pallas_step.py:1976 (body _hour_body_imp, pallas_step.py:777; _mrt_context :555, :840-858)"
    k1_pa = "heatx/ops/pallas_step.py:1976 (body _hour_body, pallas_step.py:633; _mrt_context :555, :678-684)"
    k2_tr = "heatx/ops/pallas_adjoint.py:717 (body _hour_body_imp; MRT_NAMES :204-208, :551-555)"
    k2_pa = "heatx/ops/pallas_adjoint.py:717 (body _hour_body(unroll=True), :573; MRT_NAMES :204-208)"
    b19, b20 = p19.bounds, p20.bounds
    H = PARITY_WINDOW
    return [
        entry("day_march_mrt", tr, k1_tr, p19.year_launches,
              {"MRT city annual run with the operative history (phase 19b)": p19.year_launches,
               "MRT city value_and_grad, 2 days (phase 19b)": p19.grad_counts[1]},
              p19.ms, p19.plain_ms, p19.err32, b19["march"], ms_with_operative=p19.ms_op),
        entry("day_adjoint_mrt", adj_tr, k2_tr, p19.grad_counts[3],
              {"MRT city value_and_grad, 2 days (phase 19b)": p19.grad_counts[3]},
              p19.adj_ms, p19.adj_plain_ms, p19.adj_abs, b19["adjoint"], rel_l2_err=p19.adj_rel),
        entry("day_march_parity_mrt", fwd, k1_pa, p19.pgrad_counts[1],
              {"MRT city parity value_and_grad, 2 days (phase 19c)": p19.pgrad_counts[1]},
              p19.p_ms, p19.p_plain_ms, p19.p_err, b19["parity"], plain_hours=H),
        entry("day_adjoint_parity_mrt", adj, k2_pa, p19.pgrad_counts[3],
              {"MRT city parity value_and_grad, 2 days (phase 19c)": p19.pgrad_counts[3]},
              p19.pa_ms, p19.pa_plain_ms, p19.pa_abs, b19["parity_adjoint"], rel_l2_err=p19.pa_rel,
              plain_hours=H),
        entry("day_march_cavity_mrt", tr + " and cavity_u", k1_tr, p20.launches[2],
              {"office IDF workflow with MRT, 8760 h (phase 20)": p20.launches[2],
               "python -m heatx_torch simulate, office year (phase 27a)": p27.cli_launches,
               "annual_peak_loads(engine='kernel'), office year (phase 27c)": p27.sizing_launches,
               "python -m heatx_torch size --annual, the year (phase 27f)": p27.size_year_launches},
              p20.ms, p20.plain_ms, p20.err32, b20["march"]),
        entry("day_adjoint_cavity_mrt", adj_tr + " and cavity_u", k2_tr, p20.adj_counts[2],
              {"office with MRT, one day's adjoint (phase 20)": p20.adj_counts[2]},
              p20.adj_ms, p20.adj_plain_ms, p20.adj_abs, b20["adjoint"]),
        entry("day_march_parity_cavity_mrt", fwd + " and cavity_u", k1_pa, p20.pc_counts[2],
              {f"office with MRT in parity mode at {p20.subc} sub-steps/h, one day (phase 20)": p20.pc_counts[2],
               "python -m heatx_torch size, the design days, adaptive loop (phase 27f)": p27.size_dd_launches},
              p20.pc_ms, p20.pc_plain_ms, p20.pc_err, b20["parity"]),
        entry("day_adjoint_parity_cavity_mrt", adj + " and cavity_u", k2_pa, p20.pca_counts[2],
              {f"office with MRT in parity mode at {p20.subc} sub-steps/h, one day's adjoint (phase 20)":
               p20.pca_counts[2]},
              p20.pca_ms, p20.pca_plain_ms, p20.pca_abs, b20["parity_adjoint"]),
    ]


def stop_stats(rec):
    """The no-mass runs' stopping iterations of a ``record_nomass_stops``
    recorder: ``(iters, present, broke, closest)`` as numpy ``[calls, C, SP]``,
    and a summary of the runs that exist (mean, p99, max, the shares that
    reach 100 and 500 iterations and that stopped on the increase-break)."""
    it, present, broke, closest = rec.stacked()
    runs = it[present]
    return it, present, broke, closest, dict(
        runs=int(runs.size), mean=float(runs.mean()), p99=float(np.percentile(runs, 99)),
        max=int(runs.max()), ge100=float((runs >= 100).mean()), at500=float((runs >= 500).mean()),
        broke=float(broke[present].mean()),
    )


def stats_text(st):
    return (f"{st['runs']:,} runs x sub-steps: iterations mean {st['mean']:.3f}, p99 {st['p99']:.0f}, max "
            f"{st['max']}, >= 100 {st['ge100']:.2e}, 500 {st['at500']:.2e}, stopped on the increase-break "
            f"{st['broke']:.2e}")


def phase24_adaptive_f64(torch, ctx):
    """The adaptive no-mass loop in every kind's parity body, f64, small
    buildings at the coarse discretization over ADAPTIVE_HOURS: the kernel
    against its plain twin from a scattered state (<= F64_TOL on T, zT, the
    zone history and h/q), and the kernel route (FastRunner.run) against the
    port's XLA path (ThermalModel.run) on the card from the initial state
    (<= ADAPTIVE_XLA_TOL).  Returns ``(worst, rows)``."""
    import os

    from heatx_torch.engine import surface as surf

    day_march, testing, ThermalModel = ctx.day_march, ctx.testing, ctx.ThermalModel
    os.environ["HEATX_KERNEL_WHILE"] = "1"
    hours = ADAPTIVE_HOURS
    rng = np.random.default_rng(24)
    k = day_march.day_march_kernel
    cases = {
        "free-float (4-zone city)": (lambda: testing.build_city_model(4, 10), {}, testing.bench_inputs, None),
        "kExt, gated (controlled city)": (lambda: testing.build_controlled_city(2, 3), {},
                                          testing.controlled_city_inputs, "parity_gated_launches"),
        "kCav (cavity building)": (testing.build_cavity_model, {}, testing.bench_inputs, "parity_cavity_launches"),
        "kMrt (two-zone building)": (testing.build_two_zone_model, dict(interior_mrt=True), testing.bench_inputs,
                                     "parity_mrt_launches"),
        "kMrt + kCav (cavity building with MRT)": (testing.build_cavity_model, dict(interior_mrt=True),
                                                   testing.bench_inputs, "parity_mrt_launches"),
    }
    worst, rows = dict(T=0.0, xla=0.0), []
    for label, (build, extra, inputs, counter) in cases.items():
        what = f"adaptive parity {label}"
        tm = ThermalModel(build(), config=testing.coarse_config(torch.float64, None, **extra), device="cuda")
        r = tm.fast_runner(mode="parity", hours=hours)
        check(r.hour_march.adaptive and r._substeps <= 8, f"{what}: not the adaptive loop")
        seq = inputs(tm.building, hours, device="cuda")
        # The weather starts at midnight: give the two hours some sun.
        sun = rng.uniform(50.0, 400.0, (hours, tm.building.n_surfaces))
        seq = seq.replace(sol_front=torch.as_tensor(sun, device="cuda"))
        hi = r.kernel_inputs(seq)[0]
        st0 = tm.initial_state()
        T0, zT0 = r.to_blocked(st0)
        mask = day_march.bit_rows(r.params, "node_bits")
        noise = torch.as_tensor(rng.normal(size=tuple(T0.shape)) * 2.0, device="cuda")
        Tn, zTn = T0 + noise * mask, zT0 + torch.as_tensor(rng.normal(size=tuple(zT0.shape)) * 0.5, device="cuda")
        c0 = (k.parity_launches, getattr(k, counter) if counter else 0)
        got = r.hour_march(r.params, Tn, zTn, hi)
        check((k.parity_launches - c0[0], (getattr(k, counter) if counter else 1) - c0[1]) == (1, 1),
              f"{what}: the launch did not run the kind's parity body")
        with surf.record_nomass_stops() as rec:
            ref = r.hour_march.plain(r.params, Tn, zTn, hi)
        for name, a, b in (("T", got[0], ref[0]), ("zT", got[1], ref[1]), ("zt_hist", got[3], ref[3]),
                           *((f"hq{j}", got[2][j], ref[2][j]) for j in range(4))):
            err = float((a - b).abs().max())
            check(err <= F64_TOL, f"{what} {name}: max |d| {err} > {F64_TOL}")
            worst["T"] = max(worst["T"], err)
        check(float(got[4].sum()) == 0.0, f"{what}: non-finite state in the kernel")
        st = stop_stats(rec)[-1]
        check(st["max"] > 2 and st["at500"] == 0.0, f"{what}: the loop ran {st['max']} iterations at most")
        # The kernel route against the XLA path, from the initial state.
        kf, kz = r.run(st0, seq)[:2]
        fields = {f.name: getattr(seq, f.name) for f in dataclasses.fields(seq) if getattr(seq, f.name) is not None}
        xf, xz = tm.run(st0, tm.inputs_sequence(hours, **fields))
        valid = torch.as_tensor(tm.building.surfaces.node_mask, device="cuda")
        err = max(float((kz - xz).abs().max()), float(((kf.node_T - xf.node_T) * valid).abs().max()))
        check(err <= ADAPTIVE_XLA_TOL, f"{what}: kernel route vs ThermalModel.run max |d| {err} > {ADAPTIVE_XLA_TOL}")
        worst["xla"] = max(worst["xla"], err)
        rows.append(f"{label} max {st['max']} mean {st['mean']:.2f} iterations, {st['broke']:.1%} broke")
    return worst, rows


def phase25_adaptive_city(torch, ctx, p13):
    """The adaptive loop at full width: the bench city, f32 (see the module
    docstring).  Returns what the kernels line and PERF.md need."""
    from heatx_torch.engine import surface as surf

    day_march, testing, SimConfig, ThermalModel = ctx.day_march, ctx.testing, ctx.SimConfig, ctx.ThermalModel
    smi = ctx.smi
    tm32 = ThermalModel(ctx.model, n=1, config=SimConfig(dtype=torch.float32, nomass_fixed_iters=None),
                        device="cuda")
    r32 = tm32.fast_runner(mode="parity", hours=24)
    sub = r32._substeps
    check(r32.hour_march.adaptive and sub == p13.sub, "the adaptive runner is not the bench city's parity march")
    st0 = tm32.initial_state()
    k = day_march.day_march_kernel
    k.launches = k.parity_launches = 0
    t0 = time.time()
    fin, z48 = r32.run(st0, testing.bench_inputs(tm32.building, 48, device="cuda"), interp_weather=True)
    torch.cuda.synchronize()
    run_s = time.time() - t0
    launches = (k.launches, k.parity_launches)
    check(launches == (2, 2), f"adaptive main path: {launches} (all, parity) launches, expected (2, 2)")
    check(bool(torch.isfinite(z48).all() and torch.isfinite(fin.node_T).all()), "adaptive 48 h run not finite")

    # One bench-day launch, beside the fixed-iteration one on the same operands (in turns).
    T, zT = r32.to_blocked(st0)
    hi = r32.kernel_inputs(testing.bench_inputs(tm32.building, 24, device="cuda"), interp_weather=True)[0]
    rp = p13.runner

    def fixed():
        return rp.hour_march(rp.params, p13.T, p13.zT, p13.hi)

    def adaptive():
        return r32.hour_march(r32.params, T, zT, hi)

    ms_fixed = [event_ms(torch, fixed, 2)]
    ms = event_ms(torch, adaptive, 3)
    note_variant(day_march, "day_march_parity_adaptive")
    ms_fixed.append(event_ms(torch, fixed, 2))
    day = adaptive()
    check(float(day[4].sum()) == 0.0, "the adaptive bench-day launch is not finite")

    # The daytime window, every side from the kernel's state at its start.
    H, W0 = PARITY_PLAIN_HOURS, PARITY_WINDOW_START
    Tw, zTw, hiw = daytime_window(day_march, r32._bb, r32.params, T, zT, hi, sub)
    hm = day_march.hour_march_for(r32._bb, mode="parity", hours=H)
    got = hm(r32.params, Tw, zTw, hiw)
    torch.cuda.synchronize()
    t0 = time.time()
    with surf.record_nomass_stops() as rec32:
        ref32 = hm.plain(r32.params, Tw, zTw, hiw)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    w64 = (Tw.double(), zTw.double(), tuple(x.double() for x in hiw))
    hm64 = {}
    for iters in (None, 1, 2):  # the adaptive loop, and two kernels that ignore its stop
        r = ThermalModel(ctx.model, n=1, config=SimConfig(dtype=torch.float64, nomass_fixed_iters=iters),
                         device="cuda").fast_runner(mode="parity", hours=24)
        hm64[iters] = (day_march.hour_march_for(r._bb, mode="parity", hours=H), r.params)
    t0 = time.time()
    with surf.record_nomass_stops() as rec64:
        ref64 = hm64[None][0].plain(hm64[None][1], *w64)
    torch.cuda.synchronize()
    plain64_s = time.time() - t0
    zinv = r32._zinv
    zk = got[3].reshape(H, -1)[:, zinv].double()
    z64 = ref64[3].reshape(H, -1)[:, zinv]
    dz = (zk - z64).abs()
    rmse = float((dz ** 2).mean().sqrt())
    check(rmse <= ADAPTIVE_RMSE, f"adaptive window, f32 kernel vs f64 plain: zone T RMSE {rmse} > {ADAPTIVE_RMSE}")
    err32 = max(float((got[i] - ref32[i]).abs().max()) for i in (0, 1, 3))
    it32, pres, _, _, st32 = stop_stats(rec32)
    it64, pres64, _, closest64, st64 = stop_stats(rec64)
    near64 = (closest64 <= ADAPTIVE_NEAR) & pres64
    check(it32.shape == it64.shape and (pres == pres64).all(), "the f32 and f64 windows ran different runs")
    nodes = day_march.bit_rows(r32.params, "node_bits").any(0)

    def gaps(out, lanes, zones):
        """max |d T| on ``lanes`` at the window's end and max |d| of the zone
        history on ``zones``, a window's outputs against the f64 plain version."""
        dT = float((out[0].double() - ref64[0])[:, lanes].abs().max())
        dh = (out[3].reshape(H, -1)[:, zinv].double() - z64)[:, torch.as_tensor(zones, device=z64.device)]
        return dT, float(dh.abs().max()) if dh.numel() else 0.0

    # The f64 kernel against its plain version, off the runs whose stop
    # decision the plain version took within ADAPTIVE_NEAR of a threshold
    # (where round-off may decide it the other way) and off their zones; the
    # fixed-iteration bodies on the same window show what the bound rejects.
    lanes64, zones64 = clean_lanes(r32, tm32.building, nodes & torch.as_tensor(
        ~near64.any(axis=(0, 1)), device="cuda"))
    got64 = {iters: hm_(p_, *w64) for iters, (hm_, p_) in hm64.items()}
    gap64 = {iters: gaps(o, lanes64, zones64) for iters, o in got64.items()}
    # The f32 kernel against the f64 plain version, off the runs whose
    # stopping iteration differs between the f32 and the f64 plain versions
    # (T) and off their zones (the zone history).
    differ = (it32 != it64) & pres
    lanes = nodes & torch.as_tensor(~differ.any(axis=(0, 1)), device="cuda")
    zones = clean_lanes(r32, tm32.building, lanes)[1]
    outside, z_outside = gaps(got, lanes, zones)
    gap1, gap2 = gaps(got64[1], lanes, zones), gaps(got64[2], lanes, zones)
    del ref32, ref64, got64
    checks = [
        (int(zones64.sum()) >= tm32.building.n_zones // 2,
         f"adaptive window: {int((~zones64).sum())} zones hold a stop decision within round-off of its threshold"),
        (max(gap64[None]) <= F64_TOL, f"adaptive window, f64 kernel vs f64 plain: max |d| {gap64[None]} > {F64_TOL}"),
        *((max(gap64[i]) > 1e3 * F64_TOL, f"adaptive window: a {i}-iteration f64 kernel is within {gap64[i]} K of "
           "the adaptive plain version, which the f64 bound cannot tell apart") for i in (1, 2)),
        (outside <= PARITY_DAY_TOL and z_outside <= CAV_WINDOW_T_TOL, f"adaptive window, f32 kernel vs f64 plain "
         f"off the differing stops: max |d T| {outside} > {PARITY_DAY_TOL} or zone history {z_outside} > "
         f"{CAV_WINDOW_T_TOL}"),
        *((g[0] > PARITY_DAY_TOL, f"adaptive window: a {i}-iteration f64 kernel is within {g[0]} K on T of the "
           "adaptive plain version off the differing stops, which PARITY_DAY_TOL cannot tell apart")
          for i, g in ((1, gap1), (2, gap2))),
    ]
    print(f"phase 25a adaptive parity on {smi}: the bench city, f32, {sub} sub-steps/h, 48 h through run: "
          f"{launches[0]} launches ({launches[1]} parity) in {run_s:.3f} s, finite; one bench-day launch "
          f"{ms:.3f} ms (CUDA events) beside the fixed-iteration one {ms_fixed[0]:.3f} / {ms_fixed[1]:.3f} ms "
          f"(nomass_fixed_iters={PARITY_ITERS}, same operands, in turns)", flush=True)
    print(f"phase 25b adaptive window hours {W0}-{W0 + H} from the kernel's state at {W0} h, against the f64 "
          f"plain version: the f64 kernel max |d T| {gap64[None][0]:.3e} K, zone history {gap64[None][1]:.3e} K "
          f"(<= {F64_TOL:g}) off {int(near64.sum()):,} runs x sub-steps with a stop decision within "
          f"{ADAPTIVE_NEAR:g} K of its threshold ({int((~lanes64.cpu().numpy() & nodes.cpu().numpy()).sum()):,} "
          f"lanes, {int((~zones64).sum()):,} zones left out); the f64 kernel with nomass_fixed_iters=1 "
          f"{gap64[1][0]:.3e} / {gap64[1][1]:.3e} K, =2 {gap64[2][0]:.3e} / {gap64[2][1]:.3e} K (> "
          f"{1e3 * F64_TOL:g}); the f32 kernel zone T RMSE {rmse:.3e} K (<= {ADAPTIVE_RMSE:g}: heatx's f32 "
          f"parity RMSE against its adaptive golden, BENCH_r05, a TPU v5e record), max |d| {float(dz.max()):.3e} "
          f"K; runs whose stopping iteration differs between the f32 and f64 plain versions "
          f"{int(differ.sum()):,} of {int(pres.sum()):,} ({int((~lanes.cpu().numpy() & nodes.cpu().numpy()).sum()):,} "
          f"lanes, {int((~zones).sum()):,} zones); off them the f32 kernel max |d T| {outside:.3e} K (<= "
          f"{PARITY_DAY_TOL:g}), zone history {z_outside:.3e} K (<= {CAV_WINDOW_T_TOL:g}), the f64 kernel with "
          f"nomass_fixed_iters=1 {gap1[0]:.3e} / {gap1[1]:.3e} K, =2 {gap2[0]:.3e} / {gap2[1]:.3e} K; f32 kernel vs f32 plain "
          f"{err32:.3e} K; plain f32 {plain_ms:.1f} ms, f64 {plain64_s:.1f} s; f64 {stats_text(st64)}; f32 mean "
          f"{st32['mean']:.3f}, max {st32['max']}", flush=True)
    for ok, msg in checks:
        check(ok, msg)
    ops = parity_day_work(r32.params, 24, sub, st64["mean"])[0]
    moved = nbytes(*param_tensors(r32.params), T, zT, *hi) + nbytes(day[0], day[1], *day[2], day[3], day[4])
    return SimpleNamespace(launches=launches, run_s=run_s, ms=ms, ms_fixed=ms_fixed, rmse=rmse, dz=float(dz.max()),
                           err32=err32, plain_ms=plain_ms, plain64_s=plain64_s, stats=st64, differ=int(differ.sum()),
                           outside=outside, z_outside=z_outside, gap64=gap64[None],
                           bound=(ops, moved) + bound(moved, ops))


def phase26_xla_run(torch, ctx):
    """ThermalModel.run, the XLA-path integrators, at full width on the card
    (see the module docstring).  Returns the rows printed."""
    testing, SimConfig, ThermalModel = ctx.testing, ctx.SimConfig, ctx.ThermalModel
    H = ADAPTIVE_RUN_HOURS
    k2 = dict(mode="trbdf2_refresh", substeps=8, refresh_every=2)
    modes = (
        ("parity, adaptive", None, dict(mode="parity"), None),
        (f"parity, nomass_fixed_iters={PARITY_ITERS}", PARITY_ITERS, dict(mode="parity"), dict(mode="parity")),
        ("trbdf2, 8 sub-steps", PARITY_ITERS, dict(mode="trbdf2"), None),
        ("trbdf2_refresh k=2", PARITY_ITERS, k2, k2),
        ("exp, 8 sub-steps", PARITY_ITERS, dict(mode="exp"), None),
    )
    rows = []
    for label, iters, kw, fast_kw in modes:
        tm = ThermalModel(ctx.model, n=1, config=SimConfig(dtype=torch.float32, nomass_fixed_iters=iters),
                          device="cuda")
        seq = testing.bench_inputs(tm.building, H, device="cuda")
        fields = {f.name: getattr(seq, f.name) for f in dataclasses.fields(seq) if getattr(seq, f.name) is not None}
        xs = tm.inputs_sequence(H, **fields)
        st0 = tm.initial_state()
        torch.cuda.synchronize()
        t0 = time.time()
        final, zt = tm.run(st0, xs, **kw)
        torch.cuda.synchronize()
        wall = time.time() - t0
        check(bool(torch.isfinite(zt).all() and torch.isfinite(final.node_T).all()), f"run({label}) not finite")
        row = f"{label} {wall:.3f} s"
        if fast_kw is not None:
            kf, kz = tm.fast_runner(hours=H, **fast_kw).run(st0, seq)
            gap = float((kz - zt).abs().max())
            check(gap <= F32_TOL, f"run({label}) vs the kernel route: max |d zone_T| {gap} > {F32_TOL}")
            row += f" (kernel route {gap:.2e} K apart)"
        rows.append(row)
    return rows


def csv_table(path):
    """(header, values [rows, columns]) of one of the command line's CSVs."""
    import csv

    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], np.array([[float(v) for v in r] for r in rows[1:]])


def json_gap(got, ref, what=""):
    """The largest relative gap between two summary JSONs' numbers (the wall
    clock left out); raises where their structure or other values differ."""
    if isinstance(ref, dict):
        check(sorted(got) == sorted(ref), f"summary keys differ at {what}")
        return max([json_gap(got[k], ref[k], f"{what}.{k}") for k in ref if k != "wall_clock_s"], default=0.0)
    if isinstance(ref, list):
        check(len(got) == len(ref), f"summary lengths differ at {what}")
        return max([json_gap(g, r, f"{what}[{i}]") for i, (g, r) in enumerate(zip(got, ref))], default=0.0)
    if isinstance(ref, float):
        return abs(got - ref) / max(abs(ref), 1e-300)
    check(got == ref, f"summary differs at {what}: {got!r} != {ref!r}")
    return 0.0


def phase27_cli_sizing(torch, ctx):
    """The command line and equipment sizing on the card, and FastRunner's
    one-hour entry points and update_building at full width (see the module
    docstring).  Returns the launch counts and the numbers printed."""
    import contextlib
    import io
    import os
    import re
    import tempfile

    from heatx_torch import cli, sizing
    from heatx_torch.engine.adjoint import tree_map
    from heatx_torch.model.idf import load_idf
    from heatx_torch.weather.epw import read_epw

    testing, SimConfig, ThermalModel, smi = ctx.testing, ctx.SimConfig, ctx.ThermalModel, ctx.smi
    km = ctx.day_march.day_march_kernel
    idf = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", "data", "office.idf")
    t_phase = time.time()

    def count_reset():
        km.launches = km.cavity_launches = km.mrt_launches = km.parity_launches = 0

    def counts():
        return km.launches, km.cavity_launches, km.mrt_launches

    def main(argv):
        err = io.StringIO()
        with contextlib.redirect_stdout(io.StringIO()) as out, contextlib.redirect_stderr(err):
            rc = cli.main(argv)
        return rc, out.getvalue(), err.getvalue()

    with tempfile.TemporaryDirectory() as d:
        epw_path = testing.write_synthetic_epw(os.path.join(d, "santiago_synthetic.epw"), seed=0)
        flags = ["--engine", "kernel", "--mode", "trbdf2"]

        def files(tag):
            return ["-o", f"{d}/{tag}_z.csv", "--loads-csv", f"{d}/{tag}_l.csv", "--comfort-csv",
                    f"{d}/{tag}_c.csv", "--fluxes-csv", f"{d}/{tag}_f", "--summary-json", f"{d}/{tag}_s.json"]

        # (a) the year in f32 on the card
        count_reset()
        t0 = time.time()
        rc, out_a, err_a = main(["simulate", idf, epw_path, *flags, "--warmup-days", str(CLI_WARMUP_DAYS),
                                 *files("year")])
        wall_a = time.time() - t0
        check(rc == 0, f"CLI year: exit code {rc}: {err_a[-2000:]}")
        m = re.search(r"# warm-up: (\d+) first-day repeats", err_a)
        check(m is not None, "CLI year: no warm-up line")
        reps = int(m.group(1))
        got = counts()
        check(got == (365 + reps,) * 3,
              f"CLI year: {got} (all, cavity, MRT) day-march launches, expected {365 + reps} of each")
        names = ["z.csv", "l.csv", "c.csv"] + [f"f_{c}.csv" for c in ("h_front", "h_back", "q_front", "q_back")]
        for name in names:
            hdr, v = csv_table(f"{d}/year_{name}")
            check(v.shape[0] == 8760 and bool(np.isfinite(v).all()), f"CLI year {name}: {v.shape}, finite?")
        with open(f"{d}/year_s.json") as f:
            year = json.load(f)
        demand = year["demand"]
        check(demand["heating_kwh"] > 0 and demand["cooling_kwh"] > 0, f"CLI year demand {demand}")

        # (b) 48 h in f64, the card against the plain versions on the CPU
        base = ["simulate", idf, epw_path, *flags, "--f64", "--hours", str(CLI_F64_HOURS)]
        rc_g, _, err_g = main(base + files("gpu"))
        rc_c, _, err_c = main(base + ["--platform", "cpu"] + files("cpu"))
        check(rc_g == rc_c == 0, f"CLI f64: exit codes {rc_g}, {rc_c}: {err_g[-1000:]} {err_c[-1000:]}")
        units = {"z.csv": 1e-4, "l.csv": 0.1, "c.csv": None}
        worst_units = 0.0
        for name in names:
            hg, g = csv_table(f"{d}/gpu_{name}")
            hc, c = csv_table(f"{d}/cpu_{name}")
            check(hg == hc and g.shape == c.shape == (CLI_F64_HOURS, len(hg)), f"CLI f64 {name}: shapes")
            unit = units.get(name, 1e-4)
            if unit is None:  # PMV to 1e-3, PPD% to 0.1
                z = (len(hg) - 1) // 2
                unit = np.array([1e-3] * z + [0.1] * z)
            gap = float((np.abs(g[:, 1:] - c[:, 1:]) / unit).max())
            check(gap <= 1.0 + 1e-9, f"CLI f64 {name}: card vs CPU {gap} units of the last digit apart")
            worst_units = max(worst_units, gap)
        with open(f"{d}/gpu_s.json") as f, open(f"{d}/cpu_s.json") as f2:
            js_gap = json_gap(json.load(f), json.load(f2))
        check(js_gap <= 1e-9, f"CLI f64 summary: card vs CPU {js_gap} relative")
        w = read_epw(epw_path)

        # (f) size --annual in f32: the design days on the parity day march
        # (the adaptive no-mass loop), the year on the TR-BDF2 one
        count_reset()
        t0 = time.time()
        rc, _, err_f = main(["size", idf, epw_path, "--annual", "--sizing-json", f"{d}/size.json"])
        wall_f = time.time() - t0
        check(rc == 0, f"CLI size: exit code {rc}: {err_f[-2000:]}")
        with open(f"{d}/size.json") as f:
            sz = json.load(f)
        dd_launches = sum(sz[season]["warmup_days"] + 1 for season in ("winter", "summer"))
        year_f = 365 + sz["annual"]["warmup_days"]
        got = counts() + (km.parity_launches,)
        check(got == (dd_launches + year_f,) * 3 + (dd_launches,),
              f"CLI size: {got} (all, cavity, MRT, parity) launches, expected {dd_launches} parity design-day "
              f"launches and {year_f} for the year, all on the cavity-and-MRT kind")
        peaks = (sz["winter"]["total_peak_heating_W"], sz["summer"]["total_peak_cooling_W"],
                 sz["annual"]["total_peak_heating_W"], sz["annual"]["total_peak_cooling_W"])
        check(bool(np.isfinite(peaks).all()) and peaks[0] > 0, f"CLI size: peaks {peaks}")

    # (c) annual sizing on the office
    model = load_idf(idf).model
    count_reset()
    torch.cuda.synchronize()
    t0 = time.time()
    ann = sizing.annual_peak_loads(model, w, engine="kernel", coverage=99.6)
    wall_c = time.time() - t0
    got = counts()
    check(got == (365 + ann.warmup_days,) * 3,
          f"sizing year: {got} (all, cavity, MRT) launches, expected {365 + ann.warmup_days} of each")
    for name in ("peak_heating_W", "peak_cooling_W", "max_heating_W", "max_cooling_W"):
        check(bool(np.isfinite(getattr(ann, name)).all()), f"sizing year {name} not finite")
    # Without internal gains (annual_peak_loads' default) the synthetic
    # Santiago year may ask for no cooling at all; it always asks for heat.
    check(float(ann.max_heating_W.max()) > 0, "sizing year: no heating load")
    cut = testing.cut_weather(w, SIZING_CUT_HOURS)
    cfg64 = SimConfig(dtype=torch.float64, interior_mrt=True)
    kw_cut = dict(engine="kernel", config=cfg64, max_repeats=SIZING_CUT_WARMUP)
    s_gpu = sizing.annual_peak_loads(model, cut, device="cuda", **kw_cut)
    s_cpu = sizing.annual_peak_loads(model, cut, device="cpu", **kw_cut)
    scale = float(np.abs(s_cpu.loads_W).max())
    gap_c = float(np.abs(s_gpu.loads_W - s_cpu.loads_W).max())
    check(s_gpu.warmup_days == s_cpu.warmup_days, "sizing cut: warm-up repeats differ")
    check(scale > 0 and gap_c <= 1e-9 * scale, f"sizing cut: card vs CPU loads {gap_c} W > 1e-9 x {scale} W")
    # (f) the winter design day in f64 at the coarse discretization with the
    # adaptive loop: the kernel route on the card against heatx's route
    # (ThermalModel.run) on the CPU
    winter = sizing.design_days_from_epw(w)["winter"]
    kw_dd = dict(epw=w, config=testing.coarse_config(nomass_fixed_iters=None, interior_mrt=True),
                 max_repeats=SIZING_DD_WARMUP)
    count_reset()
    dd_gpu = sizing.design_day_loads(model, winter, device="cuda", **kw_dd)
    launches_dd = km.parity_launches
    dd_cpu = sizing.design_day_loads(model, winter, device="cpu", **kw_dd)
    check(launches_dd == dd_gpu.warmup_days + 1, f"design day: {launches_dd} parity launches")
    check(dd_gpu.warmup_days == dd_cpu.warmup_days, "design day: warm-up repeats differ")
    scale_dd = float(np.abs(dd_cpu.profile_W).max())
    gap_dd = float(np.abs(dd_gpu.profile_W - dd_cpu.profile_W).max())
    check(scale_dd > 0 and gap_dd <= 1e-9 * scale_dd,
          f"design day: card kernel vs CPU ThermalModel.run {gap_dd} W > 1e-9 x {scale_dd} W")

    # (d) update_building on the bench city, f32, phase 4's mode
    kw = dict(mode="trbdf2_refresh", substeps=8, hours=24, refresh_every=2)
    tm = ThermalModel(ctx.model, n=1, config=SimConfig(dtype=torch.float32), device="cuda")
    b = tm.building
    b12 = dataclasses.replace(b, surfaces=dataclasses.replace(b.surfaces, seg_u=b.surfaces.seg_u * 1.2))
    day = testing.bench_inputs(b, 24, device="cuda")
    runner = tm.fast_runner(**kw)
    _, z_before = runner.run(tm.initial_state(), day, interp_weather=True)
    count_reset()
    runner.update_building(b12)
    f_swap, z_swap = runner.run(tm.initial_state(), day, interp_weather=True)
    launches_d = km.launches
    t12 = ThermalModel.from_building(b12, device="cuda")
    f_new, z_new = t12.fast_runner(**kw).run(t12.initial_state(), day, interp_weather=True)
    check(launches_d == 1, f"update_building day: {launches_d} launches")
    check(torch.equal(z_swap, z_new) and torch.equal(f_swap.node_T, f_new.node_T),
          "update_building: the swapped runner's day is not bit-equal to a fresh runner's")
    moved = float((z_swap - z_before).abs().max())
    check(moved > 1e-3, f"update_building: the swap moved zone T by {moved} K only")

    # (e) FastRunner(hours=1).march x 24, f64, against one run of the day
    tm64 = ThermalModel(ctx.model, n=1, config=SimConfig(dtype=torch.float64), device="cuda")
    day64 = testing.bench_inputs(tm64.building, 24, device="cuda")
    f24, z24 = tm64.fast_runner(hours=24, **{k: v for k, v in kw.items() if k != "hours"}).run(
        tm64.initial_state(), day64)
    r1 = tm64.fast_runner(hours=1, **{k: v for k, v in kw.items() if k != "hours"})
    st, rows = tm64.initial_state(), []
    count_reset()
    torch.cuda.synchronize()
    t0 = time.time()
    for h in range(24):
        st = r1.march(st, tree_map(lambda v: v[h] if v.ndim and v.shape[0] == 24 else v, day64))
        rows.append(st.zone_T)
    torch.cuda.synchronize()
    wall_e = time.time() - t0
    launches_e = km.launches
    check(launches_e == 24, f"march x 24: {launches_e} launches")
    gap_e = max(float((torch.stack(rows) - z24).abs().max()), float((st.node_T - f24.node_T).abs().max()))
    check(gap_e <= F64_TOL, f"march x 24 vs run: max |d| {gap_e} K > {F64_TOL}")
    phase_s = time.time() - t_phase
    print(f"phase 27 the command line and sizing on {smi}: (a) python -m heatx_torch simulate office.idf, a "
          f"synthetic Santiago year, --engine kernel --mode trbdf2, f32, --warmup-days {CLI_WARMUP_DAYS} ({reps} "
          f"repeats), loads, comfort, fluxes and summary: {wall_a:.3f} s (host clock; the CLI's own "
          f"{year['wall_clock_s']:.3f} s), {365 + reps} day-march launches, all on the cavity-and-MRT kind, heating "
          f"{demand['heating_kwh']:.1f} kWh, cooling {demand['cooling_kwh']:.1f} kWh; (b) {CLI_F64_HOURS} h f64 "
          f"card vs --platform cpu: every CSV within {worst_units:.3f} units of its last digit (<= 1), summary "
          f"{js_gap:.1e} relative (<= 1e-9); (c) annual_peak_loads(engine=\"kernel\") on the office, f32 year "
          f"{wall_c:.3f} s (host clock), {365 + ann.warmup_days} launches ({ann.warmup_days} warm-up), peaks "
          f"heating {float(ann.peak_heating_W.sum()):.1f} W, cooling {float(ann.peak_cooling_W.sum()):.1f} W at "
          f"{ann.coverage:g} %; f64 {SIZING_CUT_HOURS} h card vs CPU loads {gap_c:.3e} W = "
          f"{gap_c / scale:.1e} of max |load| (<= 1e-9); (d) update_building on the bench city, seg_u x 1.2, one "
          f"f32 day bit-equal to a fresh runner (the swap moved zone T by {moved:.3f} K); (e) FastRunner(hours=1)"
          f".march x 24 on the bench city, f64, {launches_e} launches in {wall_e:.3f} s (host clock), max |d| "
          f"{gap_e:.3e} K vs one run of the day (<= {F64_TOL:g}); (f) python -m heatx_torch size office.idf "
          f"--annual, f32: {wall_f:.3f} s (host clock), {dd_launches} parity design-day launches (warm-up "
          f"{sz['winter']['warmup_days']} winter, {sz['summer']['warmup_days']} summer) and {year_f} for the year, "
          f"totals: winter heating {peaks[0]} W, summer cooling {peaks[1]} W, annual 99.6 % heating {peaks[2]} W, "
          f"cooling {peaks[3]} W; the winter design day in f64 at the coarse discretization, adaptive loop, "
          f"{launches_dd} parity launches, card kernel vs CPU ThermalModel.run {gap_dd:.3e} W = "
          f"{gap_dd / scale_dd:.1e} of max |load| (<= 1e-9); phase {phase_s:.1f} s", flush=True)
    return SimpleNamespace(cli_launches=365 + reps, sizing_launches=365 + ann.warmup_days,
                           size_dd_launches=dd_launches, size_year_launches=year_f, wall_f=wall_f,
                           swap_launches=launches_d, hour_launches=launches_e, wall_a=wall_a, wall_c=wall_c,
                           heat=demand["heating_kwh"], cool=demand["cooling_kwh"], seconds=phase_s)


def adaptive_kernel_entry(p25):
    """The kernels line's entry of the adaptive loop in the parity body."""
    b = p25.bound
    return {
        "name": "day_march_parity_adaptive", "route": "cuda",
        "source": "heatx_torch/csrc/day_march_parity.cu (the no-mass loop, nomass_iters -1; device code in "
                  "day_parity_rows.cuh)",
        "replaces": "heatx/ops/pallas_step.py:1976 (body _hour_body, pallas_step.py:633; the adaptive loop "
                    ":1345-1353, heatx/engine/surface.py:814-825)",
        "launches": p25.launches[1],
        "launches_by_path": {"adaptive parity run, 48 h (phase 25a)": p25.launches[1]},
        "max_abs_err": p25.err32, "ms": p25.ms, "plain_ms": p25.plain_ms, "plain_hours": PARITY_WINDOW,
        "bound_ms": b[2], "bound_by": b[3], "library_ms": None, "ms_fixed_iters": p25.ms_fixed,
        "mean_iterations": p25.stats["mean"],
    }


def tree_rows(seq, T, start, hours):
    """Hours ``start`` to ``start + hours`` of an input sequence whose time
    series have ``T`` leading rows (the rest is passed on as it is)."""
    from heatx_torch.engine.adjoint import tree_map

    return tree_map(lambda v: v[start:start + hours] if v.ndim and v.shape[0] == T else v, seq)


def tree_head(seq, T, hours):
    """The first ``hours`` of an input sequence (:func:`tree_rows`)."""
    return tree_rows(seq, T, 0, hours)


def main() -> int:
    t_start = time.time()
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
        ("heatx_day_march", day_march.KERNEL_SOURCES),
        ("heatx_day_adjoint", day_adjoint.KERNEL_SOURCES),
    ])
    day_march.load_kernel()
    day_adjoint.load_kernel()
    build_s = time.time() - t0
    ptxas = ptxas_table(cuda_lib.build_log("heatx_day_march", day_march.KERNEL_SOURCES))
    print(f"phase 2 build: {build_s:.1f} s for both kernels (nvcc sm_90a, in parallel); "
          f"day_march ptxas: {ptxas}", flush=True)

    # 3. f64 algorithm check on the card
    err64 = phase3_f64_check(torch, day_march, testing, SimConfig, compile_building)
    print(f"phase 3 f64 4-zone 3 h kernel vs plain twin: max |d| {err64:.3e} K "
          f"(<= {F64_TOL:g}) in trbdf2_refresh k=2, k=8 and trbdf2", flush=True)
    e3b, e3b32, e3b_adj, shapes3b = phase3b_b1_edge(torch, day_march, day_adjoint, testing, ThermalModel, SimConfig)
    print("phase 3b B1's edge (" + "; ".join(f"one zone of {s} surfaces in {m}, one block of {b} lanes, a {n}-node "
                                             f"wall, 4 threads per surface, {t} a block, the adjoint {ta}"
                                             for s, m, b, n, t, ta in shapes3b)
          + f"), trbdf2 3 h free-float k=2 and a thermostat in trbdf2, parity 2 h at 6 sub-steps/h, one no-mass "
          f"iteration, free-float and a thermostat: f64 kernel vs plain twin max |d| {e3b:.3e} K "
          f"(<= {F64_TOL:g}); f32 kernel vs f64 plain max |d| {e3b32:.3e} K (<= {F32_TOL:g}); both adjoint "
          f"kernels vs the plain adjoint, f64, seeded cotangents: worst max |d| / max |ref| {e3b_adj:.3e} "
          f"(<= {ADJ_F64_RTOL:g})", flush=True)
    e3c, (sb3c, zb3c, n3c, var3c) = phase3c_zone_rows(torch, day_adjoint, testing, ThermalModel, SimConfig)
    e3cp, (sbp, zbp, np_, subp, varp) = parity_zone_rows(torch, day_adjoint, testing, ThermalModel, SimConfig)
    print(f"phase 3c each adjoint with the most zone rows a block held: TR-BDF2 {zb3c} zones in one block of {sb3c} "
          f"lanes, {n3c}-node panes, a thermostat each, {ZONE_ROWS_SUBSTEPS} sub-steps/h, f64, 2 h, k=2 and frozen "
          f"(launch variants {', '.join(var3c)}): adjoint kernel vs plain adjoint, seeded cotangents, worst max |d| "
          f"/ max |ref| {e3c:.3e}; parity {PARITY_CHAIN_ZONES} zones ({zbp} zone slots) in one block of {sbp} lanes, "
          f"{np_}-node panes, a thermostat each, {subp} sub-steps/h, one no-mass iteration, f64, 1 h (launch variant "
          f"{varp}): {e3cp:.3e} (<= {ADJ_F64_RTOL:g})", flush=True)

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

    note_variant(day_march, "day_march")
    print(f"phase 5 timing on {smi}: 30 days kernel path {wall30:.3f} s "
          f"({wall30 / 30 * 1e3:.2f} ms/day, host clock); one day-kernel launch "
          f"{kernel_ms:.3f} ms vs plain twin {plain_ms:.1f} ms (CUDA events, {runner.layout.block_size} lanes/block, "
          f"launch variant {VARIANTS['day_march']}); f32 kernel vs plain max |d| {err32:.3e} K", flush=True)

    # 6. the adjoint kernel's build (it ran in parallel with phase 2's)
    ptxas_adj = ptxas_table(cuda_lib.build_log("heatx_day_adjoint", day_adjoint.KERNEL_SOURCES))
    print(f"phase 6 build the day adjoint (the C entry day_adjoint.cu, day_adjoint_parity.cu with the parity "
          f"body, day_adjoint_tr.cu with the TR-BDF2 body, each with its kMrt unit; with phase 2's, {build_s:.1f} s "
          f"for both libraries); "
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
    gaps = rel_l2_gaps(torch, g32, g64p, "f32 adjoint kernel vs f64 plain adjoint", ADJ_F32_RL2)
    worst_gap = max(gaps, key=gaps.get)
    adj_ms = event_ms(torch, lambda: adj32(runner.params, T, zT, hi, cots32), 10)
    note_adjoint_variant(day_adjoint, "day_adjoint")
    # The recompute: the adjoint's hour starts against the forward kernel's
    # states at the same hours (the same device code in the same order).
    gap32 = recompute_gap(torch, day_adjoint, adj32, runner, tm32.fast_runner(**dict(kw, hours=1)), T, zT, hi,
                          cots32)
    gap64 = recompute_gap(torch, day_adjoint, adj64, r64, tm64.fast_runner(**dict(kw, hours=1)), T64, zT64, hi64,
                          cots64)
    t0 = time.time()
    g32p = flat_grads(adj32.plain(runner.params, T, zT, hi, cots32))
    torch.cuda.synchronize()
    adj_plain_ms = (time.time() - t0) * 1e3  # the f32 plain adjoint, as the kernel's ms is f32
    adj32_abs = max(float((g32[n] - ref).abs().max()) for n, ref in g32p.items())
    adj32_rel = max(float((g32[n] - ref).abs().max()) / max(float(ref.abs().max()), 1e-300)
                    for n, ref in g32p.items())
    print(f"phase 8a one bench day, f32 adjoint kernel vs f64 plain adjoint: relative L2 gap "
          f"worst {gaps[worst_gap]:.3e} ({worst_gap}; <= {ADJ_F32_RL2:g}), "
          + ", ".join(f"{n} {v:.2e}" for n, v in gaps.items())
          + f"; the adjoint's recomputed hour starts vs the forward kernel's states at the same hours, max |d| "
          f"T / zone T: f32 {gap32[0]:.3e} / {gap32[1]:.3e} K, f64 {gap64[0]:.3e} / {gap64[1]:.3e} K; launch "
          f"variant {VARIANTS['day_adjoint']}", flush=True)

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
    cots_d64 = tuple(c.double() for c in cots_d32)
    gd32 = flat_grads(adjd32(frd32.params, Tt, zTt, hit, cots_d32))
    # The f64 plain adjoint re-run from the forward kernel's hour starts (the
    # march the f32 adjoint differentiates), every zone and lane held; and
    # along the f64 plain march's own, printed.
    r1d32 = frd32._tm.fast_runner(mode="trbdf2_refresh", refresh_every=2, substeps=8, hours=1)
    starts_d = forward_hour_starts(torch, frd32, r1d32, Tt, zTt, hit)
    gd64k = flat_grads(adjd64.plain(frd64.params, Tt64, zTt64, hit64, cots_d64, starts=starts_d))
    gaps_d = rel_l2_gaps(torch, gd32, gd64k, "f32 demand adjoint kernel vs f64 plain adjoint from the forward "
                         "kernel's hour starts", ADJ_F32_RL2_TSTAT)
    worst_gap_d = max(gaps_d, key=gaps_d.get)
    gd64p = flat_grads(adjd64.plain(frd64.params, Tt64, zTt64, hit64, cots_d64))
    gaps_own = rel_l2_gaps(torch, gd32, gd64p, "f32 demand adjoint kernel vs f64 plain adjoint", float("inf"))
    parted, parted_margins, n_near, n_ctl = parted_thermostat_zones(torch, frd64, Tt64, zTt64, hit64, got_t[-1])
    tstat_adj_ms = event_ms(torch, lambda: adjd32(frd32.params, Tt, zTt, hit, cots_d32), 10)
    tstat_adj_variant = f"G=4/{day_adjoint.day_adjoint_kernel.block_threads}"
    t0 = time.time()
    gd32p = flat_grads(adjd32.plain(frd32.params, Tt, zTt, hit, cots_d32))
    torch.cuda.synchronize()
    tstat_adj_plain_ms = (time.time() - t0) * 1e3
    tstat_adj_abs = max(float((gd32[n] - ref).abs().max()) for n, ref in gd32p.items())
    print(f"phase 11a one demand day (k=2), f32: thermostat day-launch {tstat_ms:.3f} ms vs plain twin "
          f"{tstat_plain_ms:.1f} ms (free-float {kernel_ms:.3f} ms), kernel vs plain max |d| {tstat_err:.3e} K, "
          f"loads {tstat_ld_err:.3e} W of max {tstat_ld_scale:.1f} W; thermostat adjoint day-launch "
          f"{tstat_adj_ms:.3f} ms vs f32 plain adjoint {tstat_adj_plain_ms:.1f} ms (free-float {adj_ms:.3f} ms); "
          f"f32 adjoint kernel vs f64 plain adjoint from the forward kernel's hour starts, seeded load cotangent, "
          f"every zone: relative L2 gap worst {gaps_d[worst_gap_d]:.3e} ({worst_gap_d}; <= {ADJ_F32_RL2_TSTAT:g}), "
          f"d_ctl_heat {gaps_d['d_ctl_heat']:.2e}, d_zone_volume {gaps_d['d_zone_volume']:.2e}, seg_u "
          f"{gaps_d['seg_u']:.2e}; along the f64 plain march {worst_of(gaps_own)}; {int(parted.sum())} of {n_ctl} "
          f"thermostat zones whose f32 kernel and f64 hourly loads part (0 on one side only; <= "
          f"{TSTAT_PARTED_MAX}), their f64 free-float temperatures within "
          + ", ".join(f"{m:.2e}" for m in parted_margins)
          + f" K of a setpoint (<= {FLIP_MARGIN:g}; {n_near} zones come that close)", flush=True)

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
    ctx.parity_ms = p13.kernel_ms
    p14 = phase14_parity_grad(torch, ctx, p13)

    # 15-17. gas cavities: the four bodies small in f64, the glazed city at
    # full width, the office IDF workflow (see the module docstring)
    w15, n15, live15 = phase15_cavity_f64(torch, ctx)
    print(f"phase 15 f64 cavity bodies, {n15} cases (testing.build_cavity_model: cavities in every tilt band of "
          f"the correlation; the 4-zone glazed city; trbdf2, trbdf2_refresh k=2, parity with 1 and 2 no-mass "
          f"iterations): forward kernel vs plain twin max |d| {w15['T']:.3e} K on T, zT, zone history, h/q "
          f"(<= {F64_TOL:g}); adjoint kernel vs plain adjoint {w15['adj']:.3e} of max |ref| (<= {ADJ_F64_RTOL:g}), "
          f"seg_u cotangent exactly 0 on every cavity segment; central differences of the forward kernel along "
          f"T0 and seg_u: worst relative error {w15['fd']:.3e} (<= {FD_RTOL:g}); the live cavity U moves the "
          f"zones up to {live15:.3e} K against the static one", flush=True)
    p16 = phase16_glazed_city(torch, ctx)
    p17 = phase17_office(torch, ctx)

    # 18-20. interior MRT: every MRT body small in f64, the MRT city at full
    # width, the office with MRT (see the module docstring)
    w18, n18, live18 = phase18_mrt_f64(torch, ctx)
    print(f"phase 18 f64 MRT bodies, {n18} cases (testing.build_two_zone_model, the 4-zone city: trbdf2, "
          f"trbdf2_refresh k=1 and k=2 at 8 sub-steps over 3 h, parity with 1 and 2 no-mass iterations at the "
          f"coarse discretization over 2 h; the office with its gas cavities: k=2 and parity with 2; the "
          f"histories without MRT physics on two more): forward "
          f"kernel vs plain twin max |d| {w18['T']:.3e} K on T, zT, zone history, h/q, the h/q and operative "
          f"histories (<= {F64_TOL:g}); adjoint kernel vs plain adjoint {w18['adj']:.3e} of max |ref| "
          f"(<= {ADJ_F64_RTOL:g}), mrt_eps_* included; central differences of the forward kernel along T0, "
          f"mrt_eps_b, and eps_back and area through the network's statics: worst relative error {w18['fd']:.3e} "
          f"(<= {FD_RTOL:g}); the network moves the zones up to {live18:.3e} K against the air bath", flush=True)
    p19 = phase19_mrt_city(torch, ctx)
    p20 = phase20_office_mrt(torch, ctx, p17)

    # 21-23. the in-run passive controls: every kind small in f64, the
    # controlled city at full width, the controlled office (see the module
    # docstring)
    w21, n21, shares21, equal21 = phase21_gates_f64(torch, ctx)
    print(f"phase 21 f64 in-run controls, {n21} cases ({{trbdf2_refresh k=2 at 8 sub-steps, parity at the coarse "
          f"discretization}} x {{free-float, thermostats, gas cavities, MRT with the operative history}} x "
          f"{{shading, ventilation gates, both}}, testing.build_controlled_city(2, 3): one window read by the other "
          f"zone; {GATE_CASE_HOURS} h, one launch each): kernel vs plain twin max |d| {w21:.3e} K on every output "
          f"(<= {F64_TOL:g}); decisions on per case: shading {min(shares21['shade']):.0%}-"
          f"{max(shares21['shade']):.0%}, ventilation {min(shares21['vent']):.0%}-{max(shares21['vent']):.0%}; "
          f"a +1e9 shade_sp series bit-equal to the uncontrolled building in both bodies; a no-op ventilation "
          f"control within " + ", ".join(f"{v:.1e} K ({k})" for k, v in equal21.items())
          + " of the ungated building (<= 1e-12)", flush=True)
    p22 = phase22_controlled_city(torch, ctx)
    p23 = phase23_controlled_office(torch, ctx, p17)

    # 24-26. the adaptive no-mass loop and the XLA-path integrators (see the
    # module docstring)
    w24, rows24 = phase24_adaptive_f64(torch, ctx)
    print(f"phase 24 f64 adaptive no-mass loop in every kind's parity body ({ADAPTIVE_HOURS} h at the coarse "
          f"discretization; {'; '.join(rows24)}): kernel vs plain twin max |d| {w24['T']:.3e} K on T, zT, zone "
          f"history, h/q (<= {F64_TOL:g}); the kernel route vs ThermalModel.run on the card {w24['xla']:.3e} K "
          f"(<= {ADAPTIVE_XLA_TOL:g}, heatx's own bound)", flush=True)
    p25 = phase25_adaptive_city(torch, ctx, p13)
    rows26 = phase26_xla_run(torch, ctx)
    print(f"phase 26 ThermalModel.run on {smi}, the bench city at full width, f32, {ADAPTIVE_RUN_HOURS} h from "
          f"midnight (host clock): " + "; ".join(rows26), flush=True)

    # 27. the command line and sizing (see the module docstring)
    p27 = phase27_cli_sizing(torch, ctx)
    print(f"chip_smoke.py so far {time.time() - t_start:.1f} s (host clock, from its start)", flush=True)

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
    cav_b = p16.bounds
    for what, bs in (("with gas cavities (f32 glazed city, the day-launches of phase 16)", cav_b),
                     ("with interior MRT (f32 MRT city, the day-launches of phase 19)", p19.bounds),
                     ("with gas cavities and MRT (f32 office, the day-launches of phase 20)", p20.bounds),
                     ("with the in-run controls (f32 controlled city, the day-launches of phase 22)", p22.bounds)):
        print(f"bounds {what}: " + "; ".join(
            f"{name} {b[1] / 1e6:.2f} MB, {b[0] / 1e9:.3f} GFLOP -> {b[2] * 1e3:.2f} us ({b[3]})"
            for name, b in bs.items()), flush=True)
    print(f"bounds (f32 bench day, published H100 SXM rates): day_march {bytes_fwd / 1e6:.2f} MB, "
          f"{ops_fwd / 1e9:.3f} GFLOP -> {fwd_bound * 1e3:.2f} us ({fwd_by}); day_adjoint "
          f"{bytes_adj / 1e6:.2f} MB, {ops_adj / 1e9:.3f} GFLOP -> {adj_bound * 1e3:.2f} us ({adj_by}); "
          f"with thermostats: day_march {bytes_tf / 1e6:.2f} MB, {ops_tf / 1e9:.3f} GFLOP -> "
          f"{tf_bound * 1e3:.2f} us ({tf_by}); day_adjoint {bytes_ta / 1e6:.2f} MB, {ops_ta / 1e9:.3f} GFLOP "
          f"-> {ta_bound * 1e3:.2f} us ({ta_by}); parity, 24 h at {p13.sub} sub-steps/h: day_march "
          f"{bytes_pf / 1e6:.2f} MB, {ops_pf / 1e9:.3f} GFLOP -> {pf_bound * 1e3:.2f} us ({pf_by}); day_adjoint "
          f"{bytes_pa / 1e6:.2f} MB, {ops_pa / 1e9:.3f} GFLOP -> {pa_bound * 1e3:.2f} us ({pa_by})", flush=True)

    kernels = [
        {
            "name": "day_march",
            "route": "cuda",
            "source": "heatx_torch/csrc/day_march_tr.cu (device code: heatx_torch/csrc/day_tr.cuh)",
            "replaces": "heatx/ops/pallas_step.py:1976",
            "launches": launches_dfwd,
            "launches_by_path": {
                "run, 48 h (phase 4)": launches,
                "value_and_grad, 30 days (phase 8b)": launches_fwd,
                "demand run, 48 h (phase 10)": launches_demand,
                "demand gradient, 30 days (phase 11b)": launches_dfwd,
                "parity run, 48 h (phase 13a)": p13.launches[0],
                f"parity value_and_grad, {PARITY_GRAD_DAYS} days (phase 14a)": p14.counts[0],
                "update_building, one day (phase 27d)": p27.swap_launches,
                "FastRunner(hours=1).march x 24, f64 (phase 27e)": p27.hour_launches,
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
            "source": "heatx_torch/csrc/day_adjoint_tr.cu (device code: heatx_torch/csrc/day_tr_adj.cuh, "
                      "day_tr.cuh; C entry: day_adjoint.cu)",
            "replaces": "heatx/ops/pallas_adjoint.py:717",
            "launches": launches_dadj,
            "launches_by_path": {
                "value_and_grad, 30 days (phase 8b)": launches_adj,
                "demand gradient, 30 days (phase 11b)": launches_dadj,
                f"parity value_and_grad, {PARITY_GRAD_DAYS} days (phase 14a)": p14.counts[2],
            },
            "max_abs_err": adj32_abs,
            "ms": adj_ms,
            "plain_ms": adj_plain_ms,
            "bound_ms": adj_bound,
            "bound_by": adj_by,
            "library_ms": None,
            "thermostat": {"ms": tstat_adj_ms, "plain_ms": tstat_adj_plain_ms, "max_abs_err": tstat_adj_abs,
                           "bound_ms": ta_bound, "bound_by": ta_by, "variant": tstat_adj_variant},
        },
        {
            "name": "day_march_parity",
            "route": "cuda",
            "source": "heatx_torch/csrc/day_march_parity.cu (device code: heatx_torch/csrc/day_parity_rows.cuh)",
            "replaces": "heatx/ops/pallas_step.py:1976 (body _hour_body, pallas_step.py:633)",
            "launches": p14.counts[1],
            "launches_by_path": {
                "parity run, 48 h (phase 13a)": p13.launches[1],
                f"parity value_and_grad, {PARITY_GRAD_DAYS} days (phase 14a)": p14.counts[1],
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
            "source": "heatx_torch/csrc/day_adjoint_parity.cu (device code: heatx_torch/csrc/day_parity_adj.cuh, "
                      "day_parity_rows.cuh)",
            "replaces": "heatx/ops/pallas_adjoint.py:717 (body _hour_body(unroll=True), pallas_adjoint.py:573)",
            "launches": p14.counts[3],
            "launches_by_path": {f"parity value_and_grad, {PARITY_GRAD_DAYS} days (phase 14a)": p14.counts[3]},
            "ms_bench_day": p14.bench_adj_ms,
            "max_abs_err": p14.adj32_abs,
            "rel_l2_err": p14.adj32_rel,
            "ms": p14.adj_ms,
            "plain_ms": p14.adj_plain_ms,
            "bound_ms": pa_bound,
            "bound_by": pa_by,
            "library_ms": None,
        },
        {
            "name": "day_march_cavity",
            "route": "cuda",
            "source": "heatx_torch/csrc/day_march_tr.cu (cavity U: heatx_torch/csrc/day_common.cuh cavity_u)",
            "replaces": "heatx/ops/pallas_step.py:1976 (body _hour_body_imp, pallas_step.py:777, with gas "
                        "cavities, :1497-1529)",
            "launches": p17.launches,
            "launches_by_path": {
                "office IDF workflow, 8760 h (phase 17)": p17.launches,
                "glazed city run, 48 h (phase 16a)": p16.run_launches,
                f"glazed city value_and_grad, {CAV_GRAD_DAYS} days (phase 16b)": p16.counts["trbdf2"]["march"][1],
            },
            "max_abs_err": p16.err32,
            "ms": p16.ms,
            "plain_ms": p16.plain_ms,
            "bound_ms": cav_b["march"][2],
            "bound_by": cav_b["march"][3],
            "library_ms": None,
        },
        {
            "name": "day_adjoint_cavity",
            "route": "cuda",
            "source": "heatx_torch/csrc/day_adjoint_tr.cu (kCav: the cavity U's dU/dT on the segment's first "
                      "row; day_common.cuh cavity_u)",
            "replaces": "heatx/ops/pallas_adjoint.py:717 (body _hour_body_imp, cavity operands :401-425)",
            "launches": p16.counts["trbdf2"]["adjoint"][1],
            "launches_by_path": {
                f"glazed city value_and_grad, {CAV_GRAD_DAYS} days (phase 16b)": p16.counts["trbdf2"]["adjoint"][1],
            },
            "max_abs_err": p16.adj_abs,
            "ms": p16.adj_ms,
            "plain_ms": p16.adj_plain_ms,
            "bound_ms": cav_b["adjoint"][2],
            "bound_by": cav_b["adjoint"][3],
            "library_ms": None,
        },
        {
            "name": "day_march_parity_cavity",
            "plain_hours": PARITY_WINDOW,
            "route": "cuda",
            "source": "heatx_torch/csrc/day_march_parity.cu (kCav: the cavity U in registers, day_common.cuh "
                      "cavity_u)",
            "replaces": "heatx/ops/pallas_step.py:1976 (body _hour_body, pallas_step.py:633, with gas cavities)",
            "launches": p16.counts["parity"]["march"][2],
            "launches_by_path": {
                f"glazed city parity value_and_grad, {CAV_GRAD_DAYS} days (phase 16b)": p16.counts["parity"]["march"][2],
            },
            "max_abs_err": p16.p_err,
            "ms": p16.p_ms,
            "plain_ms": p16.p_plain_ms,
            "bound_ms": cav_b["parity"][2],
            "bound_by": cav_b["parity"][3],
            "library_ms": None,
        },
        {
            "name": "day_adjoint_parity_cavity",
            "plain_hours": PARITY_WINDOW,
            "route": "cuda",
            "source": "heatx_torch/csrc/day_adjoint_parity.cu (kCav: the cavity U's dU/dT on the segment's first "
                      "row; day_common.cuh cavity_u)",
            "replaces": "heatx/ops/pallas_adjoint.py:717 (body _hour_body(unroll=True), pallas_adjoint.py:573, "
                        "with gas cavities)",
            "launches": p16.counts["parity"]["adjoint"][2],
            "launches_by_path": {
                f"glazed city parity value_and_grad, {CAV_GRAD_DAYS} days (phase 16b)":
                    p16.counts["parity"]["adjoint"][2],
            },
            "max_abs_err": p16.pa_abs,
            "rel_l2_err": p16.pa_rel,
            "ms": p16.pa_ms,
            "plain_ms": p16.pa_plain_ms,
            "bound_ms": cav_b["parity_adjoint"][2],
            "bound_by": cav_b["parity_adjoint"][3],
            "library_ms": None,
        },
        *mrt_kernel_entries(p19, p20, p27),
        *gate_kernel_entries(ctx, p22, p23),
        adaptive_kernel_entry(p25),
    ]
    for k in kernels:
        if k["name"] in VARIANTS:
            k["variant"] = VARIANTS[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

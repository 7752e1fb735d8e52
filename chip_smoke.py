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

The last line is ``{"ok": true, "device": {...}}``; any failed check raises
and the script exits non-zero.
"""

import json
import subprocess
import sys
import time

import numpy as np

F64_TOL = 1e-9  # K: kernel vs plain twin, f64, same inputs
F32_TOL = 1e-2  # K: f32 against f64, or f32 kernel vs f32 twin, full width
BLOCK_SIZES = (32, 64, 128, 256)


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
        from heatx_torch.ops import cuda_lib, day_march
    except ImportError as e:
        print(f"chip_smoke: heatx_torch is not importable here ({e})", file=sys.stderr)
        return 2

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = card_facts()
    print(smi)
    print(f"phase 1 device: torch sees {kind!r} x{torch.cuda.device_count()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # 2. build
    t0 = time.time()
    day_march.load_kernel()
    build_s = time.time() - t0
    ptxas = [
        ln.strip() for ln in cuda_lib.build_log("heatx_day_march", [day_march.KERNEL_SOURCE]).splitlines()
        if "registers" in ln or "spill" in ln
    ]
    print(f"phase 2 build: {build_s:.1f} s (nvcc sm_90a); ptxas: {' | '.join(ptxas)}", flush=True)

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

    def event_ms(fn, reps):
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

    T, zT, hi = day_operands(runner)
    kernel_ms = event_ms(lambda: runner.hour_march(runner.params, T, zT, hi), 10)
    plain_ms = event_ms(lambda: runner.hour_march.plain(runner.params, T, zT, hi), 1)
    got = runner.hour_march(runner.params, T, zT, hi)
    ref = runner.hour_march.plain(runner.params, T, zT, hi)
    torch.cuda.synchronize()
    err32 = max(float((got[i] - ref[i]).abs().max()) for i in (0, 1, 3))
    check(err32 <= F32_TOL, f"f32 day kernel vs plain twin: max |d| {err32} > {F32_TOL}")

    sweep = {}
    for bs in BLOCK_SIZES:
        r = tm32.fast_runner(block_size=bs, **kw)
        Tb, zTb, hib = day_operands(r)
        sweep[bs] = (r.layout.n_blocks, event_ms(lambda: r.hour_march(r.params, Tb, zTb, hib), 10))
    print(f"phase 5 timing on {smi}: 30 days kernel path {wall30:.3f} s "
          f"({wall30 / 30 * 1e3:.2f} ms/day, host clock); one day-kernel launch "
          f"{kernel_ms:.3f} ms vs plain twin {plain_ms:.1f} ms (CUDA events, default {runner.layout.block_size} lanes/block); "
          f"f32 kernel vs plain max |d| {err32:.3e} K; lanes/block -> (blocks, ms/day): "
          + ", ".join(f"{bs}: ({nb}, {ms:.3f})" for bs, (nb, ms) in sweep.items()),
          flush=True)

    print(json.dumps({"kernels": [{
        "name": "day_march",
        "route": "cuda",
        "source": "heatx_torch/csrc/day_march.cu",
        "replaces": "heatx/ops/pallas_step.py:1976",
        "launches": launches,
        "max_abs_err": err32,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

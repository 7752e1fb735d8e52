#!/usr/bin/env python3
"""The command line and equipment sizing of heatx_torch on one NVIDIA GPU, as
a user runs them: what chip_smoke.py's phase 27 does not time.  Run from the
repository root:

    python3 scripts/torch_cli_check.py

It builds the day-march library (one nvcc per source, together; prints the
time), then times by the host clock, with the built library reused:
``python -m heatx_torch simulate`` of the office year as a process (f32,
kernel engine, loads and summary), ``python -m heatx_torch size --annual``
of the office as a process (the design days on the parity day march, the
year on the TR-BDF2 one), and one winter design day of the office in-process
(``sizing.design_day_loads`` in f32 with one warm-up day, the CLI's ``size``
configuration) on both engines: ``"kernel"`` (the parity day march with the
adaptive no-mass loop) and ``"xla"`` (``ThermalModel.run``, heatx's route:
plain PyTorch on the card), with the gap between them.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402

LIMIT_S = 600  # each process


def timed(argv):
    """(seconds by the host clock, exit code, stdout, stderr) of one command."""
    t0 = time.time()
    r = subprocess.run(argv, cwd=REPO, capture_output=True, text=True, timeout=LIMIT_S)
    return time.time() - t0, r.returncode, r.stdout, r.stderr


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_cli_check: no CUDA device", file=sys.stderr)
        return 2
    from heatx_torch import SimConfig, ThermalModel, sizing, testing
    from heatx_torch.model.idf import load_idf
    from heatx_torch.ops import cuda_lib, day_march
    from heatx_torch.weather.epw import read_epw

    smi = cs.card_facts()
    print(smi, flush=True)
    t0 = time.time()
    cuda_lib.build_many([("heatx_day_march", day_march.KERNEL_SOURCES)])
    day_march.load_kernel()
    print(f"build {time.time() - t0:.1f} s (the day-march library)", flush=True)

    idf = str(REPO / "examples" / "data" / "office.idf")
    with tempfile.TemporaryDirectory() as d:
        epw = testing.write_synthetic_epw(os.path.join(d, "santiago.epw"), seed=0)
        py = [sys.executable, "-m", "heatx_torch"]
        wall, rc, out, err = timed(py + ["simulate", idf, epw, "--engine", "kernel", "--mode", "trbdf2",
                                         "--loads-csv", f"{d}/l.csv", "--summary-json", f"{d}/s.json"])
        cs.check(rc == 0, f"simulate: exit code {rc}: {err[-2000:]}")
        with open(f"{d}/s.json") as f:
            s = json.load(f)
        print(f"python -m heatx_torch simulate office.idf <synthetic year> --engine kernel --mode trbdf2 "
              f"--loads-csv --summary-json on {smi}: process {wall:.2f} s (host clock), the CLI's own "
              f"'simulated {s['hours']} h in {s['wall_clock_s']:.3f} s'; heating {s['demand']['heating_kwh']:.1f} "
              f"kWh, cooling {s['demand']['cooling_kwh']:.1f} kWh", flush=True)
        wall, rc, out, err = timed(py + ["size", idf, epw, "--annual", "--sizing-json", f"{d}/z.json"])
        cs.check(rc == 0, f"size: exit code {rc}: {err[-2000:]}")
        with open(f"{d}/z.json") as f:
            z = json.load(f)
        print(f"python -m heatx_torch size office.idf <synthetic year> --annual on {smi}: process {wall:.2f} s "
              f"(host clock); winter total {z['winter']['total_peak_heating_W']} W ({z['winter']['warmup_days']} "
              f"warm-up days), summer total {z['summer']['total_peak_cooling_W']} W "
              f"({z['summer']['warmup_days']}), annual 99.6 % heating {z['annual']['total_peak_heating_W']} W, "
              f"cooling {z['annual']['total_peak_cooling_W']} W", flush=True)
        w = read_epw(epw)

    model = load_idf(idf).model
    winter = sizing.design_days_from_epw(w)["winter"]
    cfg = SimConfig(dtype=torch.float32, interior_mrt=True)
    sub = ThermalModel(model, config=cfg, device="cuda").dt_subdivisions
    res = {}
    for engine in ("kernel", "xla"):
        torch.cuda.synchronize()
        t0 = time.time()
        res[engine] = sizing.design_day_loads(model, winter, epw=w, config=cfg, max_repeats=1, engine=engine)
        torch.cuda.synchronize()
        wall = time.time() - t0
        r = res[engine]
        cs.check(bool(np.isfinite(r.profile_W).all()) and r.peak_W.max() > 0, f"{engine} design day: no heating")
        print(f"sizing.design_day_loads(office, the winter design day, max_repeats=1, engine={engine!r}) on "
              f"{smi}: 2 simulated days at {sub} parity sub-steps/h with the adaptive no-mass loop in "
              f"{wall:.3f} s (host clock), {wall / 2:.3f} s a simulated day; peak heating "
              f"{float(r.peak_W.sum()):.1f} W", flush=True)
    gap = float(np.abs(res["kernel"].profile_W - res["xla"].profile_W).max())
    print(f"f32 design day, kernel vs xla: max |d load| {gap:.3e} W of max |load| "
          f"{float(np.abs(res['xla'].profile_W).max()):.1f} W", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

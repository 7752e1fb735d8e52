"""A complete EnergyPlus-file workflow: IDF in, annual demand out.

heatx_torch's counterpart of examples/office_idf.py.
``examples/data/office.idf`` is a 3-zone office exercising the whole IDF
subset: insulated envelope, an argon double-glazed facade plus U/SHGC simple
glazing, interior partitions and furniture mass, zone-list internal gains on
office schedules, scheduled infiltration/ventilation, and night-setback
thermostats imported as ideal loads.  This script is the same run a shell
user gets from

    python -m heatx_torch simulate examples/data/office.idf weather.epw \
        --hours 8760 -o zones.csv --loads-csv demand.csv --mode trbdf2

through ``heatx_torch.cli.main``: on the card the TR-BDF2 day kernel (the
CLI's ``--engine auto``), on the CPU heatx's XLA path
(``ThermalModel.run``, plain PyTorch).

Deliberate differences from heatx: without the EPW file (``--epw`` or
``HEATX_EPW``) heatx returns 2; this script writes
``testing.write_synthetic_epw(<tmp>, seed=0)`` (Santiago's location, seeded
weather) and says so.  The CSVs go to the temporary directory unless
``--out``/``--loads`` name paths.

Run:  python examples_torch/office_idf.py [--platform gpu|cpu] [--hours 8760] [--epw path.epw]
          [any further ``simulate`` option, e.g. --f64 --summary-json s.json]
      (HEATX_EXAMPLE_FAST=1: 48 h)
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

HERE = os.path.dirname(os.path.abspath(__file__))
IDF = os.path.normpath(os.path.join(HERE, "..", "examples", "data", "office.idf"))


def weather_file(epw):
    """``epw`` where the file exists, else a synthetic EPW file (seed 0) in
    the temporary directory; and whether it is synthetic."""
    if epw and os.path.isfile(epw):
        return epw, False
    from heatx_torch import testing

    path = os.path.join(tempfile.mkdtemp(prefix="heatx_torch_"), "synthetic.epw")
    return testing.write_synthetic_epw(path, seed=0), True


def main(argv=None):
    tmp = tempfile.gettempdir()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--platform", choices=("gpu", "cpu"), default="gpu")
    ap.add_argument("--hours", type=int, default=8760)
    ap.add_argument("--epw", default=os.environ.get("HEATX_EPW", ""))
    ap.add_argument("--out", default=os.path.join(tmp, "office_zones.csv"))
    ap.add_argument("--loads", default=os.path.join(tmp, "office_demand.csv"))
    args, extra = ap.parse_known_args(argv)  # the rest goes to the command line
    if os.environ.get("HEATX_EXAMPLE_FAST") == "1":  # smoke-test settings
        args.hours = min(args.hours, 48)
    epw, synthetic = weather_file(args.epw)
    if synthetic:
        print(f"# weather: synthetic EPW (testing.write_synthetic_epw, seed 0) at {epw}")

    from heatx_torch.cli import main as cli_main

    rc = cli_main([
        "simulate", IDF, epw, "--hours", str(args.hours), "-o", args.out,
        "--loads-csv", args.loads, "--mode", "trbdf2", "--platform", args.platform, *extra,
    ])
    # The command line's --engine auto: the day kernel on the card, the XLA
    # path on the CPU.
    engine = extra[extra.index("--engine") + 1] if "--engine" in extra else "auto"
    if engine == "auto":
        engine = "kernel" if args.platform == "gpu" else "xla"
    print(f"({engine} engine)")
    return rc


if __name__ == "__main__":
    sys.exit(main())

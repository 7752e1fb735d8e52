"""The port's command line (``python -m heatx_torch``) against heatx's, f64,
CPU.

``examples/data/office.idf`` (3 zones, argon glazing, slab floors, office
schedules, night-setback thermostats) under ``testing.write_synthetic_epw``
weather, through ``heatx_torch.cli.main`` and ``heatx.cli.main`` on the same
arguments (heatx's kernel engine in interpret mode):

* ``info`` prints heatx's text, on the IDF and on an ``.spl`` model;
* ``simulate --platform cpu --f64`` with ``--engine kernel --mode trbdf2``
  (48 h), ``--engine xla --mode trbdf2`` (48 h, two warm-up days) and
  ``--engine kernel --mode parity --nomass-iters 1`` (24 h): every CSV
  agrees to one unit of its last printed digit (1e-4 K, 0.1 W, 1e-3 PMV),
  the summary JSON within 1e-9 relative (but the wall clock), the saved
  state within 1e-9;
* 24 h + 24 h resumed through ``--init-state`` equals 48 h, and a state
  saved by heatx resumes in the port;
* the refusals return heatx's exit codes and messages;
* ``python -m heatx_torch --help`` runs, and the default platform (the
  card) raises without one.

``size`` on a one-room ``.spl`` model against heatx's is slow here (the
parity design days march as plain PyTorch on the CPU, ~90 s) and marked so.
"""

import contextlib
import csv
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import heatx.cli as hx_cli
from heatx_torch import cli, testing

torch.set_num_threads(1)

REPO = os.path.join(os.path.dirname(__file__), os.pardir)
IDF = os.path.join(REPO, "examples", "data", "office.idf")

#: The per-simulation arguments of each case (heatx's interpret-mode kernel
#: at 16 lanes per block, as tests/test_torch_office.py runs it).
CASES = {
    "kernel_trbdf2": ["--engine", "kernel", "--mode", "trbdf2", "--substeps", "4", "--hours", "48",
                      "--block-size", "16", "--fluxes-csv", "{d}/f", "--comfort-csv", "{d}/c.csv"],
    "xla_trbdf2": ["--engine", "xla", "--mode", "trbdf2", "--substeps", "4", "--hours", "48",
                   "--warmup-days", "2"],
    "kernel_parity": ["--engine", "kernel", "--mode", "parity", "--nomass-iters", "1", "--hours", "24",
                      "--block-size", "16", "--fluxes-csv", "{d}/f", "--comfort-csv", "{d}/c.csv"],
}
COMMON = ["--platform", "cpu", "--f64", "-o", "{d}/z.csv", "--loads-csv", "{d}/l.csv",
          "--summary-json", "{d}/s.json", "--save-state", "{d}/st"]

#: One unit of each CSV's last printed digit.
UNITS = {"z.csv": 1e-4, "l.csv": 0.1, "f_h_front.csv": 1e-4, "f_h_back.csv": 1e-4,
         "f_q_front.csv": 1e-4, "f_q_back.csv": 1e-4}


@pytest.fixture(scope="module")
def epw_path(tmp_path_factory):
    return testing.write_synthetic_epw(tmp_path_factory.mktemp("weather") / "santiago.epw", seed=0)


@contextlib.contextmanager
def _heatx_as_configured():
    """heatx's CLI without its jax configuration step: tests/conftest.py
    has put jax on the CPU in f64 already, and the step would also move the
    compilation cache."""
    configure = hx_cli._configure_jax
    hx_cli._configure_jax = lambda args: None
    try:
        yield
    finally:
        hx_cli._configure_jax = configure


def _main(which, argv):
    """(exit code, stdout, stderr) of one in-process CLI call."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        if which == "heatx":
            with _heatx_as_configured():
                rc = hx_cli.main(argv)
        else:
            rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


def _argv(command, args, d, epw):
    return [command, IDF, epw] + [a.format(d=d) for a in COMMON + args]


def _rows(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], np.array([[float(v) for v in r] for r in rows[1:]])


def _csv_close(got, ref, unit, what):
    hg, g = _rows(got)
    hr, r = _rows(ref)
    assert hg == hr, what
    assert g.shape == r.shape and g.size, what
    np.testing.assert_array_equal(g[:, 0], r[:, 0], err_msg=what)  # the hours
    unit = np.broadcast_to(np.asarray(unit, np.float64), g[:, 1:].shape[1:])
    bad = np.abs(g[:, 1:] - r[:, 1:]) > unit * (1 + 1e-9)
    assert not bad.any(), f"{what}: {int(bad.sum())} values part by more than one unit"


def _json_close(got, ref, what=""):
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref), what
        for k in ref:
            if k != "wall_clock_s":
                _json_close(got[k], ref[k], f"{what}.{k}")
    elif isinstance(ref, list):
        assert len(got) == len(ref), what
        for i, (g, r) in enumerate(zip(got, ref)):
            _json_close(g, r, f"{what}[{i}]")
    elif isinstance(ref, float):
        assert abs(got - ref) <= 1e-9 * max(abs(ref), 1e-300), (what, got, ref)
    else:
        assert got == ref, (what, got, ref)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, epw_path):
    """Each case through both command lines, run once per module."""
    done = {}

    def get(case):
        if case not in done:
            out = {}
            for which in ("heatx", "port"):
                d = tmp_path_factory.mktemp(f"{case}_{which}")
                rc, stdout, stderr = _main(which, _argv("simulate", CASES[case], d, epw_path))
                out[which] = dict(dir=d, rc=rc, stdout=stdout, stderr=stderr)
            done[case] = out
        return done[case]

    return get


@pytest.mark.parametrize("case", list(CASES))
def test_simulate_matches_heatx(runs, case):
    res = runs(case)
    ref, got = res["heatx"], res["port"]
    assert ref["rc"] == got["rc"] == 0, got["stderr"]
    assert got["stdout"] == ref["stdout"]  # the demand and per-zone summary lines
    files = sorted(p.name for p in ref["dir"].iterdir())
    assert files == sorted(p.name for p in got["dir"].iterdir())
    kernel = case.startswith("kernel")
    assert ("c.csv" in files) == kernel and ("f_q_back.csv" in files) == kernel
    for name in files:
        if name.endswith(".csv"):
            unit = UNITS.get(name)
            if name == "c.csv":  # PMV to 1e-3, PPD% to 0.1, per zone
                unit = [1e-3] * 3 + [0.1] * 3
            _csv_close(got["dir"] / name, ref["dir"] / name, unit, f"{case} {name}")
    with open(ref["dir"] / "s.json") as f:
        ref_s = json.load(f)
    with open(got["dir"] / "s.json") as f:
        got_s = json.load(f)
    assert got_s["engine"] == ("kernel" if kernel else "xla") and "demand" in got_s
    _json_close(got_s, ref_s, "summary")
    with np.load(ref["dir"] / "st.npz") as r, np.load(got["dir"] / "st.npz") as g:
        assert sorted(g.files) == sorted(r.files)
        assert int(g["step"]) == int(r["step"])
        for k in r.files:
            np.testing.assert_allclose(g[k], r[k], rtol=0, atol=1e-9, err_msg=f"{case} {k}")


def test_resume_equals_continuous_and_heatx_checkpoints_resume(runs, epw_path, tmp_path):
    """24 h, saved, then 24 h more from ``--start-hour 24 --init-state``,
    equals the 48 h run hour for hour; a state heatx saved resumes the same
    way."""
    full = runs("kernel_trbdf2")
    base = ["--platform", "cpu", "--f64", "--engine", "kernel", "--mode", "trbdf2", "--substeps", "4",
            "--block-size", "16", "--hours", "24"]
    _, whole = _rows(full["port"]["dir"] / "z.csv")
    for which in ("port", "heatx"):
        rc, _, err = _main(which, ["simulate", IDF, epw_path, *base, "--start-hour", "0",
                                   "--save-state", str(tmp_path / f"{which}_day1")])
        assert rc == 0, err
        out = tmp_path / f"day2_{which}.csv"
        rc, _, err = _main("port", ["simulate", IDF, epw_path, *base, "--start-hour", "24",
                                    "--init-state", str(tmp_path / f"{which}_day1.npz"), "-o", str(out)])
        assert rc == 0 and "resumed state" in err and "(step 24)" in err, err
        _, day2 = _rows(out)
        np.testing.assert_array_equal(day2[:, 0], np.arange(24, 48))
        assert np.abs(day2[:, 1:] - whole[24:, 1:]).max() <= 1e-4 * (1 + 1e-9), which


REFUSALS = {
    "exp_on_kernel": (["--engine", "kernel", "--mode", "exp"], 2),
    "subhourly_kernel": (["--engine", "kernel", "--n", "2", "--hours", "24"], 2),
    "fluxes_off_kernel": (["--engine", "xla", "--mode", "trbdf2", "--fluxes-csv", "{d}/f"], 2),
    "operative_off_kernel": (["--engine", "xla", "--mode", "trbdf2", "--operative-csv", "{d}/o.csv"], 2),
    "comfort_off_kernel": (["--engine", "xla", "--mode", "trbdf2", "--comfort-csv", "{d}/c.csv"], 2),
    "refresh_every_mode": (["--mode", "trbdf2", "--refresh-every", "2"], 2),
    "refresh_every_divides": (["--mode", "trbdf2_refresh", "--substeps", "4", "--refresh-every", "3"], 2),
    "checked_off_parity": (["--engine", "xla", "--mode", "trbdf2", "--substeps", "2", "--hours", "24",
                            "--checked"], 0),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals_match_heatx(name, epw_path, tmp_path):
    args, code = REFUSALS[name]
    argv = ["simulate", IDF, epw_path, "--platform", "cpu", "--f64"] + [
        a.format(d=tmp_path) for a in args
    ]
    ref = _main("heatx", argv)
    got = _main("port", argv)
    assert ref[0] == got[0] == code
    lines = [[ln for ln in r[2].splitlines() if ln.startswith(("error:", "# note:"))] for r in (ref, got)]
    assert lines[0] and lines[1] == lines[0]


def test_block_size_over_b1_raises(epw_path, tmp_path):
    """An explicit ``--block-size`` is the block the runner takes, never a
    silent clamp (heatx's default is 1024; the port's is the fewest lanes):
    512 lanes, past one CTA (a thread-block cluster on the card, ROADMAP B1),
    runs and gives the default block's loads to round-off on the plain
    versions; past the kernels' limit of 1,024 lanes the launch shape raises
    ROADMAP B1's error."""
    argv = ["simulate", IDF, epw_path, "--platform", "cpu", "--f64", "--engine", "kernel", "--mode", "trbdf2",
            "--hours", "24"]
    loads = {}
    for block in (None, 512):
        out = str(tmp_path / f"loads_{block}.csv")
        extra = [] if block is None else ["--block-size", str(block)]
        rc, _, err = _main("port", argv + extra + ["--loads-csv", out])
        assert rc == 0, err
        loads[block] = _rows(out)[1]
    scale = float(np.abs(loads[None]).max())
    assert scale > 0 and np.abs(loads[512] - loads[None]).max() <= 1e-9 * scale
    from heatx_torch.ops import day_march

    with pytest.raises(NotImplementedError, match="ROADMAP B1"):
        day_march.launch_shape(day_march.launch_block_lanes(2048, 8), 8)


def test_info_prints_heatx_text(tmp_path):
    spl = tmp_path / "room.spl"
    spl.write_text(ROOM_SPL)
    for model in (IDF, str(spl)):
        ref = _main("heatx", ["info", model, "--platform", "cpu"])
        got = _main("port", ["info", model, "--platform", "cpu"])
        assert ref[0] == got[0] == 0
        assert got[1] == ref[1] and "zone 0" in got[1]


def test_python_m_heatx_torch_help():
    for argv in ([], ["simulate"], ["size"]):
        r = subprocess.run([sys.executable, "-m", "heatx_torch", *argv, "--help"], cwd=REPO,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr
        assert "python -m heatx_torch" in r.stdout
    assert "--platform {gpu,cpu}" in r.stdout


def test_default_platform_is_the_card(epw_path):
    """No ``--platform``: the card, which is refused here, never replaced by
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-GPU refusal")
    for argv in (["info", IDF], ["simulate", IDF, epw_path, "--hours", "24"],
                 ["size", IDF, epw_path]):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(argv)


#: One room with a concrete wall and a window to the outdoors, a slab on the
#: ground and a thermostat.
ROOM_SPL = """
Substance { type: "Normal", name: "Concrete", thermal_conductivity: 0.816, density: 1700.,
    specific_heat_capacity: 800., front_thermal_absorbtance: 0.9, back_thermal_absorbtance: 0.9,
    front_solar_absorbtance: 0.7, back_solar_absorbtance: 0.7 }
Substance { type: "Normal", name: "Glass", thermal_conductivity: 1.0, density: 2500.,
    specific_heat_capacity: 840., solar_transmittance: 0.8, front_thermal_absorbtance: 0.84,
    back_thermal_absorbtance: 0.84, front_solar_absorbtance: 0.1, back_solar_absorbtance: 0.1 }
Material { name: "C20", substance: "Concrete", thickness: 0.2 }
Material { name: "G6", substance: "Glass", thickness: 0.006 }
Construction { name: "Wall", materials: ["C20"] }
Construction { name: "Pane", materials: ["G6"] }
Space { name: "Room", volume: 60. }
Surface { name: "S", construction: "Wall", back_boundary: { type: "Space", space: "Room" },
    vertices: [ 0.,0.,0., 5.,0.,0., 5.,0.,3., 0.,0.,3. ] }
Surface { name: "Floor", construction: "Wall", front_boundary: { type: "Ground" },
    back_boundary: { type: "Space", space: "Room" }, vertices: [ 0.,0.,0., 0.,4.,0., 5.,4.,0., 5.,0.,0. ] }
Fenestration { name: "W", construction: "Pane", back_boundary: { type: "Space", space: "Room" },
    vertices: [ 1.,0.,1., 3.,0.,1., 3.,0.,2., 1.,0.,2. ] }
HVAC { type: "IdealHeaterCooler", name: "tstat", target_spaces: ["Room"], heating_setpoint: 19.,
    cooling_setpoint: 27. }
"""

@pytest.mark.slow
def test_size_matches_heatx(tmp_path):
    """``size`` on the one-room model: the design-day tables agree within
    1e-9 relative (~90 s: the parity design days march as plain PyTorch)."""
    spl = tmp_path / "room.spl"
    spl.write_text(ROOM_SPL)
    epw = testing.write_synthetic_epw(tmp_path / "design.epw")
    out = {}
    for which in ("heatx", "port"):
        path = tmp_path / f"{which}.json"
        rc, stdout, _ = _main(which, ["size", str(spl), epw, "--platform", "cpu", "--f64",
                                      "--sizing-json", str(path)])
        assert rc == 0
        with open(path) as f:
            out[which] = (stdout, json.load(f))
    assert out["port"][0] == out["heatx"][0]
    assert out["port"][1]["winter"]["peak_heating_W"]["Room"] > 100
    _json_close(out["port"][1], out["heatx"][1], "sizing")

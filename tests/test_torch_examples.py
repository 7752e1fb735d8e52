"""The port's examples (examples_torch/) and the ensemble sweep script run
in-process on their smoke settings: ``HEATX_EXAMPLE_FAST=1 --platform cpu``,
their own closing asserts included, each printing the engine its CPU route
ran (``(xla engine)``: heatx's XLA-path integrators, plain PyTorch;
``(kernel engine)``: the day march, its plain version here); with no
arguments each asks for the card and raises here.  The card's runs are
chip_smoke.py's phases 28d and 29 and scripts/torch_examples_check.py; each
computation against heatx's is tests/test_torch_examples_heatx*.py's.
optimal_control's smoke run is tests/test_torch_examples_heatx_power.py's,
which holds its phase 1's first objective and gradient against heatx."""

import importlib.util
import os

import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
EXAMPLES = sorted(f[:-3] for f in os.listdir(os.path.join(ROOT, "examples_torch")) if f.endswith(".py"))
SHARED = ("optimal_control",)  # smoke runs held in a cross-package file, which reuses them

#: Each example's closing line (its "OK" marker where heatx prints one) and
#: the engines its CPU route prints.
MARKERS = {
    "annual_city": ("checkpoint saved to", ["kernel engine"]),
    "annual_demand": ("demand OK", ["(kernel engine)"]),
    "calibrate": ("calibration OK", ["(xla engine"]),
    "calibrate_demand": ("demand calibration OK", ["(xla engine"]),
    "comfort": ("single pane:", ["kernel engine"]),
    "design_sweep": ("sweep OK", ["(xla engine)"]),
    "office_idf": ("(xla engine)", ["(xla engine)"]),
    "optimal_control": ("optimal control OK", ["(xla engine)", "(kernel engine)"]),
    "passive_controls": ("controls shave", ["xla engine"]),
    "size_equipment": ("unmet cooling h", ["(xla engine)"]),
    "uncertainty": ("UQ OK", ["(xla engine)"]),
}

torch.set_num_threads(1)


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_examples_listed():
    assert EXAMPLES == sorted(MARKERS)
    assert len(EXAMPLES) == 11  # every heatx example (tests/test_examples.py counts them)


@pytest.mark.parametrize("name", [n for n in EXAMPLES if n not in SHARED])
def test_example_runs_on_cpu(name, monkeypatch, capsys, tmp_path):
    monkeypatch.setenv("HEATX_EXAMPLE_FAST", "1")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr("tempfile.tempdir", None)
    mod = _load(os.path.join(ROOT, "examples_torch", f"{name}.py"), f"example_torch_{name}")
    assert mod.main(["--platform", "cpu"]) in (None, 0)
    out = capsys.readouterr().out
    ok, engines = MARKERS[name]
    assert ok in out.rstrip().splitlines()[-1], out[-800:]
    for engine in engines:
        assert engine in out, (engine, out[-800:])


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_refuses_without_a_card(name, monkeypatch, tmp_path):
    """The default platform is the card: without one each example raises,
    and none falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-GPU refusal")
    monkeypatch.setenv("HEATX_EXAMPLE_FAST", "1")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr("tempfile.tempdir", None)
    mod = _load(os.path.join(ROOT, "examples_torch", f"{name}.py"), f"example_torch_{name}")
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main([])


def test_ensemble_sweep_script_runs_on_cpu(capsys):
    mod = _load(os.path.join(ROOT, "scripts", "torch_ensemble_sweep.py"), "torch_ensemble_sweep")
    mod.main(["--platform", "cpu", "--max-e", "64", "--hours", "24"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("E=")]
    assert [ln.split(":")[0] for ln in lines] == ["E=   16", "E=   64"]

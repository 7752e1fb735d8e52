"""The port's examples (examples_torch/) and the ensemble sweep script run
in-process on their smoke settings: ``HEATX_EXAMPLE_FAST=1 --platform cpu``
(the XLA-path route of ``heatx_torch.ensemble``), their own closing asserts
included.  The card's runs at full settings are chip_smoke.py's phase 28d."""

import importlib.util
import os

import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
EXAMPLES = sorted(f[:-3] for f in os.listdir(os.path.join(ROOT, "examples_torch")) if f.endswith(".py"))

torch.set_num_threads(1)


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_examples_listed():
    assert EXAMPLES == ["design_sweep", "uncertainty"]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_cpu(name, monkeypatch, capsys):
    monkeypatch.setenv("HEATX_EXAMPLE_FAST", "1")
    mod = _load(os.path.join(ROOT, "examples_torch", f"{name}.py"), f"example_torch_{name}")
    assert mod.main(["--platform", "cpu"]) in (None, 0)
    out = capsys.readouterr().out
    assert ("sweep OK" if name == "design_sweep" else "UQ OK") in out
    assert "(xla engine)" in out


def test_ensemble_sweep_script_runs_on_cpu(capsys):
    mod = _load(os.path.join(ROOT, "scripts", "torch_ensemble_sweep.py"), "torch_ensemble_sweep")
    mod.main(["--platform", "cpu", "--max-e", "64", "--hours", "24"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("E=")]
    assert [ln.split(":")[0] for ln in lines] == ["E=   16", "E=   64"]

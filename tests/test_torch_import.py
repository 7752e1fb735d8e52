"""heatx_torch stands alone: importing it loads no jax (the GPU host has
none), and a GPU device is never silently replaced by the CPU."""

import pathlib
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_import_loads_no_jax():
    code = (
        "import sys\n"
        "import heatx_torch, heatx_torch.api, heatx_torch.ops.day_march\n"
        "import heatx_torch.ops.day_adjoint, heatx_torch.engine.adjoint, heatx_torch.engine.zone\n"
        "import heatx_torch.convert, heatx_torch.testing\n"
        "import heatx_torch.model.idf, heatx_torch.weather.epw, heatx_torch.weather.solar\n"
        "import heatx_torch.physics.gas, heatx_torch.physics.cavity\n"
        "import heatx_torch.cli, heatx_torch.sizing, heatx_torch.comfort, heatx_torch.io.checkpoint\n"
        "import heatx_torch.model.spl, heatx_torch.weather.shadow, heatx_torch.utils\n"
        "import heatx_torch.utils.debug, heatx_torch.utils.profiling\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'heatx'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert r.returncode == 0, r.stdout + r.stderr


def _imported_packages(path):
    for line in path.read_text().splitlines():
        t = line.split()
        if len(t) >= 2 and t[0] in ("import", "from"):
            yield t[1].split(".")[0].rstrip(",")


def test_no_jax_import_in_sources():
    offenders = [
        (str(p.relative_to(REPO)), m)
        for p in (REPO / "heatx_torch").rglob("*.py")
        for m in _imported_packages(p)
        if m in ("jax", "jaxlib", "heatx")
    ]
    assert offenders == []


def test_cuda_model_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-GPU refusal")
    from heatx_torch import ThermalModel, testing

    with pytest.raises(RuntimeError, match="CUDA"):
        ThermalModel(testing.build_city_model(1, 3), device="cuda")


def test_model_defaults_to_the_card():
    """With no device given, the entry points ask for the card, and refuse
    on a box without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-GPU refusal")
    from heatx_torch import SimConfig, ThermalModel, testing
    from heatx_torch.build.layout import compile_building
    from heatx_torch.ops import day_adjoint, day_march

    model = testing.build_city_model(1, 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        ThermalModel(model)
    b = compile_building(model, config=SimConfig(dtype=torch.float64))
    with pytest.raises(RuntimeError, match="CUDA"):
        ThermalModel.from_building(b)
    bb = day_march.block_building(b)
    with pytest.raises(RuntimeError, match="CUDA"):
        day_march.make_hour_march(bb, substeps=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        day_adjoint.make_day_adjoint(bb, substeps=2)


def test_hour_march_has_no_device_fallback():
    """A tensor on neither CPU nor CUDA is refused, never marched elsewhere."""
    from heatx_torch import SimConfig, testing
    from heatx_torch.build.layout import compile_building
    from heatx_torch.ops import day_march

    b = compile_building(testing.build_city_model(1, 3), config=SimConfig(dtype=torch.float64))
    bb = day_march.block_building(b)
    hm, params = day_march.make_hour_march(bb, substeps=2, mode="trbdf2", device="meta")
    SP, NB, ZB = bb.layout.padded_surfaces, bb.n_blocks, bb.zones_per_block
    meta = dict(device="meta", dtype=torch.float64)
    hi = tuple(torch.zeros(2, **meta) for _ in range(3)) + tuple(
        torch.zeros(1, SP, **meta) for _ in range(4)
    ) + (torch.zeros(1, NB, ZB, **meta), torch.zeros(1, NB, ZB, **meta))
    with pytest.raises(ValueError, match="no day march for device"):
        hm(params, torch.zeros(bb.max_nodes, SP, **meta), torch.zeros(NB, ZB, **meta), hi)

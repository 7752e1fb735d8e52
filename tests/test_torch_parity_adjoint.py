"""The parity day adjoint kernel (csrc/day_adjoint_parity.cu): what its
wrapper takes and how it dispatches, on the CPU; on an NVIDIA GPU (``cuda``
marker; skipped without one: the kernel has no CPU mode) against the plain
parity adjoint in f64 where a block holds the most zone rows of an hour, at
B1's edge and on the small buildings of every kind.  The plain version and
the row plan are held to heatx in tests/test_torch_parity_grad.py and
tests/test_torch_parity_adj_rows.py.
"""

import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from heatx_torch import SimConfig, ThermalModel, testing
from heatx_torch.ops import cuda_lib, day_adjoint, day_march

torch.set_num_threads(1)

RTOL = 1e-9  # of max |ref|, per output
SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"


def test_parity_adjoint_kernel_takes_any_substep_count():
    """The parity adjoint kernel keeps its hour's tape in a workspace in
    device memory ([substeps, 32, SP] values, then each block's zone rows and
    weather for its 1024-thread variant), so no sub-step or node count is
    refused for it: at the default discretization's 118 sub-steps and 25
    nodes the wrapper's first refusal of CPU tensors is its device check.
    The one-thread kernel and its per-launch U row are gone."""
    tm = ThermalModel(testing.build_city_model(2, 3), config=SimConfig(dtype=torch.float64, nomass_fixed_iters=1),
                      device="cpu")
    r = tm.fast_runner(mode="parity", hours=1)
    sub = tm.dt_subdivisions
    assert sub == 118 and r.params.max_nodes == 25
    T, zT = r.to_blocked(tm.initial_state())
    hi = r.kernel_inputs(testing.bench_inputs(tm.building, 1), interp_weather=True)[0]
    adj = day_adjoint.make_day_adjoint(r._bb, substeps=sub, mode="parity", hours=1, device="cpu")
    cots = (torch.zeros_like(T), torch.zeros_like(zT), torch.zeros((1, r._bb.n_blocks, r._bb.zones_per_block),
                                                                  dtype=torch.float64))
    with pytest.raises(ValueError, match="expected a tensor on cpu, got cpu"):
        day_adjoint.day_adjoint_kernel(*adj._args(r.params, T, zT, hi, cots), **adj._hm._kw(observables=False))
    sources = "".join(p.read_text() for p in cuda_lib.CSRC_DIR.iterdir())
    for gone in ("day_parity_adjoint_kernel", "ParityTape", "parity_substep_adj", "march_nomass_adj", "sub_ws",
                 "cav_u"):
        assert gone not in sources, gone
    assert not hasattr(day_march, "cavity_u_row")


def test_parity_adjoint_dispatch():
    """The C entry hands every parity launch to the parity body, which
    launches every variant of the adjoints' table (kAdjLaunchVariants)
    through adj_launch_variant, and refuses the adaptive no-mass loop as
    heatx does; the wrapper builds the parity units."""
    entry = (cuda_lib.CSRC_DIR / "day_adjoint.cu").read_text()
    assert "heatx_day_adjoint_parity_f32(&g, stream, block_threads)" in entry
    assert "a.parity && (a.refresh_every != 1 || a.nomass_iters < 1)" in entry
    table = re.search(r"kAdjLaunchVariants\[\] = \{(.*?)\};",
                      (cuda_lib.CSRC_DIR / "day_march_args.cuh").read_text()).group(1)
    variants = re.findall(r"\{([\d, ]+)\}", table)
    body = (cuda_lib.CSRC_DIR / "day_adjoint_parity.cu").read_text()
    body = body[body.index("int launch_kind("):]
    body = body[:body.index("\n}\n")]
    assert "adj_launch_variant(g.in.SB)" in body
    assert re.findall(r"case (\d+):", body) == [str(v) for v in range(len(variants))]
    assert re.findall(r"kAdjLaunchVariants\[(\d+)\]\.threads", body) == [str(v) for v in range(len(variants))]
    names = [p.name for p in day_adjoint.KERNEL_SOURCES]
    assert "day_adjoint_parity.cu" in names and "day_adjoint_parity_mrt.cu" in names


def _check_script():
    sys.path.insert(0, str(SCRIPTS))
    import torch_parity_adjoint_check

    return torch_parity_adjoint_check


def _worst(got, ref):
    worst = 0.0
    for x, y in zip(got, ref):
        if y is not None:
            scale = float(y.abs().max())
            d = float((x - y).abs().max())
            worst = max(worst, d / scale if scale else d)
    return worst


@pytest.mark.cuda
def test_cuda_parity_adjoint_most_zone_rows():
    """72 zones in one 96-lane block at their 118 sub-steps an hour: the
    most zone rows of an hour that the one-thread kernel took (its shared
    memory grew with zones x sub-steps); the kernel keeps them in its
    workspace (the 1024-thread variant), f64 against the plain adjoint."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from chip_smoke import parity_zone_rows

    worst, shape = parity_zone_rows(torch, day_adjoint, testing, ThermalModel, SimConfig)
    assert worst <= RTOL and shape[-1] == "G=4/1024"


@pytest.mark.cuda
@pytest.mark.parametrize("surfaces,thermostat", [(256, False), (50, False), (50, True)])
def test_cuda_parity_adjoint_b1_edge(surfaces, thermostat):
    """B1's edge at the coarse discretization (an 8-node wall): one zone of
    256 surfaces (the 1024-thread variant) and of 50 (a 64-lane block, the
    256-thread one), f64 against the plain adjoint."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    hours = 2
    tm = ThermalModel(testing.build_wide_zone_model(surfaces, thermostat=thermostat), n=1,
                      config=testing.coarse_config(torch.float64, 1), device="cuda")
    r = tm.fast_runner(mode="parity", hours=hours)
    T, zT = r.to_blocked(tm.initial_state())
    inputs = testing.demand_inputs if thermostat else testing.bench_inputs
    hi = r.kernel_inputs(inputs(tm.building, hours, device="cuda"), interp_weather=True)[0]
    adj = day_adjoint.make_day_adjoint(r._bb, substeps=tm.dt_subdivisions, mode="parity", hours=hours)
    NB, ZB = r._bb.n_blocks, r._bb.zones_per_block
    rng = np.random.default_rng(surfaces)
    cots = [torch.as_tensor(rng.normal(size=s), dtype=torch.float64, device="cuda")
            for s in (T.shape, zT.shape, (hours, NB, ZB))]
    if thermostat:
        cots.append(torch.as_tensor(rng.normal(size=(hours, NB, ZB)) * 1e-3, device="cuda"))
    args, kw = adj._args(r.params, T, zT, hi, cots), adj._hm._kw(observables=False)
    got = day_adjoint.day_adjoint_kernel(*args, **kw)
    assert day_adjoint.day_adjoint_kernel.block_threads == (1024 if surfaces == 256 else 256)
    assert _worst(got, day_adjoint.plain_day_adjoint(*args, **kw)) <= RTOL


@pytest.mark.cuda
def test_cuda_parity_adjoint_every_kind():
    """Every kind (free-float, thermostats and mixing, schedules, cavities,
    MRT, MRT with cavities) with 1, 2 and 3 no-mass iterations and runs of
    one to four no-mass nodes, f64 against the plain adjoint
    (scripts/torch_parity_adjoint_check.py's cases)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from heatx_torch.build.layout import compile_building

    pac = _check_script()
    worst = pac.check(torch, testing, SimConfig, compile_building, day_march, day_adjoint, cases=pac.cases,
                      log=lambda *a, **k: None)
    assert worst <= RTOL

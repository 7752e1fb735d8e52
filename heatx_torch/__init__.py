"""heatx_torch — the PyTorch/CUDA port of heatx.

A package beside ``heatx`` (which stays the JAX/TPU reference).  It imports
``torch`` and never ``jax``, and carries its own copy of heatx's numpy front
end (model, discretization, layout, blocking), because the GPU host has no
jax.  What runs today, in modes ``trbdf2``, ``trbdf2_refresh`` and
``parity``, on free-float buildings, on buildings with thermostats (ideal
loads), setpoint schedules and inter-zone mixing, and with gas cavities
(double glazing): the day march through
``ThermalModel(...).fast_runner(...).run`` (with ``collect_loads=True``, the
hourly demand; with ``ground_hourly``, monthly soil temperatures swapped in
per dispatch), and its gradient through
``heatx_torch.engine.adjoint.chunked_value_and_grad`` with
``FastRunner.chunk_forward``/``chunk_grad`` (zone-temperature and demand
objectives).  The EnergyPlus front end is here too: ``model.idf.load_idf``
(IDF files), ``weather.epw.read_epw`` and ``weather.solar`` (EPW weather,
computed solar and longwave), so bench.py's office workflow runs end to end.
heatx's XLA-path integrators run too, as plain tensor code on the device:
``ThermalModel.run`` (heatx's default exact parity march with the adaptive
no-mass loop, and the fast modes), ``march``, ``run_checked``, ``warmup``,
``march_imp`` and ``march_exp``; the day march runs the adaptive loop with
``HEATX_KERNEL_WHILE=1``, as heatx's kernel does.
Both day kernels are written in CUDA for Hopper
(``heatx_torch/csrc/day_march_tr.cu``, ``day_march_parity.cu``,
``day_adjoint.cu``) with plain PyTorch
versions beside them.  Models live on the card (``device="cuda"``) unless
the caller asks for ``device="cpu"``, where the plain versions run.
"""

__version__ = "0.5.0"

from heatx_torch.api import FastRunner, ThermalModel  # noqa: F401
from heatx_torch.config import DEFAULT_CONFIG, SimConfig  # noqa: F401
from heatx_torch.engine.state import SimState, StepInputs  # noqa: F401
from heatx_torch.model.building import (  # noqa: F401
    Boundary,
    BuildingModel,
    Construction,
    ElectricHeater,
    GasSubstance,
    IdealHeaterCooler,
    Luminaire,
    Material,
    SiteDetails,
    SpaceDef,
    Substance,
    SurfaceDef,
)

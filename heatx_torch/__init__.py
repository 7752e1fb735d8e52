"""heatx_torch — the PyTorch/CUDA port of heatx.

A package beside ``heatx`` (which stays the JAX/TPU reference).  It imports
``torch`` and never ``jax``, and carries its own copy of heatx's numpy front
end (model, discretization, layout, blocking), because the GPU host has no
jax.  What runs today: the TR-BDF2 day march (modes ``trbdf2`` and
``trbdf2_refresh``) on free-float buildings, through
``ThermalModel(..., device=...).fast_runner(...).run``, with the day kernel
written in CUDA for Hopper (``heatx_torch/csrc/day_march.cu``) and a plain
PyTorch twin on the CPU.
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

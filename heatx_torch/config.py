"""Simulation configuration.

The reference hard-codes its numerical knobs (max_dx=0.04 / min_dt=60 at
model.rs:236-237, SAFETY=2 at model.rs:329) and exposes no options
(``OptionType = ()``, model.rs:190).  heatx promotes them into a config
dataclass, and this is heatx_torch's copy of the fields the port reads:
``dtype`` is a ``torch.dtype``.  heatx's parity-integrator and XLA-path
knobs (the no-mass fixed-point tolerances, ``nomass_fixed_iters``,
``flush_tiny``, ``kernel_mode``, ``unroll_fixed_loops``, ``surface_axis``)
come with the slices that use them (ROADMAP A7, A10, A12).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Numerical and execution configuration for a compiled simulation."""

    # Device dtype for the marching state: torch.float32 on the GPU; the
    # tests compare against heatx in torch.float64 on the CPU.
    dtype: torch.dtype = torch.float32

    # Discretization knobs (model.rs:236-237, model.rs:329).
    max_dx: float = 0.04
    min_dt: float = 60.0
    safety: int = 2

    # Reproduce the reference's back-side AmbientTemperature boundary reusing
    # *front* surface values (surface.rs:672-686) — an apparent upstream bug,
    # kept by default for fixture parity. Set False for the physically
    # sensible behavior.
    replicate_ambient_back_bug: bool = True

    # Contact coefficient for Boundary.ground faces (W/m2K): the face
    # couples conductively to soil at the boundary's temperature instead of
    # through a convective film (carried in the fixed-h channel).
    ground_contact_h: float = 20.0

    # Interior longwave exchange through Carroll's MRT network (heatx
    # extension).  Not ported yet: the day march raises on it (ROADMAP A9).
    interior_mrt: bool = False

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = SimConfig()

"""Simulation configuration.

The reference hard-codes its numerical knobs (max_dx=0.04 / min_dt=60 at
model.rs:236-237, SAFETY=2 at model.rs:329) and exposes no options
(``OptionType = ()``, model.rs:190).  heatx promotes them into a config
dataclass, and this is heatx_torch's copy of the fields the port reads:
``dtype`` is a ``torch.dtype``.  ``kernel_mode`` and ``unroll_fixed_loops``
are switches for heatx's Mosaic lowering and have no counterpart here;
``surface_axis`` comes with sharding (ROADMAP A12).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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

    # No-mass fixed-point solve of the parity integrator (surface.rs:808-896):
    # mean-error tolerance, escalated tolerance after `escalate_after`
    # iterations, and a hard iteration cap for the adaptive loop (the
    # reference loops unbounded with an assert bomb at surface.rs:869-877).
    nomass_tol: float = 0.01
    nomass_tol_escalated: float = 0.5
    nomass_escalate_after: int = 100
    nomass_max_iter: int = 500

    # Run exactly this many relaxed fixed-point iterations per sub-step, with
    # the same per-chunk update/convergence masking, instead of iterating to
    # tolerance.  None = the reference-exact adaptive loop; the parity day
    # march runs it only with HEATX_KERNEL_WHILE=1, as heatx's kernel does.
    nomass_fixed_iters: Optional[int] = None

    # Flush RK4 stage values below 1e-25 to zero: read by
    # ``engine.surface.march_surfaces`` and by the plain parity hour it runs
    # in.  The day-march path overrides it to False (``ops.day_march.HourMarch``):
    # the kernel never flushes, as heatx's kernel path does not.
    flush_tiny: bool = True

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
    # extension): every integrator, the day march's kernels included.
    interior_mrt: bool = False

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = SimConfig()

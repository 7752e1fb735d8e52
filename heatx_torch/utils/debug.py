"""NaN/Inf guards for simulation state.

heatx_torch copy of ``heatx.utils.debug``.  The reference guards with
runtime ``assert!`` on NaN temperatures (model.rs:416-419,
surface.rs:704-707); the port offers explicit checks to call between
(batches of) marches.  The count is reduced on the state's device and only
the per-channel totals reach the host.
"""

from __future__ import annotations

import dataclasses

import torch

from heatx_torch.engine.state import SimState


def check_state_finite(state: SimState) -> dict:
    """Count of non-finite entries per state channel."""
    out = {}
    for f in dataclasses.fields(SimState):
        arr = getattr(state, f.name)
        if arr is None:  # optional channel (e.g. ideal_load) absent
            continue
        a = torch.as_tensor(arr)
        bad = int((~torch.isfinite(a)).sum()) if a.is_floating_point() else 0
        if bad:
            out[f.name] = bad
    return out


def assert_state_finite(state: SimState, context: str = ""):
    """Raise with channel names if any state entry is NaN/Inf
    (the port's equivalent of the reference's NaN asserts)."""
    bad = check_state_finite(state)
    if bad:
        raise FloatingPointError(
            f"non-finite simulation state{' at ' + context if context else ''}: {bad}"
        )

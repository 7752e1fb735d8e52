"""Checkpoint / resume for simulation state.

heatx_torch copy of ``heatx.io.checkpoint``: the same ``.npz`` file, with
the same keys (``step`` and one array per :class:`SimState` channel), so a
checkpoint written by either package loads in the other.  The state is the
whole simulation state (the reference's flat ``SimulationState`` vector,
SURVEY.md section 5); saving it moves each channel to the host once.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from heatx_torch.engine.state import SimState

#: Channels ``save_state`` may legitimately omit.
_OPTIONAL = {"ideal_load"}


def save_state(path: str, state: SimState, step: int = 0) -> str:
    """Serialize a SimState (and the step counter) to ``path``; returns the
    actual file path.  ``np.savez`` appends ``.npz`` when missing; the
    suffix is normalized here so a later ``load_state`` with the SAME path
    string round-trips."""
    if not str(path).endswith(".npz"):
        path = f"{path}.npz"
    arrays = {}
    for f in dataclasses.fields(SimState):
        v = getattr(state, f.name)
        if v is not None:
            arrays[f.name] = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    np.savez(path, step=np.int64(step), **arrays)
    return path


def load_state(path: str, dtype=None, building=None, device="cuda"):
    """Load a SimState onto ``device`` (the card unless the caller asks for
    another); returns ``(state, step)``.  ``dtype`` is a torch dtype (None:
    the file's).

    Pass ``building`` to reconcile optional channels with the model the
    state will march: a checkpoint without ``ideal_load`` loaded into a
    building with thermostats gets a zero-initialized channel, and one WITH
    the channel loaded into an uncontrolled building drops it."""
    from heatx_torch.ops.cuda_lib import resolve_device

    device = resolve_device(device)
    if not os.path.exists(path) and not str(path).endswith(".npz"):
        if os.path.exists(f"{path}.npz"):
            path = f"{path}.npz"  # save_state's normalized suffix

    with np.load(path) as d:
        step = int(d["step"])
        kw = {}
        for f in dataclasses.fields(SimState):
            k = f.name
            if k not in d:
                if k not in _OPTIONAL:
                    raise KeyError(
                        f"checkpoint {path!r} is missing required state "
                        f"channel {k!r} (truncated or foreign file?)"
                    )
                kw[k] = None  # optional channel absent
                continue
            kw[k] = torch.as_tensor(d[k], dtype=dtype, device=device)
        if building is not None:
            if building.has_ideal_hvac and kw.get("ideal_load") is None:
                kw["ideal_load"] = torch.zeros(
                    (building.n_zones,), dtype=dtype or building.config.dtype, device=device
                )
            elif not building.has_ideal_hvac:
                kw["ideal_load"] = None
        return SimState(**kw), step

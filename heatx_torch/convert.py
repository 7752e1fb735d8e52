"""Carry a building across from ``heatx`` to ``heatx_torch``.

Both functions take plain numpy arrays in dicts, so this module imports
nothing of heatx (or jax): the caller flattens heatx's objects.  With them,
the two packages compute on the very same operands.

* :func:`building_from_arrays` rebuilds a :class:`CompiledBuilding` from the
  fields of heatx's ``CompiledBuilding`` (``surfaces`` given as a dict of the
  ``SurfaceBatch`` fields, ``cav_gas`` as its 7 arrays; ``config`` as a dict
  of ``SimConfig`` fields with a numpy ``dtype``).
* :func:`params_from_kernel_operands` turns heatx's ``make_hour_march``
  operands (a single node-height part, i.e. ``block_building(...,
  node_split=None)``), named by heatx's operand names, into the port's
  :class:`~heatx_torch.ops.day_march.DayMarchParams`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from heatx_torch.build.layout import CompiledBuilding, SurfaceBatch
from heatx_torch.config import SimConfig
from heatx_torch.ops.day_march import (
    CAV_FIELDS, MRT_FIELDS, SHADE_FIELDS, SURF_FIELDS, DayMarchParams, local_zone,
    mix_lists_from_dense, pack_params,
)
from heatx_torch.physics.gas import GasProps

#: heatx's names for the four thermostat operand rows, in kernel order.
CTL_NAMES = ("ctl_heat_sp", "ctl_cool_sp", "ctl_max_heat", "ctl_max_cool")
#: heatx's names for the gas-cavity operands, in ``CAV_FIELDS`` order.
CAV_NAMES = (
    "cav_k0", "cav_k1", "cav_mu0", "cav_mu1", "cav_cp0", "cav_cp1", "cav_mass",
    "cav_thickness", "cav_height", "cav_angle", "cav_ein", "cav_eout",
)

_TORCH_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}


def config_from_dict(d: dict) -> SimConfig:
    """SimConfig from a dict of heatx SimConfig fields (numpy ``dtype``)."""
    d = dict(d)
    d["dtype"] = _TORCH_DTYPES[np.dtype(d["dtype"])]
    names = {f.name for f in dataclasses.fields(SimConfig)}
    return SimConfig(**{k: v for k, v in d.items() if k in names})


def building_from_arrays(fields: dict) -> CompiledBuilding:
    """CompiledBuilding from heatx CompiledBuilding fields (see module doc)."""
    fields = dict(fields)
    sb = dict(fields.pop("surfaces"))
    sb["cav_gas"] = GasProps(*sb["cav_gas"])
    fields["config"] = config_from_dict(fields["config"])
    fields.setdefault("discretizations", [])
    return CompiledBuilding(surfaces=SurfaceBatch(**sb), **fields)


def params_from_kernel_operands(
    ops: dict, n_blocks: int, dtype=torch.float64, device="cpu"
) -> DayMarchParams:
    """DayMarchParams from heatx ``make_hour_march`` operands.

    ``ops`` holds the node arrays ``node_mask``, ``mass``, ``massive``,
    ``seg_u``, ``same_chunk``, ``front_alphas``, ``back_alphas`` ([N, SP];
    ``same_chunk``, which only the parity march reads, may be absent and is
    then derived from the masks); the lane rows
    ``area`` ... ``normal_y``, ``front_code``, ``back_code`` ([1, SP] or
    [SP]); the zone one-hots ``front_oh``/``back_oh`` ([SP, ZB]; absent when
    no face of that side bounds a zone); ``zone_volume`` ([NB*8, ZB],
    heatx's 8-row padded zone rows, or [NB, ZB]); and, where the building
    has them, the thermostat rows ``ctl_heat_sp``, ``ctl_cool_sp``,
    ``ctl_max_heat``, ``ctl_max_cool`` (zone rows like ``zone_volume``) and
    the dense mixing matrix ``mix_wt`` ([NB*ZB, ZB], ``[block*ZB + from,
    to]``), which becomes the port's entry lists, and the gas-cavity operands
    ``seg_is_cavity`` and CAV_NAMES ([N, SP]), and the Carroll network's
    effective emissivities ``mrt_eps_f``/``mrt_eps_b`` ([1, SP]; heatx
    leaves out a side on which no face takes part, which the port carries as
    a zero row), and the in-run controls: the zone-shading gather
    ``shade_ohT`` ([NB*ZB, SB], heatx's transposed one-hot of each lane's
    controlling zone, which becomes the port's block-local slot per lane)
    with its ``shade_tau``/``shade_sp`` rows ([1, SP]), and the ventilation
    gates' indoor limits ``vent_min``/``vent_max`` (zone rows like
    ``zone_volume``)."""
    node_mask = np.asarray(ops["node_mask"], bool)
    SP = node_mask.shape[1]
    ZB = np.asarray(ops["zone_volume"]).shape[-1]

    def zone_rows(a):
        a = np.asarray(a)
        return a if a.shape[0] == n_blocks else a.reshape(n_blocks, -1, ZB)[:, 0]

    zv = zone_rows(ops["zone_volume"])
    ctl = None
    if "ctl_heat_sp" in ops:
        ctl = [zone_rows(ops[k]) for k in CTL_NAMES]
    mix = mix_lists_from_dense(ops["mix_wt"]) if "mix_wt" in ops else None
    mass = np.asarray(ops["mass"], np.float64)
    massive = np.asarray(ops["massive"], bool)
    capacity = np.where(massive, mass, 0.0)
    zero_oh = np.zeros((SP, ZB))
    seg_is_cavity = ops.get("seg_is_cavity")
    cav = None
    if seg_is_cavity is not None and np.asarray(seg_is_cavity).any():
        cav = {k: np.asarray(ops[n]) for k, n in zip(CAV_FIELDS, CAV_NAMES)}
    shade = None
    if "shade_ohT" in ops:
        oh = np.asarray(ops["shade_ohT"]).reshape(n_blocks, ZB, -1).transpose(0, 2, 1).reshape(SP, ZB)
        shade = (local_zone(oh), *(np.asarray(ops[k]).reshape(SP) for k in SHADE_FIELDS))
    vent = [zone_rows(ops[k]) for k in ("vent_min", "vent_max")] if "vent_min" in ops else None
    mrt = None
    if "mrt_eps_f" in ops or "mrt_eps_b" in ops:
        mrt = np.stack([np.asarray(ops.get(n, np.zeros(SP))).reshape(SP) for n in MRT_FIELDS])
    return pack_params(
        node_mask, massive, capacity, ops["seg_u"], ops["front_alphas"], ops["back_alphas"],
        {k: np.asarray(ops[k]).reshape(SP) for k in SURF_FIELDS},
        np.asarray(ops["front_code"]).reshape(SP),
        np.asarray(ops["back_code"]).reshape(SP),
        ops.get("front_oh", zero_oh), ops.get("back_oh", zero_oh), zv, n_blocks,
        dtype=dtype, device=device, ctl=ctl, mix=mix, same_chunk=ops.get("same_chunk"),
        seg_is_cavity=seg_is_cavity, cav=cav, mrt=mrt, shade=shade, vent=vent,
    )

"""Ensemble simulation: many building variants in one march.

PyTorch counterpart of ``heatx.ensemble``, with its public names.  A
population of variants that share one compiled layout (the same node
counts, static flags, ``SimConfig`` and ``dt_subdivisions``) stacks field by
field into one building with a leading ``[E]`` axis (:func:`stack_pytrees`),
and every member marches at once: design sweeps, Monte-Carlo uncertainty
and population calibration are one batched march instead of E runs.

heatx vmaps its XLA step over the member axis.  Here the member axis is
folded into the building: the E members laid end to end are one building of
``E x S`` surfaces and ``E x Z`` zones whose zones never meet (member ``e``
holds surfaces ``[e*S, (e+1)*S)`` and zones ``[e*Z, (e+1)*Z)``).  Two
engines march it:

* ``engine="kernel"``: the day march (``ops.day_march``: the CUDA kernel on
  the card, its plain version on the CPU), the route heatx's docstring names
  the fastest ("replicate the variants into one BuildingModel ... blocks are
  zone-closed, so members never interact").  The folded building is
  blocked as any building is (its members are zone components of their own,
  packed first-fit into blocks of the largest member's lanes), so ONE launch
  a day marches the whole population.  Modes: ``trbdf2`` is the frozen
  day march (the refresh kernel with ``refresh_every = substeps``), ``parity``
  the parity day march at the building's ``dt_subdivisions`` (heatx's
  default ``nomass_fixed_iters=None`` admits the adaptive no-mass loop, as
  ``sizing`` does).  A gradient (a tensor that requires grad in the building
  fields the day adjoint differentiates, the state or the inputs) runs each
  day through ``day_adjoint.DayMarchFn``: one backward launches the day
  adjoint once a day for the whole population.  The kernel reads one weather
  series a launch, so members whose weather differs go in groups that share
  it, each group its own launch a day (``last_groups``).
* ``engine="xla"``: heatx's own way, the XLA-path integrators
  (``engine.step.run``, ``engine.implicit.imp_march``,
  ``engine.exponential.exp_march``) on the folded building, in every mode,
  differentiable where heatx's ``jax.grad`` is (fixed no-mass iterations and
  the fast modes).  The adaptive no-mass loop iterates while any member's
  run is active and holds the others where they stopped, which is what
  heatx's ``vmap`` of a ``while_loop`` does: each member equals its solo run.
* ``engine="auto"`` (the default): the kernel on the card for ``parity`` and
  ``trbdf2``, the XLA route on the CPU and for ``exponential``.

No route gives way to another: under ``"kernel"`` a request the day march
cannot take raises and names the reason (``mode="exponential"``, weather
given per sub-step, a gradient into fields the day adjoint does not
differentiate, or through the adaptive loop or in-run gates).
``last_engine`` names the engine of the last call.  A building whose
``n_steps_per_hour`` is above 1 takes the kernel too: a day-march "hour" is
one main step.

``shard_ensemble`` waits for the port's multi-GPU item (ROADMAP A12).

Results are tensors on ``device`` (the card unless the caller asks for the
CPU).  A stacked building is a container of ``[E, ...]`` arrays for this
module's functions; its shape properties (``n_surfaces``) are a member's
only after :func:`member`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from heatx_torch.build.layout import CompiledBuilding
from heatx_torch.engine import exponential as exp_mod
from heatx_torch.engine import implicit as imp_mod
from heatx_torch.engine import step as step_mod
from heatx_torch.engine.adjoint import tree_flatten, tree_map
from heatx_torch.engine.state import SimState, StepInputs, initial_state
from heatx_torch.ops import day_march
from heatx_torch.ops.cuda_lib import resolve_device

__all__ = [
    "stack_pytrees",
    "ensemble_initial_state",
    "make_run",
    "ensemble_run",
    "run_param_ensemble",
    "shard_ensemble",
    "member",
    "fold_building",
    "apply_members",
    "population_runner",
    "fold_state",
    "fold_inputs",
]

ENGINES = ("auto", "kernel", "xla")

#: The engine of the last call ("kernel" or "xla").
last_engine: Optional[str] = None
#: The kernel route's weather groups of the last call: one list of member
#: indices per group, each group its own launch a day.  None after an XLA-route call.
last_groups: Optional[list] = None

# Surface and zone fields whose values index zones (offset by each member's
# first zone when the members are laid end to end).
_ZONE_INDEX = ("front_space", "back_space", "lum_space", "hvac_pair_space", "mix_src", "mix_dst",
               "shade_zone")
_WEATHER = ("t_out", "wind_speed", "wind_direction")


# ---------------------------------------------------------------------------
# Stacking
# ---------------------------------------------------------------------------


def _is_array(v) -> bool:
    return isinstance(v, (np.ndarray, np.generic, torch.Tensor))


def _flatten(tree, in_dataclass=False):
    """``(leaves, statics, rebuild)`` of a tree: dicts, lists, tuples (named
    ones too) and dataclasses are containers; arrays and tensors are leaves,
    and so are numbers inside dicts, lists and tuples.  Frozen dataclasses
    (``SimConfig``), numbers and flags held by a dataclass, and None are
    static, as heatx's registered aux data are; ``CompiledBuilding``'s
    host-side ``discretizations`` are dropped, as heatx drops them."""
    if tree is None or (isinstance(tree, (bool, int, float, str)) and in_dataclass):
        return [], [tree], lambda leaves: tree
    if _is_array(tree) or isinstance(tree, (bool, int, float)):
        return [tree], [], lambda leaves: leaves[0]
    if isinstance(tree, dict):
        keys, parts = list(tree), [_flatten(v) for v in tree.values()]
        make = lambda out: dict(zip(keys, out))  # noqa: E731
        tag = ("dict", tuple(keys))
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        if tree.__dataclass_params__.frozen:
            return [], [tree], lambda leaves: tree
        keys = [f.name for f in dataclasses.fields(tree)
                if not (isinstance(tree, CompiledBuilding) and f.name == "discretizations")]
        parts = [_flatten(getattr(tree, k), in_dataclass=True) for k in keys]
        extra = {"discretizations": []} if isinstance(tree, CompiledBuilding) else {}
        make = lambda out: dataclasses.replace(tree, **dict(zip(keys, out)), **extra)  # noqa: E731
        tag = (type(tree).__name__, tuple(keys))
    elif isinstance(tree, (list, tuple)):
        parts = [_flatten(v) for v in tree]
        make = (lambda out: type(tree)(*out)) if hasattr(tree, "_fields") else (lambda out: type(tree)(out))
        tag = (type(tree).__name__, len(tree))
    else:
        return [], [tree], lambda leaves: tree
    sizes = [len(p[0]) for p in parts]

    def rebuild(leaves):
        out, i = [], 0
        for (_, _, fn), n in zip(parts, sizes):
            out.append(fn(leaves[i:i + n]))
            i += n
        return make(out)

    statics = [tag] + [s for p in parts for s in p[1]]
    return [leaf for p in parts for leaf in p[0]], statics, rebuild


def _same_static(a, b) -> bool:
    try:
        return bool(a == b)
    except (TypeError, ValueError):  # an ambiguous comparison is a mismatch
        return a is b


def stack_pytrees(trees: Sequence[Any]):
    """Stack identically structured trees leaf-wise along a new leading
    ensemble axis (heatx ``stack_pytrees``): ``CompiledBuilding``,
    ``SimState``, ``StepInputs`` or any parameter tree of dicts, lists,
    tuples and dataclasses.

    The structure, static fields included (node counts, flags,
    ``SimConfig``, ``dt_subdivisions``), and every leaf's shape and dtype
    must match member 0's: the shared compiled layout.  Otherwise
    ``ValueError``, with heatx's messages.  Leaves stack as numpy arrays, or
    as tensors where a member's leaf is a tensor (autograd kept); a leaf
    that is the same object in every member is broadcast, not copied."""
    if not trees:
        raise ValueError("stack_pytrees needs at least one tree")
    leaves0, statics0, rebuild = _flatten(trees[0])
    cols = [[leaf] for leaf in leaves0]
    shapes = [(tuple(np.shape(leaf)), _dtype(leaf)) for leaf in leaves0]
    for i, t in enumerate(trees[1:], start=1):
        leaves, statics, _ = _flatten(t)
        if len(statics) != len(statics0) or len(leaves) != len(leaves0) or not all(
                _same_static(a, b) for a, b in zip(statics, statics0)):
            raise ValueError(
                f"ensemble member {i} has a different compiled structure "
                f"than member 0 (layouts/configs must match):\n{statics}\nvs\n{statics0}"
            )
        for col, (shape, dtype), leaf in zip(cols, shapes, leaves):
            if (tuple(np.shape(leaf)), _dtype(leaf)) != (shape, dtype):
                raise ValueError(
                    f"ensemble member {i} leaf shape/dtype {tuple(np.shape(leaf))}/{_dtype(leaf)} "
                    f"!= member 0 {shape}/{dtype}"
                )
            col.append(leaf)
    return rebuild([_stack(col) for col in cols])


def _dtype(leaf):
    if isinstance(leaf, torch.Tensor):
        return torch.empty((), dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


def _stack(col):
    if any(isinstance(x, torch.Tensor) for x in col):
        dev = next(x.device for x in col if isinstance(x, torch.Tensor))
        return torch.stack([torch.as_tensor(x, device=dev) for x in col])
    if all(x is col[0] for x in col):
        return np.broadcast_to(np.asarray(col[0]), (len(col),) + np.shape(col[0]))
    return np.stack([np.asarray(x) for x in col])


def member(tree_e, i: int):
    """Member ``i`` of a stacked tree (every leaf's row ``i``)."""
    leaves, _, rebuild = _flatten(tree_e)
    return rebuild([x[i] for x in leaves])


def _n_members(tree_e) -> int:
    leaves = _flatten(tree_e)[0]
    if not leaves:
        raise ValueError("a stacked tree needs at least one array leaf")
    return int(np.shape(leaves[0])[0])


def ensemble_initial_state(building_e: CompiledBuilding, n_members: int, device="cuda") -> SimState:
    """Fresh ``[E, ...]`` state of a stacked building (heatx
    ``ensemble_initial_state``): every member starts at the reference's
    registered initial values, on ``device``."""
    st = initial_state(member(building_e, 0), device=resolve_device(device))
    return tree_map(lambda x: x[None].expand((n_members,) + tuple(x.shape)), st)


# ---------------------------------------------------------------------------
# The folded population: E members laid end to end
# ---------------------------------------------------------------------------


def _xp_moveaxis(x, src, dst):
    return torch.movedim(x, src, dst) if isinstance(x, torch.Tensor) else np.moveaxis(x, src, dst)


def _own(x):
    """A folded array that owns its (writable) memory; tensors as they are."""
    return x if isinstance(x, torch.Tensor) else np.array(x)


def _fold_surface(x, E):
    """``[E, ..., S]`` -> ``[..., E*S]`` (member-major on the surface axis)."""
    y = _xp_moveaxis(x, 0, -2)
    return _own(y.reshape(tuple(y.shape[:-2]) + (-1,)))


def _offset(x, step, where_valid=False):
    """Add each member's offset ``e * step`` to a stacked index array."""
    E = x.shape[0]
    off = np.arange(E).reshape((E,) + (1,) * (x.ndim - 1)) * step
    if isinstance(x, torch.Tensor):
        off = torch.as_tensor(off, device=x.device, dtype=x.dtype)
        return torch.where(x >= 0, x + off, x) if where_valid else x + off
    x = np.asarray(x)
    return np.where(x >= 0, x + off, x) if where_valid else x + off


def fold_building(building_e: CompiledBuilding) -> CompiledBuilding:
    """A stacked building's members laid end to end as one building: member
    ``e``'s surfaces ``[e*S, (e+1)*S)``, zones ``[e*Z, (e+1)*Z)``, HVAC units
    and luminaires likewise, their zone indices offset.  Tensor fields keep
    their autograd graph."""
    E = _n_members(building_e)
    b0 = building_e
    Z = b0.n_zones
    sb = b0.surfaces
    upd = {}
    for f in dataclasses.fields(sb):
        v = getattr(sb, f.name)
        if not (_is_array(v) or isinstance(v, tuple)):
            continue
        if isinstance(v, tuple):  # GasProps, each field [E, N, S]
            upd[f.name] = type(v)(*(_fold_surface(x, E) for x in v))
        elif f.name == "normal":  # [E, S, 3]
            upd[f.name] = _own(v.reshape((-1, v.shape[-1])))
        else:
            upd[f.name] = _fold_surface(_offset(v, Z) if f.name in _ZONE_INDEX else v, E)
    out = {"surfaces": dataclasses.replace(sb, **upd)}
    for f in dataclasses.fields(b0):
        v = getattr(b0, f.name)
        if f.name == "surfaces" or not _is_array(v):
            continue
        if f.name == "hvac_pair_unit":
            v = _offset(v, b0.n_hvacs)
        elif f.name in _ZONE_INDEX:
            v = _offset(v, Z, where_valid=f.name == "shade_zone")
        out[f.name] = _own(v.reshape((-1,) + tuple(v.shape[2:])))
    return dataclasses.replace(
        b0, **out, n_zones=E * Z, n_hvacs=E * b0.n_hvacs, n_luminaires=E * b0.n_luminaires,
        n_real_surfaces=E * b0.n_real_surfaces, discretizations=[],
    )


def fold_state(st: SimState, idx) -> SimState:
    """Members ``idx`` of an ``[E, ...]`` state as the state of their folded
    building (:func:`fold_building`)."""
    def f(name, x):
        if x is None:
            return None
        x = x[idx]
        return _fold_surface(x, len(idx)) if name == "node_T" else x.reshape(-1)

    return SimState(**{k.name: f(k.name, getattr(st, k.name)) for k in dataclasses.fields(st)})


def _unfold_state(st: SimState, G: int) -> SimState:
    def f(name, x):
        if x is None:
            return None
        if name == "node_T":
            return torch.movedim(x.reshape(x.shape[0], G, -1), 1, 0)
        return x.reshape(G, -1)

    return SimState(**{k.name: f(k.name, getattr(st, k.name)) for k in dataclasses.fields(st)})


def _entity_count(name, b: CompiledBuilding) -> int:
    if name in ("sol_front", "sol_back", "ir_front", "ir_back", "shade_sp"):
        return b.n_surfaces
    if name == "hvac_power":
        return b.n_hvacs
    if name == "lum_power":
        return b.n_luminaires
    if name == "mix_vol":
        return int(np.asarray(b.mix_src).shape[0])
    return b.n_zones


def _canon(name, v, T, n, batched):
    """An input channel of one member (or ``[G, ...]`` of several, with
    ``batched``) as ``[(G,) T, n]``: scalar, ``[n]`` and ``[1, n]`` held over
    the T steps, a ``[T]`` series (the reading that wins when ``T == n``, as
    in heatx) one value for all ``n``, ``[T, n]`` and ``[T, 1]`` as they are."""
    lead = tuple(v.shape[:1]) if batched else ()
    shape = tuple(v.shape[1:]) if batched else tuple(v.shape)
    if len(shape) == 0:
        w = v.reshape(lead + (1, 1))
    elif len(shape) == 1 and shape[0] == T:
        w = v.reshape(lead + (T, 1))
    elif len(shape) == 1 and shape[0] == n:
        w = v.reshape(lead + (1, n))
    elif len(shape) == 2 and shape[0] in (1, T) and shape[1] in (1, n):
        w = v
    else:
        raise ValueError(f"input channel {name} of shape {shape} not understood (T={T}, n={n})")
    return w.expand(lead + (T, n))


def fold_inputs(seq: StepInputs, axes: dict, b0: CompiledBuilding, idx, T, dtype, device) -> StepInputs:
    """The inputs of members ``idx`` as their folded building's ``[T, ...]``
    sequence: weather as the group's one series (member ``idx[0]``'s where it
    is per member), every other channel ``[T, G*n]`` (member-major).
    ``axes`` maps the channels given per member (``[E, T, ...]``) to 0;
    ``b0`` is one member's building."""
    G = len(idx)
    sel = torch.as_tensor(idx, device=device)
    out = {}
    for f in dataclasses.fields(StepInputs):
        v = getattr(seq, f.name)
        if v is None:
            out[f.name] = None
            continue
        per = axes.get(f.name) == 0
        v = torch.as_tensor(v, device=device)
        if v.is_floating_point():
            v = v.to(dtype)
        if f.name in _WEATHER:
            out[f.name] = v[idx[0]] if per else v
            continue
        n = _entity_count(f.name, b0)
        if per:
            w = _canon(f.name, v[sel], T, n, batched=True)  # [G, T, n]
            out[f.name] = torch.movedim(w, 0, 1).reshape(T, G * n)
        else:
            out[f.name] = _canon(f.name, v, T, n, batched=False).repeat(1, G)
    return StepInputs(**out)


def _input_axes(inputs_axes) -> dict:
    """heatx's ``inputs_axes`` (None: shared; 0: every leaf per member; a
    StepInputs or dict of per-channel 0/None) as {channel: 0}."""
    names = [f.name for f in dataclasses.fields(StepInputs)]
    if inputs_axes is None:
        return {}
    if inputs_axes == 0 and not isinstance(inputs_axes, bool):
        return {k: 0 for k in names}
    items = (inputs_axes.items() if isinstance(inputs_axes, dict)
             else ((k, getattr(inputs_axes, k)) for k in names))
    out = {}
    for k, a in items:
        if a not in (None, 0):
            raise ValueError(f"inputs_axes: channel {k} has axis {a!r}; only 0 and None are taken")
        if a == 0:
            out[k] = 0
    return out


def _weather_groups(seq: StepInputs, axes: dict, E: int, device):
    """Members grouped by their weather series (t_out, wind, direction):
    lists of member indices in order of their first member."""
    if not any(axes.get(k) == 0 for k in _WEATHER):
        return [list(range(E))]
    rows = []
    for k in _WEATHER:
        v = torch.as_tensor(getattr(seq, k), device=device).to(torch.float64)
        v = v if axes.get(k) == 0 else v[None].expand((E,) + tuple(v.shape))
        rows.append(v.reshape(E, -1))
    _, inv = torch.unique(torch.cat(rows, dim=1), dim=0, return_inverse=True)
    inv = inv.tolist()
    groups = {}
    for i, g in enumerate(inv):
        groups.setdefault(g, []).append(i)
    return sorted(groups.values(), key=lambda m: m[0])


def _steps(seq: StepInputs, axes: dict) -> int:
    t = torch.as_tensor(seq.t_out)
    return int(t.shape[1] if axes.get("t_out") == 0 else t.shape[0])


# ---------------------------------------------------------------------------
# The two routes
# ---------------------------------------------------------------------------


def _check_mode(mode, substeps):
    if mode == "parity":
        if substeps is not None:
            # Parity marches the stability-dictated dt_subdivisions; a
            # substeps request would otherwise be silently ignored.
            raise ValueError(
                "mode='parity' marches the building's dt_subdivisions; "
                "substeps applies to 'trbdf2'/'exponential' only"
            )
        return None
    if mode not in ("trbdf2", "exponential"):
        raise ValueError(f"unknown mode {mode!r} (parity | trbdf2 | exponential)")
    return 8 if substeps is None else int(substeps)


def _pick_engine(engine: str, mode: str, device: torch.device) -> str:
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    if engine == "auto":
        return "kernel" if device.type == "cuda" and mode != "exponential" else "xla"
    return engine


def _requires_grad(tree) -> bool:
    return any(isinstance(x, torch.Tensor) and x.requires_grad for x in _flatten(tree)[0])


def _hours_per_launch(T: int) -> int:
    """A day a launch where the steps make whole days, else the largest
    divisor of T up to 24."""
    return max(h for h in range(1, 25) if T % h == 0)


def _detached(building):
    """The building with every tensor field as a host numpy array (the
    blocking's input)."""
    leaves, _, rebuild = _flatten(building)
    return rebuild([x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x for x in leaves])


def _kernel_route(building_e, state_e, seq, axes, E, T, mode, substeps, collect_zone_T,
                  collect_loads, device):
    """The population through the day march: one launch a day per weather group."""
    global last_groups
    if mode == "exponential":
        raise ValueError(
            "engine='kernel': mode='exponential' has no day march (heatx's Pallas kernels "
            "carry TR-BDF2 and parity only); use engine='xla'"
        )
    for k in _WEATHER:
        v = torch.as_tensor(getattr(seq, k))
        if v.ndim != 1 + (axes.get(k) == 0):
            raise ValueError(
                f"engine='kernel': weather channel {k} of shape {tuple(v.shape)}; the day march "
                "takes one value a main step ([T], or [E, T] per member)"
            )
    b_np = _detached(building_e)
    b0 = member(b_np, 0)
    grad = _requires_grad(building_e) or _requires_grad(state_e) or _requires_grad(seq)
    groups = _weather_groups(seq, axes, E, device)
    last_groups = groups
    outs = []
    for idx in groups:
        pick = (lambda x: x[idx]) if len(idx) < E else (lambda x: x)
        xs = fold_inputs(seq, axes, b0, idx, T, b0.config.dtype, device)
        runner = population_runner(
            _map_leaves(pick, b_np), mode, substeps, _hours_per_launch(T), device,
            scheduled_setpoints=xs.heat_sp is not None or xs.cool_sp is not None)
        st = fold_state(state_e, idx)
        if not grad:
            with torch.no_grad():
                r = runner.run(st, xs, collect_zone_T=collect_zone_T, collect_loads=collect_loads,
                               assert_finite=False)
            final, zt, loads = r[0], r[1], (r[2] if collect_loads else None)
        else:
            final, zt, loads = runner.grad_run(fold_building(_map_leaves(pick, building_e)), st, xs,
                                               collect_loads, who="engine='kernel': the population")
            zt = zt if collect_zone_T else None
        if final.ideal_load is None and b0.has_ideal_hvac and loads is not None:
            final.ideal_load = loads[-1]
        outs.append((idx, final, zt, loads))
    return _assemble(outs, E, T, collect_zone_T, collect_loads)


def population_runner(building_e, mode: str = "trbdf2", substeps: int = None, hours: int = 24,
                      device="cuda", use_kernel: bool = True, scheduled_setpoints: bool = False):
    """The ``FastRunner`` of the kernel route over a stacked building: its
    members folded into one building (:func:`fold_building`), whose
    zone-closed blocks hold them all, so that one launch a day marches the
    population.  ``mode`` is ``"trbdf2"`` (the frozen day march,
    ``substeps`` default 8) or ``"parity"`` (the building's
    ``dt_subdivisions``, the adaptive no-mass loop admitted);
    ``use_kernel=False`` runs the day march's plain versions even on the
    card (the reference the kernels are held against).  Its ``run`` takes
    :func:`fold_state`/:func:`fold_inputs` of the members; ``grad_run``
    differentiates."""
    from heatx_torch.api import FastRunner, ThermalModel

    if mode == "trbdf2" and substeps is None:
        substeps = 8
    tm = ThermalModel.from_building(fold_building(_detached(building_e)), device=device)
    return FastRunner(
        tm, mode=mode, substeps=substeps, hours=hours, scheduled_setpoints=scheduled_setpoints,
        use_kernel=use_kernel, adaptive_nomass=True,
    )


def _map_leaves(fn, tree):
    """``fn`` over the array leaves of a (stacked) tree; statics kept."""
    leaves, _, rebuild = _flatten(tree)
    return rebuild([fn(x) for x in leaves])


def _xla_route(building_e, state_e, seq, axes, E, T, mode, substeps, collect_zone_T,
               collect_loads, device):
    """The population through the XLA-path integrators, the member axis folded
    into the building; one run per weather group."""
    global last_groups
    last_groups = None
    b0 = member(building_e, 0)
    if mode == "trbdf2":
        march_fn = functools.partial(imp_mod.imp_march, substeps=substeps)
    elif mode == "exponential":
        march_fn = functools.partial(exp_mod.exp_march, substeps=substeps)
    else:
        march_fn = None
    if collect_loads and not b0.has_ideal_hvac:
        raise ValueError(
            "collect_loads requires setpoint-driven HVAC "
            "(IdealHeaterCooler with heat_setpoint/cool_setpoint)"
        )
    outs = []
    for idx in _weather_groups(seq, axes, E, device):
        G = len(idx)
        pick = (lambda x: x[idx]) if G < E else (lambda x: x)
        folded = fold_building(_map_leaves(pick, building_e))
        b = step_mod.device_building(folded, device=device)
        xs = fold_inputs(seq, axes, b0, idx, T, b.dtype, device)
        st, out = step_mod.run(b, fold_state(state_e, idx), xs, collect_zone_T=collect_zone_T,
                               collect_loads=collect_loads, march_fn=march_fn)
        zt, loads = out if collect_loads else (out, None)
        outs.append((idx, st, zt, loads))
    return _assemble(outs, E, T, collect_zone_T, collect_loads)


def _assemble(outs, E, T, collect_zone_T, collect_loads):
    """Per-group results ``(idx, folded final state, zone_T [T, G*Z], loads)``
    -> ``(state_e, hist_e)`` in member order, heatx's return layout."""
    order = torch.as_tensor(np.argsort(np.concatenate([np.asarray(o[0]) for o in outs])))

    def cat(parts):
        x = torch.cat(parts, dim=0)
        return x[order.to(x.device)]

    def hist(k):
        parts = [torch.movedim(o[k].reshape(T, len(o[0]), -1), 1, 0) for o in outs]
        return cat(parts)

    states = [_unfold_state(o[1], len(o[0])) for o in outs]
    state_e = SimState(**{
        f.name: None if getattr(states[0], f.name) is None
        else cat([getattr(s, f.name) for s in states])
        for f in dataclasses.fields(SimState)
    })
    zt = hist(2) if collect_zone_T else None
    if collect_loads:
        return state_e, (zt, hist(3))
    return state_e, zt


def _run(building_e, state_e, inputs_seq, mode, substeps, collect_zone_T, inputs_axes,
         collect_loads, engine, device):
    global last_engine
    substeps = _check_mode(mode, substeps)
    device = resolve_device(device)
    engine = _pick_engine(engine, mode, device)
    axes = _input_axes(inputs_axes)
    E = _n_members(building_e)
    T = _steps(inputs_seq, axes)
    route = _kernel_route if engine == "kernel" else _xla_route
    out = route(building_e, state_e, inputs_seq, axes, E, T, mode, substeps, collect_zone_T,
                collect_loads, device)
    last_engine = engine
    return out


def make_run(
    mode: str = "parity",
    substeps: int = None,
    collect_zone_T: bool = True,
    inputs_axes=None,
    jit: bool = True,
    collect_loads: bool = False,
    engine: str = "auto",
    device="cuda",
):
    """An ensemble runner ``fn(building_e, state_e, inputs_seq)`` (heatx
    ``make_run``).

    ``building_e``/``state_e`` carry a leading ensemble axis on every leaf
    (:func:`stack_pytrees` / :func:`ensemble_initial_state`); ``inputs_seq``
    is shared across members by default (``inputs_axes=None``) or per member
    with ``inputs_axes=0`` (every leaf ``[E, T, ...]``), or per channel with
    a StepInputs or dict of 0/None.  ``substeps`` (fast modes only; default
    8) is rejected under ``mode="parity"``, which marches the
    stability-dictated sub-step count.  Returns ``(final_state_e,
    zone_T_hist_e)`` with ``zone_T_hist_e`` shaped ``[E, T, Z]``;
    ``collect_loads`` makes the history ``(zone_T_hist_e,
    ideal_load_hist_e)`` (setpoint-driven HVAC only).  ``engine`` and
    ``device`` as the module docstring says; ``jit`` is heatx's and changes
    nothing here."""
    _check_mode(mode, substeps)

    def fn(building_e, state_e, inputs_seq):
        return _run(building_e, state_e, inputs_seq, mode, substeps, collect_zone_T, inputs_axes,
                    collect_loads, engine, device)

    return fn


def ensemble_run(
    building_e: CompiledBuilding,
    state_e: SimState,
    inputs_seq: StepInputs,
    mode: str = "parity",
    substeps: int = None,
    collect_zone_T: bool = True,
    inputs_axes=None,
    collect_loads: bool = False,
    engine: str = "auto",
    device="cuda",
):
    """One call of :func:`make_run`'s runner (heatx ``ensemble_run``)."""
    return make_run(mode, substeps, collect_zone_T, inputs_axes, collect_loads=collect_loads,
                    engine=engine, device=device)(building_e, state_e, inputs_seq)


def run_param_ensemble(
    building: CompiledBuilding,
    apply_fn: Callable[[CompiledBuilding, Any], CompiledBuilding],
    params_e: Any,
    state: SimState,
    inputs_seq: StepInputs,
    mode: str = "parity",
    substeps: int = None,
    collect_zone_T: bool = True,
    inputs_axes=None,
    collect_loads: bool = False,
    engine: str = "auto",
    device="cuda",
):
    """Sweep a batched parameter tree over ONE compiled building (heatx
    ``run_param_ensemble``).

    ``apply_fn(building, params) -> building`` is any transform that keeps
    the layout (for instance ``dataclasses.replace`` scaling
    ``surfaces.seg_u``); it is called once per member, with that member's
    row of every leaf of ``params_e`` (each leaf carries a leading ``[E]``
    axis).  The building, the initial state and the inputs are shared (or
    per member through ``inputs_axes``, as in :func:`make_run`).
    Differentiable: where a leaf of ``params_e`` requires grad, the results
    carry the population's graph, and ``torch.autograd.grad`` of a sum of
    member losses gives each member's gradient (heatx's ``vmap(grad)``); on
    the kernel route the backward launches the day adjoint once a day for
    the whole population."""
    building_e = apply_members(building, apply_fn, params_e)
    E = _n_members(building_e)
    state_e = tree_map(lambda x: torch.as_tensor(x)[None].expand((E,) + tuple(np.shape(x))), state)
    return _run(building_e, state_e, inputs_seq, mode, substeps, collect_zone_T, inputs_axes,
                collect_loads, engine, device)


def apply_members(building, apply_fn, params_e):
    """The stacked building of ``apply_fn`` over the members' parameter rows
    (each leaf of ``params_e`` leads with the member axis).
    Where every parameter leaf is a tensor, ``torch.func.vmap`` evaluates
    ``apply_fn`` once over the member axis (its numpy fields cannot depend on
    the parameters, so member 0's are broadcast); otherwise, or where
    ``apply_fn`` does not trace under vmap, it is called member by member
    and :func:`stack_pytrees` checks the layouts."""
    leaves, rebuild = tree_flatten(params_e)
    E = int(np.shape(leaves[0])[0])
    first = apply_fn(building, rebuild([x[0] for x in leaves]))
    if all(isinstance(x, torch.Tensor) for x in leaves):
        out, _, make = _flatten(first)
        pos = [k for k, x in enumerate(out) if isinstance(x, torch.Tensor)]
        try:
            batched = torch.func.vmap(
                lambda p: tuple(_flatten(apply_fn(building, p))[0][k] for k in pos))(params_e)
        except (RuntimeError, TypeError, ValueError):  # apply_fn does not trace: call it per member
            batched = None
        if batched is not None:
            new = dict(zip(pos, batched))
            return make([new[k] if k in new else np.broadcast_to(np.asarray(x), (E,) + np.shape(x))
                         for k, x in enumerate(out)])
    members = [first] + [apply_fn(building, rebuild([x[i] for x in leaves])) for i in range(1, E)]
    return stack_pytrees(members)


def shard_ensemble(tree, mesh, axis_name: Optional[str] = None):
    """Distribute an ensemble-stacked tree's leading axis over a device mesh
    (heatx ``shard_ensemble``).  Not ported yet: multi-GPU is ROADMAP A12."""
    raise NotImplementedError("not ported yet: shard_ensemble (ROADMAP A12, multi-GPU)")

"""High-level API: ``ThermalModel`` and the day-march ``FastRunner``.

PyTorch counterpart of ``heatx.api`` for the slice the port carries: a
compiled building on a device (the card unless the caller asks for the
CPU), its initial state and inputs (``inputs``, ``inputs_sequence``), its
zone MRT (``zone_mrt``); the XLA-path integrators, plain tensor code on the
device: ``march`` and ``run`` (the reference-parity march, or the fast modes
``trbdf2``, ``trbdf2_refresh`` and ``exp``), ``run_checked``, ``warmup``,
``march_imp`` and ``march_exp``; ``FastRunner.run``, which marches a whole hourly input sequence through the
day march (the CUDA kernel on a GPU, its plain twin on the CPU), with the
per-hour ideal loads of a building with thermostats, with setpoint
schedules, with the ground faces' soil temperature swapped in month by
month (``ground_hourly``), with interior MRT (``config.interior_mrt``),
with the in-run passive controls (zone shading with its ``shade_sp``
schedules, ventilation gates), and with the per-hour h/q and
operative-temperature histories (``collect_fluxes``, ``collect_operative``); and
``FastRunner.chunk_forward``/``chunk_grad``, the forward and backward sweeps
of ``heatx_torch.engine.adjoint.chunked_value_and_grad`` (the day march and
the adjoint day march), for zone-temperature and demand objectives; the
one-step entry points ``FastRunner.hour_inputs``, ``march_blocked`` and
``march``, and ``FastRunner.update_building``, which swaps a same-layout
building's values in without a rebuild.
"""

from __future__ import annotations

import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import torch

from heatx_torch.build.layout import B_GROUND, CompiledBuilding, compile_building
from heatx_torch.config import DEFAULT_CONFIG, SimConfig
from heatx_torch.constants import KELVIN
from heatx_torch.engine import exponential as exp_mod
from heatx_torch.engine import implicit as imp_mod
from heatx_torch.engine import step as step_mod
from heatx_torch.engine import surface as surf_mod
from heatx_torch.engine.adjoint import tree_flatten
from heatx_torch.engine.state import SimState, StepInputs, default_inputs, initial_state
from heatx_torch.model.building import BuildingModel
from heatx_torch.ops import day_adjoint, day_march
from heatx_torch.ops.cuda_lib import resolve_device
from heatx_torch.physics import gas
from heatx_torch.weather.epw import interpolate_to_steps

#: FastRunner.run checks the per-hour non-finite counts once at the end of
#: the run when a dispatch chunk covers fewer surface-hours than this, and
#: per chunk with a one-chunk lag otherwise (heatx.api's rule).
DEFER_CHECK_SURFACE_HOURS = int(1e7)

#: ``run`` options that do not change the marched trajectory (heatx
#: api.py:889-892).  ``chunk_grad`` takes only these, and raises when its
#: paired ``chunk_forward`` ran with any other.
TRAJECTORY_NEUTRAL = frozenset(
    {"assert_finite", "dispatch_days", "collect_zone_T", "collect_fluxes", "collect_operative"}
)

#: Building fields whose cotangents the adjoint day march returns; on a
#: building with thermostats also the compiled setpoints CTL_FIELDS.
DIFF_FIELDS = frozenset(
    ["surfaces." + n for n in day_adjoint.DIFF_NODE + day_adjoint.DIFF_SURF] + ["zone_volume"]
)
CTL_FIELDS = frozenset(["ctl_heat_sp", "ctl_cool_sp"])


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _fields(building: CompiledBuilding):
    """(name, value) of every building field the day march reads or could be
    asked to: the surface fields and the building-level arrays (not the
    discretization records or the config)."""
    for f in dataclasses.fields(building.surfaces):
        yield "surfaces." + f.name, getattr(building.surfaces, f.name)
    for f in dataclasses.fields(building):
        if f.name not in ("surfaces", "discretizations", "config"):
            yield f.name, getattr(building, f.name)


def _same(a, b) -> bool:
    if a is b:
        return True
    if isinstance(a, tuple) and isinstance(b, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    a, b = _np(a), _np(b)
    if a.shape != b.shape:
        return False
    return bool(np.array_equal(a, b, equal_nan=a.dtype.kind == "f" and b.dtype.kind == "f"))


def _operand_shapes(params) -> list:
    """(name, shape, dtype) of every tensor operand of the day march's
    blocked building (``None`` where an optional one is absent)."""
    out = []
    for f in dataclasses.fields(params):
        v = getattr(params, f.name)
        parts = [v] if v is None or isinstance(v, torch.Tensor) else [
            getattr(v, g.name) for g in dataclasses.fields(v)
        ]
        out += [(f.name, None if a is None else (tuple(a.shape), a.dtype)) for a in parts]
    return out


def _requires_grad(v) -> bool:
    if isinstance(v, tuple):
        return any(_requires_grad(x) for x in v)
    return isinstance(v, torch.Tensor) and v.requires_grad


def _check_setpoint_order(building, heat_sp, cool_sp):
    """Scheduled setpoints: heating must stay below cooling wherever both are
    active (heatx ``_check_setpoint_order``).  The zone update's heating
    branch wins, so a transposed setback array would hold every zone at the
    cooling setpoint.  Skipped for shape pairs that do not broadcast."""
    if heat_sp is None and cool_sp is None:
        return
    h = _np(building.ctl_heat_sp if heat_sp is None else heat_sp).astype(np.float64)
    c = _np(building.ctl_cool_sp if cool_sp is None else cool_sp).astype(np.float64)
    if h.size == 0 or c.size == 0:
        return
    try:
        hb, cb = np.broadcast_arrays(h, c)
    except ValueError:
        return
    bad = (hb > -1e8) & (cb < 1e8) & (hb >= cb)
    if bad.any():
        i = tuple(int(x) for x in np.argwhere(bad)[0])
        raise ValueError(
            f"scheduled heating setpoint >= cooling setpoint at index {i} "
            f"({float(hb[i])} >= {float(cb[i])}): the heating branch would win every "
            "sub-step and hold the zone at the heating value (transposed schedule "
            "arrays are the usual cause)"
        )


def _unsupported(**flags):
    on = [name for name, (value, item) in flags.items() if value]
    if on:
        raise NotImplementedError(
            "not ported yet: "
            + ", ".join(f"{n} ({flags[n][1]})" for n in on)
        )


class ThermalModel:
    """A compiled whole-building thermal model on one torch device."""

    def __init__(
        self,
        model: BuildingModel,
        n: int = 1,
        config: SimConfig = DEFAULT_CONFIG,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.building: CompiledBuilding = compile_building(model, n=n, config=config)
        self._device_building = None

    @classmethod
    def from_building(cls, building: CompiledBuilding, device="cuda") -> "ThermalModel":
        """A model around an already compiled building (for instance one
        carried across from heatx by ``heatx_torch.convert``)."""
        tm = cls.__new__(cls)
        tm.device = resolve_device(device)
        tm.building = building
        tm._device_building = None
        return tm

    def _device(self):
        """The building as tensors on the model's device in the config's
        dtype (``engine.step.device_building``), made at first use so that
        host-side edits before it are picked up; call :meth:`invalidate`
        after later edits."""
        if self._device_building is None:
            self._device_building = step_mod.device_building(self.building, device=self.device)
        return self._device_building

    def invalidate(self):
        """Forget the device copy of the building (after editing it)."""
        self._device_building = None

    @property
    def surfaces(self):
        return self.building.surfaces

    @property
    def dt(self) -> float:
        return self.building.dt

    @property
    def dt_subdivisions(self) -> int:
        return self.building.dt_subdivisions

    def set_ground_temperature(self, value: float) -> None:
        """Set every ground-contact face's soil temperature in the compiled
        building, in place (heatx ``ThermalModel.set_ground_temperature``):
        runners made afterwards read it.  ``FastRunner.set_ground_temperature``
        (or ``run(ground_hourly=...)``) swaps it in a runner that exists."""
        sb = self.building.surfaces
        front = np.asarray(sb.front_code) == B_GROUND
        back = np.asarray(sb.back_code) == B_GROUND
        if not (front.any() or back.any()):
            raise ValueError("model has no ground boundaries")
        sb.front_temp[front] = value
        sb.back_temp[back] = value
        self.invalidate()

    def initial_state(self, dtype=None) -> SimState:
        return initial_state(self.building, dtype=dtype, device=self.device)

    def zone_mrt(self, state: SimState) -> torch.Tensor:
        """Per-zone mean radiant temperature [Z] of a state (heatx
        ``ThermalModel.zone_mrt``): the Carroll exchange node over the
        zone's surface temperatures, a comfort observable whether or not
        ``config.interior_mrt`` drives the physics (zone air where a zone has
        no network).  Operative temperature is ``(zone_T + zone_mrt) / 2``."""
        b = self._device()
        if b.dtype != state.node_T.dtype:
            b = step_mod.device_building(self.building, state.node_T.dtype, state.node_T.device)
        return surf_mod.zone_mrt(b.surfaces, state.node_T, state.zone_T, b.n_zones)

    def inputs(self, dtype=None, **overrides) -> StepInputs:
        return default_inputs(self.building, dtype=dtype, device=self.device, **overrides)

    def inputs_sequence(self, T: int, dtype=None, **overrides) -> StepInputs:
        """A ``[T, ...]`` StepInputs sequence for :meth:`run`/:meth:`run_checked`
        (heatx ``ThermalModel.inputs_sequence``).

        Each channel may be static (its :meth:`inputs` shape, held over the
        ``T`` main steps) or per-step (a leading axis of length ``T``).  The
        weather scalars may also carry a trailing ``[dt_subdivisions]`` axis
        of sub-step values (``[T, sub]`` per step, ``[sub]`` static); a 1-D
        weather array of length T is a per-step series.  Per-step values of
        other channels broadcast from the left (a ``[T]`` series is one value
        per step for all elements).  ``mix_vol``/``heat_sp``/``cool_sp``/
        ``shade_sp`` keep their static-or-scheduled forms (:meth:`run` lifts
        them)."""
        base = default_inputs(self.building, dtype=dtype, device=self.device)
        weather = ("t_out", "wind_speed", "wind_direction")
        upd = {}
        for f in dataclasses.fields(StepInputs):
            name = f.name
            given = overrides.get(name)
            b0 = getattr(base, name)
            if name in ("mix_vol", "heat_sp", "cool_sp", "shade_sp"):
                if given is not None:
                    upd[name] = torch.as_tensor(given, dtype=base.t_out.dtype, device=self.device)
                continue
            if given is None:  # absent or an explicit None: the default
                upd[name] = b0[None].expand((T,) + tuple(b0.shape))
                continue
            v = torch.as_tensor(given, dtype=b0.dtype, device=self.device)
            if v.ndim >= 1 and v.shape[0] == T:
                if name in weather and v.ndim <= 2:
                    upd[name] = v
                else:
                    tail = tuple(v.shape[1:])
                    v = v.reshape((T,) + tail + (1,) * (b0.ndim - len(tail)))
                    upd[name] = v.expand((T,) + tuple(b0.shape))
            elif name in weather and v.ndim == 1:  # [sub] static sub-step values
                upd[name] = v[None].expand((T,) + tuple(v.shape))
            else:
                upd[name] = v.expand(b0.shape)[None].expand((T,) + tuple(b0.shape))
        return base.replace(**upd)

    def warmup(self, state: SimState, inputs_period: StepInputs, max_repeats: int = 25,
               tol: float = 0.01, run=None):
        """EnergyPlus-style warm-up (heatx ``ThermalModel.warmup``): march one
        period of inputs repeatedly from ``state`` until the largest zone- or
        node-temperature change between consecutive repeats is below ``tol``
        K, or ``max_repeats`` times.  Returns ``(state, repeats_run)``.
        ``run(state) -> state`` replaces the period integrator (default:
        :meth:`run` without history; a FastRunner closure warms up through
        the day march)."""
        if run is None:
            def run(s):
                return self.run(s, inputs_period, collect_zone_T=False)[0]

        mask = np.asarray(self.building.surfaces.node_mask)
        prev_z = prev_n = None
        for d in range(max_repeats):
            state = run(state)
            zt = _np(state.zone_T)
            nt = np.where(mask, _np(state.node_T), 0.0)
            if prev_z is not None:
                dz = float(np.max(np.abs(zt - prev_z))) if zt.size else 0.0
                dn = float(np.max(np.abs(nt - prev_n)))
                if max(dz, dn) < tol:
                    return state, d + 1
            prev_z, prev_n = zt, nt
        return state, max_repeats

    # -- the XLA-path integrators --------------------------------------------

    def march(self, state: SimState, inputs: StepInputs) -> SimState:
        """One main timestep (= dt_subdivisions reference-parity sub-steps),
        plain tensor code on the model's device (``engine.step.march``)."""
        _check_setpoint_order(self.building, inputs.heat_sp, inputs.cool_sp)
        return step_mod.march(self._device(), state, inputs)

    def run(
        self,
        state: SimState,
        inputs_seq: StepInputs,
        collect_zone_T: bool = True,
        collect_loads: bool = False,
        collect_operative: bool = False,
        mode: str = "parity",
        substeps: int = None,
        refresh_every: int = None,
    ):
        """March a whole ``[T, ...]`` input sequence (heatx
        ``ThermalModel.run``; ``engine.step.run``) on the model's device.

        ``mode`` is ``"parity"`` (default: the reference's sub-step count and
        no-mass solve, the adaptive loop unless ``config.nomass_fixed_iters``
        is set), or the fast modes ``"trbdf2"``, ``"trbdf2_refresh"`` (with
        ``refresh_every``) and ``"exp"`` at ``substeps`` sub-steps per main
        step (default 8), step for step what a loop of :meth:`march_imp`/
        :meth:`march_exp` gives.  With ``collect_loads`` (thermostats only)
        the history is ``(zone_T_hist, ideal_load_hist)``;
        ``collect_operative`` appends the ``[T, Z]`` operative-temperature
        history."""
        _check_setpoint_order(self.building, inputs_seq.heat_sp, inputs_seq.cool_sp)
        if refresh_every is not None and mode != "trbdf2_refresh":
            raise ValueError("refresh_every applies to mode='trbdf2_refresh'")
        if mode == "parity":
            march_fn = None
            if substeps is not None:
                raise ValueError(
                    "substeps applies to the fast modes; the parity "
                    "integrator's sub-step count is stability-dictated"
                )
        else:
            substeps = 8 if substeps is None else int(substeps)
            if substeps < 1:
                raise ValueError(f"substeps must be >= 1, got {substeps}")
            if mode in ("trbdf2", "trbdf2_refresh"):
                march_fn = functools.partial(
                    imp_mod.imp_march, substeps=substeps, refresh_h=(mode == "trbdf2_refresh"),
                    refresh_every=refresh_every,
                )
            elif mode == "exp":
                march_fn = functools.partial(exp_mod.exp_march, substeps=substeps)
            else:
                raise ValueError(f"unknown mode {mode!r}")
        return step_mod.run(
            self._device(), state, inputs_seq, collect_zone_T=collect_zone_T,
            collect_loads=collect_loads, collect_operative=collect_operative, march_fn=march_fn,
        )

    def run_checked(self, state: SimState, inputs_seq: StepInputs, collect_zone_T: bool = True):
        """Like :meth:`run` in parity mode, with a finiteness check after
        every main step (the reference's NaN asserts, model.rs:416-419): raises
        ``FloatingPointError`` on the first non-finite state, naming the main
        step and the zone."""
        return step_mod.make_checked_run_fn(collect_zone_T)(self._device(), state, inputs_seq)

    def march_exp(self, state: SimState, inputs: StepInputs, substeps: int = 12) -> SimState:
        """One main timestep in exponential-integrator fast mode
        (``engine.exponential``): coefficients frozen for the step, the
        massive nodes advanced by the exact matrix exponential of the frozen
        system, ``substeps`` sub-steps."""
        return exp_mod.exp_march(self._device(), state, inputs, substeps=substeps)

    def march_imp(self, state: SimState, inputs: StepInputs, substeps: int = 12,
                  refresh_h: bool = False, refresh_every: int = None) -> SimState:
        """One main timestep in TR-BDF2 fast mode (``engine.implicit``):
        coefficients frozen for the step (``refresh_h``: rebuilt every
        sub-step; ``refresh_every=k``: every k sub-steps)."""
        _check_setpoint_order(self.building, inputs.heat_sp, inputs.cool_sp)
        return imp_mod.imp_march(self._device(), state, inputs, substeps=substeps,
                                 refresh_h=refresh_h, refresh_every=refresh_every)

    def fast_runner(
        self,
        block_size: int = None,
        mode: str = "parity",
        substeps: int = None,
        hours: int = 1,
        collect_fluxes: bool = False,
        scheduled_setpoints: bool = False,
        mesh=None,
        collect_operative: bool = False,
        refresh_every: int = None,
        use_kernel: bool = True,
        adaptive_nomass: bool = False,
    ) -> "FastRunner":
        """The day-march path (heatx ``ThermalModel.fast_runner``).

        ``mode`` is ``"trbdf2"`` (operators frozen per hour),
        ``"trbdf2_refresh"`` (rebuilt every ``refresh_every`` sub-steps,
        default 1), both with ``substeps`` defaulting to 12 per hour, or
        ``"parity"`` (heatx's default: the reference-parity sub-step at the
        building's own ``dt`` and ``dt_subdivisions`` sub-steps per hour,
        118 at the default discretization; on a building with no-mass nodes
        the adaptive loop, ``config.nomass_fixed_iters=None``, runs only with
        ``HEATX_KERNEL_WHILE=1``, as in heatx, or ``adaptive_nomass=True``,
        and has no gradient).  ``block_size`` is
        the number of surface lanes per zone-closed block, one CUDA thread
        block each (at most 256; default: the largest zone-connected
        component rounded up to a warp).  ``use_kernel=False`` runs the
        plain PyTorch twin even on a GPU: the reference the kernel is
        checked against.  ``scheduled_setpoints`` (buildings with
        thermostats) lets ``StepInputs.heat_sp``/``cool_sp`` override the
        compiled setpoints hour by hour.  ``collect_fluxes`` and
        ``collect_operative`` let ``run`` return the per-hour h/q and
        operative-temperature histories.  ``mesh`` is not ported yet and
        raises ``NotImplementedError``."""
        return FastRunner(
            self, block_size=block_size, mode=mode, substeps=substeps,
            hours=hours, collect_fluxes=collect_fluxes,
            scheduled_setpoints=scheduled_setpoints, mesh=mesh,
            collect_operative=collect_operative, refresh_every=refresh_every,
            use_kernel=use_kernel, adaptive_nomass=adaptive_nomass,
        )


class FastRunner:
    """Marches :class:`SimState` through the day march, handling the
    zone-closed block permutation.  ``params`` holds the blocked building on
    the model's device."""

    def __init__(
        self,
        tm: ThermalModel,
        block_size: int = None,
        mode: str = "parity",
        substeps: int = None,
        hours: int = 1,
        collect_fluxes: bool = False,
        scheduled_setpoints: bool = False,
        mesh=None,
        collect_operative: bool = False,
        refresh_every: int = None,
        use_kernel: bool = True,
        adaptive_nomass: bool = False,
    ):
        _unsupported(mesh=(mesh is not None, "ROADMAP A12"))
        self._tm = tm
        self.device = tm.device
        building = tm.building
        #: The building whose values the operands hold (``update_building``
        #: swaps it; the inputs keep reading ``tm.building``, as in heatx).
        self._building = building
        # The requested block size, for update_building's re-blocking.
        self._block_size = block_size
        # The operative history needs the Carroll statics even without MRT physics.
        self._bb = day_march.block_building(
            building, block_size=block_size, mrt_statics=True if collect_operative else None
        )
        self._hours = hours
        # A zone-shaded building's march always takes the shading setpoint
        # series (so run(shade_sp=...) needs no constructor flag); it defaults
        # to the compiled setpoints (heatx api.py:512-514).
        self._scheduled_shade = bool(building.has_zone_shading)
        self.hour_march, self.params = day_march.make_hour_march(
            self._bb, substeps=substeps, mode=mode, hours=hours,
            refresh_every=refresh_every, collect_bad=True, device=self.device,
            scheduled_setpoints=scheduled_setpoints, collect_hq=collect_fluxes,
            collect_operative=collect_operative, scheduled_shade_sp=self._scheduled_shade,
            adaptive_nomass=adaptive_nomass,
        )
        self._collect_hq = collect_fluxes
        self._collect_op = collect_operative
        self._scheduled_sp = scheduled_setpoints
        self._has_loads = self.hour_march.collect_loads
        self._mode = mode
        self._substeps = self.hour_march.substeps
        self._use_kernel = use_kernel
        self._march = self.hour_march if use_kernel else self.hour_march.plain
        grad_march = self.hour_march.without_observables()
        self._grad_march = grad_march if use_kernel else grad_march.plain
        self._dtype = building.config.dtype
        # Differentiable gathers into the blocked layout (state, inputs and
        # the parameter rows alike).
        self._blocker = day_march.ParamBlocker(self._bb, self.device)
        self._ground_masks = None
        #: The first day of each dispatch chunk of the last ``run``.
        self.dispatch_starts = []

        lay = self._bb.layout
        S, Z = building.n_surfaces, building.n_zones
        perm = np.asarray(lay.surf_perm)  # [SP] -> surface id or -1
        inv = np.zeros(S, np.int64)  # surface id -> blocked lane
        inv[perm[perm >= 0]] = np.nonzero(perm >= 0)[0]
        zt = np.asarray(lay.zone_table).reshape(-1)  # blocked slot -> zone id or -1
        zinv = np.zeros(Z, np.int64)  # zone id -> blocked slot
        zinv[zt[zt >= 0]] = np.nonzero(zt >= 0)[0]
        self._inv = torch.as_tensor(inv, device=self.device)
        self._zinv = torch.as_tensor(zinv, device=self.device)

    @property
    def layout(self):
        return self._bb.layout

    def update_building(self, building: CompiledBuilding) -> None:
        """Swap every building-derived operand for those of a same-layout
        :class:`CompiledBuilding` whose VALUES changed (for instance a scaled
        ``surfaces.seg_u`` during calibration), without rebuilding the
        runner (heatx ``FastRunner.update_building``).  The blocked layout
        (the surface permutation) and every operand's shape must stay as
        they are; otherwise ``ValueError``.  The swap overrides earlier
        :meth:`set_ground_temperature` writes (re-apply them after), and
        drops the value key of ``chunk_forward``'s parameter sync, so a
        manual swap is never shadowed by a stale sync."""
        bb2 = day_march.block_building(
            building, block_size=self._block_size,
            mrt_statics=True if self._collect_op else None,
        )
        if not np.array_equal(np.asarray(bb2.layout.surf_perm), np.asarray(self._bb.layout.surf_perm)):
            raise ValueError(
                "update_building requires an identical blocked layout: "
                "re-discretized or re-ordered buildings need a fresh "
                "fast_runner (only value changes on the compiled arrays "
                "keep the layout)"
            )
        params2 = day_march.params_from_blocked(bb2, bb2.config.dtype, self.device)
        if _operand_shapes(params2) != _operand_shapes(self.params):
            raise ValueError(
                "update_building produced different operand shapes; the "
                "building's structure changed"
            )
        self._bb, self._building, self.params = bb2, building, params2
        self._blocker = day_march.ParamBlocker(bb2, self.device)
        self._ground_masks = None
        self._param_key = None

    def set_ground_temperature(self, value: float) -> None:
        """Set every ground-contact face's soil temperature in the blocked
        operands on the device (heatx ``FastRunner.set_ground_temperature``):
        a masked in-place write of the ``front_temp``/``back_temp`` rows, with
        the masks computed once from the boundary codes, and no re-blocking.
        A later change of the parameter rows (``chunk_forward``'s re-blocking)
        takes the compiled building's values again."""
        if self._ground_masks is None:
            self._ground_masks = [
                (day_march.SURF_FIELDS.index(f"{side}_temp"), mask)
                for side in ("front", "back")
                for mask in [self.params.field(f"{side}_code") == B_GROUND]
                if bool(mask.any())
            ]
        if not self._ground_masks:
            raise ValueError("model has no ground boundaries")
        for row, mask in self._ground_masks:
            self.params.surf[row].masked_fill_(mask, float(value))

    # -- layout conversion --------------------------------------------------

    def to_blocked(self, state: SimState):
        """SimState -> (T_blocked [N, SP], zT_blocked [NB, ZB])
        (differentiable)."""
        return self._blocked_state(state.node_T, state.zone_T)

    def _blocked_state(self, node_T, zone_T):
        dt = self._dtype
        return self._blocker.lanes(node_T.to(dt)), self._blocker.zones(zone_T.to(dt))

    def from_blocked(self, T, zT, hq=None) -> SimState:
        """(T_blocked, zT_blocked[, hq]) -> SimState."""
        if hq is None:
            z = torch.zeros((self._bb.layout.padded_surfaces,), dtype=T.dtype, device=T.device)
            hq = (z, z, z, z)
        hf, hb, qf, qb = (x[self._inv] for x in hq)
        return SimState(
            node_T=T[:, self._inv], zone_T=zT.reshape(-1)[self._zinv],
            h_front=hf, h_back=hb, q_front=qf, q_back=qb,
        )

    # -- input preparation --------------------------------------------------

    def _weather_xs(self, v, T_steps, interp_weather):
        """[T] hourly weather -> [D, hours*substeps] per-sub-step rows."""
        sub, H = self._substeps, self._hours
        a = np.broadcast_to(_np(v).astype(np.float64), (T_steps,))
        s = interpolate_to_steps(a, sub)[: T_steps * sub] if interp_weather else np.repeat(a, sub)
        return torch.as_tensor(s.reshape(T_steps // H, H * sub), dtype=self._dtype, device=self.device)

    def _gains(self, inputs_seq: StepInputs, T_steps):
        """Per-hour zone A/B gain terms [T, Z]: heater and luminaire power
        into A; infiltration and ventilation air exchange into A and B (the
        logic of heatx ``FastRunner.hour_inputs``).  On a building with
        ventilation gates the whole ventilation channel goes to the three
        gate rows instead (heatx api.py:1580-1602): ``a_vent``/``b_vent``
        with the weather-only gates (outdoor temperature and wind, from each
        hour's value of the hourly series, never the interpolated sub-steps)
        applied here, and ``vent_thr = vent_delta + t_out``; infiltration is
        never gated.  Returns ``(a_gain, b_gain, vent_rows or None)``."""
        b = self._tm.building
        Z = b.n_zones
        kw = dict(dtype=self._dtype, device=self.device)

        def seq(v, n):
            a = torch.as_tensor(v, **kw)
            return a if a.ndim == 2 else torch.broadcast_to(a, (T_steps, n))

        a_gain = torch.zeros((T_steps, Z), **kw)
        if b.hvac_pair_unit.size:
            hv = seq(inputs_seq.hvac_power, b.n_hvacs)
            a_gain.index_add_(
                1, torch.as_tensor(b.hvac_pair_space, device=self.device),
                hv[:, torch.as_tensor(b.hvac_pair_unit, device=self.device)],
            )
        if b.lum_space.size:
            a_gain.index_add_(
                1, torch.as_tensor(b.lum_space, device=self.device),
                seq(inputs_seq.lum_power, b.n_luminaires),
            )
        b_gain = torch.zeros((T_steps, Z), **kw)
        vent_rows = None
        for kind, (vol, temp, mask) in (
            ("inf", (inputs_seq.inf_vol, inputs_seq.inf_temp, inputs_seq.inf_mask)),
            ("vent", (inputs_seq.vent_vol, inputs_seq.vent_temp, inputs_seq.vent_mask)),
        ):
            vol, temp, mask = seq(vol, Z), seq(temp, Z), seq(mask, Z) > 0
            t_k = temp + KELVIN
            term = torch.where(
                mask, gas.density(gas.AIR, t_k) * vol * gas.heat_capacity(gas.AIR, t_k),
                torch.zeros_like(vol),
            )
            zero = torch.zeros_like(term)
            if kind == "vent" and b.has_vent_gates:
                def hourly(v):
                    return torch.broadcast_to(torch.as_tensor(v, **kw), (T_steps,))[:, None]

                def limit(v):
                    return torch.as_tensor(v, **kw)[None]

                t_o, wind = hourly(inputs_seq.t_out), hourly(inputs_seq.wind_speed)
                out_ok = ((t_o > limit(b.vent_min_tout)) & (t_o < limit(b.vent_max_tout))
                          & (wind < limit(b.vent_max_wind)))
                vent_rows = (
                    torch.where(mask & out_ok, term * temp, zero),
                    torch.where(out_ok, term, zero),
                    torch.broadcast_to(limit(b.vent_delta) + t_o, (T_steps, Z)),
                )
                continue
            # Masked product too: a masked-off channel may carry NaN temperatures.
            a_gain = a_gain + torch.where(mask, term * temp, zero)
            b_gain = b_gain + term
        return a_gain, b_gain, vent_rows

    def _surf_xs(self, v, time_leading, d0, n_days):
        """A per-surface channel ([T, S], [T], [S] or scalar) -> the blocked
        [n_days, hours, SP] rows of one dispatch chunk."""
        H = self._hours
        S = self._tm.building.n_surfaces
        a = torch.as_tensor(v, dtype=self._dtype, device=self.device)
        if time_leading:
            a = a[d0 * H:(d0 + n_days) * H]
            if a.ndim == 1:
                a = a[:, None]
        a = torch.broadcast_to(a, (n_days * H, S))
        return self._blocker.lanes(a).reshape(n_days, H, -1)

    def _zone_xs(self, a, d0, n_days):
        """[T, Z] zone rows -> blocked [n_days, hours, NB, ZB]."""
        H = self._hours
        out = self._blocker.zones(a[d0 * H:(d0 + n_days) * H])
        return out.reshape((n_days, H) + tuple(out.shape[-2:]))

    def _prepare(self, inputs_seq: StepInputs, interp_weather: bool):
        """Whole-horizon input prep: weather per sub-step, zone gains, and
        the per-surface channels with their time-axis reading."""
        T_steps = int(np.shape(_np(inputs_seq.t_out))[0])
        if T_steps % self._hours:
            raise ValueError(
                f"sequence length {T_steps} not divisible by the runner's "
                f"hours={self._hours} chunk; pad the sequence or use hours=1"
            )
        surf_raw = (inputs_seq.sol_front, inputs_seq.sol_back,
                    inputs_seq.ir_front, inputs_seq.ir_back)

        def time_leading(v):
            # A leading axis of length T is a per-hour series ([T] = one value
            # for every surface); on the T == n_surfaces ambiguity the
            # time-series reading wins, as in heatx.
            sh = tuple(np.shape(v))
            return len(sh) in (1, 2) and sh[0] == T_steps

        a_gain, b_gain, vent = self._gains(inputs_seq, T_steps)
        return SimpleNamespace(
            T_steps=T_steps, D=T_steps // self._hours, sp=self._setpoints(inputs_seq, T_steps),
            shade=self._shade_series(inputs_seq, T_steps), vent=vent,
            weather=tuple(
                self._weather_xs(v, T_steps, interp_weather)
                for v in (inputs_seq.t_out, inputs_seq.wind_speed, inputs_seq.wind_direction)
            ),
            a_gain=a_gain, b_gain=b_gain, surf=surf_raw,
            surf_ts=tuple(time_leading(v) for v in surf_raw),
        )

    def _setpoints(self, inputs_seq: StepInputs, T_steps):
        """The heating and cooling setpoint schedules of a scheduled runner,
        each as ``(is_series, tensor)``: a ``[T, Z]`` or ``[T, 1]`` series or
        a ``[Z]`` constant (heatx's reading: a 1-D array of length T is a
        per-hour schedule for every zone; scalar, ``[Z]`` and ``[1, Z]`` are
        constants; None is the compiled setpoints).  None on other runners,
        which refuse schedules."""
        b = self._tm.building
        heat, cool = inputs_seq.heat_sp, inputs_seq.cool_sp
        has_sp = heat is not None or cool is not None
        if has_sp and not self._scheduled_sp:
            raise ValueError(
                "construct the runner with scheduled_setpoints=True to pass "
                "StepInputs.heat_sp/cool_sp schedules through the day march"
            )
        if has_sp:
            _check_setpoint_order(b, heat, cool)
        if not self._scheduled_sp:
            return None
        Z = b.n_zones

        def series(v, compiled):
            a = torch.as_tensor(compiled if v is None else v, dtype=self._dtype, device=self.device)
            sh = tuple(a.shape)
            if v is None:
                return False, a
            if len(sh) == 1 and sh[0] == T_steps:
                return True, a[:, None]
            if len(sh) <= 1:
                return False, torch.broadcast_to(a, (Z,))
            if sh[0] == T_steps:
                return True, a
            if sh[0] == 1:
                return False, a[0]
            raise ValueError(
                f"setpoint schedule shape {sh} not understood: pass scalar, [Z], [T], "
                f"[1, Z], or [T, Z] (T={T_steps}, Z={Z})"
            )

        return series(heat, b.ctl_heat_sp), series(cool, b.ctl_cool_sp)

    def _shade_series(self, inputs_seq: StepInputs, T_steps):
        """The shading setpoints of a zone-shaded building as ``(is_series,
        tensor)``: ``inputs_seq.shade_sp`` as a ``[T, S]`` series or an
        ``[S]`` constant (scalar and ``[S]``), or the compiled setpoints where
        it is None (heatx api.py:1901-1930).  None on other buildings, which
        refuse the channel."""
        b = self._tm.building
        sv = inputs_seq.shade_sp
        if sv is not None and not self._scheduled_shade:
            raise ValueError(
                "StepInputs.shade_sp requires in-run zone-shading controls "
                "(BuildingModel.add_zone_shading)"
            )
        if not self._scheduled_shade:
            return None
        S = b.n_surfaces
        a = torch.as_tensor(b.shade_sp if sv is None else sv, dtype=self._dtype, device=self.device)
        sh = tuple(a.shape)
        if len(sh) == 2 and sh == (T_steps, S):
            return True, a
        if len(sh) == 0 or sh in ((1,), (S,)):
            return False, torch.broadcast_to(a, (S,))
        raise ValueError(
            f"shade_sp schedule shape {sh} not understood: pass scalar, [S], or [T, S] "
            f"(T={T_steps}, S={S})"
        )

    def _day_inputs(self, prep, d0: int, n_days: int):
        """The hour_march inputs of days [d0, d0 + n_days), blocked on the
        device for this chunk only (an annual [T, SP] buffer per channel
        would not be needed at once)."""
        surf = [self._surf_xs(v, ts, d0, n_days) for v, ts in zip(prep.surf, prep.surf_ts)]
        a_c = self._zone_xs(prep.a_gain, d0, n_days)
        b_c = self._zone_xs(prep.b_gain, d0, n_days)
        vent = [] if prep.vent is None else [self._zone_xs(v, d0, n_days) for v in prep.vent]
        shade = [] if prep.shade is None else [self._surf_xs(prep.shade[1], prep.shade[0], d0, n_days)]
        w = prep.weather
        sp = []
        if prep.sp is not None:
            H, Z = self._hours, self._tm.building.n_zones
            for is_series, a in prep.sp:  # padded zone slots read 0, as in heatx
                a = a[d0 * H:(d0 + n_days) * H] if is_series else a
                sp.append(self._zone_xs(torch.broadcast_to(a, (n_days * H, Z)), 0, n_days))
        # heatx's order: the 9 leaves, the gated rows, the setpoints, the
        # shading setpoint series.
        return [
            (w[0][d0 + d], w[1][d0 + d], w[2][d0 + d],
             surf[0][d], surf[1][d], surf[2][d], surf[3][d], a_c[d], b_c[d])
            + tuple(x[d] for x in vent + sp + shade)
            for d in range(n_days)
        ]

    def kernel_inputs(self, inputs_seq: StepInputs, interp_weather: bool = False):
        """The per-day ``hour_inputs`` tuples that :meth:`run` feeds to
        ``hour_march`` for ``inputs_seq`` (one per ``hours`` chunk)."""
        prep = self._prepare(inputs_seq, interp_weather)
        return self._day_inputs(prep, 0, prep.D)

    def hour_inputs(self, inputs: StepInputs):
        """One step's StepInputs -> the day march's hour-input tuple (heatx
        ``FastRunner.hour_inputs``), held over the runner's ``hours``:
        weather broadcast over the sub-steps (a scalar, or ``[substeps]``
        values of one hour), per-surface arrays permuted into blocks, zone
        gains summed.  Setpoints (scalar or ``[Z]``) and the shading
        setpoints (scalar or ``[S]``) are constants for the call.  The
        entries carry :meth:`run`'s leading ``[hours]`` axes
        (:meth:`kernel_inputs`), heatx's drop it on a one-hour runner."""
        H, sub = self._hours, self._substeps
        weather = ("t_out", "wind_speed", "wind_direction")
        given = {k: torch.as_tensor(getattr(inputs, k), dtype=self._dtype, device=self.device)
                 for k in weather}
        upd = {}
        for f in dataclasses.fields(StepInputs):
            v = getattr(inputs, f.name)
            if v is None:
                continue
            if f.name in ("heat_sp", "cool_sp"):
                v = torch.as_tensor(v)
                upd[f.name] = v.reshape(1, -1) if v.ndim == 1 else v  # [1, Z]: a constant
            elif f.name in weather:
                # The hourly value (heatx's gates read the hour's mean);
                # sub-step values replace the held rows below.
                upd[f.name] = given[f.name].mean().expand(H)
            elif f.name not in ("mix_vol", "shade_sp"):
                v = torch.as_tensor(v, device=self.device)
                upd[f.name] = v[None].expand((H,) + tuple(v.shape))
        out = list(self.kernel_inputs(inputs.replace(**upd))[0])
        for i, k in enumerate(weather):
            if given[k].ndim:
                out[i] = torch.broadcast_to(given[k], (sub,)).repeat(H)
        return tuple(out)

    def march_blocked(self, T, zT, hour_inputs):
        """One launch of the day march on blocked state (heatx
        ``FastRunner.march_blocked``, the zero-copy hot path).  Returns
        ``(T, zT, hq, zt_hist[, hq_hist], bad[, ld_hist][, top_hist])``: the
        trailing entries follow the runner's flags (``bad`` always, the loads
        when the building has thermostats, the operative history when built
        with ``collect_operative``)."""
        return self._march(self.params, T, zT, hour_inputs)

    def march(self, state: SimState, inputs: StepInputs) -> SimState:
        """One step of the runner's ``hours`` (one hour on a one-hour
        runner): SimState in, SimState out (heatx ``FastRunner.march``),
        through :meth:`to_blocked`, :meth:`hour_inputs`,
        :meth:`march_blocked` and :meth:`from_blocked`; on a building with
        thermostats ``ideal_load`` is the last hour's mean ideal power."""
        T, zT = self.to_blocked(state)
        outs = self.march_blocked(T, zT, self.hour_inputs(inputs))
        st = self.from_blocked(outs[0], outs[1], outs[2])
        if self._has_loads:
            # The loads sit before the optional operative history.
            ld = outs[-2] if self._collect_op else outs[-1]
            st.ideal_load = ld[-1].reshape(-1)[self._zinv]
        return st

    # -- the run ------------------------------------------------------------

    def run(
        self,
        state: SimState,
        inputs_seq: StepInputs,
        collect_zone_T: bool = True,
        assert_finite: bool = True,
        interp_weather: bool = False,
        dispatch_days: int = None,
        collect_fluxes: bool = False,
        collect_loads: bool = False,
        ground_hourly=None,
        collect_operative: bool = False,
    ):
        """March a whole [T, ...] input sequence (heatx ``FastRunner.run``).

        ``inputs_seq`` channels carry a leading [T] hour axis: weather as
        [T] series, per-surface irradiance as [T, S], [T] (one value for
        every surface), [S] or a scalar, gains as [T, n] or [n].  T must be
        a multiple of the runner's ``hours``.  ``interp_weather`` linearly
        interpolates the hourly weather to the sub-steps.  ``dispatch_days``
        bounds how many day-chunks of per-surface inputs are blocked on the
        device at once.  ``assert_finite`` reads the kernel's per-hour
        non-finite counts and raises :class:`FloatingPointError` naming the
        first bad hour and block.  ``collect_loads`` (buildings with
        thermostats) appends the per-hour mean ideal-load power ``[T, Z]`` (W,
        heating positive, cooling negative); with or without it, the final
        state of such a building carries the last hour's row as
        ``ideal_load``.  On a ``scheduled_setpoints`` runner
        ``inputs_seq.heat_sp``/``cool_sp`` may be scalar, ``[Z]``, ``[1, Z]``,
        ``[T]`` or ``[T, Z]``; other runners raise ``ValueError`` on them.
        On a building with in-run zone shading ``inputs_seq.shade_sp`` may
        be scalar, ``[S]`` or ``[T, S]`` (+1e9 where a schedule forbids
        deployment; None: the compiled setpoints); other buildings raise
        ``ValueError`` on it.  ``ground_hourly`` ``[T]`` is the soil
        temperature of the ground faces hour by hour, constant within each
        ``hours`` chunk (monthly values from ``EPWData.ground_temperature``):
        the dispatches split where it changes and
        :meth:`set_ground_temperature` swaps it in before each (the runner
        keeps the last value).

        ``collect_fluxes`` (a runner built with ``collect_fluxes=True``)
        returns the per-hour h/q history, each hour's last sub-step's, as a
        dict of ``[T, S]`` tensors (``h_front``, ``h_back``, ``q_front``,
        ``q_back``); ``collect_operative`` (a runner built with
        ``collect_operative=True``) the per-hour operative temperature ``[T,
        Z]``, ``(T_air + T_mrt)/2`` of each hour's final state.

        Returns ``(final SimState, zone_T [T, Z] or None)``, then the fluxes
        with ``collect_fluxes``, the loads with ``collect_loads`` and the
        operative temperatures with ``collect_operative``, in that order
        (heatx's).
        """
        if collect_fluxes and not self._collect_hq:
            raise ValueError(
                "construct the runner with collect_fluxes=True to collect the h/q history"
            )
        if collect_operative and not self._collect_op:
            raise ValueError(
                "construct the runner with collect_operative=True to collect the "
                "operative-temperature history"
            )
        if collect_loads and not self._has_loads:
            raise ValueError(
                "collect_loads requires setpoint-driven HVAC "
                "(IdealHeaterCooler with heat_setpoint/cool_setpoint)"
            )
        b = self._tm.building
        H = self._hours
        prep = self._prepare(inputs_seq, interp_weather)
        T_steps, D = prep.T_steps, prep.D

        Tb, zTb = self.to_blocked(state)
        chunk_D = D if dispatch_days is None else max(1, int(dispatch_days))
        defer = min(chunk_D, D) * H * b.n_surfaces < DEFER_CHECK_SURFACE_HOURS
        NB = self._bb.n_blocks
        starts = set(range(0, D, chunk_D))
        gday = None
        if ground_hourly is not None:
            g = _np(ground_hourly).astype(np.float64)
            if g.shape != (T_steps,):
                raise ValueError(
                    f"ground_hourly must be [{T_steps}] (one value per hour), got {g.shape}"
                )
            gd = g.reshape(D, H)
            if not (gd == gd[:, :1]).all():
                raise ValueError(
                    f"ground_hourly must be constant within each {H}-hour kernel chunk "
                    "(use a daily-or-coarser series, or hours=1)"
                )
            gday = gd[:, 0]
            starts |= set(int(i) for i in np.flatnonzero(np.diff(gday)) + 1)
        starts = sorted(starts)
        self.dispatch_starts = starts

        def check_bad(d0, bad_c):
            if float(bad_c.sum()) <= 0:
                return
            bad_np = _np(bad_c).reshape(-1, H, NB)
            ci, hi, bi = (int(x) for x in np.argwhere(bad_np > 0)[0])
            hour = (d0 + ci) * H + hi
            raise FloatingPointError(
                f"non-finite state first detected at hour {hour} (day "
                f"{hour // 24}, block {bi}): {int(bad_np[ci, hi, bi])} bad values"
            )

        hists, bads, loads, hqhs, tops = [], [], [], [], []
        pending = None
        hq = last_ld = None
        for si, d0 in enumerate(starts):
            n_days = (starts[si + 1] if si + 1 < len(starts) else D) - d0
            if gday is not None and (si == 0 or gday[d0] != gday[starts[si - 1]]):
                self.set_ground_temperature(float(gday[d0]))
            hist_c, bad_c = [], []
            for hi in self._day_inputs(prep, d0, n_days):
                Tb, zTb, hq, zt_hist, *rest = self._march(self.params, Tb, zTb, hi)
                if self._collect_hq:
                    hqh, *rest = rest
                    if collect_fluxes:
                        hqhs.append(torch.stack(hqh, dim=1))
                if self._collect_op:
                    *rest, top = rest
                    if collect_operative:
                        tops.append(top)
                bad, *ld = rest
                hist_c.append(zt_hist)
                bad_c.append(bad)
                if ld:
                    last_ld = ld[0]
                if collect_loads:
                    loads.append(ld[0])
            if collect_zone_T:
                hists.extend(hist_c)
            if assert_finite:
                bad_c = torch.stack(bad_c)
                if defer:
                    bads.append((d0, bad_c))
                else:
                    if pending is not None:
                        check_bad(*pending)
                    pending = (d0, bad_c)
        if pending is not None:
            check_bad(*pending)
        if bads and float(sum(bc.sum() for _, bc in bads)) > 0:
            for d0, bc in bads:
                check_bad(d0, bc)

        final = self.from_blocked(Tb, zTb, hq)
        if last_ld is not None:  # the last marched hour's mean ideal power
            final.ideal_load = last_ld[-1].reshape(-1)[self._zinv]
        zone_T = None
        if collect_zone_T:
            hist = torch.cat(hists, dim=0).reshape(T_steps, -1)
            zone_T = hist[:, self._zinv]
        ret = (final, zone_T)
        if collect_fluxes:
            hqh = torch.cat(hqhs, dim=0)  # [T, 4, SP]
            ret += (dict(zip(("h_front", "h_back", "q_front", "q_back"), hqh[:, :, self._inv].unbind(1))),)
        if collect_loads:
            ret += (torch.cat(loads, dim=0).reshape(T_steps, -1)[:, self._zinv],)
        if collect_operative:
            ret += (torch.cat(tops, dim=0).reshape(T_steps, -1)[:, self._zinv],)
        return ret

    # -- gradients ----------------------------------------------------------

    def _check_chunk_options(self, who, collect_loads, schedule_fn):
        if collect_loads and not self._has_loads:
            raise ValueError(
                f"{who}(collect_loads=True) requires setpoint-driven HVAC "
                "(IdealHeaterCooler with heat/cool setpoints)"
            )
        if schedule_fn is not None and not self._scheduled_sp:
            raise ValueError(f"{who}: schedule_fn requires a scheduled_setpoints=True runner")

    def chunk_forward(self, apply_params, loss_fn, collect_loads=False, schedule_fn=None, **run_kw):
        """The forward sweep of :func:`heatx_torch.engine.adjoint.chunked_value_and_grad`
        (heatx ``FastRunner.chunk_forward``).

        ``apply_params(params) -> CompiledBuilding`` maps the optimization
        parameters to a same-layout building whose DIFF fields
        (``heatx_torch.ops.day_adjoint.DIFF_NODE``/``DIFF_SURF``, in surface
        order), ``zone_volume`` and, with thermostats, ``ctl_heat_sp``/
        ``ctl_cool_sp`` may be torch tensors computed from the params; every
        other field must keep the runner's values.
        ``loss_fn(zt_hist, xs) -> scalar`` scores one chunk from its per-hour
        zone temperatures ``[H, zones]``; with ``collect_loads=True``
        (thermostats only) the contract is ``loss_fn(zt_hist, loads_hist,
        xs)`` with the per-hour mean ideal loads ``[H, zones]`` (W, heating
        positive): the demand objective.  ``schedule_fn(params, xs) ->
        {"heat_sp": ..., "cool_sp": ...}`` (scheduled runners) derives the
        chunk's setpoint schedules from the parameters; they replace those of
        ``xs``.  ``run_kw`` pass through to :meth:`run`.  The returned
        ``forward_fn(params, state, xs)`` re-blocks the parameter rows only
        when the parameter values change, then runs the chunk."""
        self._check_chunk_options("chunk_forward", collect_loads, schedule_fn)
        # The paired chunk_grad checks this record: a backward that
        # recomputes a different trajectory would give a silently wrong
        # gradient.  Unlike heatx (ROADMAP C, api.py:704) the record keeps
        # every trajectory-changing run option, not only interp_weather.
        self._fw_contract = dict(
            interp_weather=bool(run_kw.get("interp_weather", False)),
            collect_loads=bool(collect_loads),
            schedule_fn=schedule_fn is not None,
            trajectory_options=sorted(set(run_kw) - TRAJECTORY_NEUTRAL - {"interp_weather"}),
        )

        def forward_fn(params, state, xs):
            with torch.no_grad():
                self._sync_params(apply_params, params)
                if schedule_fn is not None:
                    xs = xs.replace(**schedule_fn(params, xs))
                out = self.run(state, xs, collect_loads=collect_loads, **run_kw)
                final, zt = out[:2]
                if collect_loads:  # after the fluxes dict, where there is one
                    return final, loss_fn(zt, out[2 + bool(run_kw.get("collect_fluxes"))], xs)
                return final, loss_fn(zt, xs)

        return forward_fn

    def _sync_params(self, apply_params, params):
        """Re-block the parameter rows iff ``apply_params`` (the callable
        itself, not its id) or the parameter VALUES changed (heatx
        ``_sync_params``): one optimizer step re-blocks once."""
        key = tuple(_np(v).tobytes() for v in tree_flatten(params)[0])
        if getattr(self, "_param_fn", None) is not apply_params or getattr(self, "_param_key", None) != key:
            with torch.no_grad():
                self.params = self._blocked_params(apply_params(params))
            self._param_fn, self._param_key = apply_params, key

    def _blocked_params(self, building: CompiledBuilding):
        """``self.params`` with the DIFF rows and zone volumes of
        ``building``, blocked differentiably.  Raises if ``building`` changed
        any other field: the runner holds those fixed (:meth:`update_building`
        swaps a whole building)."""
        base = dict(_fields(self._building))
        free = self._diff_fields()
        changed = [
            name for name, v in _fields(building) if name not in free and not _same(v, base[name])
        ]
        if changed:
            raise ValueError(
                f"apply_params changed building fields the runner holds fixed: {changed}. "
                "Only the differentiated fields and zone_volume may change; build a new "
                "fast_runner for another building"
            )
        return self._blocker(
            self.params, building.surfaces, building.zone_volume,
            building.ctl_heat_sp if self._has_loads else None,
            building.ctl_cool_sp if self._has_loads else None,
        )

    def _diff_fields(self):
        """The building fields ``apply_params`` may change and feed: the
        adjoint's DIFF set, plus the compiled setpoints on a building with
        thermostats (heatx api.py:769-771)."""
        return DIFF_FIELDS | CTL_FIELDS if self._has_loads else DIFF_FIELDS

    def make_adjoint(self):
        """The day adjoint of this runner's march (``DayAdjoint.raw``, or its
        plain version on a ``use_kernel=False`` runner): heatx's refusals of
        ``make_day_adjoint`` apply."""
        adj = day_adjoint.make_day_adjoint(
            self._bb, substeps=self._substeps, mode=self._mode, hours=self._hours,
            refresh_every=self.hour_march.refresh_every if self._mode == "trbdf2_refresh" else None,
            device=self.device, scheduled_setpoints=self._scheduled_sp,
        )
        return adj.raw if self._use_kernel else functools.partial(adj.raw, plain=True)

    def grad_run(self, building: CompiledBuilding, state: SimState, inputs_seq: StepInputs,
                 collect_loads: bool = False, interp_weather: bool = False, adjoint=None,
                 who: str = "grad_run: the building"):
        """:meth:`run`'s march, differentiable: each day runs through
        :class:`~heatx_torch.ops.day_adjoint.DayMarchFn` (the day march
        forward, the day adjoint backward: one launch of each a day) on the
        rows of ``building`` blocked differentiably and the blocked
        ``state.node_T``/``state.zone_T``.  ``building`` may differ from the
        runner's in the differentiated fields only (:meth:`_diff_fields`);
        ``adjoint`` reuses a :meth:`make_adjoint`.  Returns ``(final state,
        zone_T [T, Z], loads [T, Z] or None)``; the final h/q carry no
        gradient.  Raises (ValueError) where a field the adjoint does not
        differentiate requires grad (``who`` names the caller), and on
        ``collect_loads`` without thermostats."""
        self._check_grad_scope(building, who)
        if collect_loads and not self._has_loads:
            raise ValueError(
                "collect_loads requires setpoint-driven HVAC "
                "(IdealHeaterCooler with heat_setpoint/cool_setpoint)"
            )
        adjoint = self.make_adjoint() if adjoint is None else adjoint
        hist, loads, hq = [], [], None
        with torch.enable_grad():
            p = self._blocked_params(building)
            T, zT = self._blocked_state(state.node_T, state.zone_T)
            prep = self._prepare(inputs_seq, interp_weather)
            for hi in self._day_inputs(prep, 0, prep.D):
                outs = day_adjoint.DayMarchFn.apply(
                    self._grad_march, adjoint, p, p.node, p.surf, p.zone_volume,
                    T, zT, *hi, ctl=p.ctl, mrt=p.mrt,
                )
                T, zT, hq = outs[0], outs[1], outs[3:7]
                hist.append(outs[2])
                if collect_loads:
                    loads.append(outs[-1])

        def zone_order(rows):
            return torch.cat(rows).reshape(prep.T_steps, -1)[:, self._zinv]

        return self.from_blocked(T, zT, hq), zone_order(hist), (zone_order(loads) if collect_loads else None)

    def _check_grad_scope(self, building: CompiledBuilding, who: str):
        """Raise if a building field the adjoint does not differentiate holds
        a tensor that requires grad: its gradient would silently be zero.
        Runs on every backward call, at the current parameter values (heatx
        probes once at the first values and caches, ROADMAP C api.py:825)."""
        free = self._diff_fields()
        bad = [name for name, v in _fields(building) if name not in free and _requires_grad(v)]
        if bad:
            raise ValueError(
                f"{who} feeds building fields the adjoint day march "
                f"does not differentiate: {bad}.  Their gradients would silently be zero"
            )

    def chunk_grad(
        self, apply_params, loss_fn, interp_weather: bool = False, collect_loads=False,
        schedule_fn=None, **run_kw,
    ):
        """The backward sweep of :func:`heatx_torch.engine.adjoint.chunked_value_and_grad`
        (heatx ``FastRunner.chunk_grad``): pair it with :meth:`chunk_forward`
        built from the same ``apply_params``/``loss_fn``.

        ``backward_fn(params, state, xs, state_cot, loss_cot)`` re-runs the
        chunk from its start state day by day through
        :class:`~heatx_torch.ops.day_adjoint.DayMarchFn` (the day march
        forward, the adjoint day march backward: the CUDA kernels on a GPU)
        with the parameter rows blocked differentiably from
        ``apply_params(params)``, and takes ``torch.autograd.grad`` of the
        chunk loss and the final state onto the params and the start state.
        Cotangents on h/q are not propagated (as in heatx).  With
        ``collect_loads=True`` the loss is ``loss_fn(zt_hist, loads_hist,
        xs)`` and the load cotangent is seeded into the adjoint day march;
        the compiled setpoints ``ctl_heat_sp``/``ctl_cool_sp`` are
        differentiated on any building with thermostats.  With
        ``schedule_fn`` the schedule cotangents go back to the params through
        the one call of ``schedule_fn(params, xs)`` on the caller's ``xs``
        (heatx linearizes it a second time around the ``xs`` it has already
        replaced, ROADMAP C api.py:1173; the port does not).

        Raises (ValueError): ``run_kw`` outside TRAJECTORY_NEUTRAL; a paired
        chunk_forward with a different ``interp_weather``, ``collect_loads``
        or ``schedule_fn`` presence, or with trajectory-changing options;
        ``collect_loads`` without thermostats, ``schedule_fn`` without a
        scheduled runner; ``apply_params`` feeding non-differentiated fields
        (checked on every call); a building with in-run shading or
        ventilation gates (heatx's adjoint refuses both)."""
        unsupported = set(run_kw) - TRAJECTORY_NEUTRAL
        if unsupported:
            raise ValueError(
                f"chunk_grad: run options {sorted(unsupported)} change the forward "
                "trajectory in ways the backward does not recompute"
            )
        if self._scheduled_shade:
            raise ValueError(
                "chunk_grad: in-run zone shading is not supported (heatx's XLA backward, "
                "ROADMAP A10, is not ported)"
            )
        self._check_chunk_options("chunk_grad", collect_loads, schedule_fn)
        fw = getattr(self, "_fw_contract", None)
        if fw is not None:
            mine = dict(interp_weather=bool(interp_weather), collect_loads=bool(collect_loads),
                        schedule_fn=schedule_fn is not None)
            bad = [k for k, v in mine.items() if fw[k] != v] + fw["trajectory_options"]
            if bad:
                raise ValueError(
                    f"chunk_grad: {bad} differ from this runner's last chunk_forward: the "
                    "backward would differentiate a different trajectory"
                )
        adjoint = self.make_adjoint()

        def backward_fn(params, state, xs, state_cot, loss_cot):
            p_leaves, rebuild = tree_flatten(params)
            leaves = [
                x.detach().requires_grad_() if isinstance(x, torch.Tensor) and x.is_floating_point() else x
                for x in p_leaves
            ]
            wrt = [x for x in leaves if isinstance(x, torch.Tensor) and x.requires_grad]
            node_T = state.node_T.detach().requires_grad_()
            zone_T = state.zone_T.detach().requires_grad_()
            with torch.enable_grad():
                live = rebuild(leaves)
                building = apply_params(live)
                if schedule_fn is not None:
                    xs = xs.replace(**schedule_fn(live, xs))
                final, zt, loads = self.grad_run(
                    building, dataclasses.replace(state, node_T=node_T, zone_T=zone_T), xs,
                    collect_loads, interp_weather, adjoint, who="chunk_grad: apply_params",
                )
                loss = loss_fn(zt, loads, xs) if collect_loads else loss_fn(zt, xs)
                outs = [loss, final.node_T, final.zone_T]
                cots = [
                    torch.as_tensor(loss_cot, dtype=loss.dtype, device=loss.device),
                    state_cot.node_T.to(final.node_T.dtype), state_cot.zone_T.to(final.node_T.dtype),
                ]
                grads = torch.autograd.grad(outs, wrt + [node_T, zone_T], cots, allow_unused=True)
            grads = [torch.zeros_like(x) if g is None else g for x, g in zip(wrt + [node_T, zone_T], grads)]
            it = iter(grads[:len(wrt)])
            params_cot = rebuild([
                next(it) if isinstance(x, torch.Tensor) and x.requires_grad else None for x in leaves
            ])
            state_cot_out = SimState(
                node_T=grads[-2].to(state.node_T.dtype), zone_T=grads[-1].to(state.zone_T.dtype),
                h_front=torch.zeros_like(state.h_front), h_back=torch.zeros_like(state.h_back),
                q_front=torch.zeros_like(state.q_front), q_back=torch.zeros_like(state.q_back),
                ideal_load=None if state.ideal_load is None else torch.zeros_like(state.ideal_load),
            )
            return params_cot, state_cot_out

        return backward_fn

"""The adjoint day march: heatx's reverse-sweep Pallas kernel, on PyTorch/CUDA.

Counterpart of ``heatx.ops.pallas_adjoint`` for modes ``trbdf2``,
``trbdf2_refresh`` and ``parity``, with thermostats, scheduled setpoints and
inter-zone mixing.  :func:`make_day_adjoint` returns ``day_adjoint(params, T0, zT0,
hour_inputs, cots) -> dict`` with heatx's call signature, keys and blocked
shapes: ``params`` and ``hour_inputs`` are those of
:func:`heatx_torch.ops.day_march.make_hour_march`, ``T0 [N, SP]``/``zT0 [NB,
ZB]`` the day-START state, and ``cots = (dT_final, d_zT_final, d_zt_hist[,
d_ld_hist])`` the cotangents of the day's outputs (any may be None for zero;
``d_ld_hist``, the cotangent of the per-hour mean ideal loads, needs
thermostats).  The dict holds ``dT0`` [N, SP], ``d_zT0`` [NB, ZB],
``d_params`` ({name: [N, SP] for DIFF_NODE, [SP] for DIFF_SURF}),
``d_zone_volume`` [NB, ZB], ``d_sol_front``/``d_sol_back``/``d_ir_front``/
``d_ir_back`` [hours, SP] and ``d_a_extra``/``d_b_extra`` [hours, NB, ZB];
with thermostats also ``d_ctl_heat``/``d_ctl_cool`` [NB, ZB] (the compiled
setpoint rows; zero under scheduled setpoints, where the march reads the
schedule instead) and, under ``scheduled_setpoints``, ``d_sp_heat``/
``d_sp_cool`` [hours, NB, ZB].  The capacities ``max_heat``/``max_cool``,
the mixing flows and the masks are not differentiated, as in heatx.

Dispatch is by device, with no fallback: CPU tensors run the plain version
(:func:`plain_day_adjoint`), CUDA tensors launch the hand-written kernel in
``heatx_torch/csrc/day_adjoint.cu`` or raise; ``day_adjoint.plain`` runs the
plain version on any device.

The plain version is heatx's structure with autograd in place of the
trace-time ``jax.vjp``: march the day forward keeping each hour's start
state, then for h = hours-1 ... 0 re-run the hour body on that start under
``torch.enable_grad`` and pull the carried cotangents back with
``torch.autograd.grad``.  Memory stays at one hour's tape.  The kernel's
adjoint is derived by hand (design note in the CUDA source); both give the
cotangents of autograd through :func:`heatx_torch.ops.day_march.plain_day_march`.

:class:`DayMarchFn` joins the two: a ``torch.autograd.Function`` whose
forward is the day march and whose backward is the day adjoint, so a chain
of days differentiates with ``torch.autograd`` (``FastRunner.chunk_grad``).

Both kernels run four threads per surface on their forward kernel's device
code (the TR-BDF2 body ``csrc/day_adjoint_tr.cu``, the parity body
``csrc/day_adjoint_parity.cu``) and keep one hour's tape in a
wrapper-allocated workspace (TR-BDF2 ``[2 substeps + 1, 32, SP]``, parity
``[substeps, 32, SP]``); a block whose rows would not fit shared memory in its
128- or 256-thread launch variant runs the 1024-thread one, which keeps the
hour's zone rows and weather in that workspace too, so that its shared memory
does not grow with the sub-steps: no building that the day march takes is
refused for its sub-steps or nodes.

Parity mode: heatx unrolls the sub-steps of ``_hour_body`` under its
trace-time vjp, so its trace grows with the stability sub-step count.  The
plain version here differentiates :func:`heatx_torch.ops.day_march.plain_hour_parity`
hour by hour as it does the TR-BDF2 body, and the kernel reverses one sub-step
at a time from the taped sub-step starts, recomputing each sub-step's forward
on the parity march kernel's code.  The no-mass iteration's update, increase and
convergence masks are piecewise constant and carry no cotangent, as under
``jax.vjp``.  ``substeps`` must be given and be the building's
``dt_subdivisions`` (heatx checks only that it is given; with another count
its adjoint would step by a dt the march does not use).

Gas cavities: the cavity U of a segment is a function of its two node
temperatures at each operator build, so K's band cotangent on a cavity
segment goes through dU/dT into that build's column and not to ``seg_u``,
whose cotangent there is exactly 0; the gas operands and the cavity geometry
are not differentiated (heatx pallas_adjoint.py:44-47).

Interior MRT: the Carroll network's effective emissivities are operands
(``params.mrt``), and their cotangents come out as ``d_params["mrt_eps_f"]``
/ ``["mrt_eps_b"]`` [SP] where the building runs MRT physics (heatx
``MRT_NAMES``); ``FastRunner.chunk_grad`` pulls them back to ``area`` and the
emissivities through ``day_march.mrt_eps_blocked``.  The kernel recomputes
the network's four iterations from the column that built the operators (a
TR-BDF2 refresh group's start, a parity sub-step's start) and walks them
back: the transpose of a face's gather of its zone node is the zone's
fixed-order face sum, the transpose of the zone sums a per-face read of the
zone's cotangent.
"""

from __future__ import annotations

import ctypes
from dataclasses import replace

import torch

from heatx_torch.engine import implicit as imp_mod
from heatx_torch.engine import surface as surf_mod
from heatx_torch.ops import cuda_lib, day_march
from heatx_torch.ops.day_march import BlockedBuilding, DayMarchParams, SURF_FIELDS

# The building parameters the adjoint differentiates (heatx's names,
# pallas_adjoint.py:94-108).  ``mass`` is the heat capacity of massive nodes:
# DayMarchParams carries ``capacity = where(massive, mass, 0)``, so its
# cotangent is the capacity's on massive nodes and 0 elsewhere.
DIFF_NODE = ("mass", "seg_u", "front_alphas", "back_alphas")
DIFF_SURF = (
    "area", "perimeter", "cos_tilt", "wind_mod", "eps_front", "eps_back", "rf",
    "front_temp", "back_temp", "fixed_h_front", "fixed_h_back",
)
DIFF_CHANNELS = ("sol_front", "sol_back", "ir_front", "ir_back")
#: The DayMarchParams.node row of each DIFF_NODE name (NODE_FIELDS order).
NODE_ROW = {"seg_u": 0, "mass": 1, "front_alphas": 2, "back_alphas": 3}

#: The adjoint's compilation units (as day_march.KERNEL_SOURCES): the C entry,
#: the parity body and the TR-BDF2 body, each with its kMrt unit and its
#: cluster-variant unit.
KERNEL_SOURCES = tuple(cuda_lib.CSRC_DIR / name for name in (
    "day_adjoint.cu", "day_adjoint_parity.cu", "day_adjoint_parity_mrt.cu", "day_adjoint_parity_b1.cu",
    "day_adjoint_tr.cu", "day_adjoint_tr_mrt.cu", "day_adjoint_tr_b1.cu"))


def plain_day_adjoint(
    params: DayMarchParams, T0, zT0, t_out, wind, wdir, sol_front, sol_back,
    ir_front, ir_back, a_extra, b_extra, sp_heat, sp_cool, dT, d_zT, d_zt_hist,
    d_ld_hist, *, hours: int, substeps: int, refresh_every: int, dt: float, config,
    parity: bool = False, starts=None,
):
    """The plain PyTorch day adjoint on any device: the reference the CUDA
    kernel is held against (``parity``: of the reference-parity march).
    Operands as ``day_march.plain_day_march``
    (``sp_heat``/``sp_cool`` None without a schedule) plus the cotangents
    ``dT`` [N, SP], ``d_zT`` [NB, ZB], ``d_zt_hist`` and ``d_ld_hist``
    [hours, NB, ZB] (the last None without thermostats).  Returns ``(dT0
    [N, SP], d_zT0 [NB, ZB], d_node [4, N, SP], d_surf [13, SP],
    d_zone_volume [NB, ZB], d_chan [4, hours, SP], d_a_extra, d_b_extra
    [hours, NB, ZB], d_ctl [4, NB, ZB], d_sp_heat, d_sp_cool [hours, NB,
    ZB], d_mrt [2, SP])``; ``d_mrt`` (MRT_FIELDS) is None without MRT
    physics; ``d_node`` follows NODE_FIELDS with the capacity row holding the
    ``mass`` cotangent, ``d_surf`` follows SURF_FIELDS (normal rows 0),
    ``d_chan`` follows DIFF_CHANNELS, ``d_ctl`` the thermostat rows (capacity
    rows 0; None without thermostats), ``d_sp_*`` None without a schedule.
    ``starts`` (``hours`` pairs ``(T [N, SP], zT [NB, ZB])``) re-runs each
    hour from the given state in place of the plain march's own: the adjoint
    along another march's hour starts (a kernel's, whose f32 thermostat may
    land a sub-step apart from the plain march's)."""
    NB, ZB = params.n_blocks, params.zones_per_block
    has_ctl, sched = params.ctl is not None, sp_heat is not None
    mix = day_march._mix_slots(params)
    kw = dict(
        cfg=config, t_out_arr=t_out, wind_arr=wind, wdir_arr=wdir,
        substeps=substeps, dt_sub=dt, refresh_every=refresh_every, mix=mix,
    )

    def hour(p, zone_volume, h, T, zT, chans, a_h, b_h, sp_h):
        sbv = day_march._lanes(p, chunks=parity)
        st = surf_mod.compute_statics(sbv)  # inside the tape: cos_tilt's TARP coefficients
        ctl = None
        if has_ctl:
            rows = p.ctl.reshape(4, -1)
            ctl = (sp_h if sched else (rows[0], rows[1])) + (rows[2], rows[3])
        T, zT, _, ld = day_march.hour_body(
            parity, sbv, st, zone_volume=zone_volume, a_extra=a_h, b_extra=b_h,
            sol_front=chans[0], sol_back=chans[1], ir_front=chans[2], ir_back=chans[3],
            T0=T, zT0=zT, off=h * substeps, ctl=ctl, **kw,
        )
        return T, zT, ld

    def sp_rows(h):
        return (sp_heat[h].reshape(-1), sp_cool[h].reshape(-1)) if sched else ()

    channels = (sol_front, sol_back, ir_front, ir_back)
    if starts is None:
        starts = []
        with torch.no_grad():
            T, zT = T0, zT0.reshape(-1)
            for h in range(hours):
                starts.append((T, zT))
                T, zT, _ = hour(params, params.zone_volume.reshape(-1), h, T, zT,
                                [c[h] for c in channels], a_extra[h].reshape(-1),
                                b_extra[h].reshape(-1), sp_rows(h))
    else:
        starts = [(T.to(T0.dtype), zT.to(T0.dtype).reshape(-1)) for T, zT in starts]

    node = params.node.detach().requires_grad_()
    surf = params.surf.detach().requires_grad_()
    zone_volume = params.zone_volume.detach().reshape(-1).requires_grad_()
    ctl = params.ctl.detach().requires_grad_() if has_ctl else None
    has_mrt = bool(config.interior_mrt)
    mrt = params.mrt.detach().requires_grad_() if has_mrt else params.mrt
    p = replace(params, node=node, surf=surf, ctl=ctl, mrt=mrt)
    gT, gz = dT, d_zT.reshape(-1)
    g_node, g_surf, g_zv = (torch.zeros_like(x) for x in (node, surf, zone_volume))
    g_ctl = torch.zeros_like(ctl) if has_ctl else None
    g_mrt = torch.zeros_like(mrt) if has_mrt else None
    g_chan = torch.zeros((4,) + tuple(sol_front.shape), dtype=T0.dtype, device=T0.device)
    g_a = torch.zeros_like(a_extra)
    g_b = torch.zeros_like(b_extra)
    g_sp = (torch.zeros_like(sp_heat), torch.zeros_like(sp_cool)) if sched else (None, None)
    for h in reversed(range(hours)):
        gz = gz + d_zt_hist[h].reshape(-1)
        with torch.enable_grad():
            T = starts[h][0].detach().requires_grad_()
            zT = starts[h][1].detach().requires_grad_()
            chans = [c[h].detach().requires_grad_() for c in channels]
            a_h = a_extra[h].reshape(-1).detach().requires_grad_()
            b_h = b_extra[h].reshape(-1).detach().requires_grad_()
            sp_h = tuple(x.detach().requires_grad_() for x in sp_rows(h))
            T1, zT1, ld = hour(p, zone_volume, h, T, zT, chans, a_h, b_h, sp_h)
            leaves = (T, zT, node, surf, zone_volume, *chans, a_h, b_h) + sp_h
            leaves += ((ctl,) if has_ctl else ()) + ((mrt,) if has_mrt else ())
            outs, cots = (T1, zT1), (gT, gz)
            if has_ctl:
                outs, cots = outs + (ld,), cots + (d_ld_hist[h].reshape(-1),)
            grads = torch.autograd.grad(outs, leaves, cots, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
        gT, gz = grads[0], grads[1]
        g_node += grads[2]
        g_surf += grads[3]
        g_zv += grads[4]
        for c in range(4):
            g_chan[c, h] = grads[5 + c]
        g_a[h] = grads[9].reshape(NB, ZB)
        g_b[h] = grads[10].reshape(NB, ZB)
        if sched:
            g_sp[0][h] = grads[11].reshape(NB, ZB)
            g_sp[1][h] = grads[12].reshape(NB, ZB)
        if has_ctl:
            g_ctl += grads[-1 - has_mrt]
        if has_mrt:
            g_mrt += grads[-1]
    # The capacity row holds the mass cotangent: capacity = where(massive, mass, 0).
    g_node[1] = torch.where(day_march.bit_rows(params, "mass_bits"), g_node[1], 0.0)
    g_surf[SURF_FIELDS.index("normal_x"):] = 0.0
    if has_ctl:
        g_ctl[2:] = 0.0  # the capacities are not differentiated
    return (gT, gz.reshape(NB, ZB), g_node, g_surf, g_zv.reshape(NB, ZB), g_chan, g_a, g_b,
            g_ctl, *g_sp, g_mrt)


# ---------------------------------------------------------------------------
# The CUDA kernel wrapper
# ---------------------------------------------------------------------------

_N_PTRS = 49


def _load_library():
    lib = cuda_lib.load("heatx_day_adjoint", KERNEL_SOURCES)
    if not getattr(lib, "_heatx_bound", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.heatx_day_adjoint_f32, lib.heatx_day_adjoint_f64):
            fn.argtypes = [vp, ci, vp, vp, ctypes.POINTER(ci), vp]
            fn.restype = ci
        lib.heatx_cuda_error_string.argtypes = [ci]
        lib.heatx_cuda_error_string.restype = ctypes.c_char_p
        lib._heatx_bound = True
    return lib


def load_kernel() -> None:
    """Build (at first use) and load the day-adjoint kernel library."""
    _load_library()


class DayAdjointKernel:
    """Launches ``day_adjoint.cu`` on CUDA tensors.  ``launches`` counts the
    launches made through this wrapper (and nothing else).  Arguments and
    returns as :func:`plain_day_adjoint`; of the cotangents only
    ``d_ld_hist`` may be None here (and must be, without thermostats).
    ``block_threads`` reads back the threads of a block of the launch variant
    the last launch ran in."""

    def __init__(self):
        self.launches = 0
        self.block_threads = None
        self.shape = None  # the last launch's day_march.LaunchShape
        self.parity_launches = 0  # those of ``launches`` that ran the parity kernel
        self.cavity_launches = 0  # those of ``launches`` on a building with gas cavities
        self.parity_cavity_launches = 0  # those of ``cavity_launches`` in parity mode
        self.mrt_launches = 0  # those of ``launches`` with MRT physics
        self.parity_mrt_launches = 0  # those of ``mrt_launches`` in parity mode

    def __call__(
        self, params: DayMarchParams, T0, zT0, t_out, wind, wdir, sol_front,
        sol_back, ir_front, ir_back, a_extra, b_extra, sp_heat, sp_cool, dT, d_zT,
        d_zt_hist, d_ld_hist, *, hours: int, substeps: int, refresh_every: int,
        dt: float, config, parity: bool = False,
    ):
        return self._launch(
            params, T0, zT0, t_out, wind, wdir, sol_front, sol_back, ir_front, ir_back, a_extra,
            b_extra, sp_heat, sp_cool, dT, d_zT, d_zt_hist, d_ld_hist, hours=hours,
            substeps=substeps, refresh_every=refresh_every, dt=dt, config=config, parity=parity,
        )[0]

    def _launch(
        self, params: DayMarchParams, T0, zT0, t_out, wind, wdir, sol_front,
        sol_back, ir_front, ir_back, a_extra, b_extra, sp_heat, sp_cool, dT, d_zT,
        d_zt_hist, d_ld_hist, *, hours: int, substeps: int, refresh_every: int,
        dt: float, config, parity: bool = False,
    ):
        """One launch: returns ``(outs, (T_ws [hours, N, SP], zT_ws [hours,
        NB, ZB]))``, the second the hour-start workspace (the recompute's
        state at each hour's start)."""
        N, NB, ZB = params.max_nodes, params.n_blocks, params.zones_per_block
        SB = params.block_size
        SP = NB * SB
        dtype = T0.dtype
        has_ctl, sched, mix = params.ctl is not None, sp_heat is not None, params.mix
        if d_ld_hist is not None and not has_ctl:
            raise ValueError("d_ld_hist needs thermostat rows (params.ctl)")
        expect = day_march.launch_operands(
            "day_adjoint", params, T0, zT0, t_out, wind, wdir, sol_front, sol_back, ir_front,
            ir_back, a_extra, b_extra, sp_heat, sp_cool, hours=hours, substeps=substeps,
            refresh_every=refresh_every,
        )
        expect.update({
            "dT": (dT, (N, SP), dtype), "d_zT": (d_zT, (NB, ZB), dtype),
            "d_zt_hist": (d_zt_hist, (hours, NB, ZB), dtype),
        })
        if has_ctl:
            expect["d_ld_hist"] = (d_ld_hist, (hours, NB, ZB), dtype)
        cuda_lib.check_operands(expect, T0.device)
        lib = _load_library()
        fn = lib.heatx_day_adjoint_f32 if dtype == torch.float32 else lib.heatx_day_adjoint_f64
        kw = dict(dtype=dtype, device=T0.device)
        # Workspace: each hour's start state (the kernel allocates nothing),
        # then one hour's tape (each thread's rows at every sub-step start; in
        # TR-BDF2 mode also of every sub-step's stage-1 state) and each block's
        # zone rows and weather of the hour's sub-steps (csrc/day_adjoint_tr.cu,
        # csrc/day_adjoint_parity.cu: the only bound on the sub-steps is memory).
        T_ws = torch.empty((hours, N, SP), **kw)
        zT_ws = torch.empty((hours, NB, ZB), **kw)
        # The tape holds the launch's own node capacity a lane, and the zone
        # rows one set a CTA (every CTA of a cluster keeps the component's).
        shape = day_march.launch_shape(SB, N)
        columns, weather = (substeps, 4 * substeps) if parity else (2 * substeps + 1, 3 * substeps)
        tape = torch.empty((columns * shape.nodes * SP + NB * shape.cluster * ((3 * substeps + 1) * ZB + weather),),
                           **kw)
        outs = (
            torch.empty((N, SP), **kw), torch.empty((NB, ZB), **kw),
            torch.empty((4, N, SP), **kw), torch.empty((len(SURF_FIELDS), SP), **kw),
            torch.empty((NB, ZB), **kw), torch.empty((4, hours, SP), **kw),
            torch.empty((hours, NB, ZB), **kw), torch.empty((hours, NB, ZB), **kw),
            # The thermostat rows' cotangent: the kernel writes the two
            # setpoint rows, the capacity rows stay 0.
            torch.zeros((4, NB, ZB), **kw) if has_ctl else None,
            torch.empty((hours, NB, ZB), **kw) if sched else None,
            torch.empty((hours, NB, ZB), **kw) if sched else None,
            torch.empty((2, SP), **kw) if config.interior_mrt else None,
        )
        mrt = day_march.mrt_operands(params, config) if config.interior_mrt else (None,) * 3
        tensors = [
            params.node, params.surf, params.lane, params.zone_volume, params.zone_ptr,
            params.zone_faces, t_out, wind, wdir, sol_front, sol_back, ir_front, ir_back,
            a_extra, b_extra, T0, zT0, dT, d_zT, d_zt_hist, T_ws, zT_ws, *outs[:8],
            d_ld_hist, params.ctl, sp_heat, sp_cool,
            *((None,) * 6 if mix is None
              else (mix.ptr, mix.src, mix.vol, mix.t_ptr, mix.t_dst, mix.t_vol)),
            *outs[8:11], params.cav, *mrt, outs[11], tape,
        ]
        ptrs = (ctypes.c_void_p * _N_PTRS)(*[None if t is None else t.data_ptr() for t in tensors])
        ints = (ctypes.c_int * 13)(
            N, NB, SB, ZB, hours, substeps, refresh_every, int(config.replicate_ambient_back_bug),
            *day_march.parity_ints(config, parity)[:3], int(config.interior_mrt), shape.index,
        )
        reals = (ctypes.c_double * 8)(
            dt, imp_mod.GAMMA * dt / 2.0, imp_mod.GAMMA * dt, imp_mod.BETA * dt,
            imp_mod.C1, imp_mod.C2, config.nomass_tol, config.nomass_tol_escalated,
        )
        ran = ctypes.c_int(0)
        with torch.cuda.device(T0.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(ctypes.cast(ptrs, ctypes.c_void_p), len(tensors), ctypes.cast(ints, ctypes.c_void_p),
                     ctypes.cast(reals, ctypes.c_void_p), ctypes.byref(ran), stream)
        day_march.raise_launch_error("day_adjoint", lib, err, shape)
        self.block_threads = ran.value
        self.shape = shape
        self.launches += 1
        self.parity_launches += int(parity)
        self.cavity_launches += int(params.cav is not None)
        self.parity_cavity_launches += int(parity and params.cav is not None)
        self.mrt_launches += int(bool(config.interior_mrt))
        self.parity_mrt_launches += int(parity and bool(config.interior_mrt))
        return outs, (T_ws, zT_ws)


#: The process's day-adjoint kernel wrapper (its ``launches`` counter is
#: what chip_smoke.py reads).
day_adjoint_kernel = DayAdjointKernel()


class DayAdjoint:
    """``day_adjoint(params, T0, zT0, hour_inputs, cots) -> dict`` (see the
    module docstring).  CUDA tensors launch the kernel, CPU tensors run the
    plain version; :meth:`plain` runs the plain version on any device and
    :meth:`raw` returns the kernel's tuple instead of the dict."""

    def __init__(self, hour_march: day_march.HourMarch):
        refuse_gates(hour_march.shaded, hour_march.vent_gated)
        self._hm = hour_march
        self.hours = hour_march.hours
        self.substeps = hour_march.substeps

    def _args(self, params, T0, zT0, hour_inputs, cots):
        (T0, zT0, *hi), _ = self._hm._operands(params, T0, zT0, hour_inputs)
        sp = tuple(hi[9:]) if self._hm.scheduled_setpoints else (None, None)
        cots = tuple(cots) + (None,) * (4 - len(cots))
        dT, d_zT, d_zth, d_ld = cots
        has_ctl = params.ctl is not None
        if d_ld is not None and not has_ctl:
            raise ValueError(
                "d_ld_hist, the ideal-load cotangent, requires setpoint-driven HVAC "
                "(IdealHeaterCooler with heat/cool setpoints)"
            )
        H, NB, ZB = self.hours, self._hm.n_blocks, self._hm.zones_per_block

        def cot(c, like, shape):
            if c is None:
                return torch.zeros(shape, dtype=like.dtype, device=like.device)
            return torch.as_tensor(c, dtype=like.dtype, device=like.device).reshape(shape).contiguous()

        cots = (cot(dT, T0, T0.shape), cot(d_zT, T0, (NB, ZB)), cot(d_zth, T0, (H, NB, ZB)),
                cot(d_ld, T0, (H, NB, ZB)) if has_ctl else None)
        return (params, T0, zT0, *hi[:9], *sp, *cots)

    def raw(self, params, T0, zT0, hour_inputs, cots, plain=False):
        args = self._args(params, T0, zT0, hour_inputs, cots)
        kw = self._hm._kw(observables=False)
        if plain or T0.device.type == "cpu":
            return plain_day_adjoint(*args, **kw)
        if T0.device.type == "cuda":
            return day_adjoint_kernel(*args, **kw)
        raise ValueError(f"no day adjoint for device {T0.device}")

    @staticmethod
    def _dict(outs):
        dT0, d_zT0, d_node, d_surf, d_zv, d_chan, d_a, d_b, d_ctl, d_sph, d_spc, d_mrt = outs
        d_params = {name: d_node[NODE_ROW[name]] for name in DIFF_NODE}
        d_params.update({name: d_surf[SURF_FIELDS.index(name)] for name in DIFF_SURF})
        if d_mrt is not None:
            d_params.update(zip(day_march.MRT_FIELDS, d_mrt))
        out = {
            "dT0": dT0, "d_zT0": d_zT0, "d_params": d_params, "d_zone_volume": d_zv,
            **{"d_" + name: d_chan[i] for i, name in enumerate(DIFF_CHANNELS)},
            "d_a_extra": d_a, "d_b_extra": d_b,
        }
        if d_ctl is not None:
            out.update(d_ctl_heat=d_ctl[0], d_ctl_cool=d_ctl[1])
        if d_sph is not None:
            out.update(d_sp_heat=d_sph, d_sp_cool=d_spc)
        return out

    def __call__(self, params, T0, zT0, hour_inputs, cots):
        return self._dict(self.raw(params, T0, zT0, hour_inputs, cots))

    def plain(self, params, T0, zT0, hour_inputs, cots, starts=None):
        """The plain version's dict; ``starts`` as :func:`plain_day_adjoint`'s."""
        args = self._args(params, T0, zT0, hour_inputs, cots)
        return self._dict(plain_day_adjoint(*args, **self._hm._kw(observables=False), starts=starts))


#: Where the refusals below send the caller: heatx's "XLA backward", the
#: port's autograd through the XLA-path integrators, which carry the controls
#: (tests/test_torch_xla_controls_grad.py holds it to heatx's jax.grad).
XLA_BACKWARD = "(use the XLA backward: autograd through ThermalModel.run, engine.step.run)"


def refuse_gates(shaded: bool, vent_gated: bool):
    """heatx's refusals (pallas_adjoint.py:162-171): the adjoint does not
    differentiate in-run zone shading or ventilation gates."""
    if shaded:
        raise ValueError("adjoint kernel: in-run zone shading is not supported " + XLA_BACKWARD)
    if vent_gated:
        raise ValueError("adjoint kernel: in-run ventilation gates are not supported " + XLA_BACKWARD)


def make_day_adjoint(
    bb: BlockedBuilding,
    substeps: int = None,
    mode: str = "trbdf2",
    hours: int = 1,
    refresh_every: int = None,
    device="cuda",
    scheduled_setpoints: bool = False,
) -> DayAdjoint:
    """Build the day adjoint (heatx ``make_day_adjoint`` for modes
    ``trbdf2``/``trbdf2_refresh``): ``day_adjoint(params, T0, zT0,
    hour_inputs, cots) -> dict``, taking the ``params`` that
    ``make_hour_march`` returns for the same arguments (with
    ``scheduled_setpoints``, the 11-leaf hour inputs too).  ``device`` is
    checked as ``make_hour_march`` checks it (``"cuda"``, the default,
    raises without a GPU).  A building with in-run shading or ventilation
    gates raises heatx's ``ValueError``: neither is differentiated; so does
    the adaptive no-mass loop (``nomass_fixed_iters=None``) in parity mode
    on a building with no-mass nodes."""
    if mode == "parity":
        # heatx's rules (pallas_adjoint.py:150-161): the sub-step length is
        # 3600 / (steps per hour x substeps), so the count must be given, and
        # it is the parity march's only when it is the building's own.
        if substeps is None:
            raise ValueError(
                "mode='parity' needs the stability-dictated sub-step count "
                "(building.dt_subdivisions) passed as substeps"
            )
        if substeps != bb.base.dt_subdivisions:
            raise ValueError(
                f"mode='parity': substeps={substeps} is not the building's dt_subdivisions "
                f"({bb.base.dt_subdivisions}); the march it differentiates steps by the "
                "building's dt"
            )
        if bb.surfaces.has_nomass and bb.config.nomass_fixed_iters is None:
            raise ValueError(surf_mod.ADAPTIVE_GRAD_REFUSAL)
    refuse_gates(bb.shade is not None, bb.vent is not None)
    cuda_lib.resolve_device(device)
    return DayAdjoint(day_march.hour_march_for(
        bb, substeps, mode, hours, refresh_every, scheduled_setpoints=scheduled_setpoints
    ))


class _DayMarch(torch.autograd.Function):
    """The autograd node behind :class:`DayMarchFn`: ``apply(hour_march,
    day_adjoint, params, node, surf, zone_volume, ctl, mrt, T, zT,
    *hour_inputs)``, ``ctl`` the thermostat rows and ``mrt`` the Carroll
    network's rows, or None."""

    @staticmethod
    def forward(ctx, hour_march, day_adjoint, params, node, surf, zone_volume, ctl, mrt, T, zT,
                *hour_inputs):
        if getattr(getattr(hour_march, "__self__", hour_march), "adaptive", False):
            raise ValueError(surf_mod.ADAPTIVE_GRAD_REFUSAL)
        p = replace(params, node=node, surf=surf, zone_volume=zone_volume, ctl=ctl, mrt=mrt)
        outs = hour_march(p, T, zT, hour_inputs)
        T1, zT1, hq, zt_hist = outs[:4]
        ctx.save_for_backward(node, surf, zone_volume, ctl, mrt, T, zT, *hour_inputs)
        ctx.params = params
        ctx.adjoint = day_adjoint
        ctx.mark_non_differentiable(*hq)
        # The load history is the last output of a thermostat march.
        return (T1, zT1, zt_hist) + tuple(hq) + ((outs[-1],) if ctl is not None else ())

    @staticmethod
    def backward(ctx, gT, gzT, g_hist, *rest):
        refuse_gates(ctx.params.shade_slot is not None, ctx.params.vent is not None)
        node, surf, zone_volume, ctl, mrt, T, zT, *hour_inputs = ctx.saved_tensors
        p = replace(ctx.params, node=node, surf=surf, zone_volume=zone_volume, ctl=ctl, mrt=mrt)
        g_ld = rest[4] if ctl is not None else None
        dT0, d_zT0, d_node, d_surf, d_zv, d_chan, d_a, d_b, d_ctl, d_sph, d_spc, d_mrt = ctx.adjoint(
            p, T, zT, hour_inputs, (gT, gzT, g_hist, g_ld)
        )
        d_hi = (None, None, None, *d_chan, d_a, d_b, d_sph, d_spc)
        d_hi = tuple(None if d is None else d.reshape(x.shape) for d, x in zip(d_hi, hour_inputs))
        return (None, None, None, d_node, d_surf, d_zv.reshape(zone_volume.shape), d_ctl, d_mrt,
                dT0.reshape(T.shape), d_zT0.reshape(zT.shape)) + d_hi


class DayMarchFn:
    """The day march with the day adjoint as its backward.

    ``DayMarchFn.apply(hour_march, day_adjoint, params, node, surf,
    zone_volume, T, zT, *hour_inputs, ctl=None)`` runs ``hour_march`` on
    ``params`` with its ``node``/``surf``/``zone_volume`` (and, on a building
    with thermostats, its rows ``ctl``) replaced by the given tensors (so
    their cotangents reach whatever built them, e.g.
    :class:`~heatx_torch.ops.day_march.ParamBlocker`) and returns ``(T, zT,
    zt_hist, h_front, h_back, q_front, q_back)``, plus ``ld_hist`` when
    ``ctl`` is given.  The backward calls ``day_adjoint``
    (:meth:`DayAdjoint.raw`, or anything with its signature and returns) on
    the cotangents of T, zT, zt_hist and ld_hist; h/q are marked
    non-differentiable (heatx does not propagate their cotangents either,
    api.py:853-855).  The capacity row's cotangent is the ``mass`` cotangent
    (0 on no-mass nodes, where the capacity is the constant 0); the
    thermostat capacities get none.  Under scheduled setpoints the 11-leaf
    ``hour_inputs`` carry the setpoint rows and receive their cotangents.
    ``mrt`` (a building with MRT physics) replaces the Carroll network's
    rows and receives the ``mrt_eps_*`` cotangents.  ``hour_march`` may be an HourMarch or its ``.plain``; ``day_adjoint``
    ``DayAdjoint.raw`` or ``functools.partial(DayAdjoint.raw, plain=True)``.
    """

    @staticmethod
    def apply(hour_march, day_adjoint, params, node, surf, zone_volume, T, zT, *hour_inputs, ctl=None,
              mrt=None):
        return _DayMarch.apply(
            hour_march, day_adjoint, params, node, surf, zone_volume, ctl, mrt, T, zT, *hour_inputs
        )

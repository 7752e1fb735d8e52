"""The day march: heatx's fused Pallas hour kernel, on PyTorch/CUDA.

Counterpart of ``heatx.ops.pallas_step`` for modes ``trbdf2``,
``trbdf2_refresh`` and ``parity`` (the reference-parity sub-step: RK4 on the
massive nodes after a relaxed no-mass solve, fixed or adaptive), on free-float
buildings and on buildings with thermostats (setpoint-driven ideal loads),
scheduled setpoints, inter-zone mixing and gas cavities.  :func:`make_hour_march` returns ``(hour_march, params)``
with heatx's call signature and output layout: ``hour_march(params, T [N,
SP], zT [NB, ZB], hour_inputs)`` marches ``hours`` hours of ``substeps``
sub-steps per call and returns ``(T, zT, (h_front, h_back, q_front, q_back),
zt_hist [hours, NB, ZB])``, plus ``bad [hours, NB]`` (the per-hour non-finite
state count) with ``collect_bad``, plus ``ld_hist [hours, NB, ZB]`` (the
per-hour mean ideal-load power, W, heating positive) when the building has
thermostats (``hour_march.collect_loads``).  ``hour_inputs`` is heatx's
9-tuple ``(t_out, wind, wdir [hours*substeps], sol_front, sol_back, ir_front,
ir_back [hours, SP], a_extra, b_extra [hours, NB, ZB])``; a
``scheduled_setpoints`` march also takes the 11-tuple that appends the
per-hour setpoint rows ``sp_heat, sp_cool [hours, NB, ZB]`` (a 9-tuple there
falls back to the compiled rows ``params.ctl``).

Dispatch is by device, with no fallback: on CPU tensors the call runs the
plain PyTorch twin (:func:`plain_day_march`); on CUDA tensors it launches the
hand-written kernels or raises: the TR-BDF2 modes in
``heatx_torch/csrc/day_march_tr.cu``, parity in ``day_march_parity.cu``,
both through the C entry in ``day_march.cu``.

Design, and what of heatx's kernel is deliberately not carried over:

* One CUDA thread block per zone-closed block (at most 256 lanes per
  block), laid out with ``node_split=None``: the TPU's node-height split
  that saves padded rows on its vector lanes has nothing to save here.  Both
  kernels run 4 threads per surface lane, each owning 8 consecutive node
  rows in registers, in the launch variant that the C side's one table
  (``kLaunchVariants``, ``csrc/day_march_args.cuh``) picks from the block's
  lanes; :class:`DayMarchKernel` reads back which one ran.
* Zone coupling goes through shared memory: boundary air temperatures are
  indexed reads of the block's zone row (``front_zone``/``back_zone``, -1 for
  a face that bounds no zone), and the zone A/B sums are a fixed-order sum
  per zone over a lane list built on the host (``zone_ptr``/``zone_faces``),
  a warp per zone, so two runs give the same bits.  heatx's one-hot matmuls
  (and their transposed copies) are not ported.  The zone update uses
  ``expm1`` (heatx's ``_expm1_neg`` series exists because Mosaic has none).
* Inter-zone mixing keeps the meaning of heatx's dense ``mix_wt[b*ZB + from,
  to]`` as per-block entry lists (:class:`MixLists`): grouped by destination
  zone in a fixed order for the march, and by source zone for the adjoint's
  transpose.  A zone reads its sources' sub-step-start temperatures, so the
  kernel writes the new zone row into a second shared row and swaps the two.
* Each building runs the kind of kernel its zones and surfaces need
  (free-float; thermostats, schedules, mixing and the controls; gas
  cavities; interior MRT), so a free-float building runs none of the rest.
* Mosaic layout workarounds are gone: ``_row01`` and the rank-2 ``[1, ZB]``
  zone rows, the 8-row zone padding (``zone_spec``/``_pad_zone_rows``) and
  the HR8 hour padding, full-block broadcast writes, ``vmem_limit_mb`` /
  ``HEATX_KERNEL_VMEM_MB``; so is bench.py's dispatch chunking against a
  remote watchdog.
* Solver selection: the TR-BDF2 kernel factors the stage matrix once per
  operator refresh with a partitioned solve (``tridiag.partition_factor``/
  ``partition_solve`` state it plainly; the plain twin keeps heatx's Thomas
  sweeps).  The parity kernel keeps heatx's choice for the no-mass system:
  the closed-form solve of runs of one or two nodes (``tridiag.solve_runs2``)
  and Thomas where a run is longer (per block in the kernel, per building in
  heatx and the plain twin: the same to rounding); ``HEATX_NOMASS_PAIRS``,
  ``HEATX_KERNEL_SOLVER``, ``HEATX_KERNEL_LOOP``, ``unroll_fixed_loops`` and
  ``kernel_mode`` are not ported.  It hoists heatx's static forms (dt/C and
  the scaled K rows once per launch) into registers; chunk ids and counts
  ride as a lane's ``chunk_bits`` word.  ``tests/torch_parity_rows_plain.py``
  states its row plan plainly.
* Parity's RK4 never flushes tiny stage values to zero, and
  :class:`HourMarch` gives its twin ``flush_tiny=False`` whatever the
  building's config says (heatx's kernel path does the same on hardware that
  flushes subnormals); ``SimConfig.flush_tiny`` is read by
  ``engine.surface.march_surfaces``.
* The adaptive no-mass loop (``nomass_fixed_iters=None``) runs, as in heatx,
  only with ``HEATX_KERNEL_WHILE=1`` (otherwise heatx's ``ValueError``).  In
  the kernel each warp iterates until none of its lanes has an active run or
  ``nomass_max_iter`` iterations have run; the plain twin iterates the whole
  building until none is active, which leaves every lane where its own stop
  does (``csrc/day_parity.cuh`` has the argument).  Neither has a gradient:
  the adjoint, ``DayMarchFn`` and autograd through the plain march raise
  heatx's refusal.

Frozen mode (``trbdf2``) is the refresh kernel with ``refresh_every =
substeps``: heatx proves the two bit-identical (test_pallas_imp.py).

Gradients: :class:`ParamBlocker` blocks the parameter rows differentiably
from torch tensors, and ``heatx_torch.ops.day_adjoint`` holds the reverse
sweep (the adjoint kernel and ``DayMarchFn``).

Gas cavities: a lane's ``cav_bits`` word marks its gas-cavity segments, and
``DayMarchParams.cav`` holds their gas polynomials, geometry and
emissivities.  The kernels re-evaluate the ISO 15099 cavity U of those
segments where heatx does (TR-BDF2: at every operator build, from the
refresh group's start column; parity: on each no-mass iteration's input and
on the post-no-mass column) in an out-of-line device function, compiled into
kinds of their own (``kCav``) that every building with a cavity takes; in
both day-march kernels a cavity segment's U lives in a register of the
thread that owns its first row, and so it is in both adjoints.

Interior MRT (``config.interior_mrt``): the Carroll network's static part
(participation, view factors, effective emissivities) is computed at
blocking time (:func:`_mrt_static_blocked`, and differentiably in ``area``
and the emissivities by :func:`mrt_eps_blocked`) and rides as
``DayMarchParams.mrt`` [2, SP]; the 4-iteration linearized fixed point of
the zone MRT nodes runs in the march, frozen with the operators in TR-BDF2
(evaluated at each refresh group's start column) and at each sub-step's
start in parity mode, as heatx does.  Blocks are zone-closed, so the
network is block-local: the kernel sums each zone's participating faces in
the fixed order of a host-built list (``mrt_ptr``/``mrt_faces``) in shared
memory, with barriers between the iterations (each lane's front face on its
group's first thread, its back face on the others).  ``collect_hq`` (the per-hour
h/q history) and ``collect_operative`` (the per-hour operative temperature,
the zone-air-started solve on each hour's final state) are outputs of the
same instantiations (``kMrt``), which every launch with MRT physics or
either history takes; the others keep their code.

In-run passive controls (heatx ``bb.shade``/``bb.vent``, the hour loop's
gates at pallas_step.py:1576-1594 and :1614-1635): each kernel "hour" is one
main step, and both gates read the zone carry at its start.  Zone shading
scales a controlled pane's incident front solar by the device's
transmittance wherever its controlling zone (a block-local slot per lane,
``DayMarchParams.shade_slot``; heatx's one-hot gather is not ported) is
warmer than the setpoint: the lane's compiled one (``shade[1]``) or, with
``scheduled_shade_sp``, the hour's row of an optional trailing ``shade_sp
[hours, SP]`` hour input.  Ventilation gates add the hour's ventilation
terms ``a_vent``/``b_vent`` to ``a_extra``/``b_extra`` only where the zone's
temperature lies inside (``vent[0]``, ``vent[1]``) and above the hour's
``vent_thr``; a gated march takes heatx's 12-leaf hour inputs, the three
``[hours, NB, ZB]`` rows after ``b_extra`` (the weather-only gates are the
host's, ``FastRunner``).  In the kernel the gates are code of the ``kExt``
instantiations, read from shared memory once per hour and held.  Neither
gate is differentiated: heatx's adjoint refuses both, and so does the port
(``day_adjoint.make_day_adjoint``, ``DayMarchFn``, and autograd through a
gated plain march).

Not ported yet: sharding (ROADMAP A12).
"""

from __future__ import annotations

import copy
import ctypes
import dataclasses
import os
from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import torch

from heatx_torch.build.blocking import BlockedLayout, _union_find_components, build_blocks
from heatx_torch.build.layout import B_AMBIENT, B_OUTDOOR, B_SPACE, CompiledBuilding, SurfaceBatch
from heatx_torch.config import SimConfig
from heatx_torch.constants import KELVIN
from heatx_torch.engine import implicit as imp_mod
from heatx_torch.engine import surface as surf_mod
from heatx_torch.engine import zone as zone_mod
from heatx_torch.ops import cuda_lib, tridiag
from heatx_torch.physics import gas

#: Largest surface node count the kernel marches (node masks ride as 32-bit
#: words, one per lane).
MAX_NODES = 32
#: Largest lane count per CUDA thread block (the kernel's launch bound).
MAX_BLOCK_LANES = 256
#: Lane granularity of a block: one warp.
WARP = 32
# Row order of DayMarchParams.node / .surf / .lane — the CUDA kernel indexes
# these rows by the same order (enum ND_*, SF_*, LN_* in csrc/day_common.cuh).
NODE_FIELDS = ("seg_u", "capacity", "front_alphas", "back_alphas")
SURF_FIELDS = (
    "area", "perimeter", "cos_tilt", "wind_mod", "eps_front", "eps_back", "rf",
    "front_temp", "back_temp", "fixed_h_front", "fixed_h_back", "normal_x",
    "normal_y",
)
LANE_FIELDS = (
    "front_code", "back_code", "front_zone", "back_zone", "node_bits", "mass_bits",
    "chunk_bits", "cav_bits", "mrt_bits",
)
#: Row order of DayMarchParams.mrt: the faces' Carroll effective emissivities
#: (heatx's operand names; 0 off the network).  Bit 0 (front) and bit 1
#: (back) of a lane's ``mrt_bits`` mark its faces on the network.
MRT_FIELDS = ("mrt_eps_f", "mrt_eps_b")
#: Row order of DayMarchParams.shade: the deployed transmittance and the
#: zone-air setpoint of each lane's in-run shading control.
SHADE_FIELDS = ("shade_tau", "shade_sp")
#: Row order of DayMarchParams.cav: the gas polynomials (GasProps order), the
#: cavity geometry and the emissivities of every gas-cavity segment.
CAV_FIELDS = (
    "k0", "k1", "mu0", "mu1", "cp0", "cp1", "molar_mass", "thickness", "height",
    "angle", "ein", "eout",
)

#: The day march's compilation units: the C entry, the parity body and the
#: TR-BDF2 body (each four threads per surface), and each body's MRT kinds
#: apart (csrc/day_march_parity_mrt.cu says why).
KERNEL_SOURCES = tuple(cuda_lib.CSRC_DIR / f for f in (
    "day_march.cu", "day_march_parity.cu", "day_march_parity_mrt.cu", "day_march_tr.cu",
    "day_march_tr_mrt.cu"))

#: Values of the blocked parameter rows on padded lanes (0.0 for the rest).
#: Area 1 keeps perimeter*v/area finite on a padded lane, and its
#: derivative too.
LANE_PADS = {
    "area": 1.0, "rf": 1.0, "front_temp": 22.0, "back_temp": 22.0,
    "fixed_h_front": float("nan"), "fixed_h_back": float("nan"),
}


#: Never-act thermostat sentinels of padded and uncontrolled zone slots:
#: heating setpoint, cooling setpoint, heating capacity, cooling capacity.
CTL_FILL = (-1e9, 1e9, 0.0, 0.0)


@dataclasses.dataclass
class MixLists:
    """Inter-zone mixing flows of a blocked building as entry lists (numpy
    arrays on the host, tensors in :class:`DayMarchParams`).  Entry ``e`` with
    ``ptr[s] <= e < ptr[s + 1]`` moves ``vol[e]`` m3/s of the air of the
    block-local zone ``src[e]`` into the zone slot ``s = block*ZB + to``;
    within a slot the entries ascend by source.  ``t_ptr``/``t_dst``/``t_vol``
    hold the same entries grouped by source slot (ascending destination): the
    transpose the adjoint sums.  Together they are heatx's dense
    ``mix_wt[block*ZB + from, to]``."""

    ptr: object  # [NB*ZB + 1] int32
    src: object  # [M] int32
    vol: object  # [M] float
    t_ptr: object  # [NB*ZB + 1] int32
    t_dst: object  # [M] int32
    t_vol: object  # [M] float

    def dense(self, zones_per_block: int) -> np.ndarray:
        """The ``[NB*ZB, ZB]`` matrix ``mix_wt[block*ZB + from, to]``."""
        ptr, src, vol = (np.asarray(x) for x in (self.ptr, self.src, self.vol))
        ZB = zones_per_block
        W = np.zeros((len(ptr) - 1, ZB))
        slot = np.repeat(np.arange(len(ptr) - 1), np.diff(ptr))
        W[(slot // ZB) * ZB + src, slot % ZB] = vol
        return W


def mix_lists(from_slot, to_local, vol, n_slots: int, zones_per_block: int) -> MixLists:
    """:class:`MixLists` from flows ``vol[i]`` of zone slot ``from_slot[i]``
    into the block-local zone ``to_local[i]`` of the same block; repeated
    pairs add up (as in heatx's dense matrix)."""
    ZB = zones_per_block
    acc = {}
    for f, t, v in zip(np.asarray(from_slot), np.asarray(to_local), np.asarray(vol, np.float64)):
        key = (int(f), int(t))
        acc[key] = acc.get(key, 0.0) + float(v)
    frm = np.array([k[0] for k in acc], np.int64)
    to = np.array([k[1] for k in acc], np.int64)
    v = np.array(list(acc.values()), np.float64)
    to_slot = (frm // ZB) * ZB + to

    def csr(group, within, payload):
        order = np.lexsort((within, group))
        ptr = np.concatenate([[0], np.cumsum(np.bincount(group, minlength=n_slots))])
        return ptr.astype(np.int32), payload[order].astype(np.int32), v[order]

    ptr, src, vol_to = csr(to_slot, frm % ZB, frm % ZB)
    t_ptr, t_dst, vol_from = csr(frm, to, to)
    return MixLists(ptr, src, vol_to, t_ptr, t_dst, vol_from)


def mix_lists_from_dense(mix_wt) -> MixLists:
    """:class:`MixLists` of heatx's dense ``mix_wt [NB*ZB, ZB]``."""
    W = np.asarray(mix_wt, np.float64)
    frm, to = np.nonzero(W)
    return mix_lists(frm, to, W[frm, to], W.shape[0], W.shape[1])


@dataclasses.dataclass
class BlockedBuilding:
    """A compiled building permuted and padded into zone-closed blocks."""

    base: CompiledBuilding
    layout: BlockedLayout
    surfaces: SurfaceBatch  # node arrays [N, SP], scalars [SP] (SP = blocks*SB)
    front_oh: np.ndarray  # [SP, ZB]
    back_oh: np.ndarray  # [SP, ZB]
    zone_volume: np.ndarray  # [n_blocks, ZB] (1.0 in padded slots)
    zone_valid: np.ndarray  # [n_blocks, ZB]
    #: Thermostat rows (heat_sp, cool_sp, max_heat, max_cool), each [n_blocks,
    #: ZB] with CTL_FILL in padded and uncontrolled slots; None without
    #: thermostats.
    ctl: tuple = None
    #: Inter-zone mixing entries; None without mixing.
    mix: MixLists = None
    #: The Carroll network's effective emissivities (front, back), each [SP]
    #: float64, and its participation mask [2, NB, SB]; None without the
    #: MRT statics.
    mrt_eps: tuple = None
    mrt_part: np.ndarray = None
    #: In-run zone shading (slot, tau, sp): per lane the block-local slot of
    #: the controlling zone (-1 where the pane is uncontrolled or padded)
    #: [SP] int32, the deployed transmittance (1 where uncontrolled) and the
    #: setpoint (1e9 where uncontrolled) [SP] float64; None without shading.
    shade: tuple = None
    #: Ventilation gates: the indoor limits (vent_min, vent_max), each
    #: [n_blocks, ZB] (-100/100 in padded slots); None without gates.
    vent: tuple = None

    @property
    def config(self) -> SimConfig:
        return self.base.config

    @property
    def n_blocks(self) -> int:
        return self.layout.n_blocks

    @property
    def block_size(self) -> int:
        return self.layout.block_size

    @property
    def zones_per_block(self) -> int:
        return self.layout.zones_per_block

    @property
    def max_nodes(self) -> int:
        return self.surfaces.max_nodes


def _check_supported(building: CompiledBuilding):
    """Raise NotImplementedError (naming the ROADMAP item) for building
    features the day march does not carry yet."""
    missing = []
    if building.max_nodes > MAX_NODES:
        missing.append(f"more than {MAX_NODES} nodes per surface (ROADMAP B1)")
    if missing:
        raise NotImplementedError(
            "heatx_torch's day march does not support " + "; ".join(missing)
        )


def min_block_lanes(building: CompiledBuilding) -> int:
    """The smallest block that holds the largest zone-connected component:
    its surface count rounded up to a whole warp."""
    comp = _union_find_components(building)
    sb = building.surfaces
    fc, bc = np.asarray(sb.front_code), np.asarray(sb.back_code)
    owner = np.where(
        fc == B_SPACE, comp[np.asarray(sb.front_space)],
        np.where(bc == B_SPACE, comp[np.asarray(sb.back_space)], -1),
    )
    largest = int(np.bincount(owner[owner >= 0]).max()) if (owner >= 0).any() else 1
    return -(-largest // WARP) * WARP


def _mrt_part_mask(sb, front_oh, back_oh, n_blocks, zones_per_block):
    """The static participation mask [2, NB, SB] of the Carroll network
    (numpy, heatx ``_mrt_part_mask``): a face bounds a space, emits
    (eps > 1e-6), and its zone has at least two such faces."""
    NB, ZB = n_blocks, zones_per_block
    oh = np.stack([
        np.asarray(front_oh, np.float64).reshape(NB, -1, ZB),
        np.asarray(back_oh, np.float64).reshape(NB, -1, ZB),
    ])  # [2, NB, SB, ZB]
    part = np.stack([
        (np.asarray(sb.front_code) == B_SPACE) & (np.asarray(sb.eps_front) > 1e-6),
        (np.asarray(sb.back_code) == B_SPACE) & (np.asarray(sb.eps_back) > 1e-6),
    ]).reshape(2, NB, -1)
    count = np.einsum("fnsz,fns->nz", oh, part.astype(np.float64))
    return part & (np.einsum("fnsz,nz->fns", oh, count) >= 1.5)


def mrt_eps_blocked(area, eps_front, eps_back, part, front_oh, back_oh, n_blocks,
                    zones_per_block, xp=torch):
    """The Carroll view-factor fixed point and effective emissivities of a
    blocked building (heatx ``mrt_eps_blocked_jnp``): ``area``/``eps_*`` are
    [SP], ``part`` the static mask of :func:`_mrt_part_mask`, the one-hots
    [SP, ZB].  ``xp=np`` is heatx's numpy path, bit for bit (the blocking
    statics); ``xp=torch`` (tensors on one device) is differentiable in
    ``area`` and the emissivities, and ``FastRunner.chunk_grad`` pulls the
    adjoint's ``mrt_eps_*`` cotangents back through it.  Returns
    ``(eps_eff_front, eps_eff_back)`` [SP] (0 off the network)."""
    if xp is np:
        where, maximum, ones_like, stack, bcast = np.where, np.maximum, np.ones_like, np.stack, np.broadcast_to
    else:
        where, maximum, ones_like, stack, bcast = (
            torch.where, torch.clamp_min, torch.ones_like, torch.stack, torch.broadcast_to)
    NB, ZB = n_blocks, zones_per_block
    oh = stack([front_oh.reshape(NB, -1, ZB), back_oh.reshape(NB, -1, ZB)])  # [2, NB, SB, ZB]
    a2 = bcast(area.reshape(1, NB, -1), tuple(part.shape))
    F = ones_like(a2)
    for _ in range(20):
        af = where(part, a2 * F, 0.0)
        tot = xp.einsum("fnsz,fns->nz", oh, af)
        denom = 1.0 - af / maximum(xp.einsum("fnsz,nz->fns", oh, tot), 1e-30)
        F = 1.0 / maximum(denom, 0.05)
    F = where(part, F, 0.0)
    eps = stack([eps_front, eps_back]).reshape(2, NB, -1)
    denom = where(part, F * (1.0 - eps) + eps, 1.0)  # 0/0 off the network
    eps_eff = where(part, eps * F / denom, 0.0)
    SP = area.shape[0]
    return eps_eff[0].reshape(SP), eps_eff[1].reshape(SP)


def _mrt_static_blocked(sb, front_oh, back_oh, n_blocks, zones_per_block):
    """The Carroll network's static data of a blocked building, numpy
    (heatx ``_mrt_static_blocked``): ``(eps_eff_front, eps_eff_back)`` [SP]
    float64 and the participation mask."""
    part = _mrt_part_mask(sb, front_oh, back_oh, n_blocks, zones_per_block)
    f64 = [np.asarray(a, np.float64) for a in (sb.area, sb.eps_front, sb.eps_back, front_oh, back_oh)]
    eps = mrt_eps_blocked(*f64[:3], part, *f64[3:], n_blocks, zones_per_block, xp=np)
    return tuple(np.asarray(e) for e in eps), part


def block_building(
    building: CompiledBuilding, block_size: int = None, node_split=None, mrt_statics: bool = None
) -> BlockedBuilding:
    """Permute + pad a compiled building into zone-closed blocks of
    ``block_size`` lanes (heatx ``block_building`` with ``node_split=None``;
    the same arrays).  ``None`` picks :func:`min_block_lanes`: at bench scale
    the day kernel runs fastest with the fewest lanes per thread block
    (PERF.md, H100 port).  ``mrt_statics`` forces the Carroll network's
    static data (the operative-temperature history needs it without MRT
    physics); by default it is computed where ``config.interior_mrt`` is
    set."""
    if node_split is not None:
        raise NotImplementedError(
            "the node-height split is a TPU lane optimisation; the CUDA day "
            "kernel marches whole node columns (node_split=None only)"
        )
    _check_supported(building)
    if block_size is None:
        block_size = min_block_lanes(building)
    if block_size > MAX_BLOCK_LANES:
        raise NotImplementedError(
            f"blocks of {block_size} lanes: the day kernel takes at most "
            f"{MAX_BLOCK_LANES} surfaces per zone-connected component (ROADMAP B1)"
        )
    layout = build_blocks(building, block_size=block_size, node_split=None)
    sb = building.surfaces

    def perm(a, fill=0.0):
        return layout.surfaces_to_blocked(np.asarray(a), fill)

    new_sb = replace(
        sb,
        node_mask=perm(sb.node_mask, False),
        n_nodes=np.where(layout.surf_valid, perm(sb.n_nodes, 1), 1).astype(np.int32),
        mass=perm(sb.mass),
        massive=perm(sb.massive, False),
        seg_u=perm(sb.seg_u),
        seg_is_cavity=perm(sb.seg_is_cavity, False),
        cav_gas=type(sb.cav_gas)(*[perm(f) for f in sb.cav_gas]),
        cav_thickness=perm(sb.cav_thickness),
        cav_height=perm(sb.cav_height, 1.0),
        cav_angle=perm(sb.cav_angle),
        cav_ein=perm(sb.cav_ein),
        cav_eout=perm(sb.cav_eout),
        same_chunk=perm(sb.same_chunk, False),
        nomass_chunk_id=perm(sb.nomass_chunk_id, -1),
        nomass_chunk_count=perm(sb.nomass_chunk_count),
        front_alphas=perm(sb.front_alphas),
        back_alphas=perm(sb.back_alphas),
        area=perm(sb.area, LANE_PADS["area"]),
        perimeter=perm(sb.perimeter, 0.0),
        normal=np.ascontiguousarray(perm(np.ascontiguousarray(sb.normal.T)).T),
        cos_tilt=perm(sb.cos_tilt),
        wind_mod=perm(sb.wind_mod),
        eps_front=perm(sb.eps_front),
        eps_back=perm(sb.eps_back),
        rf=perm(sb.rf, LANE_PADS["rf"]),
        front_code=np.where(
            layout.surf_valid, perm(sb.front_code, B_AMBIENT), B_AMBIENT
        ).astype(np.int32),
        front_space=perm(sb.front_space, 0).astype(np.int32),
        front_temp=np.where(layout.surf_valid, perm(sb.front_temp), LANE_PADS["front_temp"]),
        back_code=np.where(
            layout.surf_valid, perm(sb.back_code, B_AMBIENT), B_AMBIENT
        ).astype(np.int32),
        back_space=perm(sb.back_space, 0).astype(np.int32),
        back_temp=np.where(layout.surf_valid, perm(sb.back_temp), LANE_PADS["back_temp"]),
        fixed_h_front=perm(sb.fixed_h_front, LANE_PADS["fixed_h_front"]),
        fixed_h_back=perm(sb.fixed_h_back, LANE_PADS["fixed_h_back"]),
        is_fenestration=perm(sb.is_fenestration, False),
    )
    zone_volume = layout.zones_to_blocked(np.asarray(building.zone_volume), fill=1.0)
    zone_volume = np.where(layout.zone_valid, zone_volume, 1.0)

    mix = None
    if np.asarray(building.mix_src).size:
        ZB = layout.zones_per_block
        zt = np.asarray(layout.zone_table).reshape(-1)
        slot_of = np.zeros(building.n_zones, np.int64)  # zone id -> blocked slot
        slot_of[zt[zt >= 0]] = np.nonzero(zt >= 0)[0]
        src, dst = slot_of[np.asarray(building.mix_src)], slot_of[np.asarray(building.mix_dst)]
        if (src // ZB != dst // ZB).any():
            raise AssertionError("mixed zones must share a block (blocking invariant violated)")
        mix = mix_lists(src, dst % ZB, building.mix_vol, zt.size, ZB)

    ctl = None
    if building.has_ideal_hvac:
        ctl = tuple(
            np.where(layout.zone_valid, layout.zones_to_blocked(np.asarray(v), fill=fill), fill)
            for v, fill in zip(
                (building.ctl_heat_sp, building.ctl_cool_sp, building.ctl_max_heat,
                 building.ctl_max_cool), CTL_FILL,
            )
        )
    mrt_eps = mrt_part = None
    if building.config.interior_mrt if mrt_statics is None else mrt_statics:
        mrt_eps, mrt_part = _mrt_static_blocked(
            new_sb, layout.front_oh, layout.back_oh, layout.n_blocks, layout.zones_per_block
        )
    shade = None
    if building.has_zone_shading:
        # Blocking unions the controlling zone into the pane's component
        # (build_blocks), so it is block-local here.
        sz = np.where(layout.surf_valid, perm(np.asarray(building.shade_zone, np.int64), -1), -1)
        tau = np.where(sz >= 0, perm(building.shade_tau, 1.0), 1.0).astype(np.float64)
        sp = np.where(sz >= 0, perm(building.shade_sp, 1e9), 1e9).astype(np.float64)
        zt = np.asarray(layout.zone_table)
        slot = np.full(sz.shape, -1, np.int32)
        for i in np.nonzero(sz >= 0)[0]:
            bi = i // layout.block_size
            loc = np.nonzero(zt[bi] == sz[i])[0]
            if loc.size == 0:  # defensive: blocking guarantees locality
                raise AssertionError(
                    f"zone-shading control zone {int(sz[i])} not in block {bi}'s zone table "
                    "(blocking invariant violated)"
                )
            slot[i] = loc[0]
        shade = (slot, tau, sp)
    vent = None
    if building.has_vent_gates:
        vent = tuple(
            np.where(layout.zone_valid, layout.zones_to_blocked(np.asarray(v), fill=fill), fill)
            for v, fill in ((building.vent_min_tin, -100.0), (building.vent_max_tin, 100.0))
        )
    return BlockedBuilding(
        base=building,
        layout=layout,
        surfaces=new_sb,
        front_oh=layout.front_oh,
        back_oh=layout.back_oh,
        zone_volume=zone_volume,
        zone_valid=layout.zone_valid,
        ctl=ctl,
        mix=mix,
        mrt_eps=mrt_eps,
        mrt_part=mrt_part,
        shade=shade,
        vent=vent,
    )


# ---------------------------------------------------------------------------
# Kernel operands
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DayMarchParams:
    """The blocked building as the day march reads it (one device, one
    dtype).  Rows of ``node``/``surf``/``lane`` follow NODE_FIELDS,
    SURF_FIELDS and LANE_FIELDS."""

    node: torch.Tensor  # [4, N, SP] float
    surf: torch.Tensor  # [13, SP] float
    lane: torch.Tensor  # [8, SP] int32
    zone_volume: torch.Tensor  # [NB, ZB] float
    zone_ptr: torch.Tensor  # [NB*ZB + 1] int32 offsets into zone_faces
    zone_faces: torch.Tensor  # [E] int32: block-local lane*2 + side (0 front, 1 back)
    #: Thermostat rows [4, NB, ZB] (heat_sp, cool_sp, max_heat, max_cool; CTL_FILL
    #: where nothing is controlled), or None without thermostats.
    ctl: torch.Tensor = None
    #: Inter-zone mixing entries (int32 lists, ``vol`` in the working dtype), or None.
    mix: MixLists = None
    #: Gas-cavity operands [12, N, SP] (CAV_FIELDS; bit i of a lane's
    #: ``cav_bits`` marks segment i as a cavity), or None without cavities.
    #: Not differentiated, as in heatx.
    cav: torch.Tensor = None
    #: The Carroll network (MRT_FIELDS rows [2, SP]) and each zone slot's
    #: network faces (CSR like zone_ptr/zone_faces: [NB*ZB + 1], [E']), or
    #: None without the MRT statics.
    mrt: torch.Tensor = None
    mrt_ptr: torch.Tensor = None
    mrt_faces: torch.Tensor = None
    #: In-run zone shading: per lane the block-local slot of the controlling
    #: zone (-1: uncontrolled) [SP] int32 and the rows (tau, sp) [2, SP]
    #: (SHADE_FIELDS); None without shading.  Not differentiated, as in heatx.
    shade_slot: torch.Tensor = None
    shade: torch.Tensor = None
    #: Ventilation gates: the indoor limits (vent_min, vent_max) [2, NB, ZB];
    #: None without gates.  Not differentiated.
    vent: torch.Tensor = None

    @property
    def gated(self) -> bool:
        """Whether the march runs in-run shading or ventilation gates."""
        return self.shade_slot is not None or self.vent is not None

    @property
    def n_blocks(self) -> int:
        return self.zone_volume.shape[0]

    @property
    def zones_per_block(self) -> int:
        return self.zone_volume.shape[1]

    @property
    def block_size(self) -> int:
        return self.surf.shape[1] // self.n_blocks

    @property
    def max_nodes(self) -> int:
        return self.node.shape[1]

    def field(self, name: str) -> torch.Tensor:
        if name in SHADE_FIELDS:
            return self.shade[SHADE_FIELDS.index(name)]
        if name in MRT_FIELDS:
            return self.mrt[MRT_FIELDS.index(name)]
        if name in CAV_FIELDS:
            return self.cav[CAV_FIELDS.index(name)]
        if name in NODE_FIELDS:
            return self.node[NODE_FIELDS.index(name)]
        if name in SURF_FIELDS:
            return self.surf[SURF_FIELDS.index(name)]
        return self.lane[LANE_FIELDS.index(name)]


def local_zone(oh: np.ndarray) -> np.ndarray:
    """[SP, ZB] one-hot rows -> block-local zone index per lane (-1: none)."""
    oh = np.asarray(oh)
    return np.where(oh.any(axis=1), oh.argmax(axis=1), -1).astype(np.int32)


def _node_bits(mask: np.ndarray) -> np.ndarray:
    """[N, SP] bool -> [SP] int32 words with bit i = row i."""
    bits = np.zeros(mask.shape[1], np.int64)
    for i in range(mask.shape[0]):
        bits |= mask[i].astype(np.int64) << i
    return bits.astype(np.uint32).view(np.int32)


def pack_params(
    node_mask, massive, capacity, seg_u, front_alphas, back_alphas, surf: dict,
    front_code, back_code, front_oh, back_oh, zone_volume, n_blocks,
    dtype=torch.float32, device="cpu", ctl=None, mix: MixLists = None, same_chunk=None,
    seg_is_cavity=None, cav: dict = None, mrt=None, mrt_part=None, shade=None, vent=None,
) -> DayMarchParams:
    """Pack blocked numpy operands into :class:`DayMarchParams`.

    Node arrays are ``[N, SP]`` (``massive`` marks the nodes whose capacity
    is their ``mass``; ``same_chunk[i]`` that nodes i and i+1 share a chunk,
    by default two valid nodes of the same massiveness), ``surf`` maps each
    SURF_FIELDS name to an ``[SP]`` array, ``front_oh``/``back_oh`` are the
    ``[SP, ZB]`` block-local zone one-hots, ``zone_volume`` is ``[NB, ZB]``;
    ``ctl`` the four ``[NB, ZB]`` thermostat rows and ``mix`` the host-side
    mixing lists (None: absent); ``seg_is_cavity`` ``[N, SP]`` marks the
    gas-cavity segments and ``cav`` maps each CAV_FIELDS name to their
    ``[N, SP]`` operands (both None without cavities); ``mrt`` holds the
    MRT_FIELDS rows ``[2, SP]`` and ``mrt_part`` their static participation
    mask ``[2, SP]`` (default ``mrt > 0``; both None without the MRT
    statics); ``shade`` holds the in-run shading's ``(slot [SP] block-local
    controlling zone or -1, tau [SP], sp [SP])`` and ``vent`` the gates'
    indoor limits ``(vent_min, vent_max)`` ``[NB, ZB]`` (both None without).
    Shared by :func:`make_hour_march` and ``heatx_torch.convert``."""
    node_mask = np.asarray(node_mask, bool)
    massive = np.asarray(massive, bool)
    N, SP = node_mask.shape
    if same_chunk is None:
        same_chunk = np.zeros_like(node_mask)
        same_chunk[:-1] = node_mask[:-1] & node_mask[1:] & (massive[:-1] == massive[1:])
    if N > MAX_NODES:
        raise NotImplementedError(f"more than {MAX_NODES} nodes per surface (ROADMAP B1)")
    NB = int(n_blocks)
    SB = SP // NB
    ZB = np.asarray(zone_volume).shape[-1]
    fz = local_zone(front_oh)
    bz = local_zone(back_oh)
    has_cav = seg_is_cavity is not None and np.asarray(seg_is_cavity, bool).any()
    cav_mask = np.asarray(seg_is_cavity, bool) if has_cav else np.zeros_like(node_mask)
    if (cav_mask & ~(node_mask & np.roll(node_mask, -1, axis=0))).any() or cav_mask[-1].any():
        raise ValueError("a gas-cavity segment must join two valid nodes")

    # Zone -> lane lists (CSR over global zone slots b*ZB + z): front faces
    # first, then back faces, each in ascending lane order — the fixed
    # summation order of the kernel's zone sums.
    lanes = np.arange(SP)
    keys, side, local = [], [], []
    for s, zl in ((0, fz), (1, bz)):
        m = zl >= 0
        keys.append((lanes[m] // SB) * ZB + zl[m])
        side.append(np.full(int(m.sum()), s))
        local.append(lanes[m] % SB)
    keys, side, local = (np.concatenate(x) for x in (keys, side, local))
    order = np.lexsort((local, side, keys))
    faces = (local * 2 + side)[order].astype(np.int32)
    counts = np.bincount(keys, minlength=NB * ZB)
    zone_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    # The Carroll network's faces per zone slot: the same order, filtered.
    mrt_bits = np.zeros(SP, np.int32)
    mrt_ptr = mrt_faces = None
    if mrt is not None:
        mrt = np.asarray(mrt, np.float64).reshape(2, SP)
        part = (mrt > 0) if mrt_part is None else np.asarray(mrt_part, bool).reshape(2, SP)
        part = part & (np.stack([fz, bz]) >= 0)
        mrt_bits = (part[0].astype(np.int32) | (part[1].astype(np.int32) << 1))
        sel = part[side[order], ((keys // ZB) * SB + local)[order]]
        mrt_faces = faces[sel]
        mrt_ptr = np.concatenate([[0], np.cumsum(np.bincount(keys[order][sel], minlength=NB * ZB))])

    def f(a):
        return torch.as_tensor(np.array(a, np.float64), dtype=dtype, device=device)

    def i32(a):
        return torch.as_tensor(np.array(a, np.int32), device=device)

    return DayMarchParams(
        node=f(np.stack([seg_u, capacity, front_alphas, back_alphas])),
        surf=f(np.stack([np.asarray(surf[k], np.float64).reshape(SP) for k in SURF_FIELDS])),
        lane=i32(np.stack([
            np.asarray(front_code).reshape(SP), np.asarray(back_code).reshape(SP),
            fz, bz, _node_bits(node_mask), _node_bits(massive),
            _node_bits(np.asarray(same_chunk, bool)), _node_bits(cav_mask), mrt_bits,
        ])),
        zone_volume=f(np.asarray(zone_volume).reshape(NB, ZB)),
        zone_ptr=i32(zone_ptr),
        zone_faces=i32(faces),
        ctl=None if ctl is None else f(np.stack([np.asarray(c).reshape(NB, ZB) for c in ctl])),
        mix=None if mix is None else MixLists(
            i32(mix.ptr), i32(mix.src), f(mix.vol), i32(mix.t_ptr), i32(mix.t_dst), f(mix.t_vol)
        ),
        cav=f(np.stack([np.asarray(cav[k]) for k in CAV_FIELDS])) if has_cav else None,
        mrt=None if mrt is None else f(mrt),
        mrt_ptr=None if mrt is None else i32(mrt_ptr),
        mrt_faces=None if mrt is None else i32(mrt_faces),
        shade_slot=None if shade is None else i32(np.asarray(shade[0]).reshape(SP)),
        shade=None if shade is None else f(np.stack([np.asarray(x).reshape(SP) for x in shade[1:]])),
        vent=None if vent is None else f(np.stack([np.asarray(v).reshape(NB, ZB) for v in vent])),
    )


class ParamBlocker:
    """Differentiable blocking of a building's parameter arrays.

    ``blocker(params, surfaces, zone_volume)`` returns ``params`` with its
    node rows (``seg_u``, the capacity ``where(massive, mass, 0)``,
    ``front_alphas``, ``back_alphas``), its SURF_FIELDS rows (``normal_x``/
    ``normal_y`` kept) and its zone volumes recomputed from ``surfaces``
    (any object with the SurfaceBatch field names: node arrays [N, S],
    surface arrays [S]) and ``zone_volume`` [Z], in surface and zone order.
    They may be torch tensors: the blocking is gathers, wheres and stacks,
    so the cotangents of the blocked rows flow back to them.  On a building
    with thermostats ``ctl_heat_sp``/``ctl_cool_sp`` [Z] re-block the two
    setpoint rows of ``params.ctl`` the same way (the capacity rows stay).
    Where ``params`` carries the Carroll network, its effective
    emissivities are recomputed from the blocked ``area`` and emissivities
    by :func:`mrt_eps_blocked` (the participation mask stays the blocking's).
    With the building's own arrays the result equals
    :func:`params_from_blocked` (the network to round-off)."""

    def __init__(self, bb: BlockedBuilding, device):
        lay = bb.layout
        perm = np.asarray(lay.surf_perm)
        zt = np.asarray(lay.zone_table)

        def dev(a):
            return torch.as_tensor(a, device=device)

        self.perm_c, self.perm_ok = dev(np.maximum(perm, 0)), dev(perm >= 0)
        self.zt_c, self.zt_ok = dev(np.maximum(zt, 0)), dev(zt >= 0)
        self.massive = dev(np.asarray(bb.surfaces.massive, bool))
        self.nb_zb = (bb.n_blocks, bb.zones_per_block)
        self.mrt_part = None if bb.mrt_part is None else dev(np.asarray(bb.mrt_part, bool))
        self.oh = (np.asarray(bb.front_oh, np.float64), np.asarray(bb.back_oh, np.float64))

    def lanes(self, a: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
        """[..., S] -> [..., SP], ``fill`` on padded lanes."""
        return torch.where(self.perm_ok, a[..., self.perm_c], fill)

    def zones(self, a: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
        """[..., Z] -> [..., NB, ZB], ``fill`` in padded zone slots."""
        return torch.where(self.zt_ok, a[..., self.zt_c], fill)

    def __call__(
        self, params: DayMarchParams, surfaces, zone_volume, ctl_heat_sp=None, ctl_cool_sp=None
    ) -> DayMarchParams:
        kw = dict(dtype=params.surf.dtype, device=params.surf.device)

        def get(name):
            return self.lanes(torch.as_tensor(getattr(surfaces, name), **kw), LANE_PADS.get(name, 0.0))

        node = torch.stack([
            get("seg_u"), torch.where(self.massive, get("mass"), 0.0),
            get("front_alphas"), get("back_alphas"),
        ])
        surf = torch.stack([
            params.field(k) if k.startswith("normal") else get(k) for k in SURF_FIELDS
        ])
        zv = self.zones(torch.as_tensor(zone_volume, **kw), 1.0)
        mrt = params.mrt
        if mrt is not None:
            oh = [torch.as_tensor(o, **kw) for o in self.oh]
            mrt = torch.stack(mrt_eps_blocked(
                surf[SURF_FIELDS.index("area")], surf[SURF_FIELDS.index("eps_front")],
                surf[SURF_FIELDS.index("eps_back")], self.mrt_part, *oh, *self.nb_zb,
            ))
        ctl = params.ctl
        if ctl is not None and ctl_heat_sp is not None:
            ctl = torch.stack([
                self.zones(torch.as_tensor(ctl_heat_sp, **kw), CTL_FILL[0]),
                self.zones(torch.as_tensor(ctl_cool_sp, **kw), CTL_FILL[1]),
                ctl[2], ctl[3],
            ])
        return replace(params, node=node, surf=surf, zone_volume=zv, ctl=ctl, mrt=mrt)


def params_from_blocked(bb: BlockedBuilding, dtype, device) -> DayMarchParams:
    """DayMarchParams of a blocked building (in the building's dtype cast
    first, as heatx casts ``bb.surfaces.astype(dtype)``)."""
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    sb = bb.surfaces.astype(np_dtype)
    capacity = np.where(sb.massive, sb.mass, np.zeros_like(sb.mass))
    surf = {k: getattr(sb, k) for k in SURF_FIELDS if not k.startswith("normal")}
    surf["normal_x"] = sb.normal[:, 0]
    surf["normal_y"] = sb.normal[:, 1]
    cav = None
    if sb.has_cavity:
        cav = dict(zip(CAV_FIELDS[:7], sb.cav_gas))
        cav.update({k: getattr(sb, "cav_" + k) for k in CAV_FIELDS[7:]})
    return pack_params(
        sb.node_mask, sb.massive, capacity, sb.seg_u, sb.front_alphas, sb.back_alphas, surf,
        sb.front_code, sb.back_code, bb.front_oh, bb.back_oh, bb.zone_volume,
        bb.n_blocks, dtype=dtype, device=device,
        ctl=None if bb.ctl is None else [np.asarray(c).astype(np_dtype) for c in bb.ctl],
        mix=bb.mix, same_chunk=sb.same_chunk, seg_is_cavity=sb.seg_is_cavity, cav=cav,
        mrt=None if bb.mrt_eps is None else np.stack(bb.mrt_eps).astype(np_dtype),
        mrt_part=None if bb.mrt_part is None else bb.mrt_part.reshape(2, -1),
        shade=None if bb.shade is None else (bb.shade[0], *(np.asarray(x).astype(np_dtype) for x in bb.shade[1:])),
        vent=None if bb.vent is None else [np.asarray(v).astype(np_dtype) for v in bb.vent],
    )


# ---------------------------------------------------------------------------
# Plain PyTorch twin of heatx's _hour_body_imp (all blocks at once)
# ---------------------------------------------------------------------------


def bit_rows(params: DayMarchParams, name: str) -> torch.Tensor:
    """A lane row of 32-bit node masks (``node_bits``/``mass_bits``/
    ``chunk_bits``) as the [N, SP] bool mask it packs."""
    bits = params.field(name).to(torch.int64)
    shifts = torch.arange(params.max_nodes, device=bits.device)[:, None]
    return ((bits[None, :] >> shifts) & 1).bool()


def _chunk_view(node_mask, massive, same_chunk) -> dict:
    """The no-mass chunk data of ``SurfaceBatch`` from the node masks: a
    no-mass chunk is a maximal run of valid no-mass nodes joined by
    ``same_chunk``, numbered from 0 down each surface."""
    sel = node_mask & ~massive
    prev = torch.cat([torch.zeros_like(sel[:1]), (sel & same_chunk)[:-1]], dim=0)
    head = sel & ~prev
    cid = torch.where(sel, torch.cumsum(head.to(torch.int32), dim=0) - 1, -1)
    C = max(int(cid.max()) + 1, 1)
    count = torch.stack([(cid == c).sum(dim=0) for c in range(C)])
    return dict(
        massive=massive, same_chunk=same_chunk, nomass_chunk_id=cid,
        nomass_chunk_count=count, max_nomass_run=int(count.max()),
        has_nomass=bool(sel.any()), has_massive=bool(massive.any()),
    )


def _lanes(params: DayMarchParams, chunks: bool = False):
    """SurfaceBatch-like view of the blocked lanes for the engine functions,
    plus the global zone slot (block*ZB + local zone, -1 none) of each face,
    and the gas-cavity operands where the building has them.
    ``chunks`` adds what the parity integrator reads: ``massive``, ``mass``
    (the capacity row: the mass on massive nodes) and the no-mass chunks."""
    node_mask = bit_rows(params, "node_bits")
    extra = {}
    if chunks:
        extra = _chunk_view(node_mask, bit_rows(params, "mass_bits"), bit_rows(params, "chunk_bits"))
        extra["nomass_chunk_count"] = extra["nomass_chunk_count"].to(params.node.dtype)
        extra["mass"] = params.field("capacity")
    v = {k: params.field(k) for k in NODE_FIELDS + SURF_FIELDS}
    if params.mrt is not None:
        bits = params.field("mrt_bits")
        extra.update(mrt_ef=params.mrt[0], mrt_eb=params.mrt[1],
                     mrt_part=torch.cat([(bits & 1) > 0, (bits & 2) > 0]))
    if params.cav is not None:
        seg_is_cavity = bit_rows(params, "cav_bits")
        extra.update(
            seg_is_cavity=seg_is_cavity, cav_index=surf_mod.cavity_index(seg_is_cavity),
            cav_gas=gas.GasProps(*params.cav[:7]),
            **{"cav_" + k: params.field(k) for k in CAV_FIELDS[7:]},
        )
    return SimpleNamespace(
        node_mask=node_mask,
        seg_u=v["seg_u"], capacity=v["capacity"],
        front_alphas=v["front_alphas"], back_alphas=v["back_alphas"],
        normal=(v["normal_x"], v["normal_y"]),
        **{k: v[k] for k in SURF_FIELDS if not k.startswith("normal")},
        front_code=params.field("front_code"), back_code=params.field("back_code"),
        front_slot=_zone_slots(params, params.field("front_zone")),
        back_slot=_zone_slots(params, params.field("back_zone")),
        has_cavity=params.cav is not None,
        **extra,
    )


def _boundary_temps(sbv, zT, t_out):
    """Boundary air temperatures: outdoor air, the zone air of the face's
    zone slot (``zT`` flat [NB*ZB]), or the fixed ambient temperature."""

    def side(code, slot, temp):
        t_zone = torch.where(slot >= 0, zT[slot.clamp_min(0)], torch.zeros_like(temp))
        t_out_b = torch.as_tensor(t_out, dtype=temp.dtype, device=temp.device).expand_as(temp)
        return torch.where(
            code == B_OUTDOOR, t_out_b, torch.where(code == B_SPACE, t_zone, temp)
        )

    return (
        side(sbv.front_code, sbv.front_slot, sbv.front_temp),
        side(sbv.back_code, sbv.back_slot, sbv.back_temp),
    )


def _zone_dots(a_extra, b_extra, sbv, h_front, h_back, ts_front, ts_back):
    """Per-zone A/B sums (model.rs:489-597): a = a_extra + sum(h A T_s),
    b = b_extra + sum(h A) over the faces bounding each zone, front faces
    then back faces, each in ascending lane order."""
    a_z, b_z = a_extra, b_extra
    for h, ts, slot in ((h_front, ts_front, sbv.front_slot), (h_back, ts_back, sbv.back_slot)):
        m = slot >= 0
        ha = h * sbv.area
        a_z = a_z + torch.zeros_like(a_extra).index_add_(0, slot[m], (ha * ts)[m])
        b_z = b_z + torch.zeros_like(b_extra).index_add_(0, slot[m], ha[m])
    return a_z, b_z


def _air_rho_cp(zT):
    """rho(T) cp(T) of zone air, J/m3.K."""
    t_k = zT + KELVIN
    return gas.density(gas.AIR, t_k) * gas.heat_capacity(gas.AIR, t_k)


def _mix_slots(params: DayMarchParams):
    """The mixing entries with global zone slots: ``(src_slot, dst_slot,
    vol)``, or None without mixing."""
    mix = params.mix
    if mix is None:
        return None
    ZB = params.zones_per_block
    n = mix.ptr.to(torch.int64)
    dst = torch.repeat_interleave(torch.arange(n.numel() - 1, device=n.device), n[1:] - n[:-1])
    return (dst // ZB) * ZB + mix.src.to(torch.int64), dst, mix.vol


def _mix_terms(a_z, b_z, zT, mix):
    """Inter-zone mixing (heatx ``_hour_body_imp``, pallas_step.py:938-944):
    ventilation whose inlet is the source zone's air at the sub-step's start,
    ``a += sum s0 T W`` and ``b += sum s0 W`` with ``s0 = rho cp`` of the
    SOURCE zone."""
    src, dst, vol = mix
    s0 = _air_rho_cp(zT)
    a_z = a_z + torch.zeros_like(a_z).index_add_(0, dst, (s0 * zT)[src] * vol)
    b_z = b_z + torch.zeros_like(b_z).index_add_(0, dst, s0[src] * vol)
    return a_z, b_z


def plain_mrt(sbv, st, T, zT, t_front, t_back):
    """The blocked Carroll network from the state (heatx ``_mrt_context``):
    the 4-iteration linearized fixed point over each zone slot's network
    faces, started at the faces' boundary air temperatures (the zone air on
    the network), from the node columns ``T`` and the zone row ``zT``
    [NB*ZB] (the fallback where a slot has no network).  Returns ``(mrt,
    tm)``: the ``engine.surface.apply_interior_mrt`` context of every lane
    (a face takes its effective emissivity and zone MRT where the emissivity
    is positive) and the slots' MRT nodes [NB*ZB]."""
    if getattr(sbv, "mrt_ef", None) is None:
        raise ValueError("the MRT network needs the blocked Carroll statics (DayMarchParams.mrt)")
    SP = sbv.area.shape[0]
    part = sbv.mrt_part
    idx = torch.where(part, torch.cat([sbv.front_slot, sbv.back_slot]), zT.shape[0])
    ts = torch.cat([T[0], surf_mod._last_node(sbv, T, st)])
    tm, tm_face = surf_mod.mrt_fixed_point(
        ts, torch.cat([sbv.area, sbv.area]), part, idx, torch.cat([sbv.mrt_ef, sbv.mrt_eb]),
        torch.cat([t_front, t_back]), zT,
    )
    ef, eb = sbv.mrt_ef, sbv.mrt_eb
    return (ef > 0, tm_face[:SP], ef, eb > 0, tm_face[SP:], eb), tm


def _hour_body_imp(
    cfg: SimConfig, sbv, st, zone_volume, a_extra, b_extra, t_out_arr, wind_arr,
    wdir_arr, sol_front, sol_back, ir_front, ir_back, T0, zT0, substeps: int,
    dt_sub: float, off: int, refresh_every: int, ctl=None, mix=None,
):
    """One hour of TR-BDF2 sub-steps for every block (heatx
    ``_hour_body_imp``): the operators (film coefficients, linearized
    radiation, the segment U-values with their gas cavities, K, the stage
    matrix and its Thomas factorization) are rebuilt from the marching state
    at the start of every group of
    ``refresh_every`` sub-steps; each sub-step is one K mat-vec, two stage
    solves on that factorization, the zone sums (plus the mixing terms of
    ``mix = (src_slot, dst_slot, vol)``) and the zone update: free-float, or
    with ``ctl = (heat_sp, cool_sp, max_heat, max_cool)`` the setpoint-landing
    control of :func:`heatx_torch.engine.zone.zone_update`.  With
    ``cfg.interior_mrt`` the Carroll network (:func:`plain_mrt`) is frozen
    with the operators, from the group's start state.  Zone vectors are
    flat ``[NB*ZB]``.  Returns ``(T, zT, hq, load)`` with ``load`` the hour's
    mean ideal-load power (None without ``ctl``)."""
    solar_q = surf_mod.absorbed_solar_q(sbv, sol_front, sol_back)
    a_dt = imp_mod.GAMMA * dt_sub / 2.0

    def build_ops(T, zT, t_out, ws, wd):
        t_front, t_back = _boundary_temps(sbv, zT, t_out)
        env_f0, env_b0 = surf_mod.border_conditions(
            sbv, T, t_front, t_back, wd, ws, ir_front, ir_back, cfg, statics=st
        )
        mrt = plain_mrt(sbv, st, T, zT, t_front, t_back)[0] if cfg.interior_mrt else None
        env_f0, env_b0, eps_f, eps_b = surf_mod.apply_interior_mrt(sbv, env_f0, env_b0, mrt)
        rad_hs_f = surf_mod.linearized_rad_coefficient(eps_f, env_f0)
        rad_hs_b = surf_mod.linearized_rad_coefficient(eps_b, env_b0)
        U = surf_mod.segment_u(sbv, T, env_b0.air)
        K = imp_mod._full_system_K(sbv, U, env_f0, env_b0, rad_hs_f, rad_hs_b, st)
        M1 = imp_mod._stage_matrix(sbv, K, sbv.capacity, a_dt)
        cs, inv = tridiag.factor(*M1)
        return SimpleNamespace(
            env_f0=env_f0, env_b0=env_b0, rad_hs_f=rad_hs_f, rad_hs_b=rad_hs_b,
            K=K, lower=M1[0], cs=cs, inv=inv,
        )

    T, zT, hq = T0, zT0, None
    lsum = None if ctl is None else torch.zeros_like(zT0)
    C = sbv.capacity
    for i0 in range(0, substeps, refresh_every):
        w = off + i0
        fz = build_ops(T, zT, t_out_arr[w], wind_arr[w], wdir_arr[w])
        for i in range(i0, i0 + refresh_every):
            t_front, t_back = _boundary_temps(sbv, zT, t_out_arr[off + i])
            env_f = fz.env_f0._replace(air=t_front)
            env_b = fz.env_b0._replace(air=t_back)
            q = imp_mod._substep_forcing(env_f, env_b, fz.rad_hs_f, fz.rad_hs_b, solar_q, st)
            KT0 = tridiag.matvec(*fz.K, T)
            rhs1 = C * T + a_dt * KT0 + imp_mod.GAMMA * dt_sub * q
            rhs1 = torch.where(sbv.node_mask, rhs1, T)
            T1 = tridiag.solve_factored(fz.lower, fz.cs, fz.inv, rhs1)
            rhs2 = imp_mod.C1 * C * T1 - imp_mod.C2 * C * T + imp_mod.BETA * dt_sub * q
            rhs2 = torch.where(sbv.node_mask, rhs2, T)
            T = tridiag.solve_factored(fz.lower, fz.cs, fz.inv, rhs2)

            ts_front = T[0]
            ts_back = surf_mod._last_node(sbv, T, st)
            h_f, h_b = fz.env_f0.h, fz.env_b0.h
            hq = (h_f, h_b, (ts_front - t_front) * h_f, (ts_back - t_back) * h_b)
            a_z, b_z = _zone_dots(a_extra, b_extra, sbv, h_f, h_b, ts_front, ts_back)
            if mix is not None:
                a_z, b_z = _mix_terms(a_z, b_z, zT, mix)
            t_k = zT + KELVIN  # (V rho) cp, heatx's order
            c_z = zone_volume * gas.density(gas.AIR, t_k) * gas.heat_capacity(gas.AIR, t_k)
            if ctl is None:
                zT = zone_mod.future_zone_temperatures(zT, a_z, b_z, c_z, dt_sub)
            else:
                zT, load = zone_mod.zone_update(zT, a_z, b_z, c_z, dt_sub, *ctl)
                lsum = lsum + load
    return T, zT, hq, (None if lsum is None else lsum / substeps)


def plain_hour_parity(
    cfg: SimConfig, sbv, st, zone_volume, a_extra, b_extra, t_out_arr, wind_arr,
    wdir_arr, sol_front, sol_back, ir_front, ir_back, T0, zT0, substeps: int,
    dt_sub: float, off: int, refresh_every: int = 1, ctl=None, mix=None,
):
    """One hour of reference-parity sub-steps for every block (heatx
    ``_hour_body``).  Per sub-step: the TARP border conditions of the state
    (with ``cfg.interior_mrt``, the Carroll network of the sub-step's start
    state, :func:`plain_mrt`), ``engine.surface.march_surfaces`` (the
    relaxed no-mass solve, then RK4 on the massive nodes, flushing tiny stage
    values only where ``cfg.flush_tiny`` says so: :class:`HourMarch` turns it
    off, as the kernel never flushes), the border conditions again on the new temperatures with
    the same forced-convection terms (they give the h of the zone sums and of
    h/q), the zone sums, mixing and the zone update.  Operands and returns as
    :func:`_hour_body_imp` (``refresh_every`` is not read: the operators are
    every sub-step's own); ``sbv`` and ``st`` carry the chunk structure."""
    rad_out = surf_mod.radiant_out_temperatures(ir_front, ir_back)
    solar_q = surf_mod.absorbed_solar_q(sbv, sol_front, sol_back)
    T, zT, hq = T0, zT0, None
    lsum = None if ctl is None else torch.zeros_like(zT0)
    for i in range(substeps):
        t_out, ws, wd = t_out_arr[off + i], wind_arr[off + i], wdir_arr[off + i]
        t_front, t_back = _boundary_temps(sbv, zT, t_out)
        forced = surf_mod.forced_context(sbv, wd, ws)
        kw = dict(statics=st, rad_out=rad_out, forced=forced)
        envs = surf_mod.border_conditions(
            sbv, T, t_front, t_back, wd, ws, ir_front, ir_back, cfg, **kw
        )
        mrt = plain_mrt(sbv, st, T, zT, t_front, t_back)[0] if cfg.interior_mrt else None
        T = surf_mod.march_surfaces(
            sbv, T, t_front, t_back, wd, ws, sol_front, sol_back, ir_front, ir_back, dt_sub, cfg,
            has_massive=sbv.has_massive, statics=st, rad_out=rad_out, envs=envs, solar_q=solar_q,
            mrt=mrt,
        )
        env_f, env_b = surf_mod.border_conditions(
            sbv, T, t_front, t_back, wd, ws, ir_front, ir_back, cfg, **kw
        )
        ts_front = T[0]
        ts_back = surf_mod._last_node(sbv, T, st)
        hq = (env_f.h, env_b.h, (ts_front - t_front) * env_f.h, (ts_back - t_back) * env_b.h)
        a_z, b_z = _zone_dots(a_extra, b_extra, sbv, env_f.h, env_b.h, ts_front, ts_back)
        if mix is not None:
            a_z, b_z = _mix_terms(a_z, b_z, zT, mix)
        t_k = zT + KELVIN  # (V rho) cp, heatx's order
        c_z = zone_volume * gas.density(gas.AIR, t_k) * gas.heat_capacity(gas.AIR, t_k)
        if ctl is None:
            zT = zone_mod.future_zone_temperatures(zT, a_z, b_z, c_z, dt_sub)
        else:
            zT, load = zone_mod.zone_update(zT, a_z, b_z, c_z, dt_sub, *ctl)
            lsum = lsum + load
    return T, zT, hq, (None if lsum is None else lsum / substeps)


def hour_body(parity: bool, sbv, st, **kw):
    """One hour of either integrator on the plain path (keyword operands as
    :func:`_hour_body_imp`)."""
    return (plain_hour_parity if parity else _hour_body_imp)(sbv=sbv, st=st, **kw)


def _zone_slots(params: DayMarchParams, local) -> torch.Tensor:
    """A lane row of block-local zone slots (-1: none) as global slots
    ``block*ZB + local`` (-1 kept)."""
    local = local.to(torch.int64)
    block = torch.arange(local.numel(), device=local.device) // params.block_size
    return torch.where(local >= 0, block * params.zones_per_block + local, local)


def gate_hour(params: DayMarchParams, zT, h, sol_front, a_extra, b_extra, shade_sp=None, a_vent=None,
              b_vent=None, vent_thr=None):
    """The in-run controls at the start of hour (main step) ``h`` (heatx's
    hour loop, pallas_step.py:1576-1594 and :1614-1635), from the zone carry
    ``zT`` [NB*ZB] at that start: the hour's front solar row [SP] scaled by
    the deployed transmittance where the controlling zone is warmer than the
    setpoint (``shade_sp`` [hours, SP], else the compiled row), and the zone
    gain rows [NB*ZB] with the hour's ventilation terms added where the
    indoor gates pass.  Returns ``(sol_front, a_extra, b_extra)``."""
    if params.shade_slot is not None:
        slot = _zone_slots(params, params.shade_slot)
        t_ctl = torch.where(slot >= 0, zT[slot.clamp_min(0)], torch.zeros_like(sol_front))
        sp_row = params.shade[1] if shade_sp is None else shade_sp[h]
        sol_front = sol_front * torch.where(t_ctl > sp_row, params.shade[0], torch.ones_like(sol_front))
    if params.vent is not None:
        vmin, vmax = params.vent.reshape(2, -1)
        on = (zT > vmin) & (zT < vmax) & (zT > vent_thr[h].reshape(-1))
        zero = torch.zeros_like(a_extra)
        a_extra = a_extra + torch.where(on, a_vent[h].reshape(-1), zero)
        b_extra = b_extra + torch.where(on, b_vent[h].reshape(-1), zero)
    return sol_front, a_extra, b_extra


def _refuse_gated_grad(params: DayMarchParams, *tensors):
    """Raise where autograd would differentiate through the in-run gates
    (heatx's adjoint refuses them, pallas_adjoint.py:162-171): a gradient that
    holds each decision fixed is not the gradient of the march."""
    if not (params.gated and torch.is_grad_enabled()):
        return
    leaves = [params.node, params.surf, params.zone_volume, params.ctl, params.mrt, *tensors]
    if any(isinstance(t, torch.Tensor) and t.requires_grad for t in leaves):
        raise ValueError(
            "gradients through in-run zone shading and ventilation gates are not supported "
            "(heatx's adjoint refuses them too)"
        )


def plain_day_march(
    params: DayMarchParams, T, zT, t_out, wind, wdir, sol_front, sol_back,
    ir_front, ir_back, a_extra, b_extra, sp_heat=None, sp_cool=None, *, hours: int,
    substeps: int, refresh_every: int, dt: float, config: SimConfig, parity: bool = False,
    collect_hq: bool = False, collect_operative: bool = False, shade_sp=None, a_vent=None,
    b_vent=None, vent_thr=None,
):
    """The plain PyTorch day march on any device: the reference the CUDA
    kernel is held against.  Shapes as :func:`day_march_kernel`; returns
    ``(T, zT, hq [4, SP], zt_hist, bad, ld_hist, hq_hist, top)`` with
    ``ld_hist`` None when ``params`` has no thermostat rows, ``hq_hist``
    [hours, 4, SP] each hour's last h/q with ``collect_hq`` (else None) and
    ``top`` [hours, NB, ZB] the operative temperature ``(zT + T_mrt)/2`` of
    each hour's final state with ``collect_operative`` (else None).
    ``parity`` marches the reference-parity sub-steps
    (:func:`plain_hour_parity`) instead of TR-BDF2.  The in-run controls of
    a gated building (:func:`gate_hour`) apply at each hour's start, with
    the shading setpoint series ``shade_sp`` [hours, SP] (None: the compiled
    setpoints) and, on a building with ventilation gates, the gated rows
    ``a_vent``, ``b_vent``, ``vent_thr`` [hours, NB, ZB]; autograd through a
    gated march, or through the adaptive no-mass loop
    (``surface.march_nomass``), raises."""
    gates = dict(shade_sp=shade_sp, a_vent=a_vent, b_vent=b_vent, vent_thr=vent_thr)
    _refuse_gated_grad(params, T, zT, sol_front, a_extra, b_extra, *gates.values())
    sbv = _lanes(params, chunks=parity)
    st = surf_mod.compute_statics(sbv)
    NB, ZB = params.n_blocks, params.zones_per_block
    zone_volume = params.zone_volume.reshape(-1)
    zT = zT.reshape(-1)
    mix = _mix_slots(params)
    ctl = None if params.ctl is None else tuple(params.ctl.reshape(4, -1))
    hist, bad, loads, hq_hist, top = [], [], [], [], []
    hq = None
    for h in range(hours):
        if ctl is not None and sp_heat is not None:
            ctl = (sp_heat[h].reshape(-1), sp_cool[h].reshape(-1)) + ctl[2:]
        sol_f, a_h, b_h = gate_hour(params, zT, h, sol_front[h], a_extra[h].reshape(-1),
                                    b_extra[h].reshape(-1), **gates)
        T, zT, hq, ld = hour_body(
            parity, sbv, st, cfg=config, zone_volume=zone_volume,
            a_extra=a_h, b_extra=b_h, t_out_arr=t_out,
            wind_arr=wind, wdir_arr=wdir, sol_front=sol_f, sol_back=sol_back[h],
            ir_front=ir_front[h], ir_back=ir_back[h], T0=T, zT0=zT, substeps=substeps,
            dt_sub=dt, off=h * substeps, refresh_every=refresh_every, ctl=ctl, mix=mix,
        )
        hist.append(zT.reshape(NB, ZB))
        if ld is not None:
            loads.append(ld.reshape(NB, ZB))
        if collect_hq:
            hq_hist.append(torch.stack(hq))
        if collect_operative:  # the zone-air-started solve on the hour's final state
            tm = plain_mrt(sbv, st, T, zT, *_boundary_temps(sbv, zT, t_out[(h + 1) * substeps - 1]))[1]
            top.append(((zT + tm) / 2.0).reshape(NB, ZB))
        node_bad = (sbv.node_mask & ~torch.isfinite(T)).sum(dim=0)
        count = node_bad.reshape(NB, -1).sum(dim=1) + (~torch.isfinite(zT)).reshape(NB, ZB).sum(dim=1)
        bad.append(count.to(T.dtype))
    return (T, zT.reshape(NB, ZB), torch.stack(hq), torch.stack(hist), torch.stack(bad),
            torch.stack(loads) if loads else None, torch.stack(hq_hist) if collect_hq else None,
            torch.stack(top) if collect_operative else None)


# ---------------------------------------------------------------------------
# The CUDA kernel wrapper
# ---------------------------------------------------------------------------


def _load_library():
    lib = cuda_lib.load("heatx_day_march", KERNEL_SOURCES)
    if not getattr(lib, "_heatx_bound", False):
        vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        for fn in (lib.heatx_day_march_f32, lib.heatx_day_march_f64):
            fn.argtypes = [vp] * 42 + [ci] * 13 + [cd] * 8 + [vp, vp]
            fn.restype = ci
        lib.heatx_cuda_error_string.argtypes = [ci]
        lib.heatx_cuda_error_string.restype = ctypes.c_char_p
        lib._heatx_bound = True
    return lib


def load_kernel() -> None:
    """Build (at first use) and load the day-march kernel library."""
    _load_library()


class DayMarchKernel:
    """Launches the day march on CUDA tensors: the TR-BDF2 modes in
    ``day_march_tr.cu``, parity in ``day_march_parity.cu``, both four
    threads per surface in the launch variant that the C entry picks from the
    block's lanes (``block_threads`` reads back the threads of a block of the
    last launch's).  ``launches`` counts the launches made through this
    wrapper (and nothing else).  Arguments and returns as
    :func:`plain_day_march`.  Thermostat rows (``params.ctl``), per-hour
    setpoints and mixing lists select the kernels' second kind, gas cavities
    (``params.cav``) a third that also carries the cavity code; without them
    the free-float one runs.  ``parity`` selects the reference-parity kernel
    (in the same kinds), whose no-mass iteration count and tolerances come
    from ``config``.  MRT physics (``config.interior_mrt``), ``collect_hq``
    and ``collect_operative`` select the kinds with the Carroll network and
    the two histories (:func:`mrt_operands`).  In-run shading and
    ventilation gates (``params.shade_slot``, ``params.vent``) run in the
    extended kinds (:func:`gate_hour` has their meaning)."""

    def __init__(self):
        self.block_threads = None  # threads per block of the last launch's variant
        self.launches = 0
        self.parity_launches = 0  # those of ``launches`` that ran the parity kernel
        self.cavity_launches = 0  # those of ``launches`` on a building with gas cavities
        self.parity_cavity_launches = 0  # those of ``cavity_launches`` in parity mode
        self.mrt_launches = 0  # those of ``launches`` that ran an MRT instantiation
        self.parity_mrt_launches = 0  # those of ``mrt_launches`` in parity mode
        self.gated_launches = 0  # those of ``launches`` with in-run shading or ventilation gates
        self.parity_gated_launches = 0  # those of ``gated_launches`` in parity mode

    def __call__(
        self, params: DayMarchParams, T, zT, t_out, wind, wdir, sol_front,
        sol_back, ir_front, ir_back, a_extra, b_extra, sp_heat=None, sp_cool=None, *,
        hours: int, substeps: int, refresh_every: int, dt: float, config: SimConfig,
        parity: bool = False, collect_hq: bool = False, collect_operative: bool = False,
        shade_sp=None, a_vent=None, b_vent=None, vent_thr=None,
    ):
        N, NB, ZB = params.max_nodes, params.n_blocks, params.zones_per_block
        SB = params.block_size
        SP = NB * SB
        dtype = T.dtype
        expect = launch_operands(
            "day_march", params, T, zT, t_out, wind, wdir, sol_front, sol_back, ir_front, ir_back,
            a_extra, b_extra, sp_heat, sp_cool, hours=hours, substeps=substeps,
            refresh_every=refresh_every,
        )
        expect.update(gate_operands(params, hours, dtype, shade_sp, a_vent, b_vent, vent_thr))
        cuda_lib.check_operands(expect, T.device)
        lib = _load_library()
        fn = lib.heatx_day_march_f32 if dtype == torch.float32 else lib.heatx_day_march_f64
        kw = dict(dtype=dtype, device=T.device)
        T_out = torch.empty((N, SP), **kw)
        zT_out = torch.empty((NB, ZB), **kw)
        hq = torch.empty((4, SP), **kw)
        zt_hist = torch.empty((hours, NB, ZB), **kw)
        bad = torch.empty((hours, NB), **kw)
        ld_hist = None if params.ctl is None else torch.empty((hours, NB, ZB), **kw)
        hq_hist = torch.empty((hours, 4, SP), **kw) if collect_hq else None
        top = torch.empty((hours, NB, ZB), **kw) if collect_operative else None
        mrt = mrt_operands(params, config, collect_hq, collect_operative)
        mix = params.mix
        ptrs = [None if t is None else t.data_ptr() for t in (
            params.node, params.surf, params.lane, params.zone_volume,
            params.zone_ptr, params.zone_faces, t_out, wind, wdir, sol_front,
            sol_back, ir_front, ir_back, a_extra, b_extra, T, zT,
            T_out, zT_out, hq, zt_hist, bad,
            ld_hist, params.ctl, sp_heat, sp_cool,
            *((None,) * 3 if mix is None else (mix.ptr, mix.src, mix.vol)), params.cav,
            *mrt, hq_hist, top, params.shade_slot, params.shade, shade_sp, params.vent,
            a_vent, b_vent, vent_thr,
        )]
        ran = ctypes.c_int(0)
        with torch.cuda.device(T.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(
                *ptrs, N, NB, SB, ZB, hours, substeps, refresh_every,
                int(config.replicate_ambient_back_bug), *parity_ints(config, parity),
                int(config.interior_mrt), dt, imp_mod.GAMMA * dt / 2.0, imp_mod.GAMMA * dt,
                imp_mod.BETA * dt, imp_mod.C1, imp_mod.C2,
                config.nomass_tol, config.nomass_tol_escalated, ctypes.byref(ran), stream,
            )
        if err != 0:
            msg = lib.heatx_cuda_error_string(err).decode()
            raise RuntimeError(f"day_march kernel launch failed: CUDA error {err} ({msg})")
        self.block_threads = ran.value
        self.launches += 1
        self.parity_launches += int(parity)
        self.cavity_launches += int(params.cav is not None)
        self.parity_cavity_launches += int(parity and params.cav is not None)
        self.mrt_launches += int(mrt[0] is not None)
        self.parity_mrt_launches += int(parity and mrt[0] is not None)
        self.gated_launches += int(params.gated)
        self.parity_gated_launches += int(parity and params.gated)
        return T_out, zT_out, hq, zt_hist, bad, ld_hist, hq_hist, top


def gate_operands(params: DayMarchParams, hours: int, dtype, shade_sp=None, a_vent=None, b_vent=None,
                  vent_thr=None) -> dict:
    """What a launch reads of the in-run controls, as
    ``cuda_lib.check_operands`` takes it.  Raises where the operands do not
    match the building's controls: a shading series without shading, the
    gated rows without ventilation gates or a gated launch without all
    three."""
    NB, ZB, SP = params.n_blocks, params.zones_per_block, params.surf.shape[1]
    rows = (a_vent, b_vent, vent_thr)
    if shade_sp is not None and params.shade_slot is None:
        raise ValueError("a shading setpoint series needs in-run zone shading (params.shade_slot)")
    if any((r is None) != (params.vent is None) for r in rows):
        raise ValueError("a ventilation-gated march takes a_vent, b_vent and vent_thr, and only it")
    out = {}
    if params.shade_slot is not None:
        out["shade_slot"] = (params.shade_slot, (SP,), torch.int32)
        out["shade"] = (params.shade, (len(SHADE_FIELDS), SP), dtype)
    if shade_sp is not None:
        out["shade_sp"] = (shade_sp, (hours, SP), dtype)
    if params.vent is not None:
        out["vent"] = (params.vent, (2, NB, ZB), dtype)
        out.update({name: (r, (hours, NB, ZB), dtype)
                    for name, r in zip(("a_vent", "b_vent", "vent_thr"), rows)})
    return out


def mrt_operands(params: DayMarchParams, config: SimConfig, collect_hq=False, collect_operative=False):
    """The network operands of a launch ``(mrt, mrt_ptr, mrt_faces)``.  MRT
    physics (``config.interior_mrt``) and either history take the
    instantiations with the network and the histories: the params' rows
    (zero rows and empty lists where the building has no network and only
    the h/q history is asked for); other launches three Nones.  Raises where
    MRT physics or the operative history has no network operands."""
    if (config.interior_mrt or collect_operative) and params.mrt is None:
        raise ValueError(
            "interior MRT and the operative history need the blocked Carroll statics "
            "(block_building(..., mrt_statics=True); automatic with config.interior_mrt)"
        )
    if not (config.interior_mrt or collect_hq or collect_operative):
        return None, None, None
    if params.mrt is not None:
        return params.mrt, params.mrt_ptr, params.mrt_faces
    z = params.zone_ptr
    return params.surf.new_zeros((2, params.surf.shape[1])), torch.zeros_like(z), z[:1].clone()


def parity_ints(config: SimConfig, parity: bool) -> tuple:
    """The integer arguments that select and steer the parity kernels:
    ``(parity, nomass_iters, nomass_escalate_after, nomass_max_iter)`` with
    ``nomass_iters`` the fixed iteration count, or -1 for the adaptive loop
    (``config.nomass_fixed_iters=None``), which stops a run's iterations at
    convergence or after ``nomass_max_iter``."""
    iters = -1 if config.nomass_fixed_iters is None else int(config.nomass_fixed_iters)
    return int(parity), iters, int(config.nomass_escalate_after), int(config.nomass_max_iter)


def adaptive_parity(config: SimConfig, parity: bool) -> bool:
    """Whether a march runs the adaptive no-mass loop (which has no gradient)."""
    return bool(parity) and config.nomass_fixed_iters is None


def launch_operands(
    kernel: str, params: DayMarchParams, T, zT, t_out, wind, wdir, sol_front, sol_back, ir_front,
    ir_back, a_extra, b_extra, sp_heat, sp_cool, *, hours: int, substeps: int, refresh_every: int,
) -> dict:
    """What either kernel's launch reads, as ``cuda_lib.check_operands``
    takes it (``name: (tensor, shape, dtype)``, in the order of the C
    interface's leading pointers, then the thermostat, schedule and mixing
    operands the building has).  Raises on a dtype, block size, node count
    or cadence the kernels do not take; per-hour setpoints come as a
    heat/cool pair, on thermostat rows."""
    N, NB, ZB = params.max_nodes, params.n_blocks, params.zones_per_block
    SB = params.block_size
    SP = NB * SB
    dtype = T.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{kernel} kernel takes float32/float64, got {dtype}")
    if SB > MAX_BLOCK_LANES:
        raise ValueError(f"block of {SB} lanes > {MAX_BLOCK_LANES} (use a smaller block_size)")
    if N > MAX_NODES:
        raise ValueError(f"{N} nodes per surface > {MAX_NODES}")
    if substeps % refresh_every:
        raise ValueError(f"refresh_every {refresh_every} must divide substeps {substeps}")
    if (sp_heat is None) != (sp_cool is None) or (sp_heat is not None and params.ctl is None):
        raise ValueError("per-hour setpoints come as a heat/cool pair, on thermostat rows")
    out = {
        "node": (params.node, (4, N, SP), dtype),
        "surf": (params.surf, (len(SURF_FIELDS), SP), dtype),
        "lane": (params.lane, (len(LANE_FIELDS), SP), torch.int32),
        "zone_volume": (params.zone_volume, (NB, ZB), dtype),
        "zone_ptr": (params.zone_ptr, (NB * ZB + 1,), torch.int32),
        "zone_faces": (params.zone_faces, tuple(params.zone_faces.shape), torch.int32),
        "t_out": (t_out, (hours * substeps,), dtype),
        "wind": (wind, (hours * substeps,), dtype),
        "wdir": (wdir, (hours * substeps,), dtype),
        "sol_front": (sol_front, (hours, SP), dtype),
        "sol_back": (sol_back, (hours, SP), dtype),
        "ir_front": (ir_front, (hours, SP), dtype),
        "ir_back": (ir_back, (hours, SP), dtype),
        "a_extra": (a_extra, (hours, NB, ZB), dtype),
        "b_extra": (b_extra, (hours, NB, ZB), dtype),
        "T": (T, (N, SP), dtype),
        "zT": (zT, (NB, ZB), dtype),
    }
    if params.ctl is not None:
        out["ctl"] = (params.ctl, (4, NB, ZB), dtype)
    if sp_heat is not None:
        out["sp_heat"] = (sp_heat, (hours, NB, ZB), dtype)
        out["sp_cool"] = (sp_cool, (hours, NB, ZB), dtype)
    if params.cav is not None:
        out["cav"] = (params.cav, (len(CAV_FIELDS), N, SP), dtype)
    if params.mrt is not None:
        out["mrt"] = (params.mrt, (len(MRT_FIELDS), SP), dtype)
        out["mrt_ptr"] = (params.mrt_ptr, (NB * ZB + 1,), torch.int32)
        out["mrt_faces"] = (params.mrt_faces, tuple(params.mrt_faces.shape), torch.int32)
    if params.mix is not None:
        m = params.mix
        n = tuple(m.src.shape)
        out.update({
            "mix.ptr": (m.ptr, (NB * ZB + 1,), torch.int32), "mix.src": (m.src, n, torch.int32),
            "mix.vol": (m.vol, n, dtype), "mix.t_ptr": (m.t_ptr, (NB * ZB + 1,), torch.int32),
            "mix.t_dst": (m.t_dst, n, torch.int32), "mix.t_vol": (m.t_vol, n, dtype),
        })
    return out


#: The process's day-march kernel wrapper (its ``launches`` counter is what
#: chip_smoke.py reads).
day_march_kernel = DayMarchKernel()


class HourMarch:
    """``hour_march(params, T, zT_blocked, hour_inputs)`` (see the module
    docstring).  CUDA tensors launch the kernel, CPU tensors run the plain
    twin; :meth:`plain` runs the plain twin on any device.
    ``collect_loads`` says whether the outputs carry ``ld_hist`` (the
    building has thermostats), ``scheduled_setpoints`` whether the march
    reads per-hour setpoint rows, ``parity`` whether it marches the
    reference-parity sub-steps instead of TR-BDF2, ``collect_hq`` and
    ``collect_operative`` whether the outputs carry the per-hour h/q
    history (4 x [hours, SP]) and operative temperature [hours, NB, ZB].
    The outputs follow heatx's order: ``(T, zT, hq, zt_hist[, hq_hist][,
    bad][, ld_hist][, top])``.  ``vent_gated`` (the building has ventilation
    gates) says that the hour inputs carry the three gated rows after
    ``b_extra``, and ``scheduled_shade_sp`` (a building with in-run
    shading) that they may end with a shading setpoint series."""

    def __init__(self, bb: BlockedBuilding, substeps, hours, refresh_every, dt,
                 collect_bad, scheduled_setpoints=False, parity=False, collect_hq=False,
                 collect_operative=False, scheduled_shade_sp=False):
        self.parity = parity
        # The adaptive no-mass loop runs (and no gradient may go through it).
        self.adaptive = adaptive_parity(bb.config, parity) and bb.surfaces.has_nomass
        self.shaded = bb.shade is not None
        self.vent_gated = bb.vent is not None
        self.scheduled_shade_sp = scheduled_shade_sp
        self.collect_hq = collect_hq
        self.collect_operative = collect_operative
        self.substeps = substeps
        self.hours = hours
        self.refresh_every = refresh_every
        self.dt = dt
        self.collect_bad = collect_bad
        self.collect_loads = bb.ctl is not None
        self.scheduled_setpoints = scheduled_setpoints
        # The kernel never flushes tiny RK4 stage values (heatx's kernel path
        # passes flush_tiny=False, pallas_step.py:1555), so neither does its twin.
        self.config = bb.config.replace(flush_tiny=False) if parity else bb.config
        self.n_blocks = bb.n_blocks
        self.zones_per_block = bb.zones_per_block
        self.padded_surfaces = bb.layout.padded_surfaces

    def without_observables(self) -> "HourMarch":
        """This march without the h/q and operative histories (the gradient
        path's: its outputs carry neither)."""
        out = copy.copy(self)
        out.collect_hq = out.collect_operative = False
        return out

    def _operands(self, params, T, zT_blocked, hour_inputs):
        """(the positional operands of either kernel and its plain version,
        the in-run control operands as keywords).  heatx's arity rules
        (pallas_step.py:1996-2017): a trailing shading setpoint series
        (``scheduled_shade_sp``) is told by the tuple's length, then a
        ventilation-gated march takes the 12-leaf tuple, then the setpoint
        pair of a scheduled march."""
        hour_inputs = tuple(hour_inputs)
        H, sub, SP = self.hours, self.substeps, self.padded_surfaces
        NB, ZB = self.n_blocks, self.zones_per_block

        def cast(a, shape):
            a = torch.as_tensor(a, dtype=T.dtype, device=T.device)
            return a.reshape(shape).contiguous()

        gates = {}
        n_base = 12 if self.vent_gated else 9
        if self.scheduled_shade_sp and len(hour_inputs) in (n_base + 1, n_base + 3):
            gates["shade_sp"] = cast(hour_inputs[-1], (H, SP))
            hour_inputs = hour_inputs[:-1]
        if self.vent_gated:
            if len(hour_inputs) < n_base:
                raise ValueError(
                    "vent-gated kernels take the 12-leaf hour-input tuple "
                    "(..., a_extra, b_extra, a_vent, b_vent, vent_thr)"
                )
            gates.update(zip(("a_vent", "b_vent", "vent_thr"),
                             (cast(a, (H, NB, ZB)) for a in hour_inputs[9:12])))
            hour_inputs = hour_inputs[:9] + hour_inputs[12:]
        sp = ()
        if self.scheduled_setpoints:
            if len(hour_inputs) == 11:
                sp = tuple(cast(a, (H, NB, ZB)) for a in hour_inputs[9:])
                hour_inputs = hour_inputs[:9]
            else:  # the compiled setpoints, hour-constant, from the params given
                sp = tuple(params.ctl[k].expand(H, NB, ZB).contiguous() for k in (0, 1))
        t_o, wnd, wdr, sol_f, sol_b, ir_f, ir_b, a_extra, b_extra = hour_inputs
        return (
            T.contiguous(), cast(zT_blocked, (NB, ZB)),
            cast(t_o, (H * sub,)), cast(wnd, (H * sub,)), cast(wdr, (H * sub,)),
            cast(sol_f, (H, SP)), cast(sol_b, (H, SP)), cast(ir_f, (H, SP)),
            cast(ir_b, (H, SP)), cast(a_extra, (H, NB, ZB)), cast(b_extra, (H, NB, ZB)),
        ) + sp, gates

    def _finish(self, outs):
        T, zT, hq, zt_hist, bad, ld_hist, hq_hist, top = outs
        ret = (T, zT, tuple(hq.unbind(0)), zt_hist)
        if self.collect_hq:
            ret += (tuple(hq_hist.unbind(1)),)
        if self.collect_bad:
            ret += (bad,)
        if self.collect_loads:
            ret += (ld_hist,)
        if self.collect_operative:
            ret += (top,)
        return ret

    def _kw(self, observables=True):
        """The keywords of either kernel and its plain version
        (``observables``: with the march's history flags)."""
        kw = dict(
            hours=self.hours, substeps=self.substeps,
            refresh_every=self.refresh_every, dt=self.dt, config=self.config,
            parity=self.parity,
        )
        if observables:
            kw.update(collect_hq=self.collect_hq, collect_operative=self.collect_operative)
        return kw

    def __call__(self, params, T, zT_blocked, hour_inputs):
        ops, gates = self._operands(params, T, zT_blocked, hour_inputs)
        if T.device.type == "cuda":
            return self._finish(day_march_kernel(params, *ops, **self._kw(), **gates))
        if T.device.type == "cpu":
            return self._finish(plain_day_march(params, *ops, **self._kw(), **gates))
        raise ValueError(f"no day march for device {T.device}")

    def plain(self, params, T, zT_blocked, hour_inputs):
        ops, gates = self._operands(params, T, zT_blocked, hour_inputs)
        return self._finish(plain_day_march(params, *ops, **self._kw(), **gates))


def hour_march_for(
    bb: BlockedBuilding, substeps: int = None, mode: str = "trbdf2", hours: int = 1,
    refresh_every: int = None, collect_bad: bool = False,
    scheduled_setpoints: bool = False, collect_hq: bool = False, collect_operative: bool = False,
    scheduled_shade_sp: bool = False,
) -> HourMarch:
    """The :class:`HourMarch` of :func:`make_hour_march`'s arguments, with
    the sub-step count and refresh cadence resolved (no operands)."""
    if mode not in ("parity", "trbdf2", "trbdf2_refresh"):
        raise ValueError(f"unknown hour-kernel mode {mode!r}")
    if collect_operative and bb.mrt_eps is None:
        raise ValueError(
            "collect_operative needs the blocked Carroll statics: build with "
            "block_building(..., mrt_statics=True) (automatic when config.interior_mrt is set)"
        )
    obs = dict(collect_hq=collect_hq, collect_operative=collect_operative,
               scheduled_shade_sp=scheduled_shade_sp)
    if refresh_every is not None and mode != "trbdf2_refresh":
        raise ValueError(
            f"refresh_every only applies to mode='trbdf2_refresh' (got mode={mode!r})"
        )
    if scheduled_setpoints and bb.ctl is None:
        raise ValueError(
            "scheduled_setpoints requires setpoint-driven HVAC "
            "(IdealHeaterCooler with heat_setpoint/cool_setpoint)"
        )
    if scheduled_shade_sp and bb.shade is None:
        raise ValueError(
            "scheduled_shade_sp requires in-run zone-shading controls "
            "(BuildingModel.add_zone_shading)"
        )
    if mode == "parity":
        # heatx's rules (pallas_step.py:1345-1355): the building's own
        # stability sub-step count and sub-step length, and a fixed number of
        # no-mass iterations wherever there is a no-mass node unless
        # HEATX_KERNEL_WHILE=1 admits the adaptive loop.
        if bb.config.nomass_fixed_iters is None and bb.surfaces.has_nomass:
            if os.environ.get("HEATX_KERNEL_WHILE", "0") != "1":
                raise ValueError(
                    "the parity hour kernel requires config.nomass_fixed_iters"
                    " (data-dependent while_loop in the fused pipeline is"
                    " experimental: set HEATX_KERNEL_WHILE=1 to try the exact"
                    " adaptive loop in-kernel)"
                )
        substeps = substeps or bb.base.dt_subdivisions
        return HourMarch(bb, substeps, hours, 1, bb.base.dt, collect_bad,
                         scheduled_setpoints, parity=True, **obs)
    substeps = substeps or 12
    if mode == "trbdf2":
        refresh_every = substeps
    elif refresh_every is None:
        refresh_every = 1
    if refresh_every < 1 or substeps % refresh_every:
        raise ValueError(f"refresh_every {refresh_every} must divide substeps {substeps}")
    dt = 3600.0 / (bb.base.n_steps_per_hour * substeps)
    return HourMarch(bb, substeps, hours, refresh_every, dt, collect_bad, scheduled_setpoints, **obs)


def make_hour_march(
    bb: BlockedBuilding,
    substeps: int = None,
    mode: str = "trbdf2",
    hours: int = 1,
    refresh_every: int = None,
    collect_bad: bool = False,
    device="cuda",
    scheduled_setpoints: bool = False,
    collect_hq: bool = False,
    collect_operative: bool = False,
    scheduled_shade_sp: bool = False,
):
    """Build the day march: ``(hour_march, params)`` with ``params`` on
    ``device`` (the card unless the caller asks for another; ``"cuda"``
    without a GPU raises) in the building's dtype (heatx
    ``make_hour_march``).  ``mode="parity"`` marches the reference-parity
    sub-steps: ``substeps`` defaults to the building's ``dt_subdivisions``,
    the sub-step length is the building's ``dt`` whatever ``substeps`` says,
    and a building with no-mass nodes needs ``config.nomass_fixed_iters``
    or, for the adaptive loop, ``HEATX_KERNEL_WHILE=1``.
    In the TR-BDF2 modes ``substeps`` defaults to 12, ``refresh_every=k``
    rebuilds the operators every k sub-steps (default 1 in refresh mode) and
    frozen mode is ``k = substeps``.  ``scheduled_setpoints`` (thermostat buildings) makes
    the march read per-hour setpoint rows from the 11-leaf hour inputs.
    ``collect_hq`` adds the per-hour h/q history and ``collect_operative``
    the per-hour operative temperature (the building blocked with the MRT
    statics) to the outputs, in heatx's order (:class:`HourMarch`).  A
    building with ventilation gates takes heatx's 12-leaf hour inputs, and
    ``scheduled_shade_sp`` (buildings with in-run shading) lets them end
    with a shading setpoint series ``[hours, SP]`` (see the module
    docstring)."""
    hm = hour_march_for(bb, substeps, mode, hours, refresh_every, collect_bad, scheduled_setpoints,
                        collect_hq, collect_operative, scheduled_shade_sp)
    params = params_from_blocked(bb, bb.config.dtype, cuda_lib.resolve_device(device))
    return hm, params

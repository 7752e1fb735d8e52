"""The day march: heatx's fused Pallas hour kernel, on PyTorch/CUDA.

Counterpart of ``heatx.ops.pallas_step`` for modes ``trbdf2``,
``trbdf2_refresh`` and ``parity`` (the reference-parity sub-step: RK4 on the
massive nodes after a relaxed fixed-iteration no-mass solve), on free-float
buildings and on buildings with thermostats (setpoint-driven ideal loads),
scheduled setpoints and inter-zone mixing.  :func:`make_hour_march` returns ``(hour_march, params)``
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
hand-written kernel in ``heatx_torch/csrc/day_march.cu`` or raises.

Design, and what of heatx's kernel is deliberately not carried over:

* One CUDA thread block per zone-closed block, one thread per surface lane
  (at most 256 lanes per block).  Blocks are laid out with
  ``node_split=None``: a thread marches its surface's whole node column, so
  the node-height split that saves padded rows on the TPU's vector lanes has
  nothing to save here.
* Zone coupling goes through shared memory: boundary air temperatures are
  indexed reads of the block's zone row (``front_zone``/``back_zone``, -1 for
  a face that bounds no zone), and the zone A/B sums are a fixed-order sum
  per zone over a lane list built on the host (``zone_ptr``/``zone_faces``),
  so two runs give the same bits.  heatx's one-hot matmuls (and their
  transposed copies) are not ported.
* The zone update uses ``expm1``; heatx's ``_expm1_neg`` series exists only
  because Mosaic has no expm1.
* Inter-zone mixing keeps the meaning of heatx's dense ``mix_wt[b*ZB + from,
  to]`` as per-block entry lists (:class:`MixLists`): grouped by destination
  zone in a fixed order for the march, and by source zone for the adjoint's
  transpose.  A zone reads its sources' sub-step-start temperatures, so the
  kernel writes the new zone row into a second shared row and swaps the two.
* The thermostat, schedule and mixing code is a second instantiation of the
  kernel template: free-float buildings run the code they ran before.
* Mosaic layout workarounds are gone: ``_row01`` and the rank-2 ``[1, ZB]``
  zone rows, the 8-row zone padding (``zone_spec``/``_pad_zone_rows``) and
  the HR8 hour padding, full-block broadcast writes, ``vmem_limit_mb`` /
  ``HEATX_KERNEL_VMEM_MB``.
* Solver selection is gone: the stage matrix is factored once per operator
  refresh with the Thomas sweeps (heatx's ``factor``/``solve_factored``),
  which is the natural per-thread solver; ``HEATX_KERNEL_SOLVER``,
  ``HEATX_KERNEL_LOOP`` and the scratch-ref ``_make_ref_thomas`` are not
  ported.  The PCR twins stay in ``heatx_torch.ops.tridiag``.
* bench.py's dispatch chunking against a remote watchdog has no counterpart
  (a parity day-launch runs for ~0.14 s on an H100, an adjoint one for ~1.6 s).
* Parity mode (``csrc/day_parity.cuh``, the plain twin
  :func:`plain_hour_parity`) is a further instantiation of each kernel
  template, so the TR-BDF2 code keeps its registers and times.  Not carried
  over from heatx's parity path: the hoisted static-U forms of K and q and
  the identity guards that select them (one inline form here); the solver
  choice for the no-mass system (heatx: the closed-form pair solve when no
  run is longer than 2 nodes, else PCR compiled and Thomas interpreted;
  ``HEATX_NOMASS_PAIRS``, ``HEATX_KERNEL_SOLVER``, ``HEATX_KERNEL_LOOP``):
  the kernel runs the Thomas sweeps over the identity-padded column per
  thread, and the plain twin keeps heatx's choice (``tridiag.solve_runs2`` or
  ``tridiag.solve``); ``unroll_fixed_loops``/``kernel_mode``; chunk ids and
  counts as operands (a lane's ``chunk_bits`` word and its masks give them).
  The kernel never flushes tiny RK4 stage values to zero, and
  :class:`HourMarch` gives its twin ``flush_tiny=False`` whatever the
  building's config says (heatx's kernel path does the same on hardware that
  flushes subnormals; nvcc without fast-math keeps them, and chip_smoke.py
  shows in f32 at full width that a twin which flushes differs by round-off).
  ``SimConfig.flush_tiny`` is read by ``engine.surface.march_surfaces``.  The adaptive no-mass
  loop (``nomass_fixed_iters=None``, ``HEATX_KERNEL_WHILE``) raises: ROADMAP
  B6/A10.

Frozen mode (``trbdf2``) is the refresh kernel with ``refresh_every =
substeps``: heatx proves the two bit-identical (test_pallas_imp.py).

Gradients: :class:`ParamBlocker` blocks the parameter rows differentiably
from torch tensors, and ``heatx_torch.ops.day_adjoint`` holds the reverse
sweep (the adjoint kernel and ``DayMarchFn``).

Not ported yet (each raises ``NotImplementedError``): gas cavities, interior
MRT, in-run shading and vent gates (ROADMAP A9/B5),
``collect_hq``/``collect_operative`` (A9) and sharding (A12).
"""

from __future__ import annotations

import ctypes
import dataclasses
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
# these rows by the same order (enum ND_*, SF_*, LN_* in csrc/day_march.cu).
NODE_FIELDS = ("seg_u", "capacity", "front_alphas", "back_alphas")
SURF_FIELDS = (
    "area", "perimeter", "cos_tilt", "wind_mod", "eps_front", "eps_back", "rf",
    "front_temp", "back_temp", "fixed_h_front", "fixed_h_back", "normal_x",
    "normal_y",
)
LANE_FIELDS = (
    "front_code", "back_code", "front_zone", "back_zone", "node_bits", "mass_bits",
    "chunk_bits",
)

KERNEL_SOURCE = cuda_lib.CSRC_DIR / "day_march.cu"

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
    if building.surfaces.has_cavity:
        missing.append("gas cavities (ROADMAP A9/B5)")
    if building.config.interior_mrt:
        missing.append("config.interior_mrt (ROADMAP A9/B5)")
    if building.has_zone_shading:
        missing.append("in-run zone shading (ROADMAP A9/B5)")
    if building.has_vent_gates:
        missing.append("ventilation gates (ROADMAP A9/B5)")
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


def block_building(
    building: CompiledBuilding, block_size: int = None, node_split=None
) -> BlockedBuilding:
    """Permute + pad a compiled building into zone-closed blocks of
    ``block_size`` lanes (heatx ``block_building`` with ``node_split=None``;
    the same arrays).  ``None`` picks :func:`min_block_lanes`: at bench scale
    the day kernel runs fastest with the fewest lanes per thread block
    (PERF.md, H100 port)."""
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
    lane: torch.Tensor  # [7, SP] int32
    zone_volume: torch.Tensor  # [NB, ZB] float
    zone_ptr: torch.Tensor  # [NB*ZB + 1] int32 offsets into zone_faces
    zone_faces: torch.Tensor  # [E] int32: block-local lane*2 + side (0 front, 1 back)
    #: Thermostat rows [4, NB, ZB] (heat_sp, cool_sp, max_heat, max_cool; CTL_FILL
    #: where nothing is controlled), or None without thermostats.
    ctl: torch.Tensor = None
    #: Inter-zone mixing entries (int32 lists, ``vol`` in the working dtype), or None.
    mix: MixLists = None

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
        if name in NODE_FIELDS:
            return self.node[NODE_FIELDS.index(name)]
        if name in SURF_FIELDS:
            return self.surf[SURF_FIELDS.index(name)]
        return self.lane[LANE_FIELDS.index(name)]


def _local_zone(oh: np.ndarray) -> np.ndarray:
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
) -> DayMarchParams:
    """Pack blocked numpy operands into :class:`DayMarchParams`.

    Node arrays are ``[N, SP]`` (``massive`` marks the nodes whose capacity
    is their ``mass``; ``same_chunk[i]`` that nodes i and i+1 share a chunk,
    by default two valid nodes of the same massiveness), ``surf`` maps each
    SURF_FIELDS name to an ``[SP]`` array, ``front_oh``/``back_oh`` are the
    ``[SP, ZB]`` block-local zone one-hots, ``zone_volume`` is ``[NB, ZB]``;
    ``ctl`` the four ``[NB, ZB]`` thermostat rows and ``mix`` the host-side
    mixing lists (None: absent).  Shared by :func:`make_hour_march` and
    ``heatx_torch.convert``."""
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
    fz = _local_zone(front_oh)
    bz = _local_zone(back_oh)

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
            _node_bits(np.asarray(same_chunk, bool)),
        ])),
        zone_volume=f(np.asarray(zone_volume).reshape(NB, ZB)),
        zone_ptr=i32(zone_ptr),
        zone_faces=i32(faces),
        ctl=None if ctl is None else f(np.stack([np.asarray(c).reshape(NB, ZB) for c in ctl])),
        mix=None if mix is None else MixLists(
            i32(mix.ptr), i32(mix.src), f(mix.vol), i32(mix.t_ptr), i32(mix.t_dst), f(mix.t_vol)
        ),
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
    With the building's own arrays the result equals
    :func:`params_from_blocked`."""

    def __init__(self, bb: BlockedBuilding, device):
        lay = bb.layout
        perm = np.asarray(lay.surf_perm)
        zt = np.asarray(lay.zone_table)

        def dev(a):
            return torch.as_tensor(a, device=device)

        self.perm_c, self.perm_ok = dev(np.maximum(perm, 0)), dev(perm >= 0)
        self.zt_c, self.zt_ok = dev(np.maximum(zt, 0)), dev(zt >= 0)
        self.massive = dev(np.asarray(bb.surfaces.massive, bool))

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
        ctl = params.ctl
        if ctl is not None and ctl_heat_sp is not None:
            ctl = torch.stack([
                self.zones(torch.as_tensor(ctl_heat_sp, **kw), CTL_FILL[0]),
                self.zones(torch.as_tensor(ctl_cool_sp, **kw), CTL_FILL[1]),
                ctl[2], ctl[3],
            ])
        return replace(params, node=node, surf=surf, zone_volume=zv, ctl=ctl)


def params_from_blocked(bb: BlockedBuilding, dtype, device) -> DayMarchParams:
    """DayMarchParams of a blocked building (in the building's dtype cast
    first, as heatx casts ``bb.surfaces.astype(dtype)``)."""
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    sb = bb.surfaces.astype(np_dtype)
    capacity = np.where(sb.massive, sb.mass, np.zeros_like(sb.mass))
    surf = {k: getattr(sb, k) for k in SURF_FIELDS if not k.startswith("normal")}
    surf["normal_x"] = sb.normal[:, 0]
    surf["normal_y"] = sb.normal[:, 1]
    return pack_params(
        sb.node_mask, sb.massive, capacity, sb.seg_u, sb.front_alphas, sb.back_alphas, surf,
        sb.front_code, sb.back_code, bb.front_oh, bb.back_oh, bb.zone_volume,
        bb.n_blocks, dtype=dtype, device=device,
        ctl=None if bb.ctl is None else [np.asarray(c).astype(np_dtype) for c in bb.ctl],
        mix=bb.mix, same_chunk=sb.same_chunk,
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
    plus the global zone slot (block*ZB + local zone, -1 none) of each face.
    ``chunks`` adds what the parity integrator reads: ``massive``, ``mass``
    (the capacity row: the mass on massive nodes) and the no-mass chunks."""
    SP = params.surf.shape[1]
    node_mask = bit_rows(params, "node_bits")
    extra = {}
    if chunks:
        extra = _chunk_view(node_mask, bit_rows(params, "mass_bits"), bit_rows(params, "chunk_bits"))
        extra["nomass_chunk_count"] = extra["nomass_chunk_count"].to(params.node.dtype)
        extra["mass"] = params.field("capacity")
    block = torch.arange(SP, device=node_mask.device) // params.block_size
    ZB = params.zones_per_block

    def slot(local):
        local = local.to(torch.int64)
        return torch.where(local >= 0, block * ZB + local, local)

    v = {k: params.field(k) for k in NODE_FIELDS + SURF_FIELDS}
    return SimpleNamespace(
        node_mask=node_mask,
        seg_u=v["seg_u"], capacity=v["capacity"],
        front_alphas=v["front_alphas"], back_alphas=v["back_alphas"],
        normal=(v["normal_x"], v["normal_y"]),
        **{k: v[k] for k in SURF_FIELDS if not k.startswith("normal")},
        front_code=params.field("front_code"), back_code=params.field("back_code"),
        front_slot=slot(params.field("front_zone")),
        back_slot=slot(params.field("back_zone")),
        has_cavity=False,
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


def _hour_body_imp(
    cfg: SimConfig, sbv, st, zone_volume, a_extra, b_extra, t_out_arr, wind_arr,
    wdir_arr, sol_front, sol_back, ir_front, ir_back, T0, zT0, substeps: int,
    dt_sub: float, off: int, refresh_every: int, ctl=None, mix=None,
):
    """One hour of TR-BDF2 sub-steps for every block (heatx
    ``_hour_body_imp``, no cavities): the operators (film coefficients,
    linearized radiation, K, the stage matrix and its Thomas factorization)
    are rebuilt from the marching state at the start of every group of
    ``refresh_every`` sub-steps; each sub-step is one K mat-vec, two stage
    solves on that factorization, the zone sums (plus the mixing terms of
    ``mix = (src_slot, dst_slot, vol)``) and the zone update: free-float, or
    with ``ctl = (heat_sp, cool_sp, max_heat, max_cool)`` the setpoint-landing
    control of :func:`heatx_torch.engine.zone.zone_update`.  Zone vectors are
    flat ``[NB*ZB]``.  Returns ``(T, zT, hq, load)`` with ``load`` the hour's
    mean ideal-load power (None without ``ctl``)."""
    solar_q = surf_mod.absorbed_solar_q(sbv, sol_front, sol_back)
    a_dt = imp_mod.GAMMA * dt_sub / 2.0

    def build_ops(T, zT, t_out, ws, wd):
        t_front, t_back = _boundary_temps(sbv, zT, t_out)
        env_f0, env_b0 = surf_mod.border_conditions(
            sbv, T, t_front, t_back, wd, ws, ir_front, ir_back, cfg, statics=st
        )
        rad_hs_f = surf_mod.linearized_rad_coefficient(sbv.eps_front, env_f0)
        rad_hs_b = surf_mod.linearized_rad_coefficient(sbv.eps_back, env_b0)
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
    ``_hour_body``, no cavities, no interior MRT).  Per sub-step: the TARP
    border conditions of the state, ``engine.surface.march_surfaces`` (the
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
        T = surf_mod.march_surfaces(
            sbv, T, t_front, t_back, wd, ws, sol_front, sol_back, ir_front, ir_back, dt_sub, cfg,
            has_massive=sbv.has_massive, statics=st, rad_out=rad_out, envs=envs, solar_q=solar_q,
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


def plain_day_march(
    params: DayMarchParams, T, zT, t_out, wind, wdir, sol_front, sol_back,
    ir_front, ir_back, a_extra, b_extra, sp_heat=None, sp_cool=None, *, hours: int,
    substeps: int, refresh_every: int, dt: float, config: SimConfig, parity: bool = False,
):
    """The plain PyTorch day march on any device: the reference the CUDA
    kernel is held against.  Shapes as :func:`day_march_kernel`; returns
    ``(T, zT, hq [4, SP], zt_hist, bad, ld_hist)`` with ``ld_hist`` None
    when ``params`` has no thermostat rows.  ``parity`` marches the
    reference-parity sub-steps (:func:`plain_hour_parity`) instead of
    TR-BDF2."""
    sbv = _lanes(params, chunks=parity)
    st = surf_mod.compute_statics(sbv)
    NB, ZB = params.n_blocks, params.zones_per_block
    zone_volume = params.zone_volume.reshape(-1)
    zT = zT.reshape(-1)
    mix = _mix_slots(params)
    ctl = None if params.ctl is None else tuple(params.ctl.reshape(4, -1))
    hist, bad, loads = [], [], []
    hq = None
    for h in range(hours):
        if ctl is not None and sp_heat is not None:
            ctl = (sp_heat[h].reshape(-1), sp_cool[h].reshape(-1)) + ctl[2:]
        T, zT, hq, ld = hour_body(
            parity, sbv, st, cfg=config, zone_volume=zone_volume,
            a_extra=a_extra[h].reshape(-1), b_extra=b_extra[h].reshape(-1), t_out_arr=t_out,
            wind_arr=wind, wdir_arr=wdir, sol_front=sol_front[h], sol_back=sol_back[h],
            ir_front=ir_front[h], ir_back=ir_back[h], T0=T, zT0=zT, substeps=substeps,
            dt_sub=dt, off=h * substeps, refresh_every=refresh_every, ctl=ctl, mix=mix,
        )
        hist.append(zT.reshape(NB, ZB))
        if ld is not None:
            loads.append(ld.reshape(NB, ZB))
        node_bad = (sbv.node_mask & ~torch.isfinite(T)).sum(dim=0)
        count = node_bad.reshape(NB, -1).sum(dim=1) + (~torch.isfinite(zT)).reshape(NB, ZB).sum(dim=1)
        bad.append(count.to(T.dtype))
    return (T, zT.reshape(NB, ZB), torch.stack(hq), torch.stack(hist), torch.stack(bad),
            torch.stack(loads) if loads else None)


# ---------------------------------------------------------------------------
# The CUDA kernel wrapper
# ---------------------------------------------------------------------------


def _load_library():
    lib = cuda_lib.load("heatx_day_march", [KERNEL_SOURCE])
    if not getattr(lib, "_heatx_bound", False):
        vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        for fn in (lib.heatx_day_march_f32, lib.heatx_day_march_f64):
            fn.argtypes = [vp] * 29 + [ci] * 11 + [cd] * 8 + [vp]
            fn.restype = ci
        lib.heatx_cuda_error_string.argtypes = [ci]
        lib.heatx_cuda_error_string.restype = ctypes.c_char_p
        lib._heatx_bound = True
    return lib


def load_kernel() -> None:
    """Build (at first use) and load the day-march kernel library."""
    _load_library()


class DayMarchKernel:
    """Launches ``day_march.cu`` on CUDA tensors.  ``launches`` counts the
    launches made through this wrapper (and nothing else).  Arguments and
    returns as :func:`plain_day_march`.  Thermostat rows (``params.ctl``),
    per-hour setpoints and mixing lists select the kernel's second
    instantiation; without them the free-float one runs.  ``parity`` selects
    the reference-parity kernel (again one instantiation of each kind), whose
    no-mass iteration count and tolerances come from ``config``."""

    def __init__(self):
        self.launches = 0
        self.parity_launches = 0  # those of ``launches`` that ran the parity kernel

    def __call__(
        self, params: DayMarchParams, T, zT, t_out, wind, wdir, sol_front,
        sol_back, ir_front, ir_back, a_extra, b_extra, sp_heat=None, sp_cool=None, *,
        hours: int, substeps: int, refresh_every: int, dt: float, config: SimConfig,
        parity: bool = False,
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
        mix = params.mix
        ptrs = [None if t is None else t.data_ptr() for t in (
            params.node, params.surf, params.lane, params.zone_volume,
            params.zone_ptr, params.zone_faces, t_out, wind, wdir, sol_front,
            sol_back, ir_front, ir_back, a_extra, b_extra, T, zT,
            T_out, zT_out, hq, zt_hist, bad,
            ld_hist, params.ctl, sp_heat, sp_cool,
            *((None,) * 3 if mix is None else (mix.ptr, mix.src, mix.vol)),
        )]
        with torch.cuda.device(T.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(
                *ptrs, N, NB, SB, ZB, hours, substeps, refresh_every,
                int(config.replicate_ambient_back_bug), *parity_ints(config, parity),
                dt, imp_mod.GAMMA * dt / 2.0, imp_mod.GAMMA * dt,
                imp_mod.BETA * dt, imp_mod.C1, imp_mod.C2,
                config.nomass_tol, config.nomass_tol_escalated, stream,
            )
        if err != 0:
            msg = lib.heatx_cuda_error_string(err).decode()
            raise RuntimeError(f"day_march kernel launch failed: CUDA error {err} ({msg})")
        self.launches += 1
        self.parity_launches += int(parity)
        return T_out, zT_out, hq, zt_hist, bad, ld_hist


def parity_ints(config: SimConfig, parity: bool) -> tuple:
    """The integer arguments that select and steer the parity kernels:
    ``(parity, nomass_fixed_iters, nomass_escalate_after)``.  Raises where
    the march needs the adaptive no-mass loop."""
    if parity and config.nomass_fixed_iters is None:
        raise ValueError("the parity kernels require config.nomass_fixed_iters")
    return int(parity), int(config.nomass_fixed_iters or 0), int(config.nomass_escalate_after)


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
    ``collect_loads`` says whether the outputs end with ``ld_hist`` (the
    building has thermostats), ``scheduled_setpoints`` whether the march
    reads per-hour setpoint rows, ``parity`` whether it marches the
    reference-parity sub-steps instead of TR-BDF2."""

    def __init__(self, bb: BlockedBuilding, substeps, hours, refresh_every, dt,
                 collect_bad, scheduled_setpoints=False, parity=False):
        self.parity = parity
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

    def _operands(self, params, T, zT_blocked, hour_inputs):
        hour_inputs = tuple(hour_inputs)
        H, sub, SP = self.hours, self.substeps, self.padded_surfaces
        NB, ZB = self.n_blocks, self.zones_per_block

        def cast(a, shape):
            a = torch.as_tensor(a, dtype=T.dtype, device=T.device)
            return a.reshape(shape).contiguous()

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
        ) + sp

    def _finish(self, outs):
        T, zT, hq, zt_hist, bad, ld_hist = outs
        ret = (T, zT, tuple(hq.unbind(0)), zt_hist)
        if self.collect_bad:
            ret += (bad,)
        if self.collect_loads:
            ret += (ld_hist,)
        return ret

    def _kw(self):
        return dict(
            hours=self.hours, substeps=self.substeps,
            refresh_every=self.refresh_every, dt=self.dt, config=self.config,
            parity=self.parity,
        )

    def __call__(self, params, T, zT_blocked, hour_inputs):
        ops = self._operands(params, T, zT_blocked, hour_inputs)
        if T.device.type == "cuda":
            return self._finish(day_march_kernel(params, *ops, **self._kw()))
        if T.device.type == "cpu":
            return self._finish(plain_day_march(params, *ops, **self._kw()))
        raise ValueError(f"no day march for device {T.device}")

    def plain(self, params, T, zT_blocked, hour_inputs):
        ops = self._operands(params, T, zT_blocked, hour_inputs)
        return self._finish(plain_day_march(params, *ops, **self._kw()))


def hour_march_for(
    bb: BlockedBuilding, substeps: int = None, mode: str = "trbdf2", hours: int = 1,
    refresh_every: int = None, collect_bad: bool = False,
    scheduled_setpoints: bool = False,
) -> HourMarch:
    """The :class:`HourMarch` of :func:`make_hour_march`'s arguments, with
    the sub-step count and refresh cadence resolved (no operands)."""
    if mode not in ("parity", "trbdf2", "trbdf2_refresh"):
        raise ValueError(f"unknown hour-kernel mode {mode!r}")
    if refresh_every is not None and mode != "trbdf2_refresh":
        raise ValueError(
            f"refresh_every only applies to mode='trbdf2_refresh' (got mode={mode!r})"
        )
    if scheduled_setpoints and bb.ctl is None:
        raise ValueError(
            "scheduled_setpoints requires setpoint-driven HVAC "
            "(IdealHeaterCooler with heat_setpoint/cool_setpoint)"
        )
    if mode == "parity":
        # heatx's rules (pallas_step.py:1345-1355): the building's own
        # stability sub-step count and sub-step length, and a fixed number of
        # no-mass iterations wherever there is a no-mass node.
        if bb.config.nomass_fixed_iters is None and bb.surfaces.has_nomass:
            raise ValueError(
                "the parity day march requires config.nomass_fixed_iters (the adaptive "
                "no-mass loop is ROADMAP B6/A10, not ported yet)"
            )
        substeps = substeps or bb.base.dt_subdivisions
        return HourMarch(bb, substeps, hours, 1, bb.base.dt, collect_bad,
                         scheduled_setpoints, parity=True)
    substeps = substeps or 12
    if mode == "trbdf2":
        refresh_every = substeps
    elif refresh_every is None:
        refresh_every = 1
    if refresh_every < 1 or substeps % refresh_every:
        raise ValueError(f"refresh_every {refresh_every} must divide substeps {substeps}")
    dt = 3600.0 / (bb.base.n_steps_per_hour * substeps)
    return HourMarch(bb, substeps, hours, refresh_every, dt, collect_bad, scheduled_setpoints)


def make_hour_march(
    bb: BlockedBuilding,
    substeps: int = None,
    mode: str = "trbdf2",
    hours: int = 1,
    refresh_every: int = None,
    collect_bad: bool = False,
    device="cuda",
    scheduled_setpoints: bool = False,
):
    """Build the day march: ``(hour_march, params)`` with ``params`` on
    ``device`` (the card unless the caller asks for another; ``"cuda"``
    without a GPU raises) in the building's dtype (heatx
    ``make_hour_march``).  ``mode="parity"`` marches the reference-parity
    sub-steps: ``substeps`` defaults to the building's ``dt_subdivisions``,
    the sub-step length is the building's ``dt`` whatever ``substeps`` says,
    and a building with no-mass nodes needs ``config.nomass_fixed_iters``.
    In the TR-BDF2 modes ``substeps`` defaults to 12, ``refresh_every=k``
    rebuilds the operators every k sub-steps (default 1 in refresh mode) and
    frozen mode is ``k = substeps``.  ``scheduled_setpoints`` (thermostat buildings) makes
    the march read per-hour setpoint rows from the 11-leaf hour inputs."""
    hm = hour_march_for(bb, substeps, mode, hours, refresh_every, collect_bad, scheduled_setpoints)
    params = params_from_blocked(bb, bb.config.dtype, cuda_lib.resolve_device(device))
    return hm, params

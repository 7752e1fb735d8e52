"""Zone-closed surface blocking for the fused Pallas hour-kernel.

The only cross-surface data dependency in the model is the per-zone energy
balance (SURVEY.md section 2.2), and zones never interact with each other
(inter-zone air mixing is unimplemented in the reference, model.rs:546).
Buildings therefore decompose into independent *components* — groups of zones
connected by shared surfaces — and components pack into fixed-size blocks:

* every surface of a block only references zones local to that block;
* each Pallas grid cell marches one block for a whole hour (all stability
  sub-steps) with state resident in VMEM;
* the zone reduction becomes two small one-hot matmuls per face inside the
  kernel (scatter-free, MXU-friendly).

This module computes the surface permutation, the per-block zone tables, and
the one-hot membership matrices.

heatx_torch copy of ``heatx.build.blocking``.  The only change is the default
``lane_quantum``: 32 (one warp) instead of the 128 lanes Mosaic tiles by.  The
CUDA day kernel marches one block per thread block, one surface per thread.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from heatx_torch.build.layout import B_SPACE, CompiledBuilding


def _union_find_components(building: CompiledBuilding):
    """Group zones into connected components via shared surfaces; lone
    surfaces (no space boundary) form their own singleton components."""
    Z = building.n_zones
    parent = list(range(Z))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra

    sb = building.surfaces
    fronts = np.asarray(sb.front_code)
    backs = np.asarray(sb.back_code)
    fspace = np.asarray(sb.front_space)
    bspace = np.asarray(sb.back_space)
    S = building.n_surfaces
    for s in range(S):
        if fronts[s] == B_SPACE and backs[s] == B_SPACE:
            union(int(fspace[s]), int(bspace[s]))
    # Inter-zone mixing couples zones exactly like a shared partition does:
    # mixed zones must land in the same block for the in-kernel update.
    for src, dst in zip(
        np.asarray(building.mix_src), np.asarray(building.mix_dst)
    ):
        union(int(src), int(dst))
    # In-run zone-state window shading reads the controlling zone's air
    # temperature inside the kernel: the control zone must share a block
    # with the pane's own zone(s).
    if building.has_zone_shading:
        shade_zone = np.asarray(building.shade_zone)
        for s in np.nonzero(shade_zone >= 0)[0]:
            for code, space in ((fronts[s], fspace[s]), (backs[s], bspace[s])):
                if code == B_SPACE:
                    union(int(shade_zone[s]), int(space))

    comp_of_zone = np.array([find(z) for z in range(Z)], dtype=np.int64)
    return comp_of_zone


@dataclass
class BlockedLayout:
    """Surface permutation + zone tables for block-local zone coupling."""

    block_size: int  # SB: surfaces per block (padded)
    zones_per_block: int  # ZB: zone slots per block (padded)
    n_blocks: int

    surf_perm: np.ndarray  # [n_blocks*SB] original surface idx, -1 = padding
    zone_table: np.ndarray  # [n_blocks, ZB] original zone idx, -1 = padding
    # one-hot zone membership of each face, [n_blocks*SB, ZB] float:
    # row s has a single 1 in the column of its local zone when that face
    # bounds a space, else all zeros.
    front_oh: np.ndarray
    back_oh: np.ndarray
    surf_valid: np.ndarray  # [n_blocks*SB] bool
    zone_valid: np.ndarray  # [n_blocks, ZB] bool

    # Lane partition of each block (see build_blocks): a tuple of
    # (node_rows, lane_width) parts laid out consecutively; block_size is
    # their sum.  Parts group surfaces by node height AND by whether the
    # no-mass solve touches them, so the Pallas kernel marches each group as
    # a sub-batch of exactly its height and statically skips the solve on
    # solve-free lanes.  None = single full-height part.
    split: tuple = None

    @property
    def padded_surfaces(self) -> int:
        return self.n_blocks * self.block_size

    # -- state/zone conversion ----------------------------------------------

    def zones_to_blocked(self, zone_vec: np.ndarray, fill=0.0) -> np.ndarray:
        """[Z] -> [n_blocks, ZB]."""
        out = np.full((self.n_blocks, self.zones_per_block), fill, dtype=np.asarray(zone_vec).dtype)
        zt = self.zone_table
        valid = zt >= 0
        out[valid] = np.asarray(zone_vec)[zt[valid]]
        return out

    def zones_from_blocked(self, blocked: np.ndarray, n_zones: int) -> np.ndarray:
        """[n_blocks, ZB] -> [Z]."""
        out = np.zeros((n_zones,), dtype=np.asarray(blocked).dtype)
        zt = self.zone_table
        valid = zt >= 0
        out[zt[valid]] = np.asarray(blocked)[valid]
        return out

    def surfaces_to_blocked(self, arr: np.ndarray, fill=0.0) -> np.ndarray:
        """Permute/pad a per-surface array: [..., S] -> [..., n_blocks*SB]
        (surface axis last, matching the node-major device layout)."""
        arr = np.asarray(arr)
        shape = arr.shape[:-1] + (self.padded_surfaces,)
        out = np.full(shape, fill, dtype=arr.dtype)
        valid = self.surf_perm >= 0
        out[..., valid] = arr[..., self.surf_perm[valid]]
        return out

    def surfaces_from_blocked(self, arr: np.ndarray, n_surfaces: int) -> np.ndarray:
        arr = np.asarray(arr)
        out = np.zeros(arr.shape[:-1] + (n_surfaces,), dtype=arr.dtype)
        valid = self.surf_perm >= 0
        out[..., self.surf_perm[valid]] = arr[..., valid]
        return out


def _r8(x: int) -> int:
    return ((x + 7) // 8) * 8


def _rq(x: int, q: int) -> int:
    return ((x + q - 1) // q) * q


def _pack_components(comps, caps, zones_cap):
    """Greedy first-fit decreasing packing of components under per-part lane
    capacities; each component is ([surfs_per_part...], zones).  Returns the
    block list or None if some component cannot fit at all.

    The first-fit scan is vectorized over blocks (remaining-capacity
    arrays + argmax of the fit mask): the naive per-block Python loop is
    O(components x blocks x parts) in the interpreter and dominated the
    whole 1M-surface model build (hours).  Placement order and choice are
    IDENTICAL to the naive loop (argmax returns the first fitting block),
    so layouts are bit-for-bit unchanged.
    """
    P = len(caps)
    for parts, zs in comps:
        if any(len(parts[p]) > caps[p] for p in range(P)):
            return None
    order = sorted(comps, key=lambda c: sum(len(x) for x in c[0]), reverse=True)
    C = len(order)
    blocks: List[List] = []  # each: [parts_lists, zones]
    rem = np.empty((C, P), np.int64)  # remaining lane capacity per block/part
    rem_z = np.empty((C,), np.int64)  # remaining zone slots per block
    zcap = np.iinfo(np.int64).max if zones_cap is None else int(zones_cap)
    nb = 0
    for parts, zs in order:
        need = [len(x) for x in parts]
        nz = len(zs)
        j = -1
        if nb:
            ok = rem_z[:nb] >= nz
            for p in range(P):
                ok &= rem[:nb, p] >= need[p]
            if ok.any():
                j = int(np.argmax(ok))  # FIRST fitting block
        if j >= 0:
            blk = blocks[j]
            for p in range(P):
                blk[0][p].extend(parts[p])
            blk[1].extend(zs)
            rem[j] -= need
            rem_z[j] -= nz
        else:
            blocks.append([[list(x) for x in parts], list(zs)])
            rem[nb] = np.asarray(caps) - need
            rem_z[nb] = zcap - nz
            nb += 1
    return blocks


def build_blocks(
    building: CompiledBuilding,
    block_size: int = 1024,
    zones_per_block: int = None,
    node_split="auto",
    lane_quantum: int = 32,
) -> BlockedLayout:
    """Pack zone-components into surface blocks of ``block_size``.

    Greedy first-fit by descending component size.  Raises if a single
    component exceeds the block size (use a bigger block or the unblocked
    XLA path).

    ``node_split`` controls the node-height split (see BlockedLayout.split):

    * ``"auto"`` — pick the node-count cut and short-lane width that minimize
      total padded node work, if that beats the unsplit layout by >10%.
      Candidate lane widths are multiples of ``lane_quantum`` (32 = one
      warp; heatx uses 128, Mosaic's lane tile).
    * ``None`` — never split.
    * ``(cut, short_width)`` — force this split (tests).
    """
    S = building.n_surfaces
    Z = building.n_zones
    sb = building.surfaces
    fronts = np.asarray(sb.front_code)
    backs = np.asarray(sb.back_code)
    fspace = np.asarray(sb.front_space)
    bspace = np.asarray(sb.back_space)
    n_nodes = np.asarray(sb.n_nodes)
    N = sb.max_nodes

    comp_of_zone = _union_find_components(building)

    # Component id per surface (via its zones; surfaces without zones get
    # their own pseudo-component).  A zone-shaded pane with no space
    # boundary of its own still joins its CONTROLLING zone's component —
    # the kernel reads that zone's temperature block-locally.
    shade_zone = (
        np.asarray(building.shade_zone)
        if building.has_zone_shading
        else np.full(S, -1, np.int64)
    )
    comp_surfaces: dict = {}
    comp_zones: dict = {}
    solo = []
    for s in range(S):
        if fronts[s] == B_SPACE:
            c = int(comp_of_zone[fspace[s]])
        elif backs[s] == B_SPACE:
            c = int(comp_of_zone[bspace[s]])
        elif shade_zone[s] >= 0:
            c = int(comp_of_zone[shade_zone[s]])
        else:
            solo.append(s)
            continue
        comp_surfaces.setdefault(c, []).append(s)
    for z in range(Z):
        comp_zones.setdefault(int(comp_of_zone[z]), []).append(z)

    # Components as (surfaces, zones); solo surfaces are zero-zone components.
    raw_comps = []
    for c, zs in comp_zones.items():
        raw_comps.append((comp_surfaces.get(c, []), zs))
    # zones with no surfaces still occupy a slot so their temperature is carried
    for s in solo:
        raw_comps.append(([s], []))

    for surfs, zs in raw_comps:
        if len(surfs) > block_size:
            raise ValueError(
                f"a zone-connected component has {len(surfs)} surfaces "
                f"> block_size {block_size}; increase the block size"
            )

    # Whether the no-mass steady-state solve touches a surface: solve-free
    # lanes can be segregated into their own part, whose kernel sub-batch
    # statically skips march_nomass (the per-part has_nomass flag).
    needs_solve = np.any(
        np.asarray(sb.node_mask) & ~np.asarray(sb.massive), axis=0
    )

    def comps_for_buckets(buckets):
        """buckets: list of (max_rows, solve_filter) — each surface joins the
        FIRST bucket with n_nodes <= max_rows and matching solve filter.
        Vectorized (the per-surface Python loop ran 25+ times per build and
        scaled poorly past 100k surfaces)."""
        P = len(buckets)
        bucket_of = np.full(S, -1, np.int64)
        for p in range(P - 1, -1, -1):  # reverse so the FIRST match wins
            mr, sf = buckets[p]
            cond = n_nodes <= mr
            if sf is not None:
                cond = cond & (needs_solve == sf)
            bucket_of[cond] = p
        if (bucket_of < 0).any():
            raise AssertionError("bucket list must be exhaustive")
        out = []
        for surfs, zs in raw_comps:
            if surfs:
                sa = np.asarray(surfs, np.int64)
                bo = bucket_of[sa]
                parts = [sa[bo == p].tolist() for p in range(P)]
            else:
                parts = [[] for _ in range(P)]
            out.append((parts, zs))
        return out

    def bucket_counts(comps, P):
        tot = [0] * P
        for parts, _ in comps:
            for p in range(P):
                tot[p] += len(parts[p])
        return tot

    def eval_candidate(buckets, widths):
        """Pack + score one configuration.  Cost model: padded node rows per
        lane, solve-carrying parts weighted 1.35x (the no-mass solve +
        per-iteration q assembly measured ~comparable to the rest of the
        sub-step physics on those rows)."""
        comps = comps_for_buckets(buckets)
        packed = _pack_components(comps, widths, zones_per_block)
        if packed is None:
            return None
        # actual rows of each part (<= the bucket bound)
        rows = []
        for p, (mr, sf) in enumerate(buckets):
            mx = 1
            for parts, _ in comps:
                for s in parts[p]:
                    mx = max(mx, int(n_nodes[s]))
            rows.append(mx)
        solve_w = [
            1.35 if (sf is None or sf) else 1.0 for (mr, sf) in buckets
        ]
        work = len(packed) * sum(
            _r8(r) * w * sw for r, w, sw in zip(rows, widths, solve_w)
        )
        return work, tuple(zip(rows, widths)), packed

    # ---- choose the split -------------------------------------------------
    # Unsplit baseline: every lane pays r8(N) node rows.
    base = eval_candidate([(N, None)], [block_size])
    base_work, _, base_blocks = base
    split = None
    blocks = base_blocks

    if node_split is not None and N > 8 and S > 0:
        best = (base_work, None, base_blocks)
        if node_split == "auto":
            cut_cands = [c for c in range(8, _r8(N), 8)
                         if np.any(n_nodes <= c) and np.any(n_nodes > c)]
            nb_min = max(1, (S + block_size - 1) // block_size)
            for cut in cut_cands:
                short = n_nodes <= cut
                cand_buckets = [[(cut, None), (N, None)]]
                if np.any(short & needs_solve) and np.any(short & ~needs_solve):
                    # Segregate solve-free short lanes into their own part.
                    cand_buckets.append([(cut, False), (cut, True), (N, None)])
                for buckets in cand_buckets:
                    comps = comps_for_buckets(buckets)
                    tot = bucket_counts(comps, len(buckets))
                    if any(t == 0 for t in tot):
                        continue
                    for nb_target in range(nb_min, nb_min + 4):
                        widths = [
                            _rq(max(1, -(-t // nb_target)), lane_quantum)
                            for t in tot
                        ]
                        got = eval_candidate(buckets, widths)
                        if got is not None and got[0] < best[0]:
                            best = got
        else:
            cut, sw = int(node_split[0]), int(node_split[1])
            got = eval_candidate(
                [(cut, None), (N, None)], [sw, block_size - sw]
            )
            if got is not None:
                best = got
        if node_split != "auto" or best[0] < 0.9 * base_work:
            _, split, blocks = best

    n_blocks = len(blocks)
    zb = max((len(b[1]) for b in blocks), default=1)
    zb = max(zb, 1)
    if zones_per_block is not None:
        zb = zones_per_block
    # Round ZB up to a multiple of 8 (f32 sublane tile).  Past one vector
    # register, round to a full-lane multiple: rank-1 [ZB] vectors with
    # 128 < ZB not divisible by 128 CHECK-crash Mosaic's VectorLayoutInferer
    # in the zone-update op mix (the block-2048 / 100k-surface crash;
    # minimized repro in PERF.md).  The padded zone lanes are masked slots.
    zb = ((zb + 7) // 8) * 8
    if zb > 128:
        zb = ((zb + 127) // 128) * 128

    part_meta = split if split is not None else ((N, block_size),)
    widths = [w for _, w in part_meta]
    SBtot = sum(widths)
    offsets = np.cumsum([0] + widths[:-1])

    surf_perm = np.full(n_blocks * SBtot, -1, dtype=np.int64)
    zone_table = np.full((n_blocks, zb), -1, dtype=np.int64)
    for bi, (parts, zs) in enumerate(blocks):
        for p, lanes in enumerate(parts):
            lo = bi * SBtot + int(offsets[p])
            surf_perm[lo : lo + len(lanes)] = lanes
        zone_table[bi, : len(zs)] = zs
    block_size = SBtot

    # Local zone index of each face -> one-hot matrices.
    zone_local = np.full(Z, -1, dtype=np.int64)
    zone_block = np.full(Z, -1, dtype=np.int64)
    for bi in range(n_blocks):
        for j, z in enumerate(zone_table[bi]):
            if z >= 0:
                zone_local[z] = j
                zone_block[z] = bi

    SP = n_blocks * block_size
    front_oh = np.zeros((SP, zb), dtype=np.float64)
    back_oh = np.zeros((SP, zb), dtype=np.float64)
    for sp in range(SP):
        s = surf_perm[sp]
        if s < 0:
            continue
        bi = sp // block_size
        if fronts[s] == B_SPACE:
            z = int(fspace[s])
            assert zone_block[z] == bi, "zone not local to its surface's block"
            front_oh[sp, zone_local[z]] = 1.0
        if backs[s] == B_SPACE:
            z = int(bspace[s])
            assert zone_block[z] == bi, "zone not local to its surface's block"
            back_oh[sp, zone_local[z]] = 1.0

    return BlockedLayout(
        block_size=block_size,
        zones_per_block=zb,
        n_blocks=n_blocks,
        surf_perm=surf_perm,
        zone_table=zone_table,
        front_oh=front_oh,
        back_oh=back_oh,
        surf_valid=surf_perm >= 0,
        zone_valid=zone_table >= 0,
        split=split,
    )

"""The partitioned tridiagonal solve of the TR-BDF2 day-march kernel
(csrc/day_tr.cuh), in its plain statement (heatx_torch.ops.tridiag
partition_factor / partition_solve, the kernel's G threads per surface as a
batch axis), against heatx's Thomas solve and the port's, in f64; its
transpose (partition_solve_transposed, the day adjoint's stage solve)
against a dense solve of M^T and autograd through partition_solve, at the
G = 4 and 8 (and 16) threads a surface of the kernels' launch variants and
columns of up to 64 rows; and the day kernels' launch-variant table (the C
side's and ``day_march.LAUNCH_VARIANTS``), thread-block clusters included."""

import dataclasses
import re

import numpy as np
import pytest
import torch

from heatx.ops import tridiag as hx_tri
from heatx_torch import SimConfig, testing
from heatx_torch.build.layout import compile_building
from heatx_torch.ops import cuda_lib, day_march
from heatx_torch.ops import tridiag as tri

torch.set_num_threads(1)

TOL = 1e-12  # relative to the solution's largest magnitude: f64 round-off


def stage_systems(n, seed, lanes=6):
    """``lanes`` tridiagonal systems of ``n`` rows shaped like the kernel's
    stage matrices C - (gamma dt/2) K: negative off-diagonals, the diagonal
    their magnitudes plus a capacity that is 0 on no-mass rows (weakly
    dominant), a film term on each run's first and last row; lane 1 ends in
    identity rows (a shorter surface), lane 2 has identity rows in the middle
    as well (two decoupled runs); lane 3 is all no-mass between its films."""
    rng = np.random.default_rng(seed)
    valid = np.ones((n, lanes), bool)
    if n > 1:
        valid[n - max(1, n // 3):, 1] = False
    if n > 4:
        valid[n // 2 - 1: n // 2 + 1, 2] = False
    u = rng.uniform(0.05, 5.0, (n + 1, lanes))  # segment conductances
    left = valid & np.vstack([np.zeros((1, lanes), bool), valid[:-1]])
    right = valid & np.vstack([valid[1:], np.zeros((1, lanes), bool)])
    lower = np.where(left, -u[:n], 0.0)
    upper = np.where(right, -u[1:], 0.0)
    cap = rng.uniform(0.5, 20.0, (n, lanes)) * (rng.uniform(size=(n, lanes)) > 0.4)
    cap[:, 3] = 0.0
    film = rng.uniform(1.0, 30.0, (n, lanes)) * ((valid & ~left) | (valid & ~right))
    diag = np.where(valid, -lower - upper + cap + film, 1.0)
    rhs = rng.normal(0.0, 50.0, (n, lanes))
    return lower, diag, upper, rhs


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("groups", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("n", [1, 2, 7, 25, 32, 36, 47, 64])
def test_partitioned_solve_matches_thomas(n, groups, seed):
    lower, diag, upper, rhs = stage_systems(n, seed)
    L, D, U, R = (torch.as_tensor(x, dtype=torch.float64) for x in (lower, diag, upper, rhs))
    got = tri.partition_solve(tri.partition_factor(L, D, U, groups), R).numpy()
    ref_hx = np.asarray(hx_tri.solve(lower, diag, upper, rhs))
    cs, inv = tri.factor(L, D, U)
    ref_port = tri.solve_factored(L, cs, inv, R).numpy()
    scale = max(1.0, float(np.abs(ref_hx).max()))
    assert np.abs(got - ref_hx).max() <= TOL * scale
    assert np.abs(got - ref_port).max() <= TOL * scale
    # identity rows keep their right-hand side
    ident = (lower == 0) & (upper == 0) & (diag == 1)
    assert np.array_equal(got[ident], rhs[ident])


def dense(lower, diag, upper):
    """The [lanes, n, n] matrices of the [n, lanes] bands."""
    n, lanes = diag.shape
    m = torch.diag_embed(diag.T)
    if n > 1:
        m = m + torch.diag_embed(lower.T[:, 1:], offset=-1) + torch.diag_embed(upper.T[:, :-1], offset=1)
    return m


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("groups", [2, 4, 8, 16])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 17, 25, 32, 36, 64])
def test_partitioned_transposed_solve(n, groups, seed):
    """partition_solve_transposed on the stage systems (identity padding
    rows, a shorter surface, decoupled runs, an all no-mass lane: weakly
    dominant) against a dense solve of M^T and against autograd's
    vector-Jacobian product through partition_solve, f64."""
    lower, diag, upper, rhs = stage_systems(n, seed)
    L, D, U, G = (torch.as_tensor(x, dtype=torch.float64) for x in (lower, diag, upper, rhs))
    fac = tri.partition_factor(L, D, U, groups)
    got = tri.partition_solve_transposed(fac, G)
    ref = torch.linalg.solve(dense(L, D, U).transpose(1, 2), G.T.unsqueeze(-1)).squeeze(-1).T
    r = torch.zeros_like(G, requires_grad=True)
    (vjp,) = torch.autograd.grad(tri.partition_solve(fac, r), r, G)
    scale = max(1.0, float(ref.abs().max()))
    assert float((got - ref).abs().max()) <= TOL * scale
    assert float((got - vjp).abs().max()) <= TOL * scale
    # identity rows stay identity rows: their cotangent passes through
    ident = (L == 0) & (U == 0) & (D == 1)
    assert torch.equal(got[ident], G[ident])


def launch_table(name: str) -> list:
    """A launch table of csrc/day_march_args.cuh (``kLaunchVariants`` or
    ``kAdjLaunchVariants``): [(most lanes a CTA, threads, f32 blocks per SM,
    G, node capacity, most CTAs of a cluster)]."""
    src = (cuda_lib.CSRC_DIR / "day_march_args.cuh").read_text()
    table = re.search(name + r"\[\] = \{(.*?)\};", src, re.S).group(1)
    return [tuple(int(v) for v in row.split(",")) for row in re.findall(r"\{([\d, ]+)\}", table)]


def first_fit(variants, lanes, nodes):
    """The choice ``day_march.launch_shape`` is held to: the first variant
    whose clusters take the lanes and whose columns take the rows."""
    return next((v for v, (ln, _, _, _, nd, cl) in enumerate(variants) if lanes <= ln * cl and nodes <= nd), None)


def dispatch_cases(src: str, fn: str) -> list:
    body = src[src.index(fn):]
    return body[:body.index("\n}\n")]


def test_group_choice_fits_every_block():
    """Every block the day march takes runs in a launch variant of the one
    table both kernels read, which ``day_march.LAUNCH_VARIANTS`` mirrors: the
    first whose CTAs (times its cluster) take the block's lanes and whose
    node capacity (8 rows a thread, G threads a lane) takes its rows, within
    its launch bound and 1,024 threads a CTA; a cluster's block is whole CTAs
    (``launch_block_lanes``), and a cluster holds at most 8 (portable) CTAs.
    Both kernels dispatch every variant on the host's choice, which the C
    entry checks (variant_takes) and whose threads it writes back.  The G = 4
    variants keep the block at B1's old edge (256 surfaces, a 32-node wall)
    in one CTA of 1024 threads; past it a component runs at G = 8 as a
    cluster of CTAs of 128 lanes (1,000 surfaces: 8), and so does a column of
    33-64 rows."""
    variants = launch_table("kLaunchVariants")
    assert variants == [dataclasses.astuple(v) for v in day_march.LAUNCH_VARIANTS]
    assert variants[0] == (32, 128, 3, 4, 32, 1)  # the bench city's blocks, one wave
    for lanes, threads, _, group, nodes, cluster in variants:
        assert nodes == 8 * group and lanes * group <= threads <= 1024 and 1 <= cluster <= 8
    for nodes in (1, 8, 32, 33, 47, 64):
        for sb in range(1, 1025):
            v = first_fit(variants, sb, nodes)
            shape = day_march.launch_shape(day_march.launch_block_lanes(sb, nodes), nodes)
            assert shape.index == v, (sb, nodes)
            assert shape.cluster * shape.cta_lanes == day_march.launch_block_lanes(sb, nodes) >= sb
            assert shape.cluster == 1 or shape.cta_lanes == variants[v][0]
            assert shape.threads <= variants[v][1]
    with pytest.raises(NotImplementedError, match="at most 64 nodes per surface.*ROADMAP B1"):
        day_march.launch_shape(32, 65)
    with pytest.raises(NotImplementedError, match="1024 lanes per zone-connected component"):
        day_march.launch_shape(1056, 8)
    for name, launch in (("day_march_tr.cu", "launch_tr"), ("day_march_parity.cu", "launch_parity")):
        src = (cuda_lib.CSRC_DIR / name).read_text()
        body = dispatch_cases(src, "int launch_kind(")
        assert "switch (m.in.variant)" in body
        assert re.findall(r"case (\d+):", body) == [str(v) for v in range(len(variants))], name
        # The cluster variant runs in a unit of its own (day_march_*_b1.cu).
        last = len(variants) - 1
        assert re.findall(launch + r"<T, (\d+),", body) == [str(v) for v in range(last)], name
        assert f"heatx_{name[:-3]}_b1_f32(&m" in body
        assert f"{launch}<T, {last}," in dispatch_cases(src, "_b1(const void*")
        assert (cuda_lib.CSRC_DIR / f"{name[:-3]}_b1.cu") in day_march.KERNEL_SOURCES
    entry = (cuda_lib.CSRC_DIR / "day_march.cu").read_text()
    assert "*block_threads = kLaunchVariants[variant].threads" in entry
    assert "variant_takes(kLaunchVariants, kVariants, variant, SB, N)" in entry and "a.variant = variant;" in entry
    assert not hasattr(day_march, "MAX_NODES") and not hasattr(day_march, "MAX_BLOCK_LANES")

    config = SimConfig(dtype=torch.float64)
    edge = day_march.block_building(compile_building(testing.build_wide_zone_model(), n=1, config=config))
    assert (edge.block_size, edge.max_nodes) == (256, 32)
    params = day_march.params_from_blocked(edge, torch.float64, torch.device("cpu"))
    assert tuple(params.node.shape) == (4, 32, edge.layout.padded_surfaces)
    shape = day_march.launch_shape(params.block_size, params.max_nodes)
    assert (shape.index, shape.group, shape.threads, shape.cluster) == (2, 4, 1024, 1)
    wide = day_march.block_building(compile_building(testing.build_wide_zone_model(1000, concrete=0.30), n=1,
                                                     config=config))
    assert (wide.block_size, wide.max_nodes) == (1024, 36)
    shape = day_march.launch_shape(wide.block_size, wide.max_nodes)
    assert (shape.index, shape.group, shape.threads, shape.cluster, shape.nodes) == (3, 8, 1024, 8, 64)


def test_adjoint_launch_variants_fit_every_block():
    """The day adjoints' launch variants (``kAdjLaunchVariants``, beside the
    day march's in csrc/day_march_args.cuh): the same lanes, threads, G,
    node capacity and clusters as the day march's, at most as many f32
    blocks an SM; both adjoints' dispatch (csrc/day_adjoint_tr.cu,
    day_adjoint_parity.cu) launches every variant of the table through
    the host's choice (its index in DayArgs::variant, checked by the C entry)
    and nothing else, a block whose staged rows do not fit
    taking the unstaged G = 4 variant; and the day march's table is not the
    adjoint's."""
    adj, march = launch_table("kAdjLaunchVariants"), launch_table("kLaunchVariants")
    assert [v[:2] + v[3:] for v in adj] == [v[:2] + v[3:] for v in march]
    assert all(1 <= v[2] <= w[2] for v, w in zip(adj, march))
    src = (cuda_lib.CSRC_DIR / "day_march_args.cuh").read_text()
    assert "kAdjUnstaged = 2;" in src and adj[2][1] == 1024 and adj[2][3] == 4
    for name, launch in (("day_adjoint_tr.cu", "launch_tr_adj"), ("day_adjoint_parity.cu", "launch_parity_adj")):
        src = (cuda_lib.CSRC_DIR / name).read_text()
        body = dispatch_cases(src, "int launch_kind(")
        assert "int v = g.in.variant;" in body and "v = kAdjUnstaged" in body
        assert re.findall(r"case (\d+):", body) == [str(v) for v in range(len(adj))], name
        # The cluster variant (the last) runs in its own unit, through its C entry.
        last = len(adj) - 1
        assert sorted(set(re.findall(launch + r"<T, (\d+),", body))) == [str(v) for v in range(last)], name
        entry = f"heatx_{name[:-3]}_b1_f"
        assert entry + "32(&g" in body and entry + "64(&g" in body, name
        assert f"{launch}<T, {last}," in dispatch_cases(src, "_b1(const void* args"), name
        unit = (cuda_lib.CSRC_DIR / f"{name[:-3]}_b1.cu").read_text()
        assert f'#include "{name}"' in unit and "_B1_UNIT" in unit
    entry = (cuda_lib.CSRC_DIR / "day_adjoint.cu").read_text()
    assert "variant_takes(kAdjLaunchVariants, kAdjVariants, a.variant, a.SB, a.N)" in entry
    assert "a.variant = ints[12];" in entry

"""The partitioned tridiagonal solve of the TR-BDF2 day-march kernel
(csrc/day_tr.cuh), in its plain statement (heatx_torch.ops.tridiag
partition_factor / partition_solve, the kernel's G threads per surface as a
batch axis), against heatx's Thomas solve and the port's, in f64; its
transpose (partition_solve_transposed, the day adjoint's stage solve)
against a dense solve of M^T and autograd through partition_solve; and the
day-march kernels' launch variants up to B1's edge."""

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
@pytest.mark.parametrize("n", [1, 2, 7, 25, 32])
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
@pytest.mark.parametrize("groups", [2, 4, 8])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 17, 25, 32])
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


def launch_variants() -> list:
    """The day-march kernels' launch variants as the C side declares them
    (``kLaunchVariants`` in csrc/day_march_args.cuh): [(most lanes, threads,
    f32 blocks per SM)], and G."""
    src = (cuda_lib.CSRC_DIR / "day_march_args.cuh").read_text()
    table = re.search(r"kLaunchVariants\[\] = \{(.*?)\};", src).group(1)
    group = int(re.search(r"constexpr int kGroup = (\d+);", src).group(1))
    return [tuple(int(v) for v in row.split(",")) for row in re.findall(r"\{([\d, ]+)\}", table)], group


def test_group_choice_fits_every_block():
    """Every block the day march takes (up to MAX_BLOCK_LANES lanes) runs in
    a launch variant of the one table both kernels read: the first whose
    lanes take the block's, G = 4 threads a lane within its launch bound and
    within 1024 threads; both kernels dispatch every variant of the table
    through launch_variant and nothing else, and the C entry writes back the
    variant's threads.  And one zone of 256 surfaces with a 32-node wall
    still blocks and packs."""
    variants, group = launch_variants()
    assert group == 4 and [v[0] for v in variants] == sorted(v[0] for v in variants)
    for sb in range(1, day_march.MAX_BLOCK_LANES + 1):
        lanes, threads, _ = next(v for v in variants if sb <= v[0])
        assert sb * group <= lanes * group <= threads <= 1024
    assert variants[-1][0] == day_march.MAX_BLOCK_LANES
    assert next(v for v in variants if 32 <= v[0]) == (32, 128, 3)  # the bench city's blocks, one wave
    for name in ("day_march_tr.cu", "day_march_parity.cu"):
        src = (cuda_lib.CSRC_DIR / name).read_text()
        body = src[src.index("int launch_kind("):]
        body = body[:body.index("\n}\n")]
        assert "switch (launch_variant(m.in.SB))" in body
        assert re.findall(r"case (\d+):", body) == [str(v) for v in range(len(variants))], name
        assert "group" not in body
    entry = (cuda_lib.CSRC_DIR / "day_march.cu").read_text()
    assert "*block_threads = kLaunchVariants[v].threads" in entry and "int group" not in entry
    assert not hasattr(day_march, "GROUP_MAX_THREADS") and not hasattr(day_march.day_march_kernel, "group")

    building = compile_building(testing.build_wide_zone_model(), n=1,
                                config=SimConfig(dtype=torch.float64))
    assert building.max_nodes == day_march.MAX_NODES
    bb = day_march.block_building(building)
    assert bb.block_size == day_march.MAX_BLOCK_LANES
    params = day_march.params_from_blocked(bb, torch.float64, torch.device("cpu"))
    assert tuple(params.node.shape) == (4, day_march.MAX_NODES, bb.layout.padded_surfaces)
    assert next(v for v in variants if params.block_size <= v[0])[1] == params.block_size * group == 1024


def test_adjoint_launch_variants_fit_every_block():
    """The TR-BDF2 day adjoint's launch variants (``kAdjLaunchVariants``,
    beside the day march's in csrc/day_march_args.cuh): G = 4 threads a lane
    like the day march's, the same lanes per variant, every block the day
    march takes (up to MAX_BLOCK_LANES lanes) within one variant's launch
    bound and within 1024 threads; the adjoint's dispatch (csrc/
    day_adjoint_tr.cu) launches every variant of its table through
    adj_launch_variant and nothing else, and the day march's table is not
    the adjoint's."""
    src = (cuda_lib.CSRC_DIR / "day_march_args.cuh").read_text()
    table = re.search(r"kAdjLaunchVariants\[\] = \{(.*?)\};", src).group(1)
    adj = [tuple(int(v) for v in row.split(",")) for row in re.findall(r"\{([\d, ]+)\}", table)]
    march, group = launch_variants()
    assert [v[:2] for v in adj] == [v[:2] for v in march]
    assert all(1 <= v[2] <= w[2] for v, w in zip(adj, march))
    for sb in range(1, day_march.MAX_BLOCK_LANES + 1):
        lanes, threads, _ = next(v for v in adj if sb <= v[0])
        assert sb * group <= threads <= 1024
    body = (cuda_lib.CSRC_DIR / "day_adjoint_tr.cu").read_text()
    body = body[body.index("int launch_kind("):]
    body = body[:body.index("\n}\n")]
    assert "adj_launch_variant(g.in.SB)" in body
    assert re.findall(r"case (\d+):", body) == [str(v) for v in range(len(adj))]
    assert re.findall(r"kAdjLaunchVariants\[(\d+)\]\.threads", body) == [str(v) for v in range(len(adj))]

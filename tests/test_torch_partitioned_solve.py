"""The partitioned tridiagonal solve of the TR-BDF2 day-march kernel
(csrc/day_tr.cuh), in its plain statement (heatx_torch.ops.tridiag
partition_factor / partition_solve, the kernel's G threads per surface as a
batch axis), against heatx's Thomas solve and the port's, in f64; and the
kernel wrapper's choice of threads per surface at B1's edge."""

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


def kernel_launch_bounds() -> dict:
    """The TR-BDF2 kernel's launch-bound variants as its C entry dispatches
    them (``launch_group`` in csrc/day_march_tr.cu): {G: [the most threads
    a block of each G-variant takes]}."""
    src = (cuda_lib.CSRC_DIR / "day_march_tr.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    body = src[src.index("int launch_group("):]
    body = body[:body.index("\n}\n")]
    bounds = {}
    for g, bound, tg, tb in re.findall(
            r"if \(group == (\d+) && threads <= (k\w+)\) return launch_tr<T, (\d+), (k\w+),", body):
        assert (g, bound) == (tg, tb)
        bounds.setdefault(int(g), []).append(consts[bound])
    return bounds


def test_group_choice_fits_every_block():
    """Every block the day march takes (up to MAX_BLOCK_LANES lanes) gets a
    group that the kernel's C entry launches: for every requested group,
    the request where one of its variants takes the block's lanes x G
    threads, else 4; each within 1024 threads.  The wrapper's table is the C
    side's bounds.  And one zone of 256 surfaces with a 32-node wall still
    blocks and packs."""
    bounds = kernel_launch_bounds()
    assert day_march.GROUP_MAX_THREADS == {g: max(b) for g, b in bounds.items()}
    for sb in range(1, day_march.MAX_BLOCK_LANES + 1):
        for req in (None,) + tuple(bounds):
            g = day_march.threads_per_surface(sb, req)
            want = day_march.DEFAULT_GROUP if req is None else req
            assert sb * g <= 1024
            assert any(sb * g <= b for b in bounds[g])
            assert g == (want if any(sb * want <= b for b in bounds[want]) else 4)
    assert day_march.threads_per_surface(32) == day_march.DEFAULT_GROUP
    assert day_march.threads_per_surface(256) == 4
    with pytest.raises(ValueError):
        day_march.threads_per_surface(day_march.MAX_BLOCK_LANES + 1)
    with pytest.raises(ValueError):
        day_march.threads_per_surface(32, 32)

    building = compile_building(testing.build_wide_zone_model(), n=1,
                                config=SimConfig(dtype=torch.float64))
    assert building.max_nodes == day_march.MAX_NODES
    bb = day_march.block_building(building)
    assert bb.block_size == day_march.MAX_BLOCK_LANES
    params = day_march.params_from_blocked(bb, torch.float64, torch.device("cpu"))
    assert tuple(params.node.shape) == (4, day_march.MAX_NODES, bb.layout.padded_surfaces)
    assert day_march.threads_per_surface(params.block_size) * params.block_size == 1024

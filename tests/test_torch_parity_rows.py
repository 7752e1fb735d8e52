"""The parity day-march kernel's row plan (tests/torch_parity_rows_plain.py,
the plain statement of csrc/day_march_parity.cu) against heatx, f64, CPU.

The same seeded state goes through heatx's XLA functions and through the
row plan, on the lanes of ``build_city_model(2, 3)`` (no-mass runs of one and
two nodes: the closed form), ``build_nomass_run_model`` (runs of three and
four nodes: Thomas down the column) and ``build_cavity_model`` (the cavity
U at each iteration's input):

* the no-mass solve per run against ``tridiag.solve_runs2`` (or
  ``tridiag.solve`` where a run is longer than two nodes);
* the no-mass march against ``surface.march_nomass``, one iteration, three,
  and the adaptive loop;
* RK4 on the launch-constant scaled rows with the films on the face rows
  only, against ``surface.march_massive``.

Each is run on the columns as they are and moved down by 7 rows (identity
rows above), which puts a two-node run across the first thread boundary
(rows 7 and 8) and a longer one across it: the rows' neighbours across a
thread's edge come from the next or previous thread, as the kernel's
shuffles bring them.  1e-12 of the result's largest magnitude.
"""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import heatx
import heatx.model.building as hmb
from heatx.engine import surface as hx_surf
from heatx.ops import tridiag as hx_tri
from heatx_torch import SimConfig, testing
from heatx_torch.build.layout import compile_building
from heatx_torch.engine import step as step_mod
from heatx_torch.engine import surface as surf
import torch_parity_rows_plain as pr

torch.set_num_threads(1)

RTOL = 1e-12
OFFSETS = [0, 7]  # 7: a pair's rows 0-1 become 7-8, across the first thread boundary
DT = 450.0


def _nomass_run_hx():
    """testing.build_nomass_run_model on heatx's classes."""
    m = bench.build_city_model(2, 3)
    m.add_construction(hmb.Construction("clad", ["p2", "p2", "p2", "c20"]))
    m.add_construction(hmb.Construction("light", ["p2", "p2", "p2"]))
    B = hmb.Boundary
    walls = {
        "clad0": ("clad", B.outdoor(), B.space_("z0"), [[0, 0, 0], [6, 0, 0], [6, 0, 3], [0, 0, 3]]),
        "light1": ("light", B.outdoor(), B.space_("z1"), [[0, 0, 0], [0, 4, 0], [0, 4, 3], [0, 0, 3]]),
        "between": ("clad", B.space_("z0"), B.space_("z1"), [[0, 0, 0], [4, 0, 0], [4, 0, 2], [0, 0, 2]]),
    }
    for name, (kind, front, back, verts) in walls.items():
        m.add_surface(hmb.SurfaceDef(name, kind, front, back, vertices=np.asarray(verts, float)))
    return m


MODELS = {
    "city": (lambda: bench.build_city_model(2, 3), lambda: testing.build_city_model(2, 3)),
    "nomass_runs": (_nomass_run_hx, testing.build_nomass_run_model),
    "cavity": (lambda: testing.build_cavity_model(bench.build_city_model(2, 3), hmb),
               testing.build_cavity_model),
}


@functools.lru_cache(maxsize=None)
def _case(model, iters=1):
    """Both packages' building at ``nomass_fixed_iters=iters`` (at most 25
    nodes a surface, so that a column moved down by 7 rows fits 32), a
    seeded state, and the sub-step's operands on the port's side."""
    hx_model, port_model = MODELS[model]
    cfg = dict(nomass_fixed_iters=iters, max_dx=0.5, min_dt=900.0)  # testing.coarse_config's discretization
    hb = heatx.build.layout.compile_building(
        hx_model(), n=1, config=heatx.SimConfig(dtype=jnp.float64, **cfg)).astype(np.float64)
    pb = compile_building(port_model(), n=1, config=SimConfig(dtype=torch.float64, **cfg))
    assert hb.max_nodes == pb.max_nodes and hb.max_nodes + max(OFFSETS) <= pr.ROWS
    rng = np.random.default_rng(10)
    S, N = hb.n_surfaces, hb.max_nodes
    T = np.where(hb.surfaces.node_mask, rng.uniform(-5.0, 35.0, (N, S)), 0.0)
    zT, sol, ir = rng.uniform(15, 25, hb.n_zones), rng.uniform(0, 600, S), rng.uniform(250, 400, S)
    sb = step_mod.device_building(pb).surfaces
    st = surf.compute_statics(sb)
    Tt = torch.as_tensor(T)
    t_front, t_back = surf.boundary_temperatures(sb, torch.as_tensor(zT), -3.0)
    env_f, env_b = surf.border_conditions(sb, Tt, t_front, t_back, 0.3, 4.0, torch.as_tensor(ir),
                                          torch.as_tensor(ir), pb.config, statics=st)
    rad_f = surf.linearized_rad_coefficient(sb.eps_front, env_f)
    rad_b = surf.linearized_rad_coefficient(sb.eps_back, env_b)
    sq = surf.absorbed_solar_q(sb, torch.as_tensor(sol), torch.zeros(S, dtype=torch.float64))
    face = (env_f.air * env_f.h, rad_f, env_f.rad, env_b.air * env_b.h, rad_b, env_b.rad)
    return SimpleNamespace(hb=hb, pb=pb, sb=sb, st=st, T=T, zT=zT, sol=sol, ir=ir, env_f=env_f, env_b=env_b,
                           sq=sq, face=face)


def _down(x, d, fill=0.0):
    """``[N, S]`` moved down by d rows (``fill`` above)."""
    x = torch.as_tensor(x)
    return torch.cat([x.new_full((d,) + tuple(x.shape[1:]), fill), x])


def _plan(c, d, seg_u=None):
    sb = c.sb
    return pr.row_plan(_down(sb.node_mask, d, False), _down(sb.massive, d, False), _down(sb.same_chunk, d, False),
                       _down(sb.seg_u if seg_u is None else seg_u, d), _down(sb.mass, d, 1.0), DT)


def _seg_u_of(c, d):
    """A cavity lane's U at the moved rows w (the column as it is, then
    moved back down)."""
    def f(w):
        return _down(surf.segment_u(c.sb, pr.from_threads(w, pr.ROWS)[d:d + c.pb.max_nodes], c.env_b.air), d)
    return f


def _close(got, ref):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=0, atol=RTOL * scale)


def _hx_nomass(hb, T, zT, sol, ir):
    """heatx's no-mass march of the sub-step (as tests/test_torch_adaptive.py)."""
    sb, cfg = hb.surfaces, hb.config
    st = hx_surf.compute_statics(sb)
    t_front, t_back = hx_surf.boundary_temperatures(sb, zT, -3.0)
    env_f, env_b = hx_surf.border_conditions(sb, T, t_front, t_back, 0.3, 4.0, ir, ir, cfg, statics=st)
    rad_f = hx_surf.linearized_rad_coefficient(sb.eps_front, env_f)
    rad_b = hx_surf.linearized_rad_coefficient(sb.eps_back, env_b)
    q = hx_surf.absorbed_solar_q(sb, sol, sol * 0.0)
    K = None if sb.has_cavity else hx_surf.assemble_K(sb, sb.seg_u, env_f, env_b, st)
    return hx_surf.march_nomass(sb, T, env_f, env_b, rad_f, rad_b, q, cfg, statics=st, K=K)


def _hx_massive(hb, T, zT, sol, ir):
    """heatx's RK4 of the sub-step's massive nodes from T."""
    sb, cfg = hb.surfaces, hb.config
    st = hx_surf.compute_statics(sb)
    t_front, t_back = hx_surf.boundary_temperatures(sb, zT, -3.0)
    env_f, env_b = hx_surf.border_conditions(sb, T, t_front, t_back, 0.3, 4.0, ir, ir, cfg, statics=st)
    rad_f = hx_surf.linearized_rad_coefficient(sb.eps_front, env_f)
    rad_b = hx_surf.linearized_rad_coefficient(sb.eps_back, env_b)
    q = hx_surf.absorbed_solar_q(sb, sol, sol * 0.0)
    return hx_surf.march_massive(sb, T, env_f, env_b, rad_f, rad_b, q, DT, statics=st, flush_tiny=False)


@functools.lru_cache(maxsize=None)
def _hx_ref(fn, model, iters):
    c = _case(model, iters)
    return np.asarray(jax.jit(fn)(c.hb, c.T, c.zT, c.sol, c.ir))


@pytest.mark.parametrize("offset", OFFSETS)
@pytest.mark.parametrize("model", list(MODELS))
def test_run_solve_matches_heatx(model, offset):
    """One solve of the no-mass system K x = -q(T) (identity rows elsewhere)
    per run: closed form or Thomas, as heatx picks."""
    c = _case(model)
    sb, st, hb = c.sb, c.st, c.hb
    N = c.pb.max_nodes
    Tt = torch.as_tensor(c.T)
    U = surf.segment_u(sb, Tt, c.env_b.air)
    K = surf.assemble_K(sb, U, c.env_f, c.env_b, st)
    q = surf.assemble_q(sb, Tt, U, c.env_f, c.env_b, c.face[1], c.face[4], c.sq, st)
    sel = st.nomass_sel
    lower, diag, upper = (torch.where(sel, k, torch.full_like(k, f)).numpy() for k, f in zip(K, (0.0, 1.0, 0.0)))
    rhs = torch.where(sel, -q, Tt).numpy()
    long_runs = hb.surfaces.max_nomass_run > 2
    if long_runs:
        ref = hx_tri.solve(lower, diag, upper, rhs)
    else:
        hst = hx_surf.compute_statics(hb.surfaces)
        ref = hx_tri.solve_runs2(lower, diag, upper, rhs, hst.pair_head, hst.pair_tail)
    plan = _plan(c, offset, U)
    assert plan.long_runs == long_runs
    ops = pr.operators(plan, c.env_f.h, c.env_b.h)
    r = pr.to_threads(_down(rhs, offset))
    w = pr.to_threads(_down(Tt, offset))
    if long_runs:
        x = pr.solve_column(plan, ops, r, w)
    else:
        x = pr.solve_runs(plan, ops, pr.run_factors(plan, ops), r)
    got = pr.from_threads(x, offset + N)[offset:].numpy()
    _close(np.where(sel.numpy(), got, rhs), ref)
    if offset == 7 and model == "city":  # a pair across the first thread boundary
        assert bool(plan.pair[0, 7].any()) and bool(plan.tail[1, 0].any())


@pytest.mark.parametrize("iters", [1, 3, None], ids=["one", "three", "adaptive"])
@pytest.mark.parametrize("offset", OFFSETS)
@pytest.mark.parametrize("model", list(MODELS))
def test_nomass_march_matches_heatx(model, offset, iters):
    c = _case(model, iters)
    N = c.pb.max_nodes
    ref = _hx_ref(_hx_nomass, model, iters)
    plan = _plan(c, offset, surf.segment_u(c.sb, torch.as_tensor(c.T), c.env_b.air))
    films = (c.env_f.h, c.env_b.h)
    ops = pr.operators(plan, *films)
    T = pr.to_threads(_down(c.T, offset))
    seg_u_of = _seg_u_of(c, offset) if c.sb.has_cavity else None
    got = pr.nomass_march(plan, ops, pr.to_threads(_down(c.sq, offset)), c.face, T, c.pb.config, films=films,
                          seg_u_of=seg_u_of)
    _close(pr.from_threads(got, offset + N)[offset:].numpy(), ref)


@pytest.mark.parametrize("offset", OFFSETS)
@pytest.mark.parametrize("model", list(MODELS))
def test_massive_march_matches_heatx(model, offset):
    """RK4 on the rows scaled once by dt/C, the films on the face rows."""
    c = _case(model)
    N = c.pb.max_nodes
    ref = _hx_ref(_hx_massive, model, 1)
    plan = _plan(c, offset, surf.segment_u(c.sb, torch.as_tensor(c.T), c.env_b.air))
    ops = pr.operators(plan, c.env_f.h, c.env_b.h)
    got = pr.massive_march(plan, ops, pr.to_threads(_down(c.sq, offset)), c.face, pr.to_threads(_down(c.T, offset)))
    _close(pr.from_threads(got, offset + N)[offset:].numpy(), ref)

"""The parity day adjoint kernel's reverse by rows (tests/
torch_parity_adj_rows_plain.py, the plain statement of the reverse in
csrc/day_adjoint_parity.cu) against torch.autograd through the forward row
plan (tests/torch_parity_rows_plain.py) and against heatx's jax.vjp, f64,
CPU.

On the buildings of tests/test_torch_parity_rows.py (the city's no-mass runs
of one and two nodes: the closed form; runs of three and four nodes: Thomas;
the cavity building: the cavity U at each instance's working rows), with the
columns as they are and moved down by 7 rows (a pair across the first thread
boundary), from one seeded sub-step state:

* the transposed run solve (closed form or Thomas) against autograd of the
  forward solve;
* the no-mass iterations backwards (one and three) against autograd through
  ``nomass_march`` (the cotangents of the rows, the absorbed solar, the face
  terms, the films and U) and against ``jax.vjp`` of heatx's
  ``surface.march_nomass`` (the rows, the solar, the border conditions and
  the radiation coefficients);
* RK4 backwards against autograd through ``massive_march`` (dt/C's
  cotangent too) and against ``jax.vjp`` of heatx's ``surface.march_massive``.

On the cavity building U is the cavity U of each instance's working rows, so
autograd's cotangent of the rows takes dU/dT; heatx's gradients through a
gas cavity are NaN (ROADMAP C6), so that building is held to autograd alone.
1e-12 of each cotangent's largest magnitude.  heatx is compiled once per
building and function (one sub-step each).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from heatx.engine import surface as hx_surf
from heatx_torch.engine import surface as surf
import torch_parity_adj_rows_plain as pa
import torch_parity_rows_plain as pr
from test_torch_parity_rows import DT, MODELS, OFFSETS, _case, _down, _plan, _seg_u_of

torch.set_num_threads(1)

RTOL = 1e-12


def _close(got, ref, what):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    scale = max(float(np.abs(ref).max()), 1e-300)
    np.testing.assert_allclose(got, ref, rtol=0, atol=RTOL * scale, err_msg=what)


def _rows(c, offset, x):
    """[G, M, S] rows -> the column as it is, [N, S]."""
    return pr.from_threads(x, offset + c.pb.max_nodes)[offset:]


def _u_rows(c, offset):
    """The sub-step's U at the rows above each segment ([G, M, S]), as a
    leaf: a cavity lane's at the state, the others' as they are."""
    u = surf.segment_u(c.sb, torch.as_tensor(c.T), c.env_b.air)
    return pr.to_threads(_down(u.detach(), offset)).requires_grad_()


def _with_u_rows(plan, u):
    left = plan.coup_l | plan.dir_l
    ul = torch.where(left, pr.above(u), torch.zeros_like(u))
    return pr.SimpleNamespace(**{**vars(plan), "ul": ul, "ur": pr.below(ul)})


def _leaves(c, offset):
    """The forward row plan's inputs as leaves: rows, solar, face terms,
    films, U rows; and the plan on them (a cavity lane's U the cavity U of
    the rows, not the leaf)."""
    T = pr.to_threads(_down(c.T, offset)).requires_grad_()
    sq = pr.to_threads(_down(c.sq.detach(), offset)).requires_grad_()
    face = tuple(f.detach().clone().requires_grad_() for f in c.face)
    films = tuple(e.h.detach().clone().requires_grad_() for e in (c.env_f, c.env_b))
    u = _u_rows(c, offset)
    if c.sb.has_cavity:
        plan = pr.with_u(_plan(c, offset), _seg_u_of(c, offset)(T))
    else:
        plan = _with_u_rows(_plan(c, offset), u)
    return T, sq, face, films, u, plan


def _u_vjp(c, offset):
    """A cavity lane's U at the working rows w, backwards: the U rows'
    cotangent through dU/dT into w (None off the cavity building)."""
    if not c.sb.has_cavity:
        return None

    def f(w, gU):
        w = w.detach().requires_grad_()
        u = pr.to_threads(_down(surf.segment_u(c.sb, _rows(c, offset, w), c.env_b.air), offset))
        return torch.autograd.grad(u, w, gU)[0]
    return f


def _seed(shape, k):
    return torch.as_tensor(np.random.default_rng(k).normal(size=tuple(shape)))


@functools.lru_cache(maxsize=None)
def _hx_vjp(fn_name, model, iters):
    """jax.vjp of heatx's march_nomass or march_massive at the case's state,
    for a seeded cotangent of the node rows: (cotangent, {name: vjp})."""
    c = _case(model, iters)
    hb, sb, cfg = c.hb, c.hb.surfaces, c.hb.config
    st = hx_surf.compute_statics(sb)
    t_front, t_back = hx_surf.boundary_temperatures(sb, c.zT, -3.0)
    env_f, env_b = hx_surf.border_conditions(sb, c.T, t_front, t_back, 0.3, 4.0, c.ir, c.ir, cfg, statics=st)
    rad_f = hx_surf.linearized_rad_coefficient(sb.eps_front, env_f)
    rad_b = hx_surf.linearized_rad_coefficient(sb.eps_back, env_b)
    q = hx_surf.absorbed_solar_q(sb, c.sol, c.sol * 0.0)
    if fn_name == "nomass":
        def fn(T, env_f, env_b, rad_f, rad_b, q):
            return hx_surf.march_nomass(sb, T, env_f, env_b, rad_f, rad_b, q, cfg, statics=st)
    else:
        def fn(T, env_f, env_b, rad_f, rad_b, q):
            return hx_surf.march_massive(sb, T, env_f, env_b, rad_f, rad_b, q, DT, statics=st, flush_tiny=False)
    cot = np.where(sb.node_mask, np.random.default_rng(5).normal(size=c.T.shape), 0.0)
    _, vjp = jax.vjp(jax.jit(fn), c.T, env_f, env_b, rad_f, rad_b, q)
    lT, lef, leb, lrf, lrb, lq = (jax.tree_util.tree_map(np.asarray, g) for g in jax.jit(vjp)(cot))
    return cot, dict(T=lT, sq=lq, h_f=lef.h, air_f=lef.air, rad_f=lef.rad, rc_f=lrf, h_b=leb.h, air_b=leb.air,
                     rad_b=leb.rad, rc_b=lrb)


def _as_heatx(c, offset, g):
    """The row plan's cotangents as heatx's inputs': the rows, the solar,
    and each face's border conditions (film h, air, radiant temperature)
    and radiation coefficient."""
    l_sf, l_rcf, l_rtf, l_sb, l_rcb, l_rtb = g["face"]
    hf, hb = c.env_f.h, c.env_b.h
    return dict(T=_rows(c, offset, g["T"]), sq=_rows(c, offset, g["sq"]), h_f=l_sf * c.env_f.air + g["hf"],
                air_f=l_sf * hf, rad_f=l_rtf, rc_f=l_rcf, h_b=l_sb * c.env_b.air + g["hb"], air_b=l_sb * hb,
                rad_b=l_rtb, rc_b=l_rcb)


def _compare_autograd(got, out, leaves, cot, what, with_u=True):
    """``got`` (the plain reverse's dict) against autograd of ``out``."""
    T, sq, face, films, u = leaves[:5]
    names = ["T", "sq"] + [f"face{i}" for i in range(6)] + ["hf", "hb"] + (["u"] if with_u else [])
    refs = torch.autograd.grad(out, (T, sq, *face, *films) + ((u,) if with_u else ()), cot, allow_unused=True,
                               retain_graph=True)
    mine = [got["T"], got["sq"], *got["face"], got["hf"], got["hb"], got["u"]]
    for name, r, m in zip(names, refs, mine):
        m = torch.as_tensor(m).detach()
        _close(m.numpy(), (torch.zeros_like(m) if r is None else r).numpy(), f"{what}: {name}")


@pytest.mark.parametrize("offset", OFFSETS)
@pytest.mark.parametrize("model", list(MODELS))
def test_transposed_run_solve_matches_autograd(model, offset):
    """y = M^-T x by the closed form transposed (or Thomas on M^T) against
    autograd of the forward solve's cotangent of its right-hand side."""
    c = _case(model)
    plan = _plan(c, offset, surf.segment_u(c.sb, torch.as_tensor(c.T), c.env_b.air))
    ops = pr.operators(plan, c.env_f.h, c.env_b.h)
    r = pr.to_threads(_down(c.T, offset) * 0.7 - 3.0).requires_grad_()
    w = pr.to_threads(_down(c.T, offset))
    lx = torch.where(plan.sel, _seed(r.shape, 7), torch.zeros_like(r))
    x = pa._solve(plan, ops, r, w)
    ref = torch.autograd.grad(x, r, lx)[0]
    y = pa._solve_t(plan, ops, lx)
    _close(torch.where(plan.sel, y, torch.zeros_like(y)).numpy(), torch.where(plan.sel, ref, 0 * ref).numpy(),
           f"{model} +{offset}")
    if offset == 7 and model == "city":  # a pair across the first thread boundary
        assert bool(plan.pair[0, 7].any()) and bool(plan.tail[1, 0].any())


@pytest.mark.parametrize("iters", [1, 3], ids=["one", "three"])
@pytest.mark.parametrize("offset", OFFSETS)
@pytest.mark.parametrize("model", list(MODELS))
def test_nomass_march_backwards(model, offset, iters):
    """The no-mass iterations backwards against autograd through the row
    plan and against jax.vjp of heatx's march_nomass."""
    c = _case(model, iters)
    T, sq, face, films, u, plan = _leaves(c, offset)
    ops = pr.operators(plan, *films)
    seg_u_of = _seg_u_of(c, offset) if c.sb.has_cavity else None
    out = pr.nomass_march(plan, ops, sq, face, T, c.pb.config, films=films, seg_u_of=seg_u_of)
    cot = torch.where(pr.to_threads(_down(c.sb.node_mask, offset, False), False), _seed(T.shape, 5), 0.0)
    if not c.sb.has_cavity:
        cot_hx, ref_hx = _hx_vjp("nomass", model, iters)
        cot = pr.to_threads(_down(torch.as_tensor(cot_hx), offset))
    detached = [tuple(x.detach() for x in xs) for xs in (face, films)]
    plan_d = pr.SimpleNamespace(**{k: (v.detach() if torch.is_tensor(v) else v) for k, v in vars(plan).items()})
    ops_d = tuple(o.detach() for o in ops)
    got = pa.nomass_march_adj(plan_d, ops_d, sq.detach(), detached[0], T.detach(), c.pb.config, cot,
                              films=detached[1], seg_u_of=seg_u_of, u_vjp=_u_vjp(c, offset))
    what = f"{model} +{offset} x{iters}"
    _compare_autograd(got, out, (T, sq, face, films, u), cot, what, with_u=not c.sb.has_cavity)
    if not c.sb.has_cavity:
        for name, m in _as_heatx(c, offset, got).items():
            _close(torch.as_tensor(m).detach().numpy(), ref_hx[name], f"{what} vs heatx: {name}")


@pytest.mark.parametrize("offset", OFFSETS)
@pytest.mark.parametrize("model", list(MODELS))
def test_massive_march_backwards(model, offset):
    """RK4 backwards against autograd through the row plan (dt/C too) and
    against jax.vjp of heatx's march_massive."""
    c = _case(model)
    T, sq, face, films, u, plan = _leaves(c, offset)
    s = plan.s.detach().clone().requires_grad_()
    plan = pr.SimpleNamespace(**{**vars(plan), "s": s})
    ops = pr.operators(plan, *films)
    out = pr.massive_march(plan, ops, sq, face, T)
    cot = torch.where(pr.to_threads(_down(c.sb.node_mask, offset, False), False), _seed(T.shape, 5), 0.0)
    if not c.sb.has_cavity:
        cot_hx, ref_hx = _hx_vjp("massive", model, 1)
        cot = pr.to_threads(_down(torch.as_tensor(cot_hx), offset))
    plan_d = pr.SimpleNamespace(**{k: (v.detach() if torch.is_tensor(v) else v) for k, v in vars(plan).items()})
    got = pa.massive_march_adj(plan_d, tuple(o.detach() for o in ops), sq.detach(),
                               tuple(f.detach() for f in face), T.detach(), cot, u_vjp=_u_vjp(c, offset))
    what = f"{model} +{offset}"
    _compare_autograd(got, out, (T, sq, face, films, u), cot, what, with_u=not c.sb.has_cavity)
    ls = torch.autograd.grad(out, s, cot)[0]
    _close(got["s"].numpy(), ls.numpy(), f"{what}: dt/C")
    if not c.sb.has_cavity:
        for name, m in _as_heatx(c, offset, got).items():
            _close(torch.as_tensor(m).detach().numpy(), ref_hx[name], f"{what} vs heatx: {name}")

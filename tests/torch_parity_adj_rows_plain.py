"""The parity day adjoint kernel's reverse of a sub-step by rows, stated
plainly (the helper of tests/test_torch_parity_adj_rows.py, which holds it to
autograd through the forward row plan and to heatx's ``jax.vjp``).

``csrc/day_adjoint_parity.cu`` reverses each sub-step with G = 4 threads per
surface lane, thread ``g`` holding the M = 8 rows ``[g*M, g*M + M)``, on the
forward row plan of ``tests/torch_parity_rows_plain.py`` (the same ``[G, M,
S]`` tensors and neighbour exchanges).  This module states what those
threads compute backwards:

* :func:`band_adj`: a use ``c^T K v`` of K's band (RK4's stages, the no-mass
  system) onto one cotangent per segment's U (the segment below each row)
  and the two films on the face rows' diagonals;
* :func:`forcing_adj`: the reverse of ``forcing`` at the working rows ``w``:
  the absorbed solar, the faces' sources, the couplings across chunks (onto
  U and the frozen neighbour rows, across a thread's edge by one exchange
  each way);
* :func:`solve_runs_t`, :func:`solve_column_t`: ``y = M^-T x`` on the no-mass
  rows, heatx's closed form transposed on a run's head (a pair's head takes
  its tail's lower coefficient, the tail its head's upper one, across a
  thread edge by one exchange each way), or Thomas on ``M^T`` where a run is
  longer than two rows;
* :func:`nomass_march_adj`: the fixed no-mass iterations backwards, each
  iteration's input and update mask from a re-run of the forward from the
  sub-step's start (the masks carry no cotangent);
* :func:`massive_march_adj`: RK4's stages 3 to 0 by rows (``K'^T g`` with the
  neighbours' rows), the forcing at the post-no-mass rows, the cotangent of
  dt/C.

A cavity lane's K and forcing are rebuilt at each instance's working rows;
``u_vjp(w, gU)`` sends that instance's U cotangent through dU/dT into ``w``
(the kernel: ``cavity_adj``).  Cotangents come back as a dict: ``T`` the
rows', ``sq`` the absorbed solar's, ``face`` the six face terms' of
``forcing``, ``hf``/``hb`` the films' on K's diagonal, ``u`` each segment's
U (at the row above it), ``s`` dt/C's (RK4 only).
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

import torch_parity_rows_plain as pr
from torch_parity_rows_plain import above, below


def _zeros(plan):
    return torch.zeros_like(plan.ul)


def band_adj(plan: SimpleNamespace, c, v):
    """K's band used as ``sum_j c_j (K v)_j``: the cotangent of each segment's
    U (rows [G, M, S]: the segment below each row) and of the films (hf,
    hb [S]).  Row j's diagonal is -(ul_j + ur_j + films), its lower entry ul_j
    and upper ur_j inside a chunk."""
    zero = _zeros(plan)
    own = c * v
    l_ul = torch.where(plan.coup_l, c * above(v), zero) - own  # U above row j
    l_ur = torch.where(plan.coup_r, c * below(v), zero) - own  # U below row j
    link = plan.valid & below(plan.valid, False)
    gU = torch.where(link, l_ur + below(l_ul), zero)
    lhf = -torch.where(plan.first, own, zero).sum(dim=(0, 1))
    lhb = -torch.where(plan.last, own, zero).sum(dim=(0, 1))
    return gU, lhf, lhb


def forcing_adj(plan: SimpleNamespace, lq, w, face):
    """The reverse of ``pr.forcing(plan, sq, w, face)`` for the cotangent
    ``lq`` of each row's q: (lw, lsq, lface (six [S]), gU)."""
    src_f, radf, rad_ft, src_b, radb, rad_bt = face
    zero = _zeros(plan)
    first, last = torch.where(plan.first, lq, zero), torch.where(plan.last, lq, zero)
    lw = -first * radf - last * radb
    dl, dr = torch.where(plan.dir_l, lq, zero), torch.where(plan.dir_r, lq, zero)
    lw = lw + below(dl * plan.ul) + above(dr * plan.ur)  # the frozen neighbours' rows
    gU = dr * below(w) + below(dl * above(w))  # the U below each row
    lface = (first.sum(dim=(0, 1)), (first * (rad_ft - w)).sum(dim=(0, 1)), (first * radf).sum(dim=(0, 1)),
             last.sum(dim=(0, 1)), (last * (rad_bt - w)).sum(dim=(0, 1)), (last * radb).sum(dim=(0, 1)))
    return lw, lq, lface, gU


def solve_runs_t(plan: SimpleNamespace, ops, P, lx):
    """``y = M^-T lx`` on runs of one or two no-mass rows: the closed form
    transposed (solve_runs with each pair's off-diagonal entries swapped)."""
    A, D, C = ops
    num = torch.where(plan.pair, lx * below(D, 1.0) - below(A) * below(lx),
                      torch.where(plan.tail, above(D, 1.0) * lx - above(C) * above(lx), lx))
    return num * P


def solve_column_t(plan: SimpleNamespace, ops, lx):
    """``y = M^-T lx`` by Thomas down the column on M^T: lower entries the row
    above's upper ones, upper entries the row below's lower ones, identity
    rows (right-hand side 0) off the no-mass rows."""
    A, D, C = ops
    return pr.solve_column(plan, (above(C), D, below(A)), lx, torch.zeros_like(lx))


def _solve(plan, ops, r, w):
    if plan.long_runs:
        return pr.solve_column(plan, ops, r, w)
    return pr.solve_runs(plan, ops, pr.run_factors(plan, ops), r)


def _solve_t(plan, ops, lx):
    if plan.long_runs:
        return solve_column_t(plan, ops, lx)
    return solve_runs_t(plan, ops, pr.run_factors(plan, ops), lx)


def _nomass_tape(plan, ops, sq, face, T, config, films, seg_u_of):
    """The forward no-mass iterations (pr.nomass_march, fixed count), each
    iteration's (plan, ops, input w, solve x, update mask)."""
    tape = []
    iters = config.nomass_fixed_iters
    oerr, cnt, act = torch.full_like(T, 99999.0), torch.zeros_like(T), plan.head.clone()
    length = pr._run_lengths(plan, T.dtype)
    for it in range(iters):
        if seg_u_of is not None and it > 0:
            plan = pr.with_u(plan, seg_u_of(T))
            ops = pr.operators(plan, *films)
        x = _solve(plan, ops, -pr.forcing(plan, sq, T, face), T)
        if iters == 1:
            upd = plan.sel
        else:
            d = torch.abs(x - T)
            d = torch.where(plan.sel & ~(d < 1e-25), d, torch.zeros_like(d))
            err = pr._run_errors(plan, d)
            up = act & ~(err > oerr)
            oerr = torch.where(up, err, oerr)
            tol = torch.where(cnt < config.nomass_escalate_after, torch.full_like(T, config.nomass_tol),
                              torch.full_like(T, config.nomass_tol_escalated))
            converged = err / torch.clamp_min(length, 1.0) < tol
            cnt = torch.where(up & ~converged, cnt + 1, cnt)
            act = up & ~converged
            upd = pr._run_rows(plan, up)
        tape.append((plan, ops, T, x, upd))
        T = torch.where(upd, 0.5 * (T + x), T)
    return tape


def nomass_march_adj(plan, ops, sq, face, T, config, lT, films=None, seg_u_of=None, u_vjp=None):
    """The reverse of ``pr.nomass_march`` (fixed iterations) from the
    sub-step's start rows ``T`` for the cotangent ``lT`` of its result."""
    out = dict(T=lT, sq=torch.zeros_like(lT), face=[0.0] * 6, hf=0.0, hb=0.0, u=torch.zeros_like(lT))
    for p, o, w, x, upd in reversed(_nomass_tape(plan, ops, sq, face, T, config, films, seg_u_of)):
        lT = out["T"]
        lx = torch.where(upd, 0.5 * lT, torch.zeros_like(lT))
        lT = torch.where(upd, 0.5 * lT, lT)
        c = torch.where(p.sel, -_solve_t(p, o, lx), torch.zeros_like(lx))  # r = -q(w) on the no-mass rows
        gU, lhf, lhb = band_adj(p, c, x)  # dM = -y x^T
        lw, lsq, lface, gq = forcing_adj(p, c, w, face)
        gU = gU + gq
        lT = lT + lw
        if u_vjp is not None:  # a cavity lane's K and forcing at w
            lT = lT + u_vjp(w, gU)
        out.update(T=lT, sq=out["sq"] + lsq, hf=out["hf"] + lhf, hb=out["hb"] + lhb, u=out["u"] + gU,
                   face=[a + b for a, b in zip(out["face"], lface)])
    return out


def massive_march_adj(plan, ops, sq, face, T, lT, u_vjp=None):
    """The reverse of ``pr.massive_march`` at the post-no-mass rows ``T`` for
    the cotangent ``lT`` of its result: RK4's stages 3 to 0, each ``k_s = K'
    y_s + qs`` (K' = s K and qs = s q on the massive rows), then the forcing
    at T."""
    A, D, C = ops
    zero = torch.zeros_like(T)
    qs = torch.where(plan.mass, pr.forcing(plan, sq, T, face) * plan.s, zero)

    def stage(y):
        return torch.where(plan.mass, ((D * y + A * above(y)) + C * below(y)) + qs, zero)

    k0 = stage(T)
    k1 = stage(T + 0.5 * k0)
    k2 = stage(T + 0.5 * k1)
    k3 = stage(T + k2)
    ys, ks = (T, T + 0.5 * k0, T + 0.5 * k1, T + k2), (k0, k1, k2, k3)
    wts, cin = (1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0), (0.0, 0.5, 0.5, 1.0)
    lTm, lqs, ls, ly = lT.clone(), zero, zero, zero
    gU, lhf, lhb = zero, 0.0, 0.0
    for s in (3, 2, 1, 0):
        g = torch.where(plan.mass, wts[s] * lT + (cin[s + 1] * ly if s < 3 else zero), zero)
        ly = (D * g + below(A) * below(g)) + above(C) * above(g)  # (K'^T g)
        lTm = lTm + ly
        lqs = lqs + g
        ls = ls + torch.where(plan.mass, g * ks[s] / torch.where(plan.mass, plan.s, torch.ones_like(T)), zero)
        b, f, h = band_adj(plan, g * plan.s, ys[s])
        gU, lhf, lhb = gU + b, lhf + f, lhb + h
    lw, lsq, lface, gq = forcing_adj(plan, lqs * plan.s, T, face)
    gU = gU + gq
    lTm = lTm + lw
    if u_vjp is not None:
        lTm = lTm + u_vjp(T, gU)
    return dict(T=lTm, sq=lsq, face=list(lface), hf=lhf, hb=lhb, u=gU, s=ls)

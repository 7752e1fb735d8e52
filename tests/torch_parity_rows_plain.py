"""The parity day-march kernel's row plan, stated plainly (the helper of
tests/test_torch_parity_rows.py, which holds it to heatx).

``csrc/day_march_parity.cu`` marches each surface lane with G = 4 threads,
thread ``g`` holding the M = 8 rows ``[g*M, g*M + M)`` of the lane's node
column.  This module states what those threads compute, on ``[G, M, S]``
tensors (a column padded to 32 rows and cut into the threads' rows), with
each row's neighbour across a thread's edge taken from the next or previous
thread as the kernel's shuffles take it:

* the launch-constant operator rows (:func:`row_plan`, :func:`operators`):
  dt/C on massive rows, K's rows scaled by it there and as they are on
  no-mass rows; per sub-step only the face rows' diagonals take the films;
* the no-mass solve per run (:func:`run_factors`, :func:`solve_runs`):
  heatx's closed form for runs of one or two rows (``tridiag.solve_runs2``)
  with each run's reciprocal denominator kept, a pair's partner across a
  thread boundary by one exchange each way; Thomas down the column
  (:func:`solve_column`) where a run is longer than two rows, heatx's own
  choice there;
* the masked no-mass iterations (:func:`nomass_march`), fixed or adaptive,
  with each run's state (last error, count, activity) at its head and its
  error summed in ascending row order;
* RK4 on the massive rows (:func:`massive_march`), each stage a row's three
  products with its neighbours and the frozen forcing.

Operands are node-major ``[N, S]`` in and out, as ``engine.surface`` takes
them (the tests hold them to heatx's ``surface.march_nomass``,
``march_massive`` and ``tridiag.solve_runs2``).
The plain day march (``day_march.plain_hour_parity``) is the kernel's
specification; this module is its row plan.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

#: Threads per surface lane and rows per thread of the parity kernel.
G, M = 4, 8
ROWS = G * M


def to_threads(x: torch.Tensor, fill=0.0) -> torch.Tensor:
    """``[N, S]`` -> ``[G, M, S]``: the column padded to 32 rows with
    ``fill``, thread g's rows at ``[g]``."""
    pad = x.new_full((ROWS - x.shape[0],) + tuple(x.shape[1:]), fill)
    return torch.cat([x, pad]).reshape((G, M) + tuple(x.shape[1:]))


def from_threads(x: torch.Tensor, n: int) -> torch.Tensor:
    """``[G, M, S]`` -> ``[n, S]``."""
    return x.reshape((ROWS,) + tuple(x.shape[2:]))[:n]


def above(x: torch.Tensor, fill=0.0) -> torch.Tensor:
    """Each row's row above: inside a thread the row before; a thread's first
    row takes the last row of the thread before it (``fill`` on thread 0)."""
    edge = torch.cat([torch.full_like(x[:1, -1:], fill), x[:-1, -1:]])
    return torch.cat([edge, x[:, :-1]], dim=1)


def below(x: torch.Tensor, fill=0.0) -> torch.Tensor:
    """Each row's row below; a thread's last row takes the first row of the
    thread after it (``fill`` on the last thread)."""
    edge = torch.cat([x[1:, :1], torch.full_like(x[:1, :1], fill)])
    return torch.cat([x[:, 1:], edge], dim=1)


def row_plan(node_mask, massive, same_chunk, seg_u, capacity, dt) -> SimpleNamespace:
    """A lane's rows as the kernel keeps them for a launch: the row masks
    (valid, first/last, massive and no-mass, the couplings inside and across
    chunks, the runs' heads, the pairs' heads and tails), U to the rows above
    and below (``ul``, ``ur``) and dt/C on massive rows (``s``).  Whether a
    no-mass run has more than two rows (``long_runs``) picks the solve."""
    valid = to_threads(node_mask, False)
    mass = to_threads(massive, False) & valid
    joined = to_threads(same_chunk, False)
    left = valid & above(valid, False)
    right = valid & below(valid, False)
    sel = valid & ~mass
    cont = sel & above(sel & joined, False)
    coup_r = right & joined
    u = to_threads(seg_u)
    ul = torch.where(left, above(u), torch.zeros_like(u))
    cap = to_threads(capacity, 1.0)
    return SimpleNamespace(
        valid=valid, first=valid & ~above(valid, False), last=valid & ~below(valid, False), mass=mass, sel=sel,
        coup_l=left & above(joined, False), coup_r=coup_r, dir_l=left & ~above(joined, False),
        dir_r=right & ~joined, cont=cont, head=sel & ~cont, pair=sel & coup_r, tail=above(sel & coup_r, False),
        ul=ul, ur=below(ul), s=torch.where(mass, dt / torch.where(mass, cap, torch.ones_like(cap)),
                                         torch.zeros_like(cap)),
        long_runs=bool((cont & below(cont, False)).any()),
    )


def with_u(plan: SimpleNamespace, seg_u) -> SimpleNamespace:
    """The plan with another U row (a cavity lane's, at its working
    temperatures)."""
    left = plan.coup_l | plan.dir_l
    u = to_threads(seg_u)
    ul = torch.where(left, above(u), torch.zeros_like(u))
    return SimpleNamespace(**{**vars(plan), "ul": ul, "ur": below(ul)})


def operators(plan: SimpleNamespace, hf, hb):
    """Each row's K row ``(A, D, C)`` (lower, diagonal, upper) with the films
    ``hf``/``hb`` [S] on the face rows, scaled by dt/C on massive rows."""
    zero = torch.zeros_like(plan.ul)
    kd = -(((plan.ul + plan.ur) + torch.where(plan.first, hf + zero, zero)) + torch.where(plan.last, hb + zero, zero))
    kl = torch.where(plan.coup_l, plan.ul, zero)
    ku = torch.where(plan.coup_r, plan.ur, zero)
    return tuple(torch.where(plan.mass, k * plan.s, k) for k in (kl, kd, ku))


def forcing(plan: SimpleNamespace, sq, w, face):
    """Each row's forcing q at the working rows ``w`` (assemble_q): the
    absorbed solar ``sq``, the faces' sources ``face = (t_front hf, radf,
    rad_ft, t_back hb, radb, rad_bt)`` ([S] each) and the couplings across
    chunks as frozen sources."""
    src_f, radf, rad_ft, src_b, radb, rad_bt = face
    zero = torch.zeros_like(w)
    q = sq + torch.where(plan.first, src_f + radf * (rad_ft - w), zero)
    q = q + torch.where(plan.last, src_b + radb * (rad_bt - w), zero)
    q = q + torch.where(plan.dir_l, plan.ul * above(w), zero)
    return q + torch.where(plan.dir_r, plan.ur * below(w), zero)


def run_factors(plan: SimpleNamespace, ops):
    """The reciprocal of each run's closed-form denominator on its rows (a
    single row's diagonal; a pair's 2x2 determinant, its tail copying its
    head's across a thread edge by one exchange); 1 elsewhere."""
    A, D, C = ops
    den = torch.where(plan.pair, D * below(D, 1.0) - C * below(A), D)
    P = torch.where(plan.sel & ~plan.tail, 1.0 / torch.where(plan.sel, den, torch.ones_like(den)),
                    torch.ones_like(den))
    return torch.where(plan.tail, above(P, 1.0), P)


def solve_runs(plan: SimpleNamespace, ops, P, r):
    """The no-mass rows' solution of runs of one or two rows in closed form
    (solve_runs2): a pair's head and tail read the partner's row."""
    A, D, C = ops
    num = torch.where(plan.pair, r * below(D, 1.0) - C * below(r),
                      torch.where(plan.tail, above(D, 1.0) * r - A * above(r), r))
    return num * P


def solve_column(plan: SimpleNamespace, ops, r, w):
    """Thomas down each lane's column (tridiag.solve) on K's no-mass rows
    and identity rows elsewhere (right-hand side ``w``)."""
    A, D, C = ops
    flat = [x.reshape((ROWS,) + tuple(x.shape[2:])) for x in (plan.sel, A, D, C, r, w)]
    sel, lo, di, up, rh, ww = flat
    zero = torch.zeros_like(ww[0])
    cs, ds, c_p, d_p = [], [], zero, zero
    for k in range(ROWS):
        l = torch.where(sel[k], lo[k], zero)
        inv = 1.0 / (torch.where(sel[k], di[k], torch.ones_like(zero)) - l * c_p)
        c_p = torch.where(sel[k], up[k], zero) * inv
        d_p = (torch.where(sel[k], rh[k], ww[k]) - l * d_p) * inv
        cs.append(c_p)
        ds.append(d_p)
    xs, x = [None] * ROWS, None
    for k in range(ROWS - 1, -1, -1):
        x = ds[k] if x is None else ds[k] - cs[k] * x
        xs[k] = x
    return torch.stack(xs).reshape(w.shape)


def _flat(x):
    return x.reshape((ROWS,) + tuple(x.shape[2:]))


def _run_errors(plan: SimpleNamespace, d):
    """Each run's error at its head: the rows' |dT| summed in ascending row
    order (the sum at the run's last row, carried back to its head)."""
    if not plan.long_runs:
        return (0.0 + d) + torch.where(plan.pair, below(d), torch.zeros_like(d))
    sel, head, cont, dd = (_flat(x) for x in (plan.sel, plan.head, plan.cont, d))
    pre, e = [], torch.zeros_like(dd[0])
    for k in range(ROWS):
        e = torch.where(head[k], 0.0 + dd[k], e + dd[k])
        pre.append(e)
    tot, t = [None] * ROWS, torch.zeros_like(e)
    for k in range(ROWS - 1, -1, -1):
        t = torch.where(sel[k] & (cont[k + 1] if k + 1 < ROWS else torch.zeros_like(sel[k])), t, pre[k])
        tot[k] = t
    return torch.stack(tot).reshape(d.shape)


def _run_rows(plan: SimpleNamespace, heads):
    """The rows of the runs whose heads are marked in ``heads``."""
    moved, cont = _flat(heads).clone(), _flat(plan.cont)
    for k in range(1, ROWS):
        moved[k] = moved[k] | (cont[k] & moved[k - 1])
    return moved.reshape(heads.shape)


def _run_lengths(plan: SimpleNamespace, dtype):
    """Each run's row count at its head (and at every row, the rows from it
    to its run's end)."""
    sel, cont = _flat(plan.sel), _flat(plan.cont)
    n, out = torch.zeros(sel.shape[1:], dtype=dtype), [None] * ROWS
    for k in range(ROWS - 1, -1, -1):
        nxt = cont[k + 1] if k + 1 < ROWS else torch.zeros_like(sel[k])
        n = torch.where(sel[k], 1.0 + torch.where(nxt, n, torch.zeros_like(n)), torch.zeros_like(n))
        out[k] = n
    return torch.stack(out).reshape(plan.sel.shape)


def nomass_march(plan: SimpleNamespace, ops, sq, face, T, config, films=None, seg_u_of=None):
    """The no-mass march of one sub-step (march_nomass) on the rows ``T``:
    one relaxed solve per iteration, ``config.nomass_fixed_iters`` of them
    or heatx's adaptive loop; each run's state at its head.  ``seg_u_of``
    gives a cavity lane's U at the rows of an iteration's input (iterations
    after the first), whose K takes the films ``films = (hf, hb)``."""

    def solve(plan, ops, w):
        r = -forcing(plan, sq, w, face)
        if plan.long_runs:
            return solve_column(plan, ops, r, w)
        return solve_runs(plan, ops, run_factors(plan, ops), r)

    if config.nomass_fixed_iters == 1:
        return torch.where(plan.sel, 0.5 * (T + solve(plan, ops, T)), T)
    adaptive = config.nomass_fixed_iters is None
    cap = config.nomass_max_iter if adaptive else config.nomass_fixed_iters
    oerr = torch.full_like(T, 99999.0)
    cnt = torch.zeros_like(T)
    act = plan.head.clone()
    length = _run_lengths(plan, T.dtype)
    for it in range(cap):
        if adaptive and not bool(act.any()):
            break
        if seg_u_of is not None and it > 0:
            plan = with_u(plan, seg_u_of(T))
            ops = operators(plan, *films)
        x = solve(plan, ops, T)
        d = torch.abs(x - T)
        d = torch.where(plan.sel & ~(d < 1e-25), d, torch.zeros_like(d))
        err = _run_errors(plan, d)
        up = act & ~(err > oerr)
        oerr = torch.where(up, err, oerr)
        tol = torch.where(cnt < config.nomass_escalate_after, torch.full_like(T, config.nomass_tol),
                          torch.full_like(T, config.nomass_tol_escalated))
        converged = err / torch.clamp_min(length, 1.0) < tol
        cnt = torch.where(up & ~converged, cnt + 1, cnt)
        act = up & ~converged
        T = torch.where(_run_rows(plan, up), 0.5 * (T + x), T)
    return T


def rk4(plan: SimpleNamespace, ops, qs, T):
    """RK4 on the massive rows with the scaled rows ``ops`` and the frozen
    scaled forcing ``qs``: each stage k = D y + A y_above + C y_below + qs."""
    A, D, C = ops
    zero = torch.zeros_like(T)

    def stage(y):
        return torch.where(plan.mass, ((D * y + A * above(y)) + C * below(y)) + qs, zero)

    k = stage(T)
    acc, y = T + k * (1.0 / 6.0), T + 0.5 * k
    k = stage(y)
    acc, y = acc + k * (1.0 / 3.0), T + 0.5 * k
    k = stage(y)
    acc, y = acc + k * (1.0 / 3.0), T + k
    k = stage(y)
    return torch.where(plan.mass, acc + k * (1.0 / 6.0), T)


def massive_march(plan: SimpleNamespace, ops, sq, face, T):
    """RK4 of the massive rows (march_massive) from the post-no-mass rows
    ``T``: the forcing at T, scaled by dt/C, frozen over the stages."""
    qs = torch.where(plan.mass, forcing(plan, sq, T, face) * plan.s, torch.zeros_like(T))
    return rk4(plan, ops, qs, T)

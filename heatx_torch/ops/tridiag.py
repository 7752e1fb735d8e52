"""Batched tridiagonal operations over the leading (node) axis.

PyTorch twin of ``heatx.ops.tridiag`` for the day march: the mat-vec, the
Thomas solve and its pre-factored sweeps, parallel cyclic reduction and its
pre-factored form, the closed-form solve of 1- and 2-node runs, and the
partitioned solve of the day kernels with its transpose.  Arrays are node-major
``[N, S]``; row ``i`` of each system is

    lower[i] * x[i-1] + diag[i] * x[i] + upper[i] * x[i+1] = rhs[i]

with ``lower[0]`` and ``upper[N-1]`` ignored.  Masked/identity rows are
encoded as ``diag=1, lower=upper=0, rhs=x_current``.  The sweeps are Python
loops over the (static, tiny) node axis, each step a full-width row op.
"""

from __future__ import annotations

import torch


def matvec(lower, diag, upper, x):
    """y[i] = lower[i]*x[i-1] + diag[i]*x[i] + upper[i]*x[i+1] over axis 0;
    rows 0 / N-1 read a zero neighbour."""
    zero_row = torch.zeros_like(x[:1])
    x_dn = torch.cat([zero_row, x[:-1]], dim=0)  # x[i-1]
    x_up = torch.cat([x[1:], zero_row], dim=0)  # x[i+1]
    return diag * x + lower * x_dn + upper * x_up


def solve(lower, diag, upper, rhs):
    """Thomas algorithm over axis 0, batched over the trailing axes."""
    n = rhs.shape[0]
    inv = 1.0 / diag[0]
    cs = [upper[0] * inv]
    ds = [rhs[0] * inv]
    for i in range(1, n):
        inv = 1.0 / (diag[i] - lower[i] * cs[i - 1])
        cs.append(upper[i] * inv)
        ds.append((rhs[i] - lower[i] * ds[i - 1]) * inv)
    xs = [None] * n
    xs[n - 1] = ds[n - 1]
    for i in range(n - 2, -1, -1):
        xs[i] = ds[i] - cs[i] * xs[i + 1]
    return torch.stack(xs, dim=0)


def solve_runs2(lower, diag, upper, rhs, pair_head, pair_tail):
    """Closed-form solve when off-diagonal couplings occur only inside
    disjoint 2-node runs (``pair_head[i]`` marks row i coupled to i+1,
    ``pair_tail`` its partner; every other row is decoupled: x = rhs/diag).
    The shape of the no-mass systems of ordinary constructions, whose
    no-mass layers discretize to 1-2 nodes per chunk; callers guarantee the
    run length (``SurfaceBatch.max_nomass_run <= 2``)."""
    d_n, r_n, l_n = (_shift_dn(x, 1, 0.0) for x in (diag, rhs, lower))
    d_p, r_p, u_p = (_shift_up(x, 1, 0.0) for x in (diag, rhs, upper))
    # 2x2 Cramer: [d_i u_i; l_{i+1} d_{i+1}] x = [r_i; r_{i+1}]
    det_head = diag * d_n - upper * l_n
    det_tail = d_p * diag - u_p * lower
    num = torch.where(
        pair_head, rhs * d_n - upper * r_n,
        torch.where(pair_tail, d_p * rhs - lower * r_p, rhs),
    )
    den = torch.where(pair_head, det_head, torch.where(pair_tail, det_tail, diag))
    return num / den


def solve_pcr(lower, diag, upper, rhs):
    """Parallel cyclic reduction over axis 0: ceil(log2 N) elimination steps
    with static shifts.  Needs (weak) diagonal dominance; out-of-range
    neighbours act as identity rows, which keeps decoupled sub-systems
    exact."""
    n = rhs.shape[0]
    a, b, c, r = lower, diag, upper, rhs
    d = 1
    while d < n:
        alpha = -a / _shift_up(b, d, 1.0)
        gamma = -c / _shift_dn(b, d, 1.0)
        b = b + alpha * _shift_up(c, d, 0.0) + gamma * _shift_dn(a, d, 0.0)
        r = r + alpha * _shift_up(r, d, 0.0) + gamma * _shift_dn(r, d, 0.0)
        a = alpha * _shift_up(a, d, 0.0)
        c = gamma * _shift_dn(c, d, 0.0)
        d *= 2
    return r / b


def factor(lower, diag, upper):
    """Pre-factor a tridiagonal system for repeated Thomas solves.

    Returns ``(cs, invs)`` with ``cs[i]`` the modified upper coefficient and
    ``invs[i]`` the pivot reciprocal; use with :func:`solve_factored`."""
    n = diag.shape[0]
    invs = [1.0 / diag[0]]
    cs = [upper[0] * invs[0]]
    for i in range(1, n):
        invs.append(1.0 / (diag[i] - lower[i] * cs[i - 1]))
        cs.append(upper[i] * invs[i])
    return torch.stack(cs, dim=0), torch.stack(invs, dim=0)


def solve_factored(lower, cs, invs, rhs):
    """Solve with a :func:`factor` result: one multiply-add per row in each
    sweep, no divisions."""
    n = rhs.shape[0]
    ds = [rhs[0] * invs[0]]
    for i in range(1, n):
        ds.append((rhs[i] - lower[i] * ds[i - 1]) * invs[i])
    xs = [None] * n
    xs[n - 1] = ds[n - 1]
    for i in range(n - 2, -1, -1):
        xs[i] = ds[i] - cs[i] * xs[i + 1]
    return torch.stack(xs, dim=0)


def _shift_up(x, d, fill):
    """``x[i-d]`` with ``fill`` above the top edge."""
    pad = torch.full_like(x[:1], fill).expand((d,) + tuple(x.shape[1:]))
    return torch.cat([pad, x[:-d]], dim=0)


def _shift_dn(x, d, fill):
    """``x[i+d]`` with ``fill`` below the bottom edge."""
    pad = torch.full_like(x[:1], fill).expand((d,) + tuple(x.shape[1:]))
    return torch.cat([x[d:], pad], dim=0)


def pcr_factor(lower, diag, upper):
    """Pre-factor a tridiagonal system for repeated parallel-cyclic-reduction
    solves: ceil(log2 N) levels of elimination coefficients plus the
    reciprocal reduced diagonal.  Out-of-range neighbours act as identity
    rows.  Returns ``(levels, inv_b)``; use with :func:`pcr_apply`."""
    n = diag.shape[0]
    a, b, c = lower, diag, upper
    levels = []
    d = 1
    while d < n:
        b_up = _shift_up(b, d, 1.0)
        b_dn = _shift_dn(b, d, 1.0)
        alpha = -a / b_up
        gamma = -c / b_dn
        b = b + alpha * _shift_up(c, d, 0.0) + gamma * _shift_dn(a, d, 0.0)
        a = alpha * _shift_up(a, d, 0.0)
        c = gamma * _shift_dn(c, d, 0.0)
        levels.append((alpha, gamma))
        d *= 2
    return tuple(levels), 1.0 / b


def pcr_apply(levels, inv_b, rhs):
    """Solve with a :func:`pcr_factor` result."""
    r = rhs
    d = 1
    for alpha, gamma in levels:
        r = r + alpha * _shift_up(r, d, 0.0) + gamma * _shift_dn(r, d, 0.0)
        d *= 2
    return r * inv_b


def partition_factor(lower, diag, upper, groups: int):
    """Pre-factor a tridiagonal system for the partitioned solve of the
    TR-BDF2 day-march kernel (``csrc/day_tr.cuh``), written out with the
    kernel's ``groups`` threads per system as a batch axis; the kernel's
    plain statement, used by the tests.

    The rows (padded with identity rows to ``groups * M``) are cut into
    ``groups`` chunks of ``M`` consecutive rows, one per thread.  Each chunk
    eliminates its own rows (a forward and a backward sweep) until every
    interior row reads ``x_i + A_i x_first + C_i x_last = D_i``; its first
    and last rows then couple only to the neighbouring chunks' last and first
    rows, a tridiagonal reduced system of ``2 * groups`` rows (``groups``
    when ``M == 1``) in the order first_0, last_0, first_1, ...  that
    parallel cyclic reduction solves (:func:`pcr_factor`).  Identity rows
    stay identity rows.  Returns the factors; use with
    :func:`partition_solve`."""
    n = diag.shape[0]
    m = -(-n // groups)
    pad = groups * m - n
    if pad:
        def ext(x, fill):
            return torch.cat([x, torch.full_like(x[:1], fill).expand((pad,) + tuple(x.shape[1:]))])
        lower, diag, upper = ext(lower, 0.0), ext(diag, 1.0), ext(upper, 0.0)
    a, b, c = (x.reshape((groups, m) + tuple(x.shape[1:])) for x in (lower, diag, upper))
    f, A, C = [], [], []
    for j in range(m):
        if j < 2:  # rows 0 and 1 are only normalized: row 1 couples to x_first
            f.append(1.0 / b[:, j])
            A.append(a[:, j] * f[j])
        else:
            f.append(1.0 / (b[:, j] - a[:, j] * C[j - 1]))
            A.append(-a[:, j] * A[j - 1] * f[j])
        C.append(c[:, j] * f[j])
    cf = list(C)  # the forward sweep's upper coefficients
    for j in range(m - 3, 0, -1):
        A[j] = A[j] - cf[j] * A[j + 1]
        C[j] = -cf[j] * C[j + 1]
    einv = None
    if m >= 3:  # row 0 takes row 1 out: it then couples to x_last
        einv = 1.0 / (1.0 - cf[0] * A[1])
        A[0] = A[0] * einv
        C[0] = -cf[0] * C[1] * einv
    red = (groups * (2 if m > 1 else 1),) + tuple(a.shape[2:])
    ra = (torch.stack([A[0], A[m - 1]], dim=1) if m > 1 else A[0]).reshape(red)
    rc = (torch.stack([C[0], C[m - 1]], dim=1) if m > 1 else C[0]).reshape(red)
    levels, inv_b = pcr_factor(ra, torch.ones_like(ra), rc)
    return dict(n=n, m=m, groups=groups, lower=a, f=f, cf=cf, einv=einv, A=A, C=C,
                levels=levels, inv_b=inv_b)


def partition_solve(fac, rhs):
    """Solve with a :func:`partition_factor` result: each chunk's forward and
    backward sweeps on the right-hand side, the reduced system by PCR, then
    each chunk's interior rows from its first and last."""
    n, m, groups = fac["n"], fac["m"], fac["groups"]
    pad = groups * m - n
    if pad:
        rhs = torch.cat([rhs, torch.zeros_like(rhs[:1]).expand((pad,) + tuple(rhs.shape[1:]))])
    d = rhs.reshape((groups, m) + tuple(rhs.shape[1:]))
    a, f, cf = fac["lower"], fac["f"], fac["cf"]
    D = []
    for j in range(m):
        D.append(d[:, j] * f[j] if j < 2 else (d[:, j] - a[:, j] * D[j - 1]) * f[j])
    for j in range(m - 3, 0, -1):
        D[j] = D[j] - cf[j] * D[j + 1]
    if m >= 3:
        D[0] = (D[0] - cf[0] * D[1]) * fac["einv"]
    red = (groups * (2 if m > 1 else 1),) + tuple(d.shape[2:])
    r = (torch.stack([D[0], D[m - 1]], dim=1) if m > 1 else D[0]).reshape(red)
    xr = pcr_apply(fac["levels"], fac["inv_b"], r)
    if m == 1:
        x = xr.reshape(d.shape)
    else:
        xr = xr.reshape((groups, 2) + tuple(d.shape[2:]))
        xf, xl = xr[:, 0], xr[:, 1]
        rows = [xf] + [D[j] - fac["A"][j] * xf - fac["C"][j] * xl for j in range(1, m - 1)] + [xl]
        x = torch.stack(rows, dim=1)
    return x.reshape((groups * m,) + tuple(d.shape[2:]))[:n]


def pcr_apply_transposed(levels, inv_b, g):
    """The transpose of :func:`pcr_apply`: ``y`` with ``pcr_apply``'s matrix
    transposed applied to ``g``.  Each level's update ``r + alpha r[i-d] +
    gamma r[i+d]`` turns around in reverse order: a row's cotangent takes
    its neighbours' coefficients times their cotangents, the shifts in the
    opposite direction."""
    r = g * inv_b
    d = 1 << (len(levels) - 1) if levels else 1
    for alpha, gamma in reversed(levels):
        r = r + _shift_dn(alpha * r, d, 0.0) + _shift_up(gamma * r, d, 0.0)
        d //= 2
    return r


def partition_solve_transposed(fac, g):
    """Solve ``M^T y = g`` with the :func:`partition_factor` result of ``M``:
    the TR-BDF2 day adjoint's transposed stage solve (``csrc/day_tr_adj.cuh``)
    in its plain statement, each step of :func:`partition_solve` transposed
    and taken in reverse order.  The interior rows' back-substitution sends
    their cotangents to the chunk's first and last rows, the reduced
    system's PCR levels run backwards with their shifts reversed, then each
    chunk's backward sweep and forward sweep run transposed (the backward
    sweep from the chunk's top down, the forward sweep from its bottom up)."""
    n, m, groups = fac["n"], fac["m"], fac["groups"]
    pad = groups * m - n
    if pad:
        g = torch.cat([g, torch.zeros_like(g[:1]).expand((pad,) + tuple(g.shape[1:]))])
    y = g.reshape((groups, m) + tuple(g.shape[1:]))
    a, f, cf = fac["lower"], fac["f"], fac["cf"]
    red = (groups * (2 if m > 1 else 1),) + tuple(y.shape[2:])
    lD = [y[:, j] for j in range(m)]
    if m == 1:
        lr = pcr_apply_transposed(fac["levels"], fac["inv_b"], y[:, 0].reshape(red))
        lD[0] = lr.reshape(y[:, 0].shape)
    else:
        lxf, lxl = y[:, 0], y[:, m - 1]
        for j in range(1, m - 1):
            lxf = lxf - fac["A"][j] * y[:, j]
            lxl = lxl - fac["C"][j] * y[:, j]
        lr = pcr_apply_transposed(fac["levels"], fac["inv_b"], torch.stack([lxf, lxl], dim=1).reshape(red))
        lr = lr.reshape((groups, 2) + tuple(y.shape[2:]))
        lD[0], lD[m - 1] = lr[:, 0], lr[:, 1]
    if m >= 3:
        lD[1] = lD[1] - cf[0] * fac["einv"] * lD[0]
        lD[0] = lD[0] * fac["einv"]
    for j in range(1, m - 2):
        lD[j + 1] = lD[j + 1] - cf[j] * lD[j]
    lx = [None] * m
    for j in range(m - 1, -1, -1):
        lx[j] = lD[j] * f[j]
        if j >= 2:
            lD[j - 1] = lD[j - 1] - a[:, j] * lx[j]
    x = torch.stack(lx, dim=1)
    return x.reshape((groups * m,) + tuple(y.shape[2:]))[:n]

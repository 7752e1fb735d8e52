"""Batched tridiagonal operations over the leading (node) axis.

PyTorch twin of ``heatx.ops.tridiag`` for the day march: the mat-vec, the
pre-factored Thomas sweeps and the pre-factored PCR.  Arrays are node-major
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

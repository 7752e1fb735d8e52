"""Chunked reverse-mode differentiation over long horizons.

PyTorch counterpart of ``heatx.engine.adjoint``.  :func:`chunked_value_and_grad`
splits the horizon into C chunks: the forward sweep runs chunk by chunk and
keeps only the C chunk-boundary states; the backward sweep re-runs each
chunk in reverse order and pulls its cotangents back, threading the state
cotangent between chunks.  Peak memory is one chunk's tape plus C boundary
states (checkpointed adjoint integration at one level).

Trees are dicts, lists, tuples and dataclasses (``SimState``,
``StepInputs``) of tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch


def tree_flatten(tree) -> Tuple[list, Callable]:
    """The leaves of a dict/list/tuple/dataclass tree and a function that
    rebuilds the tree from a list of new leaves.  None is an empty subtree
    (an optional channel that is absent), not a leaf."""
    if tree is None:
        return [], lambda leaves: None
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [tree_flatten(tree[k]) for k in keys]
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        keys = [f.name for f in dataclasses.fields(tree)]
        parts = [tree_flatten(getattr(tree, k)) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [tree_flatten(x) for x in tree]
    else:
        return [tree], lambda leaves: leaves[0]
    sizes = [len(leaves) for leaves, _ in parts]

    def rebuild(leaves):
        out, i = [], 0
        for (_, fn), n in zip(parts, sizes):
            out.append(fn(leaves[i:i + n]))
            i += n
        if isinstance(tree, dict):
            return dict(zip(keys, out))
        if keys is not None:
            return dataclasses.replace(tree, **dict(zip(keys, out)))
        if hasattr(tree, "_fields"):  # NamedTuple
            return type(tree)(*out)
        return type(tree)(out)

    return [leaf for leaves, _ in parts for leaf in leaves], rebuild


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure."""
    flat = [tree_flatten(t) for t in trees]
    rebuild = flat[0][1]
    return rebuild([fn(*leaves) for leaves in zip(*(f[0] for f in flat))])


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def _zeros(x):
    return torch.zeros_like(x) if _is_float(x) else None


def _autograd_vjp(chunk_fn):
    """``backward_fn`` by torch.autograd over ``chunk_fn``: re-runs the
    chunk from its start state with the parameters and state as leaves and
    pulls ``(state_cot, loss_cot)`` back to them.  Non-float leaves get
    None."""

    def bwd(params, state, xs, state_cot, loss_cot):
        p_leaves, p_rebuild = tree_flatten(params)
        s_leaves, s_rebuild = tree_flatten(state)
        leaves = [x.detach().requires_grad_() if _is_float(x) else x for x in p_leaves + s_leaves]
        with torch.enable_grad():
            new_state, loss = chunk_fn(
                p_rebuild(leaves[:len(p_leaves)]), s_rebuild(leaves[len(p_leaves):]), xs
            )
            outs, cots = [loss], [torch.as_tensor(loss_cot, dtype=loss.dtype, device=loss.device)]
            for out, cot in zip(tree_flatten(new_state)[0], tree_flatten(state_cot)[0]):
                if _is_float(out) and out.requires_grad and cot is not None:
                    outs.append(out)
                    cots.append(cot)
            wrt = [x for x in leaves if _is_float(x)]
            grads = iter(torch.autograd.grad(outs, wrt, cots, allow_unused=True))
        full = []
        for x in leaves:
            g = next(grads) if _is_float(x) else None
            full.append(torch.zeros_like(x) if g is None and _is_float(x) else g)
        return p_rebuild(full[:len(p_leaves)]), s_rebuild(full[len(p_leaves):])

    return bwd


def chunked_value_and_grad(
    chunk_fn: Callable[[Any, Any, Any], Tuple[Any, torch.Tensor]],
    params: Any,
    state0: Any,
    xs_chunks: Any,
    forward_fn: Callable[[Any, Any, Any], Tuple[Any, torch.Tensor]] = None,
    backward_fn: Callable = None,
) -> Tuple[torch.Tensor, Any]:
    """Value and parameter gradient of a chunk-summed objective (heatx
    ``chunked_value_and_grad``).

    ``chunk_fn(params, state, xs) -> (new_state, loss_contrib)`` advances the
    simulation over one chunk of inputs and returns its additive
    contribution to the scalar objective.  ``xs_chunks`` is an input tree
    whose leaves carry a leading chunk axis ``[C, ...]``.  Returns
    ``(total_loss, grad_params)`` with ``grad_params`` shaped like
    ``params``.

    ``forward_fn`` (optional) runs the forward sweep instead of
    ``chunk_fn`` (same contract; typically ``FastRunner.chunk_forward``).
    ``backward_fn(params, state, xs, state_cot, loss_cot) -> (params_cot,
    state_cot)`` (optional) runs each chunk's backward with ``state``/``xs``
    the chunk's START state and inputs (typically ``FastRunner.chunk_grad``);
    without it, torch.autograd differentiates ``chunk_fn``.  The objective
    must flow through the loss contributions only: a loss on the final state
    would need its cotangent seeded."""
    leaves = tree_flatten(xs_chunks)[0]
    if not leaves:
        raise ValueError("xs_chunks has no leaves")
    n_chunks = leaves[0].shape[0]
    if n_chunks == 0:
        raise ValueError("xs_chunks has an empty leading chunk axis")
    bad = [tuple(x.shape) for x in leaves if x.shape[0] != n_chunks]
    if bad:
        raise ValueError(
            f"xs_chunks leaves disagree on the leading chunk axis: {n_chunks} vs {bad[0][0]}"
        )

    if forward_fn is None:

        def forward_fn(params, state, xs):
            with torch.no_grad():
                return chunk_fn(params, state, xs)

    bwd = _autograd_vjp(chunk_fn) if backward_fn is None else backward_fn

    def chunk(i):
        return tree_map(lambda x: x[i], xs_chunks)

    # Forward sweep: one chunk at a time, keeping the chunk-boundary states.
    states = [state0]
    total = None
    for i in range(n_chunks):
        state, loss_i = forward_fn(params, states[-1], chunk(i))
        states.append(state)
        total = loss_i if total is None else total + loss_i

    # Backward sweep in reverse chunk order, threading the state cotangent.
    one = torch.ones_like(total)
    grad = tree_map(_zeros, params)
    state_cot = tree_map(_zeros, state0)
    for i in reversed(range(n_chunks)):
        gp, state_cot = bwd(params, states[i], chunk(i), state_cot, one)
        grad = tree_map(lambda a, b: a if a is None else a + b, grad, gp)
    return total, grad

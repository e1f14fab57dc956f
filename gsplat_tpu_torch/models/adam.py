"""Per-group Adam with torch.optim semantics (bias correction, eps added to
sqrt(vhat) outside the root), eps=1e-15: the reference's optimizer setup
(scene/gaussian_model.py:177: ``torch.optim.Adam(l, lr=0.0, eps=1e-15)``).

PyTorch port of ``gsplat_tpu/models/adam.py``.  Written by hand, not with
``torch.optim``, because densification resets single rows of the moments and
an overflowing step must be undone leaf by leaf: the state is a plain
``NamedTuple`` of tensors and ``update`` returns new tensors without touching
its inputs, so the caller can still choose between the old and the new state
(``trainer.gate_on_overflow``).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch


def tree_map(fn, tree, *rest):
    """``fn`` over the tensors of nested tuples / NamedTuples of tensors
    (what the JAX package calls a pytree), keeping the structure.  ``rest``
    are trees of the same structure; a leaf of ``rest`` may also be a plain
    number (the per-group learning rates)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, tuple):
        items = [tree_map(fn, v, *[r[i] for r in rest])
                 for i, v in enumerate(tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    raise TypeError(f"tree_map: unsupported node {type(tree).__name__}")


class AdamState(NamedTuple):
    count: torch.Tensor  # [] int32 step counter (one for all groups, as torch
                         # keeps the same step for every tensor)
    mu: Any              # tree like params
    nu: Any              # tree like params


def init(params) -> AdamState:
    return AdamState(
        count=torch.zeros((), dtype=torch.int32, device=params[0].device),
        mu=tree_map(torch.zeros_like, params),
        nu=tree_map(torch.zeros_like, params))


def update(grads, state: AdamState, params, lrs, b1=0.9, b2=0.999, eps=1e-15):
    """One Adam step.  ``lrs`` is a tree of scalars congruent with params
    (per-group learning rates).  Returns (new_params, new_state); the inputs
    are left as they were."""
    count = state.count + 1
    t = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)

    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
    nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)

    def step(p, m, v, lr):
        mhat = m / bc1
        vhat = v / bc2
        return p - lr * mhat / (torch.sqrt(vhat) + eps)

    new_params = tree_map(step, params, mu, nu, lrs)
    return new_params, AdamState(count=count, mu=mu, nu=nu)


def mask_rows(state: AdamState, row_mask) -> AdamState:
    """Zero the moment rows where ``row_mask`` is True (new or replaced
    slots): the fixed-capacity equivalent of the reference's optimizer-state
    surgery."""

    def zero_rows(x):
        m = row_mask.reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.where(m, 0.0, x)

    return AdamState(count=state.count, mu=tree_map(zero_rows, state.mu),
                     nu=tree_map(zero_rows, state.nu))

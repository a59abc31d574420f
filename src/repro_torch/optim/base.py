"""Minimal gradient-transformation protocol (port of
``repro/optim/base.py``).

A ``GradientTransformation`` is an ``(init, update)`` pair:

    state = tx.init(params)
    updates, state = tx.update(grads, state, params)
    params = apply_updates(params, updates)

Trees are the port's (``utils.tree``): dicts, tuples, ``NamedTuple``s and
``None`` as an empty subtree. Updates are computed out of place, as in
the reference; the step counter is a host int.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..utils import tree

PyTree = Any


@dataclasses.dataclass(frozen=True)
class GradientTransformation:
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, Optional[PyTree]], tuple]


def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    """``p + u`` cast to p's dtype per leaf (None updates pass through)."""
    return tree.tree_map(
        lambda p, u: p if u is None else p + u.to(p.dtype), params, updates,
        is_leaf=lambda x: x is None)


def chain(*txs: GradientTransformation) -> GradientTransformation:
    """Compose transformations left-to-right (like optax.chain)."""

    def init(params):
        return tuple(tx.init(params) for tx in txs)

    def update(grads, state, params=None):
        new_state = []
        for tx, s in zip(txs, state):
            grads, s = tx.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return GradientTransformation(init, update)


class ScaleByLrState(NamedTuple):
    count: int


def scale_by_learning_rate(lr, flip_sign: bool = True
                           ) -> GradientTransformation:
    """lr may be a float or a schedule(step)->lr."""
    sign = -1.0 if flip_sign else 1.0

    def init(params):
        del params
        return ScaleByLrState(count=0)

    def update(grads, state, params=None):
        del params
        step_lr = lr(state.count) if callable(lr) else lr
        updates = tree.tree_map(lambda g: sign * step_lr * g, grads)
        return updates, ScaleByLrState(count=state.count + 1)

    return GradientTransformation(init, update)


def global_norm(grads: PyTree) -> torch.Tensor:
    leaves = tree.tree_leaves(grads)
    if not leaves:
        return torch.zeros([])
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))


class ClipState(NamedTuple):
    pass


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """Norm-wise gradient clipping — implements Assumption 3.8 (bounded G).
    The clipped gradients are fp32 (JAX promotes a bf16 gradient times the
    fp32 clip factor)."""

    def init(params):
        del params
        return ClipState()

    def update(grads, state, params=None):
        del params
        gnorm = global_norm(grads)
        scale = torch.clamp(max_norm / (gnorm + 1e-12), max=1.0)
        return tree.tree_map(lambda g: g.float() * scale, grads), state

    return GradientTransformation(init, update)

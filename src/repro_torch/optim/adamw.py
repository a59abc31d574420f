"""AdamW, Adam, SGD and heavy-ball momentum (port of
``repro/optim/adamw.py``): Algorithms 2-4 of Appendix A, with explicit
``NamedTuple`` states so the federated layer can read and write them."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils import tree
from .base import (GradientTransformation, chain, clip_by_global_norm,
                   scale_by_learning_rate)


class AdamState(NamedTuple):
    count: int
    m: object   # tree like params, fp32
    v: object   # tree like params, fp32


def _tree_zeros_f32(params):
    return tree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  bias_correction: bool = True) -> GradientTransformation:
    """Adam preconditioning (Algorithm 4, lines 8-10)."""

    def init(params):
        return AdamState(count=0, m=_tree_zeros_f32(params),
                         v=_tree_zeros_f32(params))

    def update(grads, state, params=None):
        del params
        count = state.count + 1
        g32 = tree.tree_map(lambda g: g.float(), grads)
        m = tree.tree_map(lambda mu, g: b1 * mu + (1 - b1) * g, state.m, g32)
        v = tree.tree_map(lambda nu, g: b2 * nu + (1 - b2) * g * g,
                          state.v, g32)
        if bias_correction:
            c = torch.tensor(float(count), dtype=torch.float32)
            c1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** c)
            c2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** c)
        else:
            c1 = c2 = 1.0
        updates = tree.tree_map(
            lambda mu, nu: (mu / c1) / (torch.sqrt(nu / c2) + eps), m, v)
        return updates, AdamState(count=count, m=m, v=v)

    return GradientTransformation(init, update)


class WeightDecayState(NamedTuple):
    pass


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    """Decoupled weight decay (AdamW): adds wd * params to the update."""

    def init(params):
        del params
        return WeightDecayState()

    def update(grads, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights requires params")
        updates = tree.tree_map(
            lambda g, p: g + weight_decay * p.to(g.dtype), grads, params)
        return updates, state

    return GradientTransformation(init, update)


class MomentumState(NamedTuple):
    momentum: object


def scale_by_momentum(beta: float = 0.9) -> GradientTransformation:
    """Heavy-ball momentum (Algorithm 3): v <- beta*v + g; update = v."""

    def init(params):
        return MomentumState(momentum=_tree_zeros_f32(params))

    def update(grads, state, params=None):
        del params
        buf = tree.tree_map(lambda b, g: beta * b + g.float(),
                            state.momentum, grads)
        return buf, MomentumState(momentum=buf)

    return GradientTransformation(init, update)


def adamw(learning_rate, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
          clip_norm: Optional[float] = None) -> GradientTransformation:
    txs = []
    if clip_norm is not None:
        txs.append(clip_by_global_norm(clip_norm))
    txs += [scale_by_adam(b1, b2, eps),
            add_decayed_weights(weight_decay),
            scale_by_learning_rate(learning_rate)]
    return chain(*txs)


def adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8,
         clip_norm: Optional[float] = None) -> GradientTransformation:
    return adamw(learning_rate, b1, b2, eps, weight_decay=0.0,
                 clip_norm=clip_norm)


def sgd(learning_rate, momentum: Optional[float] = None,
        clip_norm: Optional[float] = None) -> GradientTransformation:
    txs = []
    if clip_norm is not None:
        txs.append(clip_by_global_norm(clip_norm))
    if momentum is not None:
        txs.append(scale_by_momentum(momentum))
    txs.append(scale_by_learning_rate(learning_rate))
    return chain(*txs)

"""Server aggregation 𝒜 for the GaLore methods (port of the FedAvg and
factored-lift operators of ``repro/core/aggregation.py``).

Operators take client-stacked trees or tensors (leading client axis K)
and reduce them with normalized weights. The LoRA baselines' operators
are ROADMAP Queue 1 item 8; the robust modes are item 10.
"""
from __future__ import annotations

from typing import Any

import torch

from . import projector as proj
from ..utils import tree

PyTree = Any
ROBUST_MODES = ("none", "norm_clip", "trimmed_mean", "geomedian")


def _norm_weights(weights) -> torch.Tensor:
    w = torch.as_tensor(weights, dtype=torch.float32)
    return w / torch.sum(w)


def _wavg(x, w):
    """Weighted average over the leading client axis, in x's dtype."""
    return torch.tensordot(w.to(x.device), x.float(), dims=([0], [0])).to(
        x.dtype)


def weighted_average(stacked: PyTree, weights) -> PyTree:
    """Canonical FedAvg: θ̄ = Σ p̃ᵢ θᵢ."""
    w = _norm_weights(weights)
    return tree.tree_map(lambda x: _wavg(x, w), stacked)


def dense_delta_average(stacked_deltas: PyTree, weights) -> PyTree:
    """FedAvg on dense target-module deltas."""
    return weighted_average(stacked_deltas, weights)


def factored_lift_average(delta_stack, basis, side: str, weights):
    """𝒜 for rank-r factored client deltas on a shared basis:
    ``Σᵢ wᵢ lift(Rᵢ, B) = lift(Σᵢ wᵢ Rᵢ, B)`` — a reduction in projected
    coordinates plus one rank-r lift. delta_stack (C, *batch, m, r) right |
    (C, *batch, r, n) left; basis (*batch, dim, r). Returns the fp32 dense
    weighted mean delta."""
    w = _norm_weights(weights).to(delta_stack.device)
    rbar = torch.einsum("k,k...->...", w, delta_stack.float())
    return proj.project_back(rbar, basis.float(), side)


def factored_lift_average_hetero(delta_stack, basis_stack, side: str,
                                 weights):
    """𝒜 for factored deltas with per-client bases (the adaptive round 0):
    ``Σᵢ wᵢ lift(Rᵢ, Bᵢ)`` contracted client by client, only the (m, n)
    output materialized. basis_stack (C, *batch, dim, r)."""
    w = _norm_weights(weights).to(delta_stack.device)
    d32, b32 = delta_stack.float(), basis_stack.float()
    if side == proj.RIGHT:
        return torch.einsum("k,k...mr,k...nr->...mn", w, d32, b32)
    return torch.einsum("k,k...mr,k...rn->...mn", w, b32, d32)


def robust_factored_lift(delta_stack, basis_stack, side: str, weights,
                         mode: str = "none", hetero: bool = False, **_kw):
    """𝒜 for one factored leaf: ``mode='none'`` is exactly
    :func:`factored_lift_average` (shared basis, client 0's) or
    :func:`factored_lift_average_hetero`. The robust modes are not ported
    yet."""
    if mode != "none":
        if mode not in ROBUST_MODES:
            raise ValueError(f"robust mode {mode!r} not in {ROBUST_MODES}")
        raise NotImplementedError(
            f"robust_factored_lift(mode={mode!r}) is not ported yet (ROADMAP "
            "Queue 1 item 10: population and robustness)")
    if hetero:
        return factored_lift_average_hetero(delta_stack, basis_stack, side,
                                            weights)
    return factored_lift_average(delta_stack, basis_stack[0], side, weights)

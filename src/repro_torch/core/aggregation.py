"""Server aggregation operators 𝒜 (port of ``repro/core/aggregation.py``,
Definition 3.2 + Table 1): FedAvg, the LoRA baselines' factor and lift
operators, and the GaLore methods' factored lifts.

Operators take client-stacked trees or tensors (leading client axis K)
and reduce them with normalized weights; stacked (nb, ·, ·) scan-block
leaves carry their layer axis through, as in the reference. The robust
modes are not ported yet (ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

from typing import Any

import torch

from . import projector as proj
from .lora import LoraPair, is_lora_pair, svd_truncate
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


def _is_adapter(x) -> bool:
    return x is None or is_lora_pair(x)


def factor_average(stacked_adapters: PyTree, weights) -> PyTree:
    """FedIT: average A and B factors separately.

    ΔW̄ = (Σ p̃ᵢ Bᵢ)(Σ p̃ᵢ Aᵢ) — stays rank ≤ r but is a biased estimate of
    the mean lift (the cross terms are dropped)."""
    w = _norm_weights(weights)

    def agg(ad):
        if ad is None:
            return None
        return LoraPair(a=_wavg(ad.a, w), b=_wavg(ad.b, w))

    return tree.tree_map(agg, stacked_adapters, is_leaf=_is_adapter)


def _mean_lift(ad, w):
    """Σ_k w_k B_k A_k in fp32 over the leading client axis, never
    materializing the K lifts; the ellipsis carries stacked (nb, ·, ·)
    leaves."""
    return torch.einsum("k,k...mr,k...rn->...mn", w.to(ad.a.device),
                        ad.b.float(), ad.a.float())


def lift_average(stacked_adapters: PyTree, weights, scale: float = 1.0
                 ) -> PyTree:
    """FLoRA / FR-LoRA: lift each client adapter to ΔWᵢ = scale·BᵢAᵢ and
    average in the ambient space (rank up to K·r). Returns a tree of fp32
    dense deltas (None for non-adapted leaves)."""
    w = _norm_weights(weights)

    def agg(ad):
        if ad is None:
            return None
        return scale * _mean_lift(ad, w)

    return tree.tree_map(agg, stacked_adapters, is_leaf=_is_adapter)


def lora_fair_refine(stacked_adapters: PyTree, weights, scale: float = 1.0,
                     ridge: float = 1e-6) -> PyTree:
    """LoRA-Fair: factor averaging followed by a server-side refinement of
    B̄ toward the true mean lift, ``B̄' = argmin_B ||scale·B Ā −
    ΔW̄_lift||²_F``, in closed form with a ridge term (batched over stacked
    scan-block leading dims)."""
    w = _norm_weights(weights)

    def agg(ad):
        if ad is None:
            return None
        a_bar = _wavg(ad.a, w).float()                     # (..., r, n)
        mean_lift = _mean_lift(ad, w)                      # (..., m, n)
        r = a_bar.shape[-2]
        gram = a_bar @ a_bar.mT + ridge * torch.eye(
            r, dtype=torch.float32, device=a_bar.device)
        b_ref = torch.linalg.solve(gram, a_bar @ mean_lift.mT).mT \
            / max(scale, 1e-12)
        return LoraPair(a=a_bar.to(ad.a.dtype), b=b_ref.to(ad.b.dtype))

    return tree.tree_map(agg, stacked_adapters, is_leaf=_is_adapter)


def fr_lora_merge(base_params: PyTree, stacked_adapters: PyTree, weights,
                  scale: float = 1.0) -> PyTree:
    """Lift-average the client adapters and merge the full-rank delta into
    the base weights (the residual beyond rank r is kept, in W0)."""
    deltas = lift_average(stacked_adapters, weights, scale)
    return tree.tree_map(lambda p, d: p if d is None else p + d.to(p.dtype),
                         base_params, deltas, is_leaf=lambda x: x is None)


def dense_delta_average(stacked_deltas: PyTree, weights) -> PyTree:
    """FedAvg on dense target-module deltas (FedAvg-Full / FedGaLore)."""
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


def truncate_to_rank(deltas: PyTree, rank: int) -> PyTree:
    """Post-hoc SVD truncation of dense deltas back to rank r (diagnostic /
    the 'Averaging + SVD' baseline of Appendix F)."""
    def trunc(d):
        if d is None:
            return None
        pair = svd_truncate(d.float(), rank)
        return (pair.b @ pair.a).to(d.dtype)

    return tree.tree_map(trunc, deltas, is_leaf=lambda x: x is None)

"""Server aggregation operators 𝒜 (port of ``repro/core/aggregation.py``,
Definition 3.2 + Table 1): FedAvg, the LoRA baselines' factor and lift
operators, and the GaLore methods' factored lifts.

Operators take client-stacked trees or tensors (leading client axis K)
and reduce them with normalized weights; stacked (nb, ·, ·) scan-block
leaves carry their layer axis through, as in the reference. The robust
section (defense against corrupted uploads) runs on the rank-r factored
(C, ·, r) stacks, never densifying.
"""
from __future__ import annotations

from typing import Any, Optional

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


# ------------------------------------------------- robust factored 𝒜 --------
#
# Client norms are basis-independent (the per-round bases are orthonormal,
# so ‖lift(R, B)‖_F = ‖R‖_F), which makes median-norm screening and
# clipping sound in factored coordinates. ``batch_dims`` counts the axes
# after the client axis whose entries are reduced independently (the
# shape buckets of 𝒮, which the reference maps with vmap); the axes after
# them form one client's vector, as a whole reference leaf does.

def _rest_dims(x, batch_dims: int) -> tuple:
    return tuple(range(1 + batch_dims, x.ndim))


def _per_client(v, x):
    """(C, *batch) ``v`` shaped to broadcast against (C, *batch, *rest)."""
    return v.reshape(tuple(v.shape) + (1,) * (x.ndim - v.ndim))


def client_sq_norms(stack, batch_dims: int = 0):
    """Per-client squared Frobenius norms of a (C, *batch, ...) stack in
    fp32, non-finite entries counting zero (the finiteness screen flags
    those clients; a NaN must not poison the median)."""
    s32 = stack.float()
    s32 = torch.where(torch.isfinite(s32), s32, 0.0)
    dims = _rest_dims(s32, batch_dims)
    return torch.sum(s32 * s32, dim=dims) if dims else s32 * s32


def weighted_quantile(x, w, q: float):
    """q-quantile over the client axis of (C, *batch) values under
    non-negative weights (C,) or (C, *batch): zero-weight entries are
    excluded. Stable sort, cumulative weights, left search, as the
    reference."""
    x32 = torch.as_tensor(x).float()
    w32 = torch.as_tensor(w, device=x32.device).float()
    w32 = _per_client(w32, x32).expand(x32.shape)
    xb, wb = x32.movedim(0, -1), w32.movedim(0, -1)      # (*batch, C)
    order = torch.argsort(xb, dim=-1, stable=True)
    xs = torch.take_along_dim(xb, order, -1)
    cw = torch.cumsum(torch.take_along_dim(wb, order, -1), -1)
    idx = torch.searchsorted(cw.contiguous(),
                             (q * cw[..., -1:]).contiguous(), side="left")
    idx = torch.clamp(idx, 0, x32.shape[0] - 1)
    return torch.take_along_dim(xs, idx, -1)[..., 0]


def median_norm_clip_factors(delta_stack, weights, eps: float = 1e-12,
                             batch_dims: int = 0):
    """Per-client clip factors cᵢ = min(1, med/‖Rᵢ‖) against the weighted
    median client norm: outliers shrink to the median scale, inliers pass
    (cᵢ = 1 exactly)."""
    n = torch.sqrt(client_sq_norms(delta_stack, batch_dims))
    med = weighted_quantile(n, weights, 0.5)
    return torch.minimum(torch.ones((), device=n.device),
                         med / torch.clamp(n, min=eps))


def robust_factored_reduce(delta_stack, weights, mode: str, *,
                           trim: float = 0.2, iters: int = 8,
                           eps: float = 1e-8, tol: float = 1e-6,
                           batch_dims: int = 0):
    """Robust weighted reduction over the client axis of a factored stack,
    the drop-in for the plain weighted mean (weights renormalized; zero
    weights vanish in every mode).

    norm_clip      Σ wᵢ cᵢ Rᵢ with median-norm clip factors cᵢ.
    trimmed_mean   coordinate-wise weighted trim: per coordinate each
                   sorted (stable) client's interval of the weight CDF is
                   clipped to [trim, 1-trim]; trim=0 is the weighted mean.
    geomedian      Weiszfeld iterations from the weighted mean, at most
                   ``iters``, stopping once the iterate moves less than
                   ``tol`` × the seed norm; distances floored at ``eps``.
                   Each batch entry stops on its own, as under vmap.

    Returns the reduced (*batch, ·, r) factor in fp32."""
    s32 = delta_stack.float()
    w = _norm_weights(weights).to(s32.device)
    if mode == "none":
        return torch.einsum("k,k...->...", w, s32)
    if mode == "norm_clip":
        c = median_norm_clip_factors(delta_stack, w, batch_dims=batch_dims)
        wc = _per_client(w, c) * c
        return torch.sum(_per_client(wc, s32) * s32, dim=0)
    if mode == "trimmed_mean":
        wb = _per_client(w, s32).expand(s32.shape)
        order = torch.argsort(s32, dim=0, stable=True)
        xs = torch.take_along_dim(s32, order, 0)
        ws = torch.take_along_dim(wb, order, 0)
        cum = torch.cumsum(ws, dim=0)          # total = 1 (w normalized)
        eff = torch.clamp(torch.clamp(cum, max=1.0 - trim)
                          - torch.clamp(cum - ws, min=trim), min=0.0)
        return (torch.sum(eff * xs, dim=0)
                / torch.clamp(torch.sum(eff, dim=0), min=eps))
    if mode == "geomedian":
        rest = tuple(range(batch_dims, s32.ndim - 1))
        y = torch.einsum("k,k...->...", w, s32)
        ref = torch.sqrt(torch.sum(y * y, dim=rest)) + eps
        moved = torch.full_like(ref, float("inf"))
        wb = _per_client(w, ref.expand((s32.shape[0],) + ref.shape))
        for _ in range(int(iters)):
            active = moved > tol * ref
            if not bool(active.any()):
                break
            d = torch.sqrt(client_sq_norms(s32 - y[None], batch_dims))
            inv = wb / torch.clamp(d, min=eps)
            inv = inv / torch.clamp(torch.sum(inv, dim=0), min=eps)
            y_new = torch.sum(_per_client(inv, s32) * s32, dim=0)
            step = torch.sqrt(torch.sum((y_new - y) ** 2, dim=rest))
            y = torch.where(_per_client(active, y), y_new, y)
            moved = torch.where(active, step, moved)
        return y
    raise ValueError(f"robust_agg mode {mode!r} not in {ROBUST_MODES}")


def rebase_factored_stack(stack, basis_stack, side: str):
    """Every client's factored coordinates re-expressed on client 0's basis
    through the r×r transfer Grams (right: Rᵢ(BᵢᵀB₀), left: (B₀ᵀBᵢ)Rᵢ),
    so coordinate-wise statistics are defined when bases diverge; the
    components outside the reference subspace are dropped."""
    s32, b32 = stack.float(), basis_stack.float()
    return proj.reproject(s32, b32, b32[0], side)


def robust_factored_lift(delta_stack, basis_stack, side: str, weights,
                         mode: str = "none", hetero: bool = False,
                         trim: float = 0.2, iters: int = 8,
                         tol: float = 1e-6):
    """Robust 𝒜 for one factored leaf: reduce the (C, ·, r) client stack
    with ``mode`` and lift once. ``mode='none'`` is exactly
    :func:`factored_lift_average` (client 0's basis) or, with ``hetero``,
    :func:`factored_lift_average_hetero`. With per-client bases norm_clip
    contracts client by client (its factors are basis-independent); the
    coordinate-wise modes first re-base onto client 0's basis."""
    if mode == "none":
        if hetero:
            return factored_lift_average_hetero(delta_stack, basis_stack,
                                                side, weights)
        return factored_lift_average(delta_stack, basis_stack[0], side,
                                     weights)
    if mode == "norm_clip":
        c = median_norm_clip_factors(delta_stack, _norm_weights(weights))
        d = delta_stack.float() * _per_client(c, delta_stack)
        if hetero:
            return factored_lift_average_hetero(d, basis_stack, side, weights)
        return factored_lift_average(d, basis_stack[0], side, weights)
    d32 = delta_stack.float()
    if hetero:
        d32 = rebase_factored_stack(d32, basis_stack, side)
    red = robust_factored_reduce(d32, weights, mode, trim=trim, iters=iters,
                                 tol=tol)
    return proj.project_back(red, basis_stack[0].float(), side)


def screen_factored_clients(delta_tree: PyTree, v_tree: Optional[PyTree],
                            scales, weights, zmax: float = 6.0):
    """The in-round quarantine screen: (C,) bool, True = passes. A client
    fails when any of its uplink leaves (accumulators, projected moments,
    base scale) is non-finite, or when its factored delta norm exceeds
    ``zmax`` × the weighted median norm (zero-weight clients neither vote
    nor shift it; a zero median disables the test)."""
    finite = torch.isfinite(scales.float())
    sq = torch.zeros_like(torch.as_tensor(weights, dtype=torch.float32,
                                          device=finite.device))
    for x in tree.tree_leaves(delta_tree):
        finite = finite & torch.isfinite(x.float()).flatten(1).all(1)
        sq = sq + client_sq_norms(x)
    if v_tree is not None:
        for x in tree.tree_leaves(v_tree, is_leaf=lambda x: x is None):
            if x is not None:
                finite = finite & torch.isfinite(x.float()).flatten(1).all(1)
    norm = torch.sqrt(sq)
    med = weighted_quantile(norm, torch.where(finite, weights, 0.0), 0.5)
    ok_norm = (med <= 0.0) | (norm <= zmax * med)
    return finite & ok_norm


def quarantine_weights(w, keep):
    """Fold a quarantine verdict into the round's weights: failed clients
    zeroed, survivors renormalized. An all-pass verdict returns ``w``
    bitwise (the honest round's identity); an all-fail one keeps ``w``
    over fully sanitized stacks — a skipped round, not NaNs."""
    wq = torch.where(keep, w, 0.0)
    s = torch.sum(wq)
    return torch.where(torch.all(keep), w,
                       torch.where(s > 0, wq / torch.clamp(s, min=1e-30), w))


def mask_client_rows(t: PyTree, keep) -> PyTree:
    """Zero the client rows that failed quarantine, by selection: 0·NaN is
    NaN, and an all-true verdict returns every leaf bitwise."""
    def one(x):
        if x is None:
            return None
        return torch.where(_per_client(keep, x), x,
                           torch.zeros((), dtype=x.dtype, device=x.device))
    return tree.tree_map(one, t, is_leaf=lambda x: x is None)


def truncate_to_rank(deltas: PyTree, rank: int) -> PyTree:
    """Post-hoc SVD truncation of dense deltas back to rank r (diagnostic /
    the 'Averaging + SVD' baseline of Appendix F)."""
    def trunc(d):
        if d is None:
            return None
        pair = svd_truncate(d.float(), rank)
        return (pair.b @ pair.a).to(d.dtype)

    return tree.tree_map(trunc, deltas, is_leaf=lambda x: x is None)

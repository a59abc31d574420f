"""State synchronization protocols 𝒮 (port of ``repro/core/state_sync.py``,
Definition 3.3 + Algorithm 1 line 12).

Inputs are client-stacked projected second moments ṽ (leading client
axis, further leading dims a batch) and the bases they live on.
Protocols:

  none     — clients reinitialize adaptive states each round;
  avg      — weighted average of ṽ;
  avg_svd  — average then rank-r SVD re-projection (the identity on a
             shared-basis rank-≤r lift, so it equals avg there);
  ajive    — the paper's protocol (``core.ajive``).

The dense protocols (:data:`SYNC_PROTOCOLS`, :func:`sync_lifted_views`,
:func:`sync_block`) lift the views to (K, m, n) and return the lifted
synchronized state; they are the eager oracle round's 𝒮 where bases
differ. Shared-basis rounds sync directly on ṽ
(:func:`sync_block_synced_factored`); the adaptive round 0, whose clients
refreshed onto their own bases, closes the lift → sync →
re-project-onto-client-0 round trip over r×r transfer Grams
(:func:`sync_block_hetero_factored`). :func:`map_sync_leaves` runs one
batched program per shape bucket. ``robust`` (the guarded round) replaces
the weighted means over the projected-moment stacks with the matching
``aggregation.robust_factored_reduce`` mode.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import aggregation as agg
from . import projector as proj
from .ajive import (_inv_sqrt_rank_safe, ajive_sync,
                    ajive_sync_factored, ajive_sync_hetero_factored,
                    normalize_weights)
from .galore import bucket_by_shape
from ..kernels.ops import nan_safe_eigh


# ------------------------------------------------- dense (lifted) views ----

def lift_views(v_stack, basis, side: str):
    """ṽ (K, m, r) + basis (n, r) -> views (K, m, n) [right side]; left is
    (K, r, n) + (m, r) -> (K, m, n)."""
    if side == proj.RIGHT:
        return torch.einsum("kmr,nr->kmn", v_stack, basis)
    return torch.einsum("mr,krn->kmn", basis, v_stack)


def project_state(lifted, basis, side: str):
    """Re-project a lifted (..., m, n) state onto a (possibly new) basis
    (..., dim, r); leading dims batch."""
    if side == proj.RIGHT:
        return lifted @ basis                  # (m,n)@(n,r) -> (m,r)
    return basis.mT @ lifted                   # (r,m)@(m,n) -> (r,n)


def _svd_rank(avg, rank: int):
    u, s, vt = proj._svd(avg)
    return (u[..., :rank] * s[..., None, :rank]) @ vt[..., :rank, :]


def sync_none(v_stack, basis, side, weights=None, rank=None):
    return None


def sync_avg(v_stack, basis, side, weights=None, rank=None):
    w = normalize_weights(weights, v_stack.shape[0], device=v_stack.device)
    views = lift_views(v_stack.float(), basis, side)
    return torch.einsum("k,kmn->mn", w, views)


def sync_avg_svd(v_stack, basis, side, weights=None, rank=None):
    avg = sync_avg(v_stack, basis, side, weights)
    return _svd_rank(avg, rank if rank is not None else basis.shape[1])


def sync_ajive(v_stack, basis, side, weights=None, rank=None):
    """The paper's 𝒮: spectral shared-signal extraction across client
    views."""
    r = rank if rank is not None else basis.shape[1]
    views = lift_views(v_stack.float(), basis, side)
    return ajive_sync(views, rank=r, weights=weights)


SYNC_PROTOCOLS = {
    "none": sync_none,
    "avg": sync_avg,
    "avg_svd": sync_avg_svd,
    "ajive": sync_ajive,
}


def sync_lifted_views(protocol: str, views, weights=None,
                      rank: Optional[int] = None):
    """Run protocol 𝒮 on already-lifted (k, *batch, m, n) views — the
    dense reference dispatch, for clients that lifted with heterogeneous
    bases; each batch entry (a stacked scan block) is synced on its
    own."""
    if protocol == "ajive":
        return ajive_sync(views, rank=rank, weights=weights)
    avg = torch.einsum("k,k...->...", normalize_weights(
        weights, views.shape[0], device=views.device), views)
    if protocol == "avg":
        return avg
    if protocol == "avg_svd":
        return _svd_rank(avg, rank)
    raise ValueError(protocol)


def sync_block(protocol: str, v_stack, old_basis, new_basis, side: str,
               weights=None, rank: Optional[int] = None):
    """One adapted block end to end: lift with the round-k basis,
    synchronize, re-project onto the round-(k+1) basis, clamped at 0.
    Returns the next-round ṽ init, or None for 'none'. The dense
    reference path (materializes (k, m, n) views)."""
    lifted = SYNC_PROTOCOLS[protocol](v_stack, old_basis, side, weights,
                                      rank)
    if lifted is None:
        return None
    return torch.clamp(project_state(lifted, new_basis, side), min=0.0)


def sync_block_synced_factored(protocol: str, v_stack, side: str,
                               weights=None, rank: Optional[int] = None,
                               exclude_zero_weights: bool = False,
                               robust: str = "none", trim: float = 0.2,
                               iters: int = 8, tol: float = 1e-6,
                               batch_dims: int = 0):
    """Run protocol 𝒮 on shared-basis projected moments ``v_stack`` (C,
    *batch, ·, ·): returns the synced state on the round-k basis, or None
    for 'none'. ``exclude_zero_weights`` drops zero-weight clients from
    the AJIVE joint-basis estimate. ``robust`` replaces the protocols'
    weighted mean with the matching robust reduction ('none' is bitwise
    the plain path); for avg/avg_svd a client's vector is the whole leaf
    after its first ``batch_dims`` axes (a stacked shape bucket), as the
    reference reduces a stacked scan-block leaf jointly."""
    if protocol == "none":
        return None
    if protocol in ("avg", "avg_svd"):
        if robust != "none":
            return agg.robust_factored_reduce(
                v_stack, weights, robust, trim=trim, iters=iters, tol=tol,
                batch_dims=batch_dims)
        w = normalize_weights(weights, v_stack.shape[0],
                              device=v_stack.device)
        return torch.einsum("c,c...->...", w, v_stack.float())
    if protocol == "ajive":
        r = rank if rank is not None else (
            v_stack.shape[-1] if side == proj.RIGHT else v_stack.shape[-2])
        return ajive_sync_factored(v_stack, rank=r, weights=weights,
                                   side=side,
                                   exclude_zero_weights=exclude_zero_weights,
                                   robust=robust, trim=trim, iters=iters,
                                   tol=tol)
    raise ValueError(protocol)


# ------------------------------------------- heterogeneous-basis factored --

def transfer_grams(b_stack):
    """Per-client r×r basis-change transfers ``T_i = Q_iᵀ Q_0`` onto the
    client-0 basis: (C, *batch, dim, r) -> (C, *batch, r, r)."""
    b32 = b_stack.float()
    return torch.einsum("c...dr,...ds->c...rs", b32, b32[0])


def _gram_orth(gram):
    """Rank-safe orthonormalization of a factor ``X`` from its Gram ``XᵀX``:
    (coeff, rfac) with ``Q = X @ coeff`` orthonormal (null directions
    zeroed) and ``X = Q @ rfac``."""
    lam, vec = nan_safe_eigh(gram)
    lam = torch.clamp(torch.flip(lam, [-1]), min=0.0)
    vec = torch.flip(vec, [-1])
    coeff = vec * _inv_sqrt_rank_safe(lam)[..., None, :]
    rfac = (vec * torch.sqrt(lam)[..., None, :]).mT
    return coeff, rfac


def _hetero_avg_svd(v32, b32, w, rank: int, side: str):
    """Rank-``rank`` SVD of the weighted average of heterogeneously lifted
    views, on the client-0 basis, through the two skinny factors of
    ``A = Σ wᵢ lift(ṽ^i, Q_i)`` and their (C·r)² Grams — the dense (m, n)
    average is never formed. ``v32`` (*batch, C, ·, ·), ``b32`` (*batch, C,
    dim, r)."""
    c, r = v32.shape[-3], b32.shape[-1]
    lead = v32.shape[:-3]
    t_stack = torch.einsum("...cdr,...ds->...crs", b32,
                           b32[..., 0, :, :]).reshape(lead + (c * r, r))
    wv = w[:, None, None] * v32
    chat = b32.movedim(-3, -2).reshape(lead + (b32.shape[-2], c * r))
    cc, rc = _gram_orth(chat.mT @ chat)
    if side == proj.RIGHT:
        # A = Û Ĉᵀ, Û = [wᵢ ṽ^i] (m, C·r), Ĉ = [Q_i] (n, C·r)
        uhat = wv.movedim(-3, -2).reshape(lead + (v32.shape[-2], c * r))
        cu, ru = _gram_orth(uhat.mT @ uhat)
        p, s, wt = torch.linalg.svd(ru @ rc.mT)
        left = uhat @ (cu @ p[..., :rank])
        right = wt[..., :rank, :] @ (cc.mT @ t_stack)
        return (left * s[..., None, :rank]) @ right
    # A = Ĉ V̂, Ĉ = [Q_i] (m, C·r), V̂ = [wᵢ ṽ^i] stacked rows (C·r, n)
    vhat = wv.reshape(lead + (c * r, v32.shape[-1]))
    cv, rv = _gram_orth(vhat @ vhat.mT)
    p, s, wt = torch.linalg.svd(rc @ rv.mT)
    left = t_stack.mT @ (cc @ p[..., :rank])
    right = (wt[..., :rank, :] @ cv.mT) @ vhat
    return (left * s[..., None, :rank]) @ right


def sync_block_hetero_factored(protocol: str, v_stack, b_stack, side: str,
                               weights=None, rank: Optional[int] = None,
                               exclude_zero_weights: bool = False,
                               robust: str = "none", trim: float = 0.2,
                               iters: int = 8, tol: float = 1e-6):
    """Factored 𝒮 for heterogeneous client bases (the adaptive round 0):
    ``v_stack`` (C, *batch, ·, ·), ``b_stack`` (C, *batch, dim, r). Returns
    the synced state in projected shape on the client-0 basis, or None for
    'none'. ``robust`` avg/avg_svd re-base the stacks onto client 0's
    coordinates and reduce them robustly (on rank-≤r rows the SVD
    re-projection is the identity, so the two coincide), each batch entry
    on its own as under the reference's vmap; AJIVE's joint components
    are on client 0 already and reduce directly."""
    if protocol == "none":
        return None
    r = b_stack.shape[-1]
    rank = rank if rank is not None else r
    w = normalize_weights(weights, v_stack.shape[0], device=v_stack.device)
    if protocol == "ajive":
        return ajive_sync_hetero_factored(
            v_stack, b_stack, rank, weights, side,
            exclude_zero_weights=exclude_zero_weights, robust=robust,
            trim=trim, iters=iters, tol=tol)
    v32, b32 = v_stack.float(), b_stack.float()
    if robust != "none":
        based = agg.rebase_factored_stack(v32, b32, side)
        return agg.robust_factored_reduce(
            based, weights, robust, trim=trim, iters=iters, tol=tol,
            batch_dims=v32.ndim - 3)
    if protocol == "avg":
        t = transfer_grams(b32)                          # (C, *B, r, r)
        if side == proj.RIGHT:
            return torch.einsum("c,c...mr,c...rs->...ms", w, v32, t)
        return torch.einsum("c,c...rs,c...rn->...sn", w, t, v32)
    if protocol == "avg_svd":
        return _hetero_avg_svd(v32.movedim(0, -3), b32.movedim(0, -3), w,
                               rank, side)
    raise ValueError(protocol)


def map_sync_leaves(leaf_fn, v_leaves, b_leaves):
    """Apply ``leaf_fn(v_stack, b_stack, n_batch) -> synced`` over parallel
    per-leaf lists of client-stacked (C, ·) moments and bases, one batched
    program per shape bucket: the leaves of a bucket stack along a new
    axis after the client axis (``n_batch`` = 1; 0 for a lone leaf), so
    the bucket's small eigensolves run as one batch. ``None`` v-leaves
    (non-adapted blocks) pass through as ``None``."""
    out = [None] * len(v_leaves)
    keys = [None if v is None else
            (tuple(v.shape), str(v.dtype), tuple(b.shape), str(b.dtype))
            for v, b in zip(v_leaves, b_leaves)]
    buckets, _ = bucket_by_shape(keys)
    for _, idxs in buckets:
        if len(idxs) == 1:
            out[idxs[0]] = leaf_fn(v_leaves[idxs[0]], b_leaves[idxs[0]], 0)
            continue
        vs = torch.stack([v_leaves[i] for i in idxs], dim=1)
        bs = torch.stack([b_leaves[i] for i in idxs], dim=1)
        res = leaf_fn(vs, bs, 1)
        for j, i in enumerate(idxs):
            out[i] = res[j]
    return out


def sync_block_factored(protocol: str, v_stack, old_basis, new_basis,
                        side: str, weights=None, rank: Optional[int] = None):
    """Factored counterpart of :func:`sync_block`: synchronize in projected
    coordinates, then change basis with the r×r transfer — the dense (m, n)
    lift is never built. Assumes a basis shared by every client."""
    synced = sync_block_synced_factored(protocol, v_stack, side, weights,
                                        rank)
    if synced is None:
        return None
    return torch.clamp(proj.reproject(synced, old_basis, new_basis, side),
                       min=0.0)

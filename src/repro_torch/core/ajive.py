"""Factored AJIVE second-moment sync (port of the factored section of
``repro/core/ajive.py``, lines 194-540).

Every federated input has rank ≤ r (ṽ is (·, r) and the basis is
orthonormal), so AJIVE's three phases run on the projected moments:

  Phase 1  per-view orthonormal scores from the r×r Gram ``ṽᵀṽ`` — a
           batched small eigensolve (``kernels.ops.batched_small_eigh``:
           the Jacobi kernel on the card, LAPACK on the CPU);
  Phase 2  the joint basis of the stacked scores (:func:`_joint_basis`:
           an exact small Gram, the exact (C·k)² right Gram, or a seeded
           sketched Rayleigh–Ritz);
  Phase 3  the per-view joint component ``U Uᵀ ṽ`` as two skinny GEMMs.

Layout: the public functions take the client axis first, as the
reference does — ``v_stack (C, *batch, m, r)`` right or ``(C, *batch, r,
n)`` left — and treat any further leading dims as a batch where the
reference vmaps (stacked layers, stacked buckets), so a whole bucket's
Phase-1 Grams go through one eigensolve. Internally the client axis sits
at -3. The dense ``ajive`` oracle and the robust reductions are not
ported (ROADMAP Queue 1 item 10 carries the robust modes).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels import ops as kernel_ops
from ..utils import prng


def normalize_weights(weights, k: int, device=None) -> torch.Tensor:
    """Client weights as a normalized fp32 simplex point (None = uniform)."""
    if weights is None:
        return torch.full((k,), 1.0 / k, dtype=torch.float32, device=device)
    w = torch.as_tensor(weights, dtype=torch.float32, device=device)
    return w / torch.sum(w)


def _no_robust(robust: str) -> None:
    if robust != "none":
        raise NotImplementedError(
            f"robust={robust!r}: robust reductions are not ported yet "
            "(ROADMAP Queue 1 item 10: population and robustness)")


def _topk_eig_desc(sym, k: int):
    """Top-k eigenpairs of small symmetric PSD matrices, descending."""
    lam, vec = torch.linalg.eigh(sym)
    lam = torch.clamp(torch.flip(lam, [-1]), min=0.0)
    vec = torch.flip(vec, [-1])
    return lam[..., :k], vec[..., :k]


def _topk_eig_desc_stack(sym, k: int, mask=None):
    """Top-k eigenpairs of a (..., n, n) symmetric PSD stack, descending, as
    one batched solve routed through ``kernels.ops.batched_small_eigh``.
    ``mask`` (batch-shaped bool) solves masked entries as the identity with
    zero eigenvalues."""
    lam, vec = kernel_ops.batched_small_eigh(sym, mask=mask)
    lam = torch.clamp(torch.flip(lam, [-1]), min=0.0)
    vec = torch.flip(vec, [-1])
    return lam[..., :k], vec[..., :k]


def _inv_sqrt_rank_safe(lam, rel_tol: float = 1e-10):
    """1/√λ per eigendirection, with numerically-null directions
    (λ ≤ rel_tol·λ_max, λ sorted descending) mapped to 0."""
    keep = lam > rel_tol * lam[..., :1]
    return torch.where(keep, 1.0 / torch.sqrt(torch.where(keep, lam, 1.0)),
                       0.0)


def _factored_joint_scores(scores, joint_rank: int):
    """Phase 2 on stacked scores S (..., d, C·k) via the (C·k)×(C·k) Gram:
    ``u_joint = S W Λ^{-1/2}``."""
    lam, w = _topk_eig_desc(scores.mT @ scores, joint_rank)
    return scores @ (w * _inv_sqrt_rank_safe(lam)[..., None, :])


_EXACT_JOINT_DIM = 64      # largest Gram solved exactly in the joint basis
_SKETCH_SEED = 0x5CE7C4    # fixed key: the sketch is deterministic by design


def _keep_mask_cols(lam, vec, rel_tol: float = 1e-10):
    """Zero eigenvector columns of numerically-null directions."""
    keep = lam > rel_tol * lam[..., :1]
    return vec * keep[..., None, :].to(vec.dtype)


def _joint_basis_sketch(scores, k: int, oversample: int = 8, iters: int = 2):
    """Sketched Rayleigh–Ritz top-k basis of S Sᵀ from per-client stacks
    (..., C, d, k₁): randomized subspace iteration from the fixed key,
    column-normalized between passes, a QR range basis, and an s×s Ritz
    eigenproblem."""
    d = scores.shape[-2]
    s = min(d, max(16, k + oversample))
    y = prng.normal(prng.PRNGKey(_SKETCH_SEED, device=scores.device), (d, s))
    for _ in range(iters):
        z = torch.einsum("...cdk,...ds->...cks", scores, y)
        y = torch.einsum("...cdk,...cks->...ds", scores, z)
        y = y / (torch.linalg.vector_norm(y, dim=-2, keepdim=True) + 1e-30)
    q, _ = torch.linalg.qr(y)
    b = torch.einsum("...cdk,...ds->...cks", scores, q)
    m = torch.einsum("...cks,...ckt->...st", b, b)
    lam, vec = _topk_eig_desc(m, k)
    return q @ _keep_mask_cols(lam, vec)


def _joint_basis(scores, k: int):
    """Phase-2 joint basis from per-client score stacks (..., C, d, k₁), by
    the reference's static routes: ``d ≤ 64`` — the exact d×d left Gram;
    ``C·k₁ ≤ 64`` — the exact right Gram; otherwise the sketch. Every
    route zeroes the columns of numerically-null directions."""
    c_views, d, k1 = scores.shape[-3:]
    if d <= _EXACT_JOINT_DIM:
        gram = torch.einsum("...cdk,...cek->...de", scores, scores)
        lam, vec = _topk_eig_desc(gram, k)
        return _keep_mask_cols(lam, vec)
    if c_views * k1 <= _EXACT_JOINT_DIM:
        stacked = scores.movedim(-3, -2).reshape(
            scores.shape[:-3] + (d, c_views * k1))
        return _factored_joint_scores(stacked, k)
    return _joint_basis_sketch(scores, k)


def _participation_mask(weights, exclude_zero_weights: bool,
                        device) -> Optional[torch.Tensor]:
    """Per-client bool mask of nonzero weights, when zero-weight clients
    are to be excluded from the joint basis."""
    if not exclude_zero_weights or weights is None:
        return None
    return torch.as_tensor(weights, dtype=torch.float32, device=device) > 0


def _mask_score_cols(scores, mask):
    """Zero the (..., C, ·, k) score stacks of masked-out clients, by
    selection (a multiplicative mask would let 0·NaN through)."""
    if mask is None:
        return scores
    return torch.where(mask[:, None, None], scores, 0.0)


def _batch_mask(mask, gram):
    return None if mask is None else mask.expand(gram.shape[:-2])


def ajive_sync_factored(v_stack, rank: int, weights=None,
                        side: str = "right",
                        exclude_zero_weights: bool = False,
                        robust: str = "none", **_robust_kw):
    """Server-side second-moment sync on projected moments (Alg. 1 l.12)
    for a shared orthonormal basis. ``v_stack`` (C, *batch, m, r) right |
    (C, *batch, r, n) left. Returns the weighted joint estimate in
    projected shape, (*batch, m, r) | (*batch, r, n)."""
    _no_robust(robust)
    a = v_stack.float().movedim(0, -3)             # (*B, C, m, r)|(*B, C, r, n)
    c_views = a.shape[-3]
    r = a.shape[-1] if side == "right" else a.shape[-2]
    k = min(rank, r)
    mask = _participation_mask(weights, exclude_zero_weights, a.device)
    if side == "right":
        gram = torch.einsum("...cmr,...cms->...crs", a, a)
        lam, wv = _topk_eig_desc_stack(gram, k, mask=_batch_mask(mask, gram))
        scores = torch.einsum("...cmr,...crk->...cmk", a, wv)
        scores = scores * _inv_sqrt_rank_safe(lam)[..., None, :]
        scores = _mask_score_cols(scores, mask)
        u_joint = _joint_basis(scores, k)                  # (*B, m, k)
        joint = torch.einsum("...mj,...cjr->...cmr", u_joint,
                             torch.einsum("...mj,...cmr->...cjr", u_joint, a))
    else:
        # The shared orthonormal B cancels from every Gram: Phases 1–3 run
        # wholly in the r-dimensional coefficient space.
        gram = torch.einsum("...crn,...csn->...crs", a, a)
        _, wv = _topk_eig_desc_stack(gram, k, mask=_batch_mask(mask, gram))
        wv = _mask_score_cols(wv, mask)
        q = _joint_basis(wv, k)                            # (*B, r, k)
        joint = torch.einsum("...rj,...cjn->...crn", q,
                             torch.einsum("...rj,...crn->...cjn", q, a))
    w = normalize_weights(weights, c_views, device=a.device)
    return torch.einsum("c,...cij->...ij", w, joint)


def ajive_sync_hetero_factored(v_stack, b_stack, rank: int, weights=None,
                               side: str = "right",
                               exclude_zero_weights: bool = False,
                               robust: str = "none", **_robust_kw):
    """Factored AJIVE 𝒮 for heterogeneous client bases (the adaptive round
    0): client i lifted its ṽ with its own orthonormal basis ``Q_i``; the
    result is expressed on the client-0 basis. Right: Phases 1–2 are
    basis-free and the r×r transfer ``T_i = Q_iᵀ Q_0`` enters Phase 3;
    left: the scores lift as ``Q_i u^i`` and Phase 3 is
    ``(Q_0ᵀ U)(Uᵀ Q_i) ṽ^i``. ``b_stack`` (C, *batch, dim, r)."""
    _no_robust(robust)
    a = v_stack.float().movedim(0, -3)
    b = b_stack.float().movedim(0, -3)             # (*B, C, dim, r)
    c_views = a.shape[-3]
    r = a.shape[-1] if side == "right" else a.shape[-2]
    k = min(rank, r)
    mask = _participation_mask(weights, exclude_zero_weights, a.device)
    b0 = b[..., 0, :, :]
    if side == "right":
        gram = torch.einsum("...cmr,...cms->...crs", a, a)
        lam, wv = _topk_eig_desc_stack(gram, k, mask=_batch_mask(mask, gram))
        scores = torch.einsum("...cmr,...crk->...cmk", a, wv)
        scores = scores * _inv_sqrt_rank_safe(lam)[..., None, :]
        scores = _mask_score_cols(scores, mask)
        u_joint = _joint_basis(scores, k)
        joint = torch.einsum("...mj,...cjr->...cmr", u_joint,
                             torch.einsum("...mj,...cmr->...cjr", u_joint, a))
        transfer = torch.einsum("...cdr,...ds->...crs", b, b0)
        joint = torch.einsum("...cmr,...crs->...cms", joint, transfer)
    else:
        gram = torch.einsum("...crn,...csn->...crs", a, a)
        _, wv = _topk_eig_desc_stack(gram, k, mask=_batch_mask(mask, gram))
        scores = torch.einsum("...cdr,...crk->...cdk", b, wv)
        scores = _mask_score_cols(scores, mask)
        u_joint = _joint_basis(scores, k)                  # (*B, dim, k)
        t0 = torch.einsum("...dr,...dk->...rk", b0, u_joint)
        ti = torch.einsum("...cdr,...dk->...crk", b, u_joint)
        joint = torch.einsum("...rk,...csk,...csn->...crn", t0, ti, a)
    w = normalize_weights(weights, c_views, device=a.device)
    return torch.einsum("c,...cij->...ij", w, joint)

"""AJIVE second-moment sync (port of ``repro/core/ajive.py``): the dense
Algorithm 5 (Appendix E) and its factored fast path.

The dense :func:`ajive` runs on lifted (k_views, n, m) views:

  Phase 1  per-view economy SVD at an initial signal rank; singular-value
           threshold at the r/r+1 midpoint;
  Phase 2  joint SVD of the concatenated scores; joint rank fixed (the
           paper's k = r) or estimated from the Wedin and random-direction
           bounds, drawn through the port's threefry ``split``/``normal``;
  Phase 3  per-view ``X = J + I + E``.

:func:`ajive_sync` is the eager oracle round's 𝒮 on dense lifted views;
it needs only the joint components, so it stops after Phase 2 and applies
the joint projector (the individual SVDs of Phase 3 do not enter its
result). Its SVDs go through ``core.projector``'s (LAPACK ``gesdd``
through SciPy on the CPU, as JAX's).

Every federated input has rank ≤ r (ṽ is (·, r) and the basis is
orthonormal), so the factored fast path runs AJIVE's three phases on the
projected moments:

  Phase 1  per-view orthonormal scores from the r×r Gram ``ṽᵀṽ`` — a
           batched small eigensolve (``kernels.ops.batched_small_eigh``:
           the Jacobi kernel on the card, LAPACK on the CPU);
  Phase 2  the joint basis of the stacked scores (:func:`_joint_basis`:
           an exact small Gram, the exact (C·k)² right Gram, or a seeded
           sketched Rayleigh–Ritz);
  Phase 3  the per-view joint component ``U Uᵀ ṽ`` as two skinny GEMMs.

Layout: the factored functions take the client axis first, as the
reference does — ``v_stack (C, *batch, m, r)`` right or ``(C, *batch, r,
n)`` left — and treat any further leading dims as a batch where the
reference vmaps (stacked layers, stacked buckets), so a whole bucket's
Phase-1 Grams go through one eigensolve. Internally the client axis sits
at -3. ``robust`` (the guarded round) reduces the per-client joint
components with ``aggregation.robust_factored_reduce``, each batch entry
on its own.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from . import aggregation as agg
from . import projector as proj
from ..kernels import ops as kernel_ops
from ..utils import prng


class AjiveResult(NamedTuple):
    joint: torch.Tensor        # (k_views, n, m) per-view joint components
    individual: torch.Tensor   # (k_views, n, m) per-view individual I^(i)
    noise: torch.Tensor        # (k_views, n, m) E^(i)
    joint_basis: torch.Tensor  # (n, r_joint) shared column basis U_joint
    joint_mean: torch.Tensor   # (n, m) mean of the joint components
    sv_joint: torch.Tensor     # singular values of the stacked scores


def _center(x):
    return x - torch.mean(x, dim=0, keepdim=True)


def _rank_truncate(x, rank: int):
    u, s, vt = proj._svd(x)
    return u[:, :rank], s[:rank], vt[:rank], s


def wedin_bound(x, u, s, vt, key, n_samples: int = 20) -> torch.Tensor:
    """Resampled Wedin-style perturbation bound for one view (Phase 2 aid):
    the 95th percentile of ``max(|E dv|, |Eᵀ du|)`` over random unit
    directions, over the smallest kept singular value, capped at 1."""
    resid = x - (u * s[None, :]) @ vt
    n, m = x.shape
    kk = prng.split(key, n_samples)                  # (S, 2)
    kv_ku = prng.split(kk)                           # (S, 2, 2)
    dv = prng.normal(kv_ku[:, 0], (m,))
    dv = dv / (torch.linalg.vector_norm(dv, dim=-1, keepdim=True) + 1e-12)
    du = prng.normal(kv_ku[:, 1], (n,))
    du = du / (torch.linalg.vector_norm(du, dim=-1, keepdim=True) + 1e-12)
    vals = torch.maximum(torch.linalg.vector_norm(dv @ resid.T, dim=-1),
                         torch.linalg.vector_norm(du @ resid, dim=-1))
    est = torch.quantile(vals, 0.95)       # jnp.percentile's interpolation
    return torch.clamp(est / (s[-1] + 1e-12), max=1.0)


def random_direction_bound(shapes: Sequence[tuple], ranks: Sequence[int],
                           key, n_samples: int = 20) -> torch.Tensor:
    """Null distribution of the top squared singular value of stacked
    random orthonormal score matrices (Phase 2's random bound): its 95th
    percentile over ``n_samples`` draws."""
    keys = prng.split(key, n_samples)                # (S, 2)
    subkeys = prng.split(keys, len(shapes))          # (S, V, 2)
    mats = []
    for i, ((n, _), r) in enumerate(zip(shapes, ranks)):
        q, _ = torch.linalg.qr(prng.normal(subkeys[:, i], (n, r)))
        mats.append(q)
    s = torch.linalg.svdvals(torch.cat(mats, dim=-1))
    return torch.quantile(s[:, 0] ** 2, 0.95)


def _signal_scores(views, signal_ranks):
    """Phase 1: each view's top singular triplets at its signal rank and
    the r/r+1 midpoint threshold."""
    svds, thresholds = [], []
    u_all, s_all, vt_all = proj._svd(views)           # every view at once
    for i, r in enumerate(signal_ranks):
        u, s, vt = u_all[i][:, :r], s_all[i][:r], vt_all[i][:r]
        s_full = s_all[i]
        nxt = s_full[r] if r < s_full.shape[0] else torch.zeros(
            (), dtype=s_full.dtype, device=s_full.device)
        thresholds.append(0.5 * (s_full[r - 1] + nxt))
        svds.append((u, s, vt))
    return svds, thresholds


def _joint_scores(views, svds, signal_ranks, joint_rank, key):
    """Phase 2: (u_joint, singular values of the stacked scores, rank)."""
    k_views, n, m = views.shape
    stacked = torch.cat([u for u, _, _ in svds], dim=1)     # (n, sum r_i)
    u_joint_full, d_joint, _ = proj._svd(stacked)
    if joint_rank is not None:
        return (u_joint_full[:, :joint_rank], d_joint,
                torch.tensor(joint_rank))
    if key is None:
        key = prng.PRNGKey(0, device=views.device)
    kw, kr = prng.split(key)
    wkeys = prng.split(kw, k_views)
    wedin_cut = sum(1.0 - torch.clamp(
        wedin_bound(views[i], *svds[i], wkeys[i]), max=1.0) ** 2
        for i in range(k_views))
    wedin_cut = k_views - wedin_cut + 1e-6            # cutoff on squared SVs
    rand_cut = random_direction_bound([(n, m)] * k_views, signal_ranks, kr)
    cutoff = torch.maximum(wedin_cut, rand_cut)
    rank_mask = d_joint ** 2 > cutoff
    max_joint = min(min(signal_ranks), u_joint_full.shape[1])
    mask = rank_mask[:max_joint].to(views.dtype)
    return (u_joint_full[:, :max_joint] * mask[None, :], d_joint,
            torch.sum(rank_mask[:max_joint]))


def _signal_ranks(signal_ranks, k_views):
    if isinstance(signal_ranks, int):
        return [signal_ranks] * k_views
    return list(signal_ranks)


def ajive(views, signal_ranks, joint_rank: Optional[int] = None,
          individual_ranks=None, center: bool = True, key=None,
          return_rank_diag: bool = False):
    """Run AJIVE on ``views`` of shape (k_views, n, m).

    ``signal_ranks``: int or per-view list — Phase 1 initial signal rank.
    ``joint_rank``: fixed joint rank (paper: k = r). If None, estimated
    from the Wedin/random bounds with ``key`` (default ``PRNGKey(0)``); the
    estimate masks a max-rank basis, as the reference's static shapes do.
    """
    k_views = views.shape[0]
    signal_ranks = _signal_ranks(signal_ranks, k_views)
    if center:
        views = torch.stack([_center(x) for x in views])
    svds, thresholds = _signal_scores(views, signal_ranks)
    u_joint, d_joint, est_rank = _joint_scores(views, svds, signal_ranks,
                                               joint_rank, key)

    # Phase 3: per-view decomposition
    proj_joint = u_joint @ u_joint.T                 # (n, n) joint projector
    joints, individuals, noises = [], [], []
    for i in range(k_views):
        x = views[i]
        j = proj_joint @ x
        r_ind = (individual_ranks[i] if individual_ranks is not None
                 else signal_ranks[i])
        ui, si, vti, _ = _rank_truncate(x - j, r_ind)
        keep = (si > thresholds[i]).to(x.dtype)    # above the view threshold
        ind = (ui * (si * keep)[None, :]) @ vti
        joints.append(j)
        individuals.append(ind)
        noises.append(x - j - ind)

    joint = torch.stack(joints)
    result = AjiveResult(joint=joint, individual=torch.stack(individuals),
                         noise=torch.stack(noises), joint_basis=u_joint,
                         joint_mean=torch.mean(joint, dim=0),
                         sv_joint=d_joint)
    if return_rank_diag:
        return result, est_rank
    return result


def normalize_weights(weights, k: int, device=None) -> torch.Tensor:
    """Client weights as a normalized fp32 simplex point (None = uniform)."""
    if weights is None:
        return torch.full((k,), 1.0 / k, dtype=torch.float32, device=device)
    w = torch.as_tensor(weights, dtype=torch.float32, device=device)
    return w / torch.sum(w)


def ajive_sync(views, rank: int, weights=None) -> torch.Tensor:
    """Server-side second-moment sync on dense lifted views (Algorithm 1,
    line 12): ``views`` (k_views, *batch, n, m) = ṽ^{i} R_kᵀ, each batch
    entry (a stacked scan block) synced on its own, as under the
    reference's vmap. Returns the weighted mean of the per-view joint
    components (*batch, n, m), joint rank ``rank`` — :func:`ajive`'s
    ``joint`` with ``center=False``, which needs Phases 1 and 2 and the
    joint projector only. Phase 1 takes every view of every entry as one
    stack of SVDs."""
    u, _, _ = proj._svd(views)                               # Phase 1
    stacked = torch.cat(list(u[..., :rank]), dim=-1)  # (*batch, n, k·rank)
    u_joint = proj._svd(stacked)[0][..., :rank]              # Phase 2
    joint = torch.einsum("...nj,k...jm->k...nm", u_joint @ u_joint.mT,
                         views)
    if weights is None:
        return torch.mean(joint, dim=0)
    w = torch.as_tensor(weights, dtype=torch.float32, device=views.device)
    return torch.einsum("k,k...->...", w / torch.sum(w), joint)


def _topk_eig_desc(sym, k: int):
    """Top-k eigenpairs of small symmetric PSD matrices, descending."""
    lam, vec = kernel_ops.nan_safe_eigh(sym)
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


def _joint_mean(joint, weights, robust: str, trim: float, iters: int,
                tol: float):
    """The weighted (or robust) mean over the client axis of the (*B, C,
    ·, ·) per-client joint components."""
    w = normalize_weights(weights, joint.shape[-3], device=joint.device)
    if robust != "none":
        return agg.robust_factored_reduce(
            joint.movedim(-3, 0), w, robust, trim=trim, iters=iters, tol=tol,
            batch_dims=joint.ndim - 3)
    return torch.einsum("c,...cij->...ij", w, joint)


def ajive_sync_factored(v_stack, rank: int, weights=None,
                        side: str = "right",
                        exclude_zero_weights: bool = False,
                        robust: str = "none", trim: float = 0.2,
                        iters: int = 8, tol: float = 1e-6):
    """Server-side second-moment sync on projected moments (Alg. 1 l.12)
    for a shared orthonormal basis. ``v_stack`` (C, *batch, m, r) right |
    (C, *batch, r, n) left. Returns the weighted joint estimate in
    projected shape, (*batch, m, r) | (*batch, r, n). ``robust`` replaces
    the final weighted mean over the per-client joint components with the
    matching ``aggregation.robust_factored_reduce`` mode, each batch entry
    on its own; 'none' is bitwise the weighted mean."""
    a = v_stack.float().movedim(0, -3)             # (*B, C, m, r)|(*B, C, r, n)
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
    return _joint_mean(joint, weights, robust, trim, iters, tol)


def ajive_sync_hetero_factored(v_stack, b_stack, rank: int, weights=None,
                               side: str = "right",
                               exclude_zero_weights: bool = False,
                               robust: str = "none", trim: float = 0.2,
                               iters: int = 8, tol: float = 1e-6):
    """Factored AJIVE 𝒮 for heterogeneous client bases (the adaptive round
    0): client i lifted its ṽ with its own orthonormal basis ``Q_i``; the
    result is expressed on the client-0 basis. Right: Phases 1–2 are
    basis-free and the r×r transfer ``T_i = Q_iᵀ Q_0`` enters Phase 3;
    left: the scores lift as ``Q_i u^i`` and Phase 3 is
    ``(Q_0ᵀ U)(Uᵀ Q_i) ṽ^i``. ``b_stack`` (C, *batch, dim, r). The
    per-client joint components are already on the client-0 basis, so
    ``robust`` reduces them directly, as in :func:`ajive_sync_factored`."""
    a = v_stack.float().movedim(0, -3)
    b = b_stack.float().movedim(0, -3)             # (*B, C, dim, r)
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
    return _joint_mean(joint, weights, robust, trim, iters, tol)

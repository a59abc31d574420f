"""Plain PyTorch versions of the port's kernels (port of
``repro/kernels/ref.py``). Kernel wrappers run these for CPU tensors, and
``chip_smoke.py`` holds each CUDA kernel against them on the card."""
from __future__ import annotations

import functools
import math

import torch


def lowrank_linear_batched_ref(x, w, bases, rts, scales, ids, *, side):
    """Per-row heterogeneous-adapter apply (the serving batch shape).

    x (B, t, m) or (B, m); w (m, n) shared base; bases/rts/scales are
    (G, ·, ·)/(G,) adapter tables; ids (B,) selects each row's adapter:
    ``y[b] = scales[ids[b]]·(x[b]@w) + split-matmul(x[b], bases[ids[b]],
    rts[ids[b]])``. Plain gather + einsum with fp32 accumulation; the
    output dtype is ``torch.result_type(x, w)``.
    """
    squeeze_t = x.ndim == 2
    x3 = (x[:, None, :] if squeeze_t else x).float()
    ids = ids.long()
    s = scales.float()[ids][:, None, None]
    base = s * (x3 @ w.float())
    bg = bases.float()[ids]
    rg = rts.float()[ids]
    if side == "right":
        delta = torch.einsum("btr,bnr->btn",
                             torch.einsum("btm,bmr->btr", x3, rg), bg)
    else:
        delta = torch.einsum("btr,brn->btn",
                             torch.einsum("btm,bmr->btr", x3, bg), rg)
    y = (base + delta).to(torch.result_type(x, w))
    return y[:, 0, :] if squeeze_t else y


def lowrank_linear_ref(x, w, basis, rt, scale, *, side):
    """Lift-free low-rank linear apply for one factored block.

    x (..., t, m); w (m, n); right: basis (n, r), rt (m, r) —
    ``y = scale·(x@w) + (x@rt)@basisᵀ``; left: basis (m, r), rt (r, n) —
    ``y = scale·(x@w) + (x@basis)@rt``. ``scale`` is a float or a 0-d
    tensor. fp32 accumulation; result in ``torch.result_type(x, w)``.
    """
    x32 = x.float()
    base = scale * (x32 @ w.float())
    b32, r32 = basis.float(), rt.float()
    delta = (x32 @ r32) @ b32.mT if side == "right" else (x32 @ b32) @ r32
    return (base + delta).to(torch.result_type(x, w))


def _adam_dir(gt, m, v, *, b1, b2, eps, c1, c2):
    m = b1 * m + (1 - b1) * gt
    v = b2 * v + (1 - b2) * gt * gt
    return m, v, (m / c1) / (torch.sqrt(v / c2) + eps)


def galore_precond_ref(g, basis, m, v, *, c1, c2, side, b1=0.9, b2=0.999,
                       eps=1e-8, project_back=True):
    """Project → Adam → (project back) for a stack of blocks, both sides.

    g (..., M, N); right: basis (..., N, r), m/v (..., M, r); left: basis
    (..., M, r), m/v (..., r, N). ``c1``/``c2`` are the bias corrections
    ``1 - b^count`` (1.0 without correction). Returns (u, m', v') with u
    (..., M, N) fp32, or ũ in the moment shape when ``project_back`` is
    False."""
    g32, b32 = g.float(), basis.float()
    gt = g32 @ b32 if side == "right" else b32.mT @ g32
    m, v, ut = _adam_dir(gt, m, v, b1=b1, b2=b2, eps=eps, c1=c1, c2=c2)
    if not project_back:
        return ut, m, v
    return (ut @ b32.mT if side == "right" else b32 @ ut), m, v


def galore_adamw_ref(w, g, basis, m, v, *, c1, c2, side, b1=0.9, b2=0.999,
                     eps=1e-8, lr=1e-3, weight_decay=0.0):
    """The fused GaLoreAdamW step, both sides: the lifted preconditioned
    update ``u`` applied as ``w ← w − lr·u − lr·λ·w`` in fp32. Returns
    (w' in w's dtype, m', v')."""
    u, m, v = galore_precond_ref(g, basis, m, v, c1=c1, c2=c2, side=side,
                                 b1=b1, b2=b2, eps=eps)
    w32 = w.float()
    return (w32 - lr * u - lr * weight_decay * w32).to(w.dtype), m, v


def round_robin_pairs(n: int):
    """The parallel-Jacobi schedule: (n_steps, n_pairs) int lists of
    disjoint (p, q) pairs covering every unordered pair once per sweep
    (circle method; odd n plays against a phantom seat whose pairs are
    dropped)."""
    m = n if n % 2 == 0 else n + 1
    seats = list(range(m))
    steps_p, steps_q = [], []
    for _ in range(m - 1):
        ps, qs = [], []
        for i in range(m // 2):
            a, b = seats[i], seats[m - 1 - i]
            if a < n and b < n:
                ps.append(min(a, b))
                qs.append(max(a, b))
        steps_p.append(ps)
        steps_q.append(qs)
        seats = [seats[0]] + [seats[-1]] + seats[1:-1]
    return steps_p, steps_q


@functools.lru_cache(maxsize=None)
def _schedule(n: int, device: torch.device):
    """The round-robin schedule as index tensors on ``device``, built once
    per (n, device) so the solve itself moves nothing from the host."""
    steps_p, steps_q = round_robin_pairs(n)
    return [(torch.tensor(p, dtype=torch.long, device=device),
             torch.tensor(q, dtype=torch.long, device=device))
            for p, q in zip(steps_p, steps_q)]


def jacobi_rotation(app, aqq, apq):
    """The CUDA Jacobi kernel's (c, s) for θ = ½·atan2(2a_pq, a_qq − a_pp)
    without trigonometry, in fp32 with each reciprocal square root rounded
    once (the kernel refines the hardware's estimate by a Newton step):
    x = a_qq − a_pp and y = 2a_pq scaled by a power of two, ρ = |(x, y)|,
    g = (1 + |x|/ρ)/2; for x ≥ 0, c = √g and s = sign(y)·|y|/(2ρc); for
    x < 0 the two swap; (1, 0) where a_pq = 0. Tests hold it to cos θ and
    sin θ; the plain version keeps the reference's atan2."""
    app, aqq, apq = (torch.as_tensor(v, dtype=torch.float32)
                     for v in (app, aqq, apq))
    x, y = aqq - app, 2.0 * apq
    big_xy = torch.maximum(x.abs(), y.abs())
    e = torch.clamp((big_xy.view(torch.int32) >> 23) & 0xFF, max=253)
    f = ((254 - e) << 23).view(torch.float32)            # 2^-exponent
    xs, ys = x * f, y * f

    def rsqrt(v):
        return torch.rsqrt(v.double()).float()

    ir = rsqrt(xs * xs + ys * ys)
    g = 0.5 * (xs * ir).abs() + 0.5
    rg = rsqrt(g)
    big, small = g * rg, 0.5 * (ys * ir).abs() * rg
    inner = x >= 0
    c = torch.where(inner, big, small)
    s = torch.copysign(torch.where(inner, small, big), y)
    zero = apq == 0
    return torch.where(zero, 1.0, c), torch.where(zero, 0.0, s)


def jacobi_eigh_ref(a, *, sweeps: int = 12):
    """Parallel-order cyclic Jacobi on a (..., n, n) symmetric stack, in
    plain tensor ops: the reference kernel's arithmetic (θ = ½·atan2(2a_pq,
    a_qq − a_pp), pinned to 0 where a_pq = 0; J_pp = J_qq = 1 + (c − 1);
    A ← Jᵀ(AJ), V ← VJ, symmetry re-pinned every step), then eigenvalues
    ascending (stable) with their columns."""
    n = a.shape[-1]
    lead = a.shape[:-2]
    a = a.reshape((-1, n, n)).float().clone()
    v = torch.eye(n, dtype=torch.float32, device=a.device).repeat(
        a.shape[0], 1, 1)
    idx = _schedule(n, a.device)
    for it in range(sweeps * len(idx) if n > 1 else 0):
        p, q = idx[it % len(idx)]
        app, aqq, apq = a[:, p, p], a[:, q, q], a[:, p, q]
        theta = 0.5 * torch.atan2(2.0 * apq, aqq - app)
        theta = torch.where(apq == 0.0, 0.0, theta)
        c = (1.0 + (torch.cos(theta) - 1.0))[:, None, :]
        s = torch.sin(theta)[:, None, :]
        for x in (a, v):                         # columns: X <- X J
            xp, xq = x[:, :, p], x[:, :, q]
            x[:, :, p] = xp * c - xq * s
            x[:, :, q] = xp * s + xq * c
        c, s = c.mT, s.mT
        ap, aq = a[:, p, :], a[:, q, :]          # rows: A <- J^T A
        a[:, p, :] = c * ap - s * aq
        a[:, q, :] = s * ap + c * aq
        a = 0.5 * (a + a.mT)
    lam, order = torch.sort(torch.diagonal(a, dim1=-2, dim2=-1), dim=-1,
                            stable=True)
    vec = torch.gather(v, 2, order[:, None, :].expand(-1, n, -1))
    return lam.reshape(lead + (n,)), vec.reshape(lead + (n, n))


def _pairwise_sum(x):
    """Sum over dim -2 as a pairwise tree of adjacent pairs — ((x0 + x1) +
    (x2 + x3)) + … — zero-padded to a power of two: the order the WKV6
    kernel sums in."""
    n = x.shape[-2]
    size = 1 << max(n - 1, 0).bit_length()
    if size != n:
        x = torch.nn.functional.pad(x, (0, 0, 0, size - n))
    while x.shape[-2] > 1:
        x = x[..., 0::2, :] + x[..., 1::2, :]
    return x[..., 0, :]


def _wkv_states(k, v, w, s0):
    """The states the recurrence walks through: (S_0 … S_{L-1} stacked on
    dim 1, (B, L, H, D, D), S_t the state before step t; S_L) fp32, each
    step S ← w_t S + k_t v_tᵀ rounded as the CUDA kernels round it."""
    b, l, h, d = k.shape
    s = (torch.zeros((b, h, d, d), dtype=torch.float32, device=k.device)
         if s0 is None else s0.float())
    states = []
    for t in range(l):
        states.append(s)
        kv = k[:, t].float()[..., :, None] * v[:, t].float()[..., None, :]
        s = w[:, t].float()[..., None] * s + kv
    stacked = (torch.stack(states, dim=1) if states else
               torch.zeros((b, 0, h, d, d), dtype=torch.float32,
                           device=k.device))
    return stacked, s


def rwkv6_scan_ref(r, k, v, w, u, s0=None, *, every=0):
    """The RWKV6 WKV recurrence, per (b, h), over any length L:

        y_t = r_t · (S + diag(u) k_t v_tᵀ);   S ← diag(w_t) S + k_t v_tᵀ

    r, k, v, w (B, L, H, D); u (H, D); s0 (B, H, D, D) or None (zeros).
    The state and every product are fp32, each product and sum rounded on
    its own, and the sum over i is :func:`_pairwise_sum`: the CUDA
    kernel's arithmetic in its order, so the two agree bit for bit. The
    states are walked step by step, then every y_t is computed at once
    from them. Returns (y (B, L, H, D) in r's dtype, s_final (B, H, D, D)
    fp32), and with ``every`` > 0 a third output, the states the
    checkpoint mode writes: (B, H, ⌈L / every⌉, D, D) fp32, entry n the
    state before step n·every."""
    states, s = _wkv_states(k, v, w, s0)
    kv = k.float()[..., :, None] * v.float()[..., None, :]   # (B,L,H,D,D)
    u32 = u.float()[None, None, :, :, None]
    y = _pairwise_sum(r.float()[..., :, None] * (states + u32 * kv))
    if not every:
        return y.to(r.dtype), s
    return y.to(r.dtype), s, states[:, ::every].transpose(1, 2)


def _row_sum(x):
    """:func:`_pairwise_sum` over the last dim (the columns j of a state):
    the WKV backward kernel's order for a row's sums."""
    return _pairwise_sum(x.mT)


def rwkv6_scan_bwd_ref(r, k, v, w, u, s0, dy, ds_final=None):
    """The backward of :func:`rwkv6_scan_ref`: the cotangents of (r, k, v,
    w, u, s0) given those of y (``dy``, (B, L, H, D)) and of the final
    state (``ds_final``, (B, H, D, D) or None for zeros).

    Per (b, h), G = ∂L/∂S (D×D fp32) starts at ds_final and walks back
    over t = L-1 … 0 with S = S_{t-1}, the state before step t:

        A = r_t ⊗ dy_t;   dkv = G + diag(u) A
        dr_t = Σ_j S dy_t + (u ∘ k_t)(v_t · dy_t)
        dk_t = Σ_j dkv v_t;   dv_t = Σ_i k_t dkv;   dw_t = Σ_j G ∘ S
        du += (r_t ∘ k_t)(v_t · dy_t);   G ← diag(w_t) G + A

    and ds0 = G. The states S_{t-1} are recomputed forward from s0 as
    :func:`rwkv6_scan_ref` computes them (bit for bit the states the
    forward's checkpoint mode writes), never recovered by dividing by
    w_t, which underflows to 0 in fp32. Every product and sum is rounded
    on its own and each Σ (and v·dy) is :func:`_pairwise_sum`'s tree:
    ``csrc/rwkv6_scan_bwd.cu``'s arithmetic in its order. The two walks
    (S forward, G back) go step by step; the sums of every step are then
    taken at once. Returns (dr, dk, dv in r's dtype, dw in w's dtype, du
    (H, D) fp32 — the per-row sums over b added by ``torch.sum`` —, ds0
    (B, H, D, D) fp32)."""
    b, l, h, d = r.shape
    states, _ = _wkv_states(k, v, w, s0)
    r32, k32, v32, w32, dy32 = (x.float() for x in (r, k, v, w, dy))
    a = r32[..., :, None] * dy32[..., None, :]              # (B,L,H,D,D)
    g = (torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
         if ds_final is None else ds_final.float())
    gs = [None] * l                                         # ∂L/∂S_{t+1}
    for t in reversed(range(l)):
        gs[t] = g
        g = w32[:, t][..., None] * g + a[:, t]
    gs = torch.stack(gs, dim=1) if gs else torch.zeros_like(states)
    u32 = u.float()[None, None]                             # (1, 1, H, D)
    dkv = gs + u32[..., :, None] * a
    vdy = _pairwise_sum((v32 * dy32)[..., :, None])         # (B, L, H, 1)
    dr = _row_sum(states * dy32[..., None, :]) + (u32 * k32) * vdy
    dk = _row_sum(dkv * v32[..., None, :])
    dv = _pairwise_sum(k32[..., :, None] * dkv)
    dw = _row_sum(gs * states)
    terms = (r32 * k32) * vdy
    du = torch.zeros((b, h, d), dtype=torch.float32, device=r.device)
    for t in reversed(range(l)):
        du = du + terms[:, t]
    return (dr.to(r.dtype), dk.to(r.dtype), dv.to(r.dtype), dw.to(w.dtype),
            du.sum(0), g)


FLASH_NEG = -1e30        # masked scores, finite as in the JAX package
FLASH_REF_SCORES = 1 << 28   # fp32 scores per query-row chunk (1 GiB)


def _check_flash_args(q, k, v, causal, window):
    """The shape rules both flash versions share; raises on what neither
    computes."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention takes q (B, Lq, H, D) and k, v "
                         f"(B, Lk, Hkv, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or k.shape[2] == 0 or \
            h % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)}: batch and head size must match "
                         "and H must be a multiple of Hkv")
    if window and not causal:
        raise ValueError(
            "flash_attention: a sliding window without the causal mask is "
            "not computed — the JAX package's two versions disagree there "
            "(the Pallas kernel applies the window, its reference ignores "
            "it; ROADMAP Queue 3 item m)")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def flash_attention_ref(q, k, v, *, causal=True, window=0, scale=None):
    """Causal GQA attention over a fresh sequence (port of
    ``repro/kernels/ref.py::flash_attention_ref``).

    q (B, Lq, H, D), k/v (B, Lk, Hkv, D) with H % Hkv == 0; q head h reads
    kv head h // (H / Hkv). The causal mask is suffix-aligned: query i
    sits at position Lk − Lq + i and sees keys at or before it, and with
    ``window`` > 0 only the last ``window`` of them. Scores are fp32,
    scaled after the QK product (default 1/√D), masked with −1e30 (a
    query that sees no key averages V uniformly, as in JAX); softmax and
    PV in fp32, the result in q's dtype.

    The query rows run in chunks of at most ``FLASH_REF_SCORES`` fp32
    scores: each row's softmax is its own, so chunking changes no value,
    and a long prefill (8192 tokens, 36 heads: 9.7 GB of scores) stays
    within the card's memory. ``window`` without ``causal`` raises.
    """
    _check_flash_args(q, k, v, causal, window)
    b, lq, h, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    groups = h // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    k32, v32 = k.float(), v.float()
    rows = max(1, FLASH_REF_SCORES // max(1, b * h * lk))
    out = []
    for q0 in range(0, lq, rows):
        qc = q[:, q0:q0 + rows]
        n = qc.shape[1]
        qg = qc.reshape(b, n, hkv, groups, d).float()
        scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k32) * scale
        if causal:
            qpos = torch.arange(q0, q0 + n, device=q.device)[:, None] + \
                (lk - lq)
            kpos = torch.arange(lk, device=q.device)[None, :]
            mask = kpos <= qpos
            if window:
                mask &= (qpos - kpos) < window
            scores = scores.masked_fill(~mask, FLASH_NEG)
        w = torch.softmax(scores, dim=-1)
        del scores
        ctx = torch.einsum("bkgqs,bskd->bqkgd", w, v32)
        out.append(ctx.reshape(b, n, h, d).to(q.dtype))
    if not out:
        return torch.zeros_like(q)
    return out[0] if len(out) == 1 else torch.cat(out, dim=1)

"""GQA attention with a ring-buffer KV cache (port of the GQA half of
``repro/models/attention.py``; MLA comes with the other families).

Numerics follow the JAX package: scores and context accumulate in fp32,
the softmax is fp32, and its weights are cast to the value dtype before the
PV product. The KV cache is bf16 in every config, so decode rounds K, V and
the weights through bf16 in both packages. Prefill with no autograd graph
goes through ``kernels.ops.flash_attention`` instead (:func:`gqa_forward`):
its plain version keeps the weights in fp32 for PV, as the JAX package's
flash kernel does; the CUDA kernel's tensor-core route rounds them to bf16
for its PV product.

Unlike the JAX package, :func:`kv_cache_write` writes the cache tensors in
place and returns the same :class:`KVCache`: a decode step then touches
only its own slots instead of copying every layer's cache.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..kernels import ops as kops
from .layers import apply_rope, dense, dense_init

NEG_INF = -1e30


# ------------------------------------------------------------------- GQA ----

def gqa_init(gen, d_model: int, n_heads: int, n_kv: int, head_dim: int,
             qkv_bias: bool = False, dtype=torch.float32, lead=()):
    """Params of one GQA mixer; ``lead`` prepends stacked-block dims."""
    lead = tuple(lead)
    dev = gen.device
    p = {"wq": dense_init(gen, lead + (d_model, n_heads * head_dim),
                          dtype=dtype),
         "wk": dense_init(gen, lead + (d_model, n_kv * head_dim), dtype=dtype),
         "wv": dense_init(gen, lead + (d_model, n_kv * head_dim), dtype=dtype),
         "wo": dense_init(gen, lead + (n_heads * head_dim, d_model),
                          dtype=dtype)}
    if qkv_bias:
        for name, width in (("bq", n_heads), ("bk", n_kv), ("bv", n_kv)):
            p[name] = torch.zeros(lead + (width * head_dim,), dtype=dtype,
                                  device=dev)
    return p


def _split_heads(x, n, hd):
    return x.reshape(x.shape[:-1] + (n, hd))


def causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                window: int = 0) -> torch.Tensor:
    """(..., Lq, Lk) boolean mask: attend iff k_pos <= q_pos and, for
    sliding-window attention, q_pos - k_pos < window."""
    diff = q_pos[..., :, None] - k_pos[..., None, :]
    mask = diff >= 0
    if window:
        mask = mask & (diff < window)
    return mask


def attend(q, k, v, mask) -> torch.Tensor:
    """q (B,Lq,H,hd), k/v (B,Lk,Hkv,hd) with H % Hkv == 0; mask (B|1,Lq,Lk).

    Products of the operands accumulate in fp32 (JAX's
    ``preferred_element_type=f32``); the scores are divided by sqrt(hd)
    after the QK product; masked scores are ``NEG_INF``, not -inf.
    """
    b, lq, h, hd = q.shape
    hkv = k.shape[2]
    groups = h // hkv
    qg = q.reshape(b, lq, hkv, groups, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float())
    scores = scores / math.sqrt(hd)
    scores = scores.masked_fill(~mask[:, None, None, :, :], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bkgqs,bskh->bqkgh", w.to(v.dtype).float(), v.float())
    return ctx.reshape(b, lq, h, hd).to(q.dtype)


def blockwise_attend(q, k, v, *, window=0, chunk_q=2048, chunk_k=2048,
                     q_start=0) -> torch.Tensor:
    """Flash-style blockwise causal attention in plain PyTorch.

    Query and key sequences are chunked; (q-chunk, k-chunk) pairs that are
    entirely masked are skipped, and per-pair online-softmax statistics
    keep the working set at (B, H, chunk_q, chunk_k). Scores are multiplied
    by ``1/sqrt(hd)``, as in the JAX version.
    """
    b, lq, h, hd = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    cq, ck = min(chunk_q, lq), min(chunk_k, lk)
    if lq % cq or lk % ck:
        raise ValueError(f"sequence lengths {lq}/{lk} must divide the "
                         f"chunks {cq}/{ck}")
    scale = 1.0 / (hd ** 0.5)
    qg = q.reshape(b, lq, hkv, g, hd).float()
    dev = q.device

    outs = []
    for qi in range(lq // cq):
        q_blk = qg[:, qi * cq:(qi + 1) * cq]
        q_lo = q_start + qi * cq
        q_hi = q_lo + cq - 1
        m_i = torch.full((b, hkv, g, cq), NEG_INF, dtype=torch.float32,
                         device=dev)
        l_i = torch.zeros((b, hkv, g, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, hkv, g, cq, hd), dtype=torch.float32,
                          device=dev)
        for ki in range(lk // ck):
            k_lo, k_hi = ki * ck, ki * ck + ck - 1
            if k_lo > q_hi:
                continue                      # fully in the future
            if window and k_hi < q_lo - window + 1:
                continue                      # fully outside the window
            k_blk = k[:, k_lo:k_lo + ck].float()
            v_blk = v[:, k_lo:k_lo + ck]
            s = torch.einsum("bqkgh,bskh->bkgqs", q_blk, k_blk) * scale
            crosses_causal = k_hi > q_lo
            crosses_window = window and k_lo < q_hi - window + 1
            if crosses_causal or crosses_window:
                qp = q_lo + torch.arange(cq, device=dev)
                kp = k_lo + torch.arange(ck, device=dev)
                mask = causal_mask(qp, kp, window)
                s = s.masked_fill(~mask[None, None, None], NEG_INF)
            m_new = torch.maximum(m_i, torch.amax(s, dim=-1))
            alpha = torch.exp(m_i - m_new)
            p_ = torch.exp(s - m_new[..., None])
            l_i = alpha * l_i + torch.sum(p_, dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqs,bskh->bkgqh", p_.to(v.dtype).float(), v_blk.float())
            m_i = m_new
        outs.append(acc / torch.clamp(l_i, min=1e-30)[..., None])
    full = torch.cat(outs, dim=3)             # (b, hkv, g, lq, hd)
    return full.permute(0, 3, 1, 2, 4).reshape(b, lq, h, hd).to(q.dtype)


def gqa_forward(p, x, positions, *, n_heads, n_kv, head_dim, rope=True,
                rope_theta=1e4, window=0, attn_chunk=0):
    """Training/prefill attention over a full sequence of consecutive
    ``positions``. x (B,L,D); returns (out, (k, v)).

    The attention itself takes one of two routes, by whether autograd is
    recording. With no graph being recorded (serving prefill under
    ``torch.inference_mode()``, ``FedEngine.evaluate``), it is
    ``kernels.ops.flash_attention`` — causal, with the config's window:
    the CUDA kernel on the card, its plain version on the CPU. While grad
    is recorded (the training read), it is :func:`attend`, or
    :func:`blockwise_attend` once L >= ``attn_chunk``, the code the JAX
    package differentiates; the flash kernel has no backward."""
    b, l, _ = x.shape
    q = dense(x, p["wq"]) + p.get("bq", 0)
    k = dense(x, p["wk"]) + p.get("bk", 0)
    v = dense(x, p["wv"]) + p.get("bv", 0)
    q = _split_heads(q, n_heads, head_dim)
    k = _split_heads(k, n_kv, head_dim)
    v = _split_heads(v, n_kv, head_dim)
    if rope:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v))):
        ctx = kops.flash_attention(q, k, v, causal=True, window=window)
    elif attn_chunk and l >= attn_chunk:
        c = min(attn_chunk, l // 2)
        ctx = blockwise_attend(q, k, v, window=window, chunk_q=c, chunk_k=c)
    else:
        mask = causal_mask(positions, positions, window)
        if mask.ndim == 2:
            mask = mask[None]
        ctx = attend(q, k, v, mask)
    return dense(ctx.reshape(b, l, n_heads * head_dim), p["wo"]), (k, v)


class KVCache(NamedTuple):
    k: torch.Tensor      # (B, S, Hkv, hd)
    v: torch.Tensor      # (B, S, Hkv, hd)
    pos: torch.Tensor    # (B, S) absolute position of each slot, -1 = empty


def kv_cache_init(batch: int, size: int, n_kv: int, head_dim: int,
                  dtype=torch.bfloat16, device=None, lead=()) -> KVCache:
    """An empty cache; ``lead`` prepends stacked-block dims."""
    lead = tuple(lead)
    return KVCache(
        k=torch.zeros(lead + (batch, size, n_kv, head_dim), dtype=dtype,
                      device=device),
        v=torch.zeros(lead + (batch, size, n_kv, head_dim), dtype=dtype,
                      device=device),
        pos=torch.full(lead + (batch, size), -1, dtype=torch.int32,
                       device=device))


def kv_cache_write(cache: KVCache, k_new, v_new, t0) -> KVCache:
    """Ring-buffer write of (B, Ln, Hkv, hd) starting at absolute pos t0,
    in place (returns ``cache``).

    ``t0`` scalar (int or 0-d tensor): every row writes the same slots.
    ``t0`` (B,): per-row start positions, the continuous-batching layout
    where each slot sits at its own depth.

    A write longer than the ring (a prompt over a windowed cache) keeps
    its last ``size`` positions, the ring's content after the whole write
    in the JAX package: the earlier ones would be overwritten within the
    same write, and one ``index_put_`` with repeated slots leaves the
    winner undefined."""
    b, ln = k_new.shape[:2]
    size = cache.k.shape[1]
    dev = cache.k.device
    skip = max(ln - size, 0)
    k_new, v_new = k_new[:, skip:], v_new[:, skip:]
    ln -= skip
    steps = torch.arange(skip, skip + ln, device=dev)
    if isinstance(t0, torch.Tensor) and t0.ndim:
        pos = t0.long()[:, None] + steps[None, :]             # (B, Ln)
        slots = pos % size
        rows = torch.arange(b, device=dev)[:, None]
        cache.k[rows, slots] = k_new.to(cache.k.dtype)
        cache.v[rows, slots] = v_new.to(cache.v.dtype)
        cache.pos[rows, slots] = pos.to(torch.int32)
        return cache
    pos = steps + t0
    slots = pos % size
    cache.k[:, slots] = k_new.to(cache.k.dtype)
    cache.v[:, slots] = v_new.to(cache.v.dtype)
    cache.pos[:, slots] = pos.to(torch.int32).expand(b, ln)
    return cache


def gqa_decode(p, x, cache: KVCache, t, *, n_heads, n_kv, head_dim,
               rope=True, rope_theta=1e4, window=0):
    """One-token decode. x (B,1,D); t a scalar absolute position (int or
    0-d tensor), or (B,) per-row positions (continuous-batching slots at
    different depths). Writes the cache in place."""
    b = x.shape[0]
    q = x @ p["wq"] + p.get("bq", 0)
    k = x @ p["wk"] + p.get("bk", 0)
    v = x @ p["wv"] + p.get("bv", 0)
    q = _split_heads(q, n_heads, head_dim)
    k = _split_heads(k, n_kv, head_dim)
    v = _split_heads(v, n_kv, head_dim)
    t = torch.as_tensor(t, device=x.device)
    pos1 = (t[:, None].to(torch.int32) if t.ndim
            else t.reshape(1).to(torch.int32))
    if rope:
        q = apply_rope(q, pos1, rope_theta)
        k = apply_rope(k, pos1, rope_theta)
    cache = kv_cache_write(cache, k, v, t)
    q_pos = pos1.expand(b, 1)
    mask = causal_mask(q_pos, cache.pos, window) & (cache.pos[:, None, :] >= 0)
    ctx = attend(q, cache.k, cache.v, mask)
    return ctx.reshape(b, 1, n_heads * head_dim) @ p["wo"], cache

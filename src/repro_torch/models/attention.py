"""Attention: GQA with a ring-buffer KV cache, and MLA (DeepSeek-V2) with
its compressed cache (port of ``repro/models/attention.py``).

Numerics follow the JAX package: scores and context accumulate in fp32,
the softmax is fp32, and its weights are cast to the value dtype before the
PV product. The KV cache is bf16 in every config, so decode rounds K, V and
the weights through bf16 in both packages. Prefill with no autograd graph
goes through ``kernels.ops.flash_attention`` instead (:func:`gqa_forward`):
its plain version keeps the weights in fp32 for PV, as the JAX package's
flash kernel does; the CUDA kernel's tensor-core route rounds them to bf16
for its PV product.

Unlike the JAX package, :func:`kv_cache_write` and :func:`mla_cache_write`
write the cache tensors in place and return the same cache: a decode step
then touches only its own slots instead of copying every layer's cache.

MLA attends in plain PyTorch at prefill and decode, as the JAX package
does (no Pallas kernel there): its q·k heads are 192 wide and its v heads
128, which ``flash_attention`` does not take. Decode runs the absorbed
form over the (kv_lora + rope)-wide cache. JAX multiplies the bf16 cache
by fp32 query-side operands with fp32 accumulation; torch has no
mixed-dtype dot, so the port upcasts the cache operand (bf16 → fp32 is
exact) and contracts in fp32, the same products and sums.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..kernels import ops as kops
from .layers import apply_rope, dense, dense_init, rms_norm

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


# ------------------------------------------------------------------- MLA ----

def mla_init(gen, d_model: int, n_heads: int, *, q_lora: int, kv_lora: int,
             qk_nope: int, qk_rope: int, v_dim: int, dtype=torch.float32,
             lead=()):
    """Params of one MLA mixer; ``lead`` prepends stacked-block dims."""
    lead = tuple(lead)
    dev = gen.device
    return {
        "q_a": dense_init(gen, lead + (d_model, q_lora), dtype=dtype),
        "q_a_norm": torch.ones(lead + (q_lora,), dtype=dtype, device=dev),
        "q_b": dense_init(gen, lead + (q_lora, n_heads * (qk_nope + qk_rope)),
                          dtype=dtype),
        "kv_a": dense_init(gen, lead + (d_model, kv_lora + qk_rope),
                           dtype=dtype),
        "kv_a_norm": torch.ones(lead + (kv_lora,), dtype=dtype, device=dev),
        "kv_b": dense_init(gen, lead + (kv_lora, n_heads * (qk_nope + v_dim)),
                           dtype=dtype),
        "wo": dense_init(gen, lead + (n_heads * v_dim, d_model), dtype=dtype),
    }


def _mla_qkv(p, x, positions, n_heads, qk_nope, qk_rope, kv_lora,
             rope_theta):
    """(q_nope (B,L,H,nope), q_pe (B,L,H,rope) roped, c_kv (B,L,kv_lora)
    normed, k_pe (B,L,rope) roped)."""
    b, l, _ = x.shape
    q = dense(rms_norm(dense(x, p["q_a"]), p["q_a_norm"]), p["q_b"])
    q = q.reshape(b, l, n_heads, qk_nope + qk_rope)
    q_nope, q_pe = q[..., :qk_nope], q[..., qk_nope:]
    q_pe = apply_rope(q_pe, positions, rope_theta)
    kv = dense(x, p["kv_a"])
    c_kv = rms_norm(kv[..., :kv_lora], p["kv_a_norm"])
    k_pe = apply_rope(kv[..., kv_lora:][:, :, None, :], positions,
                      rope_theta)[:, :, 0]
    return q_nope, q_pe, c_kv, k_pe


def _mla_scale(qk_nope: int, qk_rope: int) -> float:
    """JAX's ``1 / sqrt(qk_nope + qk_rope)`` in fp32, as a Python float
    (exact in fp32)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(qk_nope + qk_rope)))


def mla_forward(p, x, positions, *, n_heads, qk_nope, qk_rope, kv_lora,
                v_dim, rope_theta=1e4, window=0, attn_chunk=0):
    """Training/prefill MLA with K/V expanded from the compressed latent.
    x (B,L,D); returns (out, (c_kv, k_pe)), the two cached per position.

    At L ≥ ``attn_chunk`` the expansion runs per key chunk inside
    :func:`_mla_blockwise`, so the (B, L, H, ·) expanded K/V never exist;
    below it, ``kv_b`` expands the whole sequence once and the scores
    are one masked softmax."""
    b, l, _ = x.shape
    q_nope, q_pe, c_kv, k_pe = _mla_qkv(p, x, positions, n_heads, qk_nope,
                                        qk_rope, kv_lora, rope_theta)
    scale = _mla_scale(qk_nope, qk_rope)
    if attn_chunk and l >= attn_chunk:
        ctx = _mla_blockwise(q_nope, q_pe, c_kv, k_pe, p["kv_b"], qk_nope,
                             scale, window, min(attn_chunk, l // 2))
    else:
        kv_full = dense(c_kv, p["kv_b"]).reshape(b, l, n_heads,
                                                 qk_nope + v_dim)
        k_nope, v = kv_full[..., :qk_nope], kv_full[..., qk_nope:]
        scores = (torch.einsum("bqhd,bkhd->bhqk", q_nope.float(),
                               k_nope.float())
                  + torch.einsum("bqhd,bkd->bhqk", q_pe.float(),
                                 k_pe.float())) * scale
        mask = causal_mask(positions, positions, window)
        if mask.ndim == 2:
            mask = mask[None]
        scores = scores.masked_fill(~mask[:, None, :, :], NEG_INF)
        w = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype).float(),
                           v.float()).to(x.dtype)
    out = dense(ctx.reshape(b, l, n_heads * v_dim), p["wo"])
    return out, (c_kv, k_pe)


def _mla_blockwise(q_nope, q_pe, c_kv, k_pe, kv_b, qk_nope, scale, window,
                   chunk):
    """Blockwise causal MLA (JAX's ``_mla_blockwise``): ``kv_b`` expands
    each key chunk as it is visited, chunk pairs wholly in the future or
    outside the window are skipped, and online-softmax statistics carry
    across key chunks."""
    b, lq, h, _ = q_nope.shape
    v_dim = kv_b.shape[-1] // h - qk_nope
    cq = ck = min(chunk, lq)
    if lq % cq:
        raise ValueError(f"sequence length {lq} must divide the chunk {cq}")
    dev = q_nope.device
    outs = []
    for qi in range(lq // cq):
        qn_blk = q_nope[:, qi * cq:(qi + 1) * cq].float()
        qp_blk = q_pe[:, qi * cq:(qi + 1) * cq].float()
        q_lo, q_hi = qi * cq, qi * cq + cq - 1
        m_i = torch.full((b, h, cq), NEG_INF, dtype=torch.float32,
                         device=dev)
        l_i = torch.zeros((b, h, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, cq, v_dim), dtype=torch.float32, device=dev)
        for ki in range(lq // ck):
            k_lo, k_hi = ki * ck, ki * ck + ck - 1
            if k_lo > q_hi:
                continue                       # fully in the future
            if window and k_hi < q_lo - window + 1:
                continue                       # fully outside the window
            kv_blk = dense(c_kv[:, k_lo:k_lo + ck], kv_b).reshape(
                b, ck, h, qk_nope + v_dim)
            k_nope_blk, v_blk = kv_blk[..., :qk_nope], kv_blk[..., qk_nope:]
            s = (torch.einsum("bqhd,bshd->bhqs", qn_blk, k_nope_blk.float())
                 + torch.einsum("bqhd,bsd->bhqs", qp_blk,
                                k_pe[:, k_lo:k_lo + ck].float())) * scale
            if k_hi > q_lo or (window and k_lo < q_hi - window + 1):
                mask = causal_mask(q_lo + torch.arange(cq, device=dev),
                                   k_lo + torch.arange(ck, device=dev),
                                   window)
                s = s.masked_fill(~mask[None, None], NEG_INF)
            m_new = torch.maximum(m_i, torch.amax(s, dim=-1))
            alpha = torch.exp(m_i - m_new)
            p_ = torch.exp(s - m_new[..., None])
            l_i = alpha * l_i + torch.sum(p_, dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqs,bshd->bhqd", p_.to(v_blk.dtype).float(),
                v_blk.float())
            m_i = m_new
        outs.append(acc / torch.clamp(l_i, min=1e-30)[..., None])
    full = torch.cat(outs, dim=2)              # (b, h, lq, v_dim)
    return full.permute(0, 2, 1, 3).to(q_nope.dtype)


class MLACache(NamedTuple):
    ckv: torch.Tensor    # (B, S, kv_lora)
    kpe: torch.Tensor    # (B, S, rope_dim)
    pos: torch.Tensor    # (B, S) absolute position of each slot, -1 = empty


def mla_cache_init(batch: int, size: int, kv_lora: int, rope_dim: int,
                   dtype=torch.bfloat16, device=None, lead=()) -> MLACache:
    """An empty compressed cache; ``lead`` prepends stacked-block dims."""
    lead = tuple(lead)
    return MLACache(
        ckv=torch.zeros(lead + (batch, size, kv_lora), dtype=dtype,
                        device=device),
        kpe=torch.zeros(lead + (batch, size, rope_dim), dtype=dtype,
                        device=device),
        pos=torch.full(lead + (batch, size), -1, dtype=torch.int32,
                       device=device))


def mla_cache_write(cache: MLACache, c_kv, k_pe, t0) -> MLACache:
    """Ring-buffer write of c_kv (B, Ln, kv_lora) and k_pe (B, Ln, rope)
    from absolute position t0 (scalar, or (B,) per row), in place, with
    :func:`kv_cache_write`'s rule for a write longer than the ring: its
    last ``size`` positions are kept."""
    b, ln = c_kv.shape[:2]
    size = cache.ckv.shape[1]
    dev = cache.ckv.device
    skip = max(ln - size, 0)
    c_kv, k_pe = c_kv[:, skip:], k_pe[:, skip:]
    ln -= skip
    steps = torch.arange(skip, skip + ln, device=dev)
    if isinstance(t0, torch.Tensor) and t0.ndim:
        pos = t0.long()[:, None] + steps[None, :]             # (B, Ln)
        slots = pos % size
        rows = torch.arange(b, device=dev)[:, None]
        cache.ckv[rows, slots] = c_kv.to(cache.ckv.dtype)
        cache.kpe[rows, slots] = k_pe.to(cache.kpe.dtype)
        cache.pos[rows, slots] = pos.to(torch.int32)
        return cache
    pos = steps + t0
    slots = pos % size
    cache.ckv[:, slots] = c_kv.to(cache.ckv.dtype)
    cache.kpe[:, slots] = k_pe.to(cache.kpe.dtype)
    cache.pos[:, slots] = pos.to(torch.int32).expand(b, ln)
    return cache


def mla_decode(p, x, cache: MLACache, t, *, n_heads, qk_nope, qk_rope,
               kv_lora, v_dim, rope_theta=1e4, window=0):
    """Absorbed-form one-token MLA decode: scores and context in the
    compressed kv_lora space, the cache written in place. x (B,1,D); ``t``
    scalar, or (B,) per-row positions. ``kv_b`` is read as a plain weight
    (reshaped into W_uk, W_uv), and ``wo`` through :func:`dense`, so a
    served adapter on it applies at decode as at prefill."""
    b = x.shape[0]
    t = torch.as_tensor(t, device=x.device)
    pos1 = (t[:, None].to(torch.int32) if t.ndim
            else t.reshape(1).to(torch.int32))
    q_nope, q_pe, c_kv_new, k_pe_new = _mla_qkv(
        p, x, pos1, n_heads, qk_nope, qk_rope, kv_lora, rope_theta)
    cache = mla_cache_write(cache, c_kv_new, k_pe_new, t)

    kvb = p["kv_b"].reshape(kv_lora, n_heads, qk_nope + v_dim).float()
    w_uk, w_uv = kvb[..., :qk_nope], kvb[..., qk_nope:]
    # W_uk absorbed into the query: q_c[b,h,c] = Σ_d q_nope[b,h,d] W_uk[c,h,d]
    q_c = torch.einsum("bqhd,chd->bqhc", q_nope.float(), w_uk)
    ckv = cache.ckv.float()
    scores = (torch.einsum("bqhc,bsc->bhqs", q_c, ckv)
              + torch.einsum("bqhd,bsd->bhqs", q_pe.float(),
                             cache.kpe.float())) * _mla_scale(qk_nope,
                                                              qk_rope)
    q_pos = pos1.expand(b, 1)
    mask = causal_mask(q_pos, cache.pos, window) & (cache.pos[:, None, :] >= 0)
    scores = scores.masked_fill(~mask[:, None, :, :], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    ctx_c = torch.einsum("bhqs,bsc->bqhc", w, ckv)
    # W_uv absorbed on the way out.
    ctx = torch.einsum("bqhc,chd->bqhd", ctx_c, w_uv)
    out = dense(ctx.reshape(b, 1, n_heads * v_dim).to(x.dtype), p["wo"])
    return out, cache

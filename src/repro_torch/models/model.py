"""Config-driven decoder for every assigned family (port of
``repro/models/model.py``:
``init_params``, ``forward``, ``loss_fn``, ``prefill``, ``decode_step`` and
the decode state).

Params are the JAX tree: ``{"embed": {"w"}, "blocks": [period × stacked
per-layer dicts with a leading (n_blocks,) axis], "final_norm": {...}}``.
The JAX block ``lax.scan`` becomes a Python loop over ``n_blocks`` that
indexes every stacked leaf ``[i]`` (``MultiAdapterDelta`` fields too):
dim-0 views of contiguous tensors, no copies. The decode state's caches
are written in place through those views (``attention.kv_cache_write``),
so ``prefill`` and ``decode_step`` mutate the state they are given and
return it with the new position. ``forward`` and ``loss_fn`` are the
training read: autograd runs through the loop, with no activation
checkpointing.

Every layer kind of ``ArchConfig.layer_kinds`` runs through all five
entry points: GQA attention, MLA (DeepSeek-V2: a compressed cache,
absorbed-form decode; ``models/attention.py``) and Mamba (the hybrid's
recurrent layers; ``models/mamba.py``) as mixers, each with a dense MLP
or an MoE FFN (``models/moe.py``, shared experts included); and RWKV6
(time-mix + channel-mix, ``models/rwkv.py``). Positions are RoPE,
sinusoidal or none, and the vlm / audio backbones take a prefix of
frontend embeddings (``embeds``, from ``models/frontend.py``'s stubs).
``forward`` / ``loss_fn`` start each recurrent mix from a fresh zero
state, as the JAX ``_apply_mixer`` / ``_apply_ffn`` do, and
differentiate the WKV recurrence through ``kernels.ops.rwkv6_scan`` (the
forward and backward kernels on the card). A hybrid's decode state holds
each period position's own kind: KV caches, MLA caches or Mamba states,
all written in place.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from .. import resolve_device
from ..configs.base import ArchConfig
from ..utils import tree
from . import attention as attn_lib
from . import mamba as mamba_lib
from . import moe as moe_lib
from . import rwkv as rwkv_lib
from .layers import (apply_norm, dense_init, glu_mlp, glu_mlp_init, mlp,
                     mlp_init, norm_init, sinusoidal_positions)

PyTree = Any


_MIXERS = ("attn", "mla", "mamba")


def _check_ported(cfg: ArchConfig) -> None:
    """Refuse a config neither package runs: a positional scheme other
    than the schema's rope | sinusoidal | none, or RWKV layers mixed with
    other kinds."""
    kinds = set(cfg.layer_kinds())
    recurrent = kinds == {("rwkv", "cmix")}
    if (not (recurrent or kinds <= {(m, f) for m in _MIXERS
                                    for f in ("mlp", "moe")})
            or cfg.pos_emb not in ("rope", "none", "sinusoidal")):
        raise NotImplementedError(
            f"{cfg.name}: layer kinds {sorted(kinds)} / pos_emb "
            f"{cfg.pos_emb!r} are not a supported configuration")


# ------------------------------------------------------------------ init ----

def _init_stacked_layer(gen, cfg: ArchConfig, n_blocks: int, mix: str,
                        ffn: str) -> dict:
    """One period position's params, every leaf stacked (n_blocks, ...)."""
    dtype, dev, lead = cfg.param_dtype, gen.device, (n_blocks,)
    if cfg.rwkv:
        return {"norm1": norm_init(cfg.d_model, cfg.norm, device=dev,
                                   lead=lead),
                "tmix": rwkv_lib.time_mix_init(gen, cfg.d_model, dtype,
                                               lead=lead),
                "norm2": norm_init(cfg.d_model, cfg.norm, device=dev,
                                   lead=lead),
                "cmix": rwkv_lib.channel_mix_init(gen, cfg.d_model, cfg.d_ff,
                                                  dtype, lead=lead)}
    p = {"norm1": norm_init(cfg.d_model, cfg.norm, device=dev, lead=lead)}
    if mix == "attn":
        p["attn"] = attn_lib.gqa_init(gen, cfg.d_model, cfg.n_heads,
                                      cfg.n_kv_heads, cfg.hd, cfg.qkv_bias,
                                      dtype, lead=lead)
    elif mix == "mla":
        p["attn"] = attn_lib.mla_init(
            gen, cfg.d_model, cfg.n_heads, q_lora=cfg.q_lora_rank,
            kv_lora=cfg.kv_lora_rank, qk_nope=cfg.qk_nope_dim,
            qk_rope=cfg.qk_rope_dim, v_dim=cfg.v_head_dim, dtype=dtype,
            lead=lead)
    else:
        p["mamba"] = mamba_lib.mamba_init(
            gen, cfg.d_model, expand=cfg.mamba_expand,
            d_state=cfg.mamba_d_state, d_conv=cfg.mamba_d_conv, dtype=dtype,
            lead=lead)
    p["norm2"] = norm_init(cfg.d_model, cfg.norm, device=dev, lead=lead)
    if ffn == "moe":
        p["moe"] = moe_lib.moe_init(gen, cfg.d_model, cfg.n_experts,
                                    cfg.moe_d_ff or cfg.d_ff,
                                    cfg.n_shared_experts, dtype=dtype,
                                    lead=lead)
    else:
        init_mlp = glu_mlp_init if cfg.mlp_kind == "glu" else mlp_init
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, lead=lead)
    return p


def init_params(cfg: ArchConfig, seed: int = 0,
                device="cuda") -> PyTree:
    """Random params from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (weights N(0, 0.02²), biases 0, norm scales 1 in fp32), in
    the JAX tree layout. Not the JAX package's numbers: tests carry those
    across with ``convert.params_from_jax``."""
    _check_ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    kinds = cfg.layer_kinds()[: cfg.block_period()]
    params = {
        "embed": {"w": dense_init(gen, (cfg.vocab_size, cfg.d_model),
                                  dtype=cfg.param_dtype)},
        "blocks": [_init_stacked_layer(gen, cfg, cfg.n_blocks(), mix, ffn)
                   for mix, ffn in kinds],
        "final_norm": norm_init(cfg.d_model, cfg.norm, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": dense_init(gen, (cfg.d_model,
                                                   cfg.vocab_size),
                                             dtype=cfg.param_dtype)}
    return params


def _block(stacked: PyTree, i: int) -> PyTree:
    """Per-layer view ``[i]`` of every stacked leaf."""
    return tree.tree_map(lambda x: x[i], stacked)


# --------------------------------------------------------------- forward ----

def _embed(params, cfg: ArchConfig, tokens, embeds=None):
    """Token embeddings after the frontend's ``embeds`` prefix (B, F, D),
    with sinusoidal positions over the whole sequence, prefix included."""
    h = params["embed"]["w"][tokens]
    if embeds is not None:
        h = torch.cat([embeds.to(h.dtype), h], dim=1)
    if cfg.pos_emb == "sinusoidal":
        pos = torch.arange(h.shape[1], device=h.device)
        h = h + sinusoidal_positions(pos, cfg.d_model)[None].to(h.dtype)
    return h


def _logits(params, cfg: ArchConfig, h):
    h = apply_norm(h, params["final_norm"], cfg.norm)
    w = (params["embed"]["w"].T if cfg.tie_embeddings
         else params["lm_head"]["w"])
    return (h @ w).float()


def _ffn(lp, cfg: ArchConfig, h):
    """The layer's FFN with its residual: (h, the moe aux loss — 0.0 for a
    dense MLP)."""
    x = apply_norm(h, lp["norm2"], cfg.norm)
    if "moe" in lp:
        out, aux = moe_lib.moe_forward(lp["moe"], x, k=cfg.experts_per_token,
                                       act=cfg.act,
                                       capacity_factor=cfg.capacity_factor)
        return h + out, aux
    if cfg.mlp_kind == "glu":
        return h + glu_mlp(lp["mlp"], x, cfg.act), 0.0
    return h + mlp(lp["mlp"], x, cfg.act), 0.0


def _rwkv_train_layer(lp, cfg: ArchConfig, h):
    """One RWKV6 layer of the training forward: each mix starts from a
    fresh zero state (bf16 shifts, fp32 WKV), as the JAX ``_apply_mixer``
    / ``_apply_ffn`` start it, and writes none."""
    def fresh(x):
        return rwkv_lib.rwkv_state_init(x.shape[0], cfg.d_model,
                                        device=x.device)

    x = apply_norm(h, lp["norm1"], cfg.norm)
    h = h + rwkv_lib.time_mix_forward(lp["tmix"], x, fresh(x), cfg.d_model)
    x = apply_norm(h, lp["norm2"], cfg.norm)
    return h + rwkv_lib.channel_mix_forward(lp["cmix"], x, fresh(x))


def forward(params: PyTree, cfg: ArchConfig, tokens: torch.Tensor,
            embeds=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence causal forward over the ``embeds`` prefix (B, F, D)
    and the tokens. Returns (fp32 logits over both, moe aux loss summed
    over the layers — zero without MoE)."""
    _check_ported(cfg)
    kinds = cfg.layer_kinds()[: cfg.block_period()]
    h = _embed(params, cfg, tokens, embeds)
    positions = torch.arange(h.shape[1], device=h.device)
    aux = torch.zeros((), device=h.device)
    for i in range(cfg.n_blocks()):
        for j, (mix, _) in enumerate(kinds):
            lp = _block(params["blocks"][j], i)
            if mix == "rwkv":
                h = _rwkv_train_layer(lp, cfg, h)
                continue
            x = apply_norm(h, lp["norm1"], cfg.norm)
            if mix == "attn":
                out, _ = attn_lib.gqa_forward(
                    lp["attn"], x, positions, attn_chunk=cfg.attn_chunk,
                    **_attn_kwargs(cfg))
            elif mix == "mla":
                out, _ = attn_lib.mla_forward(
                    lp["attn"], x, positions, attn_chunk=cfg.attn_chunk,
                    **_mla_kwargs(cfg))
            else:
                out = mamba_lib.mamba_forward(lp["mamba"], x,
                                              **_mamba_kwargs(cfg))
            h, a = _ffn(lp, cfg, h + out)
            aux = aux + a
    return _logits(params, cfg, h), aux


def loss_fn(params: PyTree, cfg: ArchConfig, batch, aux_coef: float = 0.01
            ) -> torch.Tensor:
    """Next-token cross-entropy; labels == -1 are masked."""
    logits, aux = forward(params, cfg, batch["tokens"], batch.get("embeds"))
    labels = batch["labels"].long()
    n_front = logits.shape[1] - labels.shape[1]
    if n_front:
        logits = logits[:, n_front:]
    logp = torch.log_softmax(logits, dim=-1)
    mask = labels >= 0
    safe = torch.where(mask, labels, 0)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    ce = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)
    return ce + aux_coef * aux


# ---------------------------------------------------------------- decode ----

class DecodeState(NamedTuple):
    t: torch.Tensor     # int32 absolute position: 0-d (homogeneous batch)
                        # or (B,) per-slot (continuous batching)
    layers: PyTree      # list (period) of stacked per-block KVCaches,
                        # MLACaches, MambaStates or RwkvStates


def _layer_state_init(cfg: ArchConfig, mix: str, batch: int, cache_len: int,
                      dev):
    lead = (cfg.n_blocks(),)
    if mix == "mla":
        return attn_lib.mla_cache_init(batch, cache_len, cfg.kv_lora_rank,
                                       cfg.qk_rope_dim, device=dev,
                                       lead=lead)
    if mix == "mamba":
        # bf16 conv taps whatever the activation dtype, fp32 SSM state,
        # as the JAX package allocates them.
        return mamba_lib.mamba_state_init(
            batch, cfg.d_model, expand=cfg.mamba_expand,
            d_state=cfg.mamba_d_state, d_conv=cfg.mamba_d_conv, device=dev,
            lead=lead)
    if mix == "rwkv":
        # The JAX package starts the shifts in bf16 and its step replaces
        # them with x[:, -1] in the activation dtype; the port writes them
        # in place, so it allocates that dtype up front.
        return rwkv_lib.rwkv_state_init(batch, cfg.d_model,
                                        dtype=cfg.param_dtype, device=dev,
                                        lead=lead)
    return attn_lib.kv_cache_init(batch, cache_len, cfg.n_kv_heads, cfg.hd,
                                  device=dev, lead=lead)


def init_decode_state(cfg: ArchConfig, batch: int, cache_len: int,
                      per_slot: bool = False, device="cuda") -> DecodeState:
    """Empty per-layer states stacked (n_blocks, B, ...), one per period
    position by its mixer: bf16 KV caches of ``cache_len`` slots (GQA, as
    in the JAX package), bf16 compressed MLA caches of ``cache_len``
    slots, Mamba states (bf16 conv taps, fp32 SSM state) or RWKV states
    (shifts in the activation dtype, fp32 WKV); the recurrent ones ignore
    ``cache_len``. ``per_slot`` starts ``t`` as a (B,) vector — each batch
    row advances at its own depth."""
    _check_ported(cfg)
    dev = resolve_device(device)
    layers = [_layer_state_init(cfg, mix, batch, cache_len, dev)
              for mix, _ in cfg.layer_kinds()[: cfg.block_period()]]
    t = torch.zeros((batch,) if per_slot else (), dtype=torch.int32,
                    device=dev)
    return DecodeState(t=t, layers=layers)


def _attn_kwargs(cfg: ArchConfig) -> dict:
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
                rope=(cfg.pos_emb == "rope"), rope_theta=cfg.rope_theta,
                window=cfg.sliding_window)


def _mla_kwargs(cfg: ArchConfig) -> dict:
    return dict(n_heads=cfg.n_heads, qk_nope=cfg.qk_nope_dim,
                qk_rope=cfg.qk_rope_dim, kv_lora=cfg.kv_lora_rank,
                v_dim=cfg.v_head_dim, rope_theta=cfg.rope_theta,
                window=cfg.sliding_window)


def _mamba_kwargs(cfg: ArchConfig) -> dict:
    return dict(d_model=cfg.d_model, expand=cfg.mamba_expand,
                d_state=cfg.mamba_d_state, d_conv=cfg.mamba_d_conv)


def _rwkv_layer(lp, st, cfg: ArchConfig, h):
    """One RWKV6 layer over h (B, L, D) — time-mix, then channel-mix —
    writing the layer's recurrent state ``st`` in place."""
    x = apply_norm(h, lp["norm1"], cfg.norm)
    out, _ = rwkv_lib.time_mix_forward(lp["tmix"], x, st, cfg.d_model,
                                       return_state=True)
    h = h + out
    x = apply_norm(h, lp["norm2"], cfg.norm)
    out, _ = rwkv_lib.channel_mix_forward(lp["cmix"], x, st,
                                          return_state=True)
    return h + out


def decode_step(params: PyTree, cfg: ArchConfig, token: torch.Tensor,
                state: DecodeState) -> Tuple[torch.Tensor, DecodeState]:
    """One new token for every sequence in the batch. token (B,) int32.
    Returns (fp32 logits (B, V), state advanced by one)."""
    h = params["embed"]["w"][token][:, None, :]       # (B, 1, D)
    if cfg.pos_emb == "sinusoidal":
        t = state.t
        pos = t[:, None] if t.ndim else t[None]       # (B, 1) | (1,)
        emb = sinusoidal_positions(pos, cfg.d_model)
        h = h + (emb if t.ndim else emb[None]).to(h.dtype)
    kinds = cfg.layer_kinds()[: cfg.block_period()]
    for i in range(cfg.n_blocks()):
        for j, (mix, _) in enumerate(kinds):
            lp = _block(params["blocks"][j], i)
            st = _block(state.layers[j], i)
            if mix == "rwkv":
                h = _rwkv_layer(lp, st, cfg, h)
                continue
            x = apply_norm(h, lp["norm1"], cfg.norm)
            if mix == "attn":
                out, _ = attn_lib.gqa_decode(lp["attn"], x, st, state.t,
                                             **_attn_kwargs(cfg))
            elif mix == "mla":
                out, _ = attn_lib.mla_decode(lp["attn"], x, st, state.t,
                                             **_mla_kwargs(cfg))
            else:
                out, _ = mamba_lib.mamba_decode(lp["mamba"], x, st,
                                                **_mamba_kwargs(cfg))
            h, _ = _ffn(lp, cfg, h + out)
    logits = _logits(params, cfg, h)[:, 0, :]
    return logits, DecodeState(t=state.t + 1, layers=state.layers)


def prefill(params: PyTree, cfg: ArchConfig, tokens: torch.Tensor,
            state: DecodeState, embeds=None
            ) -> Tuple[torch.Tensor, DecodeState]:
    """Process a prompt after its ``embeds`` prefix, filling a fresh
    state's caches (recurrent layers: their states) in place. Returns
    (last-position fp32 logits, state with 0-d ``t`` = prefix + prompt
    length)."""
    kinds = cfg.layer_kinds()[: cfg.block_period()]
    h = _embed(params, cfg, tokens, embeds)
    l_total = h.shape[1]
    positions = torch.arange(l_total, device=h.device)
    for i in range(cfg.n_blocks()):
        for j, (mix, _) in enumerate(kinds):
            lp = _block(params["blocks"][j], i)
            st = _block(state.layers[j], i)
            if mix == "rwkv":
                h = _rwkv_layer(lp, st, cfg, h)
                continue
            x = apply_norm(h, lp["norm1"], cfg.norm)
            if mix == "attn":
                out, (k, v) = attn_lib.gqa_forward(
                    lp["attn"], x, positions, attn_chunk=cfg.attn_chunk,
                    **_attn_kwargs(cfg))
                attn_lib.kv_cache_write(st, k, v, 0)
            elif mix == "mla":
                out, (ckv, kpe) = attn_lib.mla_forward(
                    lp["attn"], x, positions, attn_chunk=cfg.attn_chunk,
                    **_mla_kwargs(cfg))
                attn_lib.mla_cache_write(st, ckv, kpe, 0)
            else:
                out, _ = mamba_lib.mamba_forward(
                    lp["mamba"], x, st, return_state=True,
                    **_mamba_kwargs(cfg))
            h, _ = _ffn(lp, cfg, h + out)
    logits = _logits(params, cfg, h[:, -1:, :])[:, 0, :]
    return logits, DecodeState(
        t=torch.tensor(l_total, dtype=torch.int32, device=h.device),
        layers=state.layers)

"""Architecture config schema + registry (port of ``repro/configs/base.py``).

The schema keeps every field of the JAX ``ArchConfig`` so a config module
reads the same in both packages; ``param_dtype`` is a torch dtype. Only the
configs the port can run are registered (``_load_all``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    pos_emb: str = "rope"          # rope | sinusoidal | none
    rope_theta: float = 1e4
    sliding_window: int = 0        # 0 = full attention
    # Blockwise attention chunk for prefill when L >= attn_chunk. 0 = off.
    attn_chunk: int = 4096
    norm: str = "rmsnorm"
    act: str = "silu"
    mlp_kind: str = "glu"          # glu | plain
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    moe_every: int = 1
    capacity_factor: float = 1.25
    # --- MLA (DeepSeek-V2) ---
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # --- hybrid (Jamba) ---
    attn_period: int = 0
    attn_offset: int = 0
    mamba_expand: int = 2
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    # --- SSM (RWKV6) ---
    rwkv: bool = False
    # --- modality frontend (stub) ---
    frontend: str = "none"
    frontend_tokens: int = 0
    # --- execution ---
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: bool = True
    unroll_blocks: bool = False
    citation: str = ""

    # ------------------------------------------------------------ derived --
    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def param_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def layer_kinds(self) -> List[Tuple[str, str]]:
        kinds = []
        for i in range(self.n_layers):
            if self.rwkv:
                kinds.append(("rwkv", "cmix"))
                continue
            if self.attn_period and i % self.attn_period != self.attn_offset:
                mix = "mamba"
            else:
                mix = "mla" if self.mla else "attn"
            if self.n_experts and (i % self.moe_every) == (self.moe_every - 1):
                ffn = "moe"
            else:
                ffn = "mlp"
            kinds.append((mix, ffn))
        return kinds

    def block_period(self) -> int:
        kinds = self.layer_kinds()
        n = len(kinds)
        for p in range(1, n + 1):
            if n % p == 0 and all(kinds[i] == kinds[i % p] for i in range(n)):
                return p
        return n

    def n_blocks(self) -> int:
        return self.n_layers // self.block_period()


# -------------------------------------------------------------- registry ----

_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"{name!r} is not registered in the port "
                       f"(ported: {sorted(_REGISTRY)})")
    return _REGISTRY[name]


def _load_all():
    from . import qwen1_5_0_5b, rwkv6_1_6b, starcoder2_7b  # noqa: F401


def smoke_variant(cfg: ArchConfig) -> ArchConfig:
    """Reduced config for CPU smoke tests: ≤2 layers·period, d_model ≤ 512,
    ≤4 experts — same family/topology, tiny dims."""
    d_model = min(cfg.d_model, 256)
    n_heads = max(1, min(cfg.n_heads, 4))
    if cfg.rwkv:
        d_model = 128            # multiple of HEAD_SIZE
        n_heads = 2
    head_dim = d_model // n_heads
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    while n_heads % n_kv:
        n_kv -= 1
    attn_period = 2 if cfg.attn_period else 0
    attn_offset = 1 if cfg.attn_period else 0
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=2,
        attn_period=attn_period,
        attn_offset=attn_offset,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=None if cfg.head_dim is None else head_dim,
        d_ff=min(cfg.d_ff, 512),
        vocab_size=min(cfg.vocab_size, 512),
        n_experts=min(cfg.n_experts, 4),
        experts_per_token=min(cfg.experts_per_token, 2),
        n_shared_experts=min(cfg.n_shared_experts, 1),
        moe_d_ff=min(cfg.moe_d_ff, 128) if cfg.moe_d_ff else 0,
        q_lora_rank=min(cfg.q_lora_rank, 64) if cfg.q_lora_rank else 0,
        kv_lora_rank=min(cfg.kv_lora_rank, 32) if cfg.kv_lora_rank else 0,
        qk_nope_dim=32 if cfg.mla else cfg.qk_nope_dim,
        qk_rope_dim=16 if cfg.mla else cfg.qk_rope_dim,
        v_head_dim=32 if cfg.mla else cfg.v_head_dim,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        frontend_tokens=min(cfg.frontend_tokens, 16) if cfg.frontend_tokens else 0,
        dtype="float32",
        remat=False,
    )

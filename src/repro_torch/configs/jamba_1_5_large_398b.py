"""jamba-1.5-large-398b [arXiv:2403.19887].

72L d_model=8192 64H (GQA kv=8, head_dim=128) d_ff=24576 vocab=65536.
Hybrid: attention every 8th layer (1:7 Mamba:attention interleave, attention
at block offset 3), MoE (16 experts top-2) on every other layer. No explicit
positional embedding — the Mamba recurrence carries position.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    head_dim=128,
    attn_period=8,
    attn_offset=3,
    mamba_expand=2,
    mamba_d_state=16,
    mamba_d_conv=4,
    n_experts=16,
    experts_per_token=2,
    moe_d_ff=24576,
    moe_every=2,
    act="silu",
    norm="rmsnorm",
    pos_emb="none",
    citation="arXiv:2403.19887",
))

"""deepseek-v2-236b [arXiv:2405.04434].

60L d_model=5120 128H MLA (kv_lora=512, q_lora=1536, qk 128 nope + 64 rope,
v 128) d_ff=1536 (routed expert width) vocab=102400; MoE 160 routed experts
top-6 + 2 shared experts per layer.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,         # MLA: logical value; the cache is kv_lora-compressed
    d_ff=1536,
    vocab_size=102400,
    mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    n_experts=160,
    experts_per_token=6,
    n_shared_experts=2,
    moe_d_ff=1536,
    moe_every=1,
    act="silu",
    norm="rmsnorm",
    pos_emb="rope",
    citation="arXiv:2405.04434",
))

"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base].

24L d_model=1024 16H (GQA kv=8) d_ff=512 vocab=49155, MoE 32 experts top-8.
Every layer is MoE with 512-wide experts; embeddings tied (model card).
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    head_dim=64,
    n_experts=32,
    experts_per_token=8,
    moe_d_ff=512,
    moe_every=1,
    tie_embeddings=True,
    act="silu",
    norm="rmsnorm",
    pos_emb="rope",
    citation="hf:ibm-granite/granite-3.0-1b-a400m-base",
))

"""command-r-35b [hf:CohereForAI/c4ai-command-r-v01].

40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000 — GQA, no bias,
tied embeddings (model card).
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    head_dim=128,
    qkv_bias=False,
    tie_embeddings=True,
    act="silu",
    norm="layernorm",
    pos_emb="rope",
    rope_theta=8e6,
    citation="hf:CohereForAI/c4ai-command-r-v01",
))

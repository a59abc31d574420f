"""qwen1.5-0.5b [hf:Qwen/Qwen1.5-0.5B].

24L d_model=1024 16H (GQA kv=16 — i.e. MHA) d_ff=2816 vocab=151936,
QKV bias, tied embeddings.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    act="silu",
    norm="rmsnorm",
    pos_emb="rope",
    citation="hf:Qwen/Qwen1.5-0.5B",
))

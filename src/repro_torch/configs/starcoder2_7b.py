"""starcoder2-7b [arXiv:2402.19173].

32L d_model=4608 36H (GQA kv=4, head_dim=128) d_ff=18432 vocab=49152 —
GQA + RoPE, LayerNorm + plain GELU MLP with bias, native sliding window 4096
(so long_500k decode is in-family, no override needed).
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab_size=49152,
    head_dim=128,
    qkv_bias=True,
    sliding_window=4096,
    act="gelu",
    mlp_kind="plain",
    norm="layernorm",
    pos_emb="rope",
    citation="arXiv:2402.19173",
))

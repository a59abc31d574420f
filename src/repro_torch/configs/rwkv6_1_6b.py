"""rwkv6-1.6b "Finch" [arXiv:2404.05892].

24L d_model=2048 (attention-free; 32 heads of size 64) d_ff=7168 vocab=65536.
RWKV6 time-mix with data-dependent decay + ddlerp token shift; squared-ReLU
channel-mix FFN. O(1)-state decode.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,             # d_model / 64 RWKV heads
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    rwkv=True,
    act="relu",
    norm="layernorm",
    pos_emb="none",
    citation="arXiv:2404.05892",
))

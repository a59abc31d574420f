"""musicgen-medium [arXiv:2306.05284].

48L d_model=1536 24H (MHA, kv=24) d_ff=6144 vocab=2048 — decoder-only
transformer over EnCodec tokens, sinusoidal positions, LayerNorm + GELU MLP.
The EnCodec audio codec (mel/conv frontend and the 4-codebook delay pattern)
is the STUB per the assignment carve-out: the backbone consumes/produces
single-stream codebook tokens (vocab 2048).
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    act="gelu",
    mlp_kind="plain",
    norm="layernorm",
    pos_emb="sinusoidal",
    frontend="audio",
    frontend_tokens=0,          # tokens ARE EnCodec codes; no embed prefix
    citation="arXiv:2306.05284",
))

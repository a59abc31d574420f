"""pixtral-12b [hf:mistralai/Pixtral-12B-2409].

Language decoder = mistral-nemo-12b dims (40L d_model=5120 32H GQA kv=8
d_ff=14336 vocab=131072). The Pixtral ViT vision encoder + projector is a
STUB per the assignment carve-out: ``input_specs`` supplies precomputed patch
embeddings (frontend_tokens × d_model) that are prepended to the token stream.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    head_dim=128,
    act="silu",
    norm="rmsnorm",
    pos_emb="rope",
    rope_theta=1e9,
    frontend="vision",
    frontend_tokens=1024,      # 1024 patch embeddings per image
    citation="hf:mistralai/Pixtral-12B-2409",
))

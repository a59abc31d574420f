"""Paper-scale vision backbone (ViT-base-like) for the DomainNet-analogue
federated benchmarks [Dosovitskiy 2020, paper §6]. Patch embeddings come from
the stub frontend; the backbone is the transformer."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="paper-vit-like",
    family="vlm",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=1000,        # classification head vocabulary
    act="gelu",
    mlp_kind="plain",
    norm="layernorm",
    pos_emb="sinusoidal",
    frontend="vision",
    frontend_tokens=196,
    citation="paper §6 / Dosovitskiy 2020",
))

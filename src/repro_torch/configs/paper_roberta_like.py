"""Paper-scale NLU backbone (RoBERTa-base-like causal variant) used by the
GLUE-analogue federated benchmarks [Liu 2019, paper §6]. 12L d=768 12H."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="paper-roberta-like",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=50265,
    act="gelu",
    mlp_kind="plain",
    norm="layernorm",
    pos_emb="sinusoidal",
    citation="paper §6 / Liu 2019",
))

"""Paper-scale NLG backbone (Llama-2-7B-like) for the MetaMathQA-analogue
federated benchmarks [Touvron 2023b, paper §6]. 32L d=4096 32H MHA."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="paper-llama-like",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab_size=32000,
    act="silu",
    norm="rmsnorm",
    pos_emb="rope",
    citation="paper §6 / Touvron 2023b",
))

"""mistral-nemo-12b [hf:mistralai/Mistral-Nemo-Base-2407].

40L d_model=5120 32H (GQA kv=8, head_dim=128) d_ff=14336 vocab=131072,
128k context (rope theta 1M). The long_500k decode shape runs the
sliding-window variant (window applied by the shape override, DESIGN.md §5).
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mistral-nemo-12b",
    family="dense",
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
    rope_theta=1e6,
    citation="hf:mistralai/Mistral-Nemo-Base-2407",
))

"""Gradient transformations (port of ``repro/optim``): the chain that
``core.galore.galore_adamw`` composes."""
from .base import (GradientTransformation, chain, clip_by_global_norm,
                   global_norm, scale_by_learning_rate)
from .adamw import AdamState, adamw, add_decayed_weights, scale_by_adam
from .schedule import constant, cosine_with_warmup, linear_warmup_frac

__all__ = [
    "GradientTransformation", "chain", "clip_by_global_norm", "global_norm",
    "scale_by_learning_rate", "AdamState", "adamw", "add_decayed_weights",
    "scale_by_adam", "constant", "cosine_with_warmup", "linear_warmup_frac",
]

"""Gradient transformations (port of ``repro/optim``): the chains the
federated methods' local optimizers 𝒯 compose."""
from .base import (GradientTransformation, apply_updates, chain,
                   clip_by_global_norm, global_norm, scale_by_learning_rate)
from .adamw import (AdamState, MomentumState, adam, adamw,
                    add_decayed_weights, scale_by_adam, scale_by_momentum,
                    sgd)
from .schedule import constant, cosine_with_warmup, linear_warmup_frac

__all__ = [
    "GradientTransformation", "apply_updates", "chain",
    "clip_by_global_norm", "global_norm", "scale_by_learning_rate",
    "AdamState", "MomentumState", "adam", "adamw", "add_decayed_weights",
    "scale_by_adam", "scale_by_momentum", "sgd", "constant",
    "cosine_with_warmup", "linear_warmup_frac",
]

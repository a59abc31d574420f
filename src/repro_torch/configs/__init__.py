"""Architecture configs (one module per assigned arch, plus the paper's
backbones): the dense family (qwen1.5-0.5b, starcoder2-7b,
mistral-nemo-12b, command-r-35b and the paper's backbones), the MoE
models granite-moe-1b-a400m and deepseek-v2-236b (MLA), the
Mamba/attention hybrid jamba-1.5-large-398b, rwkv6-1.6b, and the vlm /
audio backbones behind their stub frontends (pixtral-12b,
musicgen-medium)."""
from .base import (ArchConfig, get_config, list_configs, register,
                   smoke_variant)

# The ten architectures assigned to this paper (public pool).
ASSIGNED_ARCHS = [
    "granite-moe-1b-a400m",
    "deepseek-v2-236b",
    "command-r-35b",
    "mistral-nemo-12b",
    "qwen1.5-0.5b",
    "pixtral-12b",
    "jamba-1.5-large-398b",
    "starcoder2-7b",
    "musicgen-medium",
    "rwkv6-1.6b",
]

__all__ = ["ArchConfig", "get_config", "list_configs", "register",
           "smoke_variant", "ASSIGNED_ARCHS"]

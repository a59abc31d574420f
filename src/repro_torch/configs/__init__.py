"""Architecture configs the port can run: the dense family (qwen1.5-0.5b,
starcoder2-7b, mistral-nemo-12b, command-r-35b and the paper's
backbones), granite-moe-1b-a400m, rwkv6-1.6b, and the vlm / audio
backbones behind their stub frontends (pixtral-12b, musicgen-medium)."""
from .base import ArchConfig, get_config, register, smoke_variant

# The ten architectures assigned to this paper (public pool).
# deepseek-v2-236b (MLA) and jamba-1.5-large-398b (Mamba) are not
# registered in the port yet (ROADMAP Queue 1 items 11.5, 11.6).
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

__all__ = ["ArchConfig", "get_config", "register", "smoke_variant",
           "ASSIGNED_ARCHS"]

"""Architecture configs the port can run (qwen1.5-0.5b, rwkv6-1.6b,
starcoder2-7b)."""
from .base import ArchConfig, get_config, register, smoke_variant

__all__ = ["ArchConfig", "get_config", "register", "smoke_variant"]

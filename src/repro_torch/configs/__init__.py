"""Architecture configs the port can run (qwen1.5-0.5b so far)."""
from .base import ArchConfig, get_config, register, smoke_variant

__all__ = ["ArchConfig", "get_config", "register", "smoke_variant"]

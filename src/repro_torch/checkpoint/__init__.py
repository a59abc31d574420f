"""Crash-safe tree checkpoints (port of ``repro/checkpoint``)."""
from .io import gc_steps, latest_step, restore, save

__all__ = ["save", "restore", "latest_step", "gc_steps"]

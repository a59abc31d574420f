"""The four assigned input shapes and their input specs (port of
``repro/configs/shapes.py``).

``input_specs(cfg, shape)`` returns every model input as a tensor on the
``meta`` device: shape and dtype, no storage, so it never allocates at
any size.

long_500k requires sub-quadratic attention: RWKV6 is O(1)-state, Jamba is
Mamba + sparse attention, starcoder2 has a native 4096 window; every other
(full-attention) arch runs a **sliding-window variant** (window=8192) at this
shape, applied by ``shape_variant``. Decode caches for windowed attention
are ring buffers of size=window, so long-context decode memory is
O(window), not O(context).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from .base import ArchConfig

LONG_CONTEXT_WINDOW = 8192


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_variant(cfg: ArchConfig, shape: ShapeSpec) -> ArchConfig:
    """Arch adjustments a shape requires (the long_500k SWA carve-out)."""
    if shape.name == "long_500k" and not cfg.rwkv and not cfg.sliding_window:
        return dataclasses.replace(cfg, sliding_window=LONG_CONTEXT_WINDOW)
    return cfg


def cache_len(cfg: ArchConfig, shape: ShapeSpec) -> int:
    """KV slots needed for a decode shape: the window for SWA ring buffers,
    the full context otherwise."""
    if cfg.sliding_window:
        return min(shape.seq_len, cfg.sliding_window)
    return shape.seq_len


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict:
    """Meta-device inputs for (arch, shape). Keys by shape kind:

      train   -> {tokens, labels[, embeds]}
      prefill -> {tokens[, embeds]}
      decode  -> {token, state}
    """
    cfg = shape_variant(cfg, shape)
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        n_text = s - cfg.frontend_tokens
        spec = {"tokens": _meta((b, n_text), torch.int32)}
        if cfg.frontend_tokens:
            spec["embeds"] = _meta((b, cfg.frontend_tokens, cfg.d_model),
                                   torch.bfloat16)
        if shape.kind == "train":
            spec["labels"] = _meta((b, n_text), torch.int32)
        return spec
    # decode: one new token + a full cache/state at seq_len context
    from ..models import model as model_lib
    state = model_lib.init_decode_state(cfg, b, cache_len(cfg, shape),
                                        device="meta")
    return {"token": _meta((b,), torch.int32), "state": state}

"""Modality frontend stubs (port of ``repro/models/frontend.py``).

The vlm / audio configs specify the transformer backbone only; the real
frontends (Pixtral's ViT and projector, EnCodec's codec) are not
implemented in either package. These helpers draw deterministic synthetic
patch / frame embeddings of the right shape on the port's threefry
(``utils/prng.py``), so they are the JAX package's numbers for the same
key: fp32 draws within an ulp of JAX's, then the same bf16 cast.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..utils import prng

PROTO_SEED, N_PROTOS = 7, 1024


def _patch_fp32(key: torch.Tensor, cfg: ArchConfig, batch: int,
                class_id=None) -> torch.Tensor:
    """The fp32 draw behind ``stub_patch_embeddings``, before its cast."""
    base = prng.normal(key, (batch, cfg.frontend_tokens, cfg.d_model))
    if class_id is not None:
        protos = prng.normal(prng.PRNGKey(PROTO_SEED, device=key.device),
                             (N_PROTOS, cfg.d_model))
        ids = torch.as_tensor(class_id, device=key.device).long()
        base = base + 2.0 * protos[ids][:, None, :]
    return base


def _frame_fp32(key: torch.Tensor, cfg: ArchConfig, batch: int,
                n_frames: int) -> torch.Tensor:
    """The fp32 draw behind ``stub_frame_embeddings``, before its cast."""
    return prng.normal(key, (batch, n_frames, cfg.d_model))


def stub_patch_embeddings(key: torch.Tensor, cfg: ArchConfig, batch: int,
                          class_id=None) -> torch.Tensor:
    """(B, frontend_tokens, d_model) bf16 synthetic patch embeddings on
    ``key``'s device. When ``class_id`` (B,) is given, each row carries
    twice its class prototype (rows of a (1024, d_model) draw from
    ``PRNGKey(7)``), so classification tasks have learnable structure."""
    return _patch_fp32(key, cfg, batch, class_id).to(torch.bfloat16)


def stub_frame_embeddings(key: torch.Tensor, cfg: ArchConfig, batch: int,
                          n_frames: int) -> torch.Tensor:
    """(B, n_frames, d_model) bf16 synthetic audio-frame embeddings."""
    return _frame_fp32(key, cfg, batch, n_frames).to(torch.bfloat16)

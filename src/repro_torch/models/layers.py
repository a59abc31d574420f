"""Shared building blocks: norms, activations, MLPs, RoPE, and the
multi-adapter serving leaf (port of ``repro/models/layers.py``).

Functions take and return tensors; params are nested dicts with the JAX
tree's keys. The lift-free training leaf (``LowRankDelta``) belongs to the
training slice and is not ported yet.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..kernels import ops as kops


def dense_init(gen: torch.Generator, shape, scale: float = 0.02,
               dtype=torch.float32):
    return (scale * torch.randn(shape, generator=gen,
                                device=gen.device)).to(dtype)


# ------------------------------------------- multi-adapter serving context --
#
# One shared base weight plus a TABLE of G adapters' factors; each row of
# the batch selects its own adapter by the (B,) ids installed with
# `adapter_ids(...)`. Per row:
#
#   y[b] = scales[g]·(x[b] @ W) + split-matmul(x[b], bases[g], rts[g]),
#   g = ids[b]
#
# routed through kernels.ops.lowrank_linear_batched (the CUDA kernel on the
# card, its plain version on the CPU). Forward-only: serving never
# differentiates the leaf. Ragged per-adapter ranks arrive zero-padded.

_ADAPTER_IDS = [None]   # (B,) int32 adapter index per batch row


@contextlib.contextmanager
def adapter_ids(ids):
    """Install the per-row adapter ids consumed by ``dense`` when it meets a
    :class:`MultiAdapterDelta` leaf. ``ids`` must sit on the model's
    device."""
    _ADAPTER_IDS.append(None if ids is None
                        else torch.as_tensor(ids, dtype=torch.int32))
    try:
        yield
    finally:
        _ADAPTER_IDS.pop()


class MultiAdapterDelta(NamedTuple):
    """A served target leaf: shared base weight plus a G-adapter factor
    table. Stacked params carry a common leading axis — (nb, m, n) bases
    pair with (nb, G, dim, r) tables — and ``leaf[i]``-style slicing of
    every field (see ``model.py``) gives the per-layer view."""
    w: torch.Tensor        # (..., m, n) shared base weight
    bases: torch.Tensor    # (..., G, n, r) right | (..., G, m, r) left
    rts: torch.Tensor      # (..., G, m, r) right | (..., G, r, n) left
    scales: torch.Tensor   # (..., G) per-adapter base_scale

    @property
    def shape(self):
        return self.w.shape

    @property
    def dtype(self):
        return self.w.dtype

    @property
    def ndim(self):
        return self.w.ndim

    @property
    def side(self) -> str:
        m, n = self.w.shape[-2:]
        return "right" if m >= n else "left"

    def __rmatmul__(self, x):
        """``x @ leaf`` — decode projections (``x @ p["wq"]``) route here:
        ``Tensor.__matmul__`` returns NotImplemented for this class."""
        return dense(x, self)


def multi_adapter_apply(leaf: MultiAdapterDelta, x, ids):
    """Batched heterogeneous-adapter apply for one leaf. x (B, t, m) or
    (B, m); ids (B,). The leaf must be sliced to its per-layer view (2-D
    base) first."""
    if leaf.w.ndim != 2:
        raise ValueError(
            "multi-adapter leaf applied with a stacked base "
            f"{tuple(leaf.w.shape)} — expected the scan-sliced per-layer view")
    if x.shape[0] != ids.shape[0]:
        raise ValueError(
            f"adapter ids cover {ids.shape[0]} rows but the batch has "
            f"{x.shape[0]} — one id per decode row is required")
    return kops.lowrank_linear_batched(x, leaf.w, leaf.bases, leaf.rts,
                                       leaf.scales, ids, side=leaf.side)


def dense(x, w):
    """Delta-aware linear apply: ``x @ w`` for plain weights; the per-row
    heterogeneous-adapter apply when ``w`` is a :class:`MultiAdapterDelta`
    serving leaf (batch ids from the ambient :func:`adapter_ids`)."""
    if isinstance(w, MultiAdapterDelta):
        ids = _ADAPTER_IDS[-1]
        if ids is None:
            raise ValueError(
                "MultiAdapterDelta leaf read outside an adapter_ids(...) "
                "context — the serving loop must install the per-row "
                "adapter ids around the forward")
        return multi_adapter_apply(w, x, ids)
    return x @ w


# ------------------------------------------------------------------ norms --

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * weight.float()
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5):
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    out = out * weight.float() + bias.float()
    return out.to(x.dtype)


def apply_norm(x, p, kind: str):
    if kind == "rmsnorm":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


def norm_init(d: int, kind: str, dtype=torch.float32, device=None,
              lead=()):
    shape = tuple(lead) + (d,)
    if kind == "rmsnorm":
        return {"scale": torch.ones(shape, dtype=dtype, device=device)}
    return {"scale": torch.ones(shape, dtype=dtype, device=device),
            "bias": torch.zeros(shape, dtype=dtype, device=device)}


ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),   # jax.nn.gelu default
    "relu": F.relu,
}


def glu_mlp_init(gen, d_model: int, d_ff: int, dtype=torch.float32,
                 lead=()):
    """``lead`` prepends stacked-block dims."""
    lead = tuple(lead)
    return {"w_gate": dense_init(gen, lead + (d_model, d_ff), dtype=dtype),
            "w_up": dense_init(gen, lead + (d_model, d_ff), dtype=dtype),
            "w_down": dense_init(gen, lead + (d_ff, d_model), dtype=dtype)}


def glu_mlp(p, x, act: str = "silu"):
    """Gated MLP (SwiGLU family) — llama/mistral/command-r style."""
    gate = ACTS[act](dense(x, p["w_gate"]))
    return dense(gate * dense(x, p["w_up"]), p["w_down"])


def mlp_init(gen, d_model: int, d_ff: int, dtype=torch.float32, lead=()):
    lead = tuple(lead)
    return {"w_up": dense_init(gen, lead + (d_model, d_ff), dtype=dtype),
            "w_down": dense_init(gen, lead + (d_ff, d_model), dtype=dtype)}


def mlp(p, x, act: str = "gelu"):
    """Plain 2-layer MLP (starcoder2 / musicgen style)."""
    return dense(ACTS[act](dense(x, p["w_up"])), p["w_down"])


# ------------------------------------------------------------------ RoPE ----

def rope_freqs(head_dim: int, theta: float = 1e4, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) absolute.
    Half-split (not interleaved) rotation with fp32 angles."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)     # (hd/2,)
    angles = positions[..., :, None].float() * freqs   # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]              # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x32 = x.float()
    x1, x2 = x32[..., : hd // 2], x32[..., hd // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)

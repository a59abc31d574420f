"""Shared building blocks: norms, activations, MLPs, RoPE, the lift-free
training leaf and the multi-adapter serving leaf (port of
``repro/models/layers.py``).

Functions take and return tensors; params are nested dicts with the JAX
tree's keys. Every projection reads its weight through :func:`dense`, so a
:class:`LowRankDelta` (training) or :class:`MultiAdapterDelta` (serving)
leaf can stand in for a weight without the model changing.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..kernels import ops as kops


def dense_init(gen: torch.Generator, shape, scale: float = 0.02,
               dtype=torch.float32):
    """N(0, scale²) weights. The draw is scaled in place, so a bf16 leaf
    holds one fp32 copy at a time beside it (a full-width expert stack is
    20 GB in fp32)."""
    return torch.randn(shape, generator=gen,
                       device=gen.device).mul_(scale).to(dtype)


# ------------------------------------------------- lift-free delta context --
#
# A factored client's effective weight is W_eff = scale·W + lift(R̃, B): a
# rank-r delta around the broadcast base. A LowRankDelta replaces the weight
# leaf inside the loss, and every `x @ w`-style read routes through
# `dense()` / `__rmatmul__` to the split-matmul apply
#
#   right (m ≥ n):  y = scale·(x@W) + (x@R̃)@Bᵀ        R̃ (m, r), B (n, r)
#   left  (m < n):  y = scale·(x@W) + (x@B)@R̃          B (m, r), R̃ (r, n)
#
# (kernels.ops.lowrank_linear: the CUDA kernel on the card, its plain
# version on the CPU) under an autograd Function whose backward returns the
# cotangent of R̃ already in rank-r coordinates (right: xᵀ(∂y B); left:
# (xB)ᵀ∂y — never the dense xᵀ∂y) and, as the cotangent of the zero probe
# `nsq`, the exact squared Frobenius norm of the dense weight gradient for
# global-norm clipping. `w`, `basis` and `scale` get no gradient.


class LowRankDelta(NamedTuple):
    """A factored target leaf: the base weight plus its never-lifted rank-r
    delta. Stacked params carry a common leading axis on every field, and
    ``leaf[i]``-style slicing of every field gives the per-layer view."""
    w: torch.Tensor       # (..., m, n) broadcast base weight
    basis: torch.Tensor   # (..., n, r) right | (..., m, r) left (orthonormal)
    rt: torch.Tensor      # (..., m, r) right | (..., r, n) left — the delta R̃
    nsq: torch.Tensor     # (...,) zeros — dense-grad ‖·‖² probe
    scale: torch.Tensor   # (...,) base_scale = (1-ηλ)^t

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
        """proj_type=std side rule on the ambient shape (right iff m >= n)."""
        m, n = self.w.shape[-2:]
        return "right" if m >= n else "left"

    def __rmatmul__(self, x):
        """``x @ delta_leaf`` — ``Tensor.__matmul__`` returns
        NotImplemented for this class, so the read routes here."""
        return dense(x, self)

    def read(self):
        """Materialize ``scale·w + lift(rt)`` for non-matmul consumption;
        the backward still returns the rank-r cotangent and the probe
        ``‖∂y‖²``."""
        return lowrank_read(self.side, self.w, self.basis, self.rt,
                            self.nsq, self.scale)

    def __add__(self, other):
        return self.read() + other

    def __radd__(self, other):
        return other + self.read()


def _lift(rt, basis, side):
    if side == "right":
        return torch.einsum("...mr,...nr->...mn", rt, basis)
    return torch.einsum("...mr,...rn->...mn", basis, rt)


def _project(g, basis, side):
    if side == "right":
        return torch.einsum("...mn,...nr->...mr", g, basis)
    return torch.einsum("...mr,...mn->...rn", basis, g)


class _LowRankRead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, side, w, basis, rt, nsq, scale):
        ctx.side = side
        ctx.save_for_backward(basis)
        s = scale.float().reshape(scale.shape + (1, 1))
        out = s * w.float() + _lift(rt.float(), basis.float(), side)
        return out.to(w.dtype)

    @staticmethod
    def backward(ctx, dy):
        (basis,) = ctx.saved_tensors
        dy32 = dy.float()
        drt = _project(dy32, basis.float(), ctx.side)
        dnsq = torch.sum(dy32 * dy32, dim=(-2, -1))
        return None, None, None, drt, dnsq, None


def lowrank_read(side, w, basis, rt, nsq, scale):
    """Materialized delta-leaf read ``scale·w + lift(rt, basis)``; backward:
    the ``rt`` cotangent projected (``project(∂y, B)``), the probe the exact
    ``‖∂y‖²``."""
    return _LowRankRead.apply(side, w, basis, rt, nsq, scale)


_SQNORM_TILE = 1024


def _sqnorm_gram(x2, dy2, tile: int = _SQNORM_TILE):
    """Exact ``‖x2ᵀ dy2‖²_F = Σᵢⱼ (x2 x2ᵀ)ᵢⱼ (dy2 dy2ᵀ)ᵢⱼ`` without the
    (m, n) product. Short token counts take one (t, t) Gram pair; longer
    ones loop over row tiles so the transient working set is O(nt·tile²)
    per tile instead of O(t²). Zero-padding the tail tile is sound (zero
    rows contribute zero to both Grams)."""
    t = x2.shape[0]
    if t <= tile:
        return torch.sum((x2 @ x2.mT) * (dy2 @ dy2.mT))
    nt = -(-t // tile)
    pad = nt * tile - t
    xp = torch.nn.functional.pad(x2, (0, 0, 0, pad)).reshape(nt, tile, -1)
    dyp = torch.nn.functional.pad(dy2, (0, 0, 0, pad)).reshape(nt, tile, -1)
    acc = torch.zeros((), dtype=torch.float32, device=x2.device)
    for xi, dyi in zip(xp, dyp):
        cx = torch.einsum("tm,jsm->jts", xi, xp)
        cd = torch.einsum("tn,jsn->jts", dyi, dyp)
        acc = acc + torch.sum(cx * cd)
    return acc


class _LowRankApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, side, x, w, basis, rt, nsq, scale):
        ctx.side = side
        ctx.save_for_backward(x, w, basis, rt, scale)
        return kops.lowrank_linear(x, w, basis, rt, scale, side=side)

    @staticmethod
    def backward(ctx, dy):
        x, w, basis, rt, scale = ctx.saved_tensors
        m, n = w.shape
        dy32, x32 = dy.float(), x.float()
        b32, r32 = basis.float(), rt.float()
        # dx through the effective weight, split low-rank (never lift(rt)).
        if ctx.side == "right":
            dx = scale * (dy32 @ w.float().mT) + (dy32 @ b32) @ r32.mT
        else:
            dx = scale * (dy32 @ w.float().mT) + (dy32 @ r32.mT) @ b32.mT
        # Projected cotangent for R̃ — rank-r coordinates, no dense xᵀ∂y.
        x2, dy2 = x32.reshape(-1, m), dy32.reshape(-1, n)
        if ctx.side == "right":
            drt = x2.mT @ (dy2 @ b32)
        else:
            drt = (x2 @ b32).mT @ dy2
        dnsq = _sqnorm_gram(x2, dy2)
        return None, dx.to(x.dtype), None, None, drt, dnsq, None


def lowrank_apply(side, x, w, basis, rt, nsq, scale):
    """The lift-free delta read ``x @ (scale·w + lift(rt, basis))`` as split
    matmuls (``kernels.ops.lowrank_linear``). ``nsq`` (zeros) is the norm
    probe: its gradient is the exact ``‖xᵀ∂y‖²_F`` of the dense weight
    gradient, from token Grams (:func:`_sqnorm_gram`), so global-norm
    clipping matches the transient-lift path without the m×n cotangent
    ever existing. Caveat, as in the reference: autograd sums the probe
    across *uses* of a leaf, so a weight read more than once per forward
    (MLA's ``kv_b`` at or above ``attn_chunk``, once per visited chunk
    pair in ``_mla_blockwise``) gets ``Σᵤ‖gᵤ‖²`` instead of the exact
    ``‖Σᵤgᵤ‖²``: the sign-indefinite cross-use terms are missing, so it is
    neither a bound nor exact. The reference gates that configuration
    off the lift-free path in its sharded round step (``launch/steps.py::
    make_fed_round_step``, ROADMAP Queue 1 item 12), not in
    ``FedEngine``; the port mirrors the per-use sum, as the reference
    computes it, and does not correct it. Every single-read weight is
    exact."""
    return _LowRankApply.apply(side, x, w, basis, rt, nsq, scale)


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
    """Delta-aware linear apply: ``x @ w`` for plain weights; the lift-free
    split-matmul read when ``w`` is a :class:`LowRankDelta` training leaf;
    the per-row heterogeneous-adapter apply when ``w`` is a
    :class:`MultiAdapterDelta` serving leaf (batch ids from the ambient
    :func:`adapter_ids`)."""
    if isinstance(w, LowRankDelta):
        return lowrank_apply(w.side, x, w.w, w.basis, w.rt, w.nsq, w.scale)
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


def sinusoidal_positions(positions: torch.Tensor, d_model: int
                         ) -> torch.Tensor:
    """Any-length sinusoidal embeddings (musicgen, the paper's roberta and
    vit backbones — no learned table): (..., d_model) fp32, ``sin`` over
    the first half, ``cos`` over the second."""
    half = d_model // 2
    log_base = torch.log(torch.tensor(10000.0, dtype=torch.float32,
                                      device=positions.device))
    freqs = torch.exp(-log_base * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)

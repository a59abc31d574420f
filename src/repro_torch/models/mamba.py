"""Mamba (selective SSM) layer, the recurrent half of Jamba's interleave
(port of ``repro/models/mamba.py``).

Selective scan: h_t = exp(Δ_t ⊙ A) h_{t-1} + (Δ_t ⊙ x_t) B_tᵀ ;
y_t = h_t C_t + D x_t. The JAX package scans the state (B, d_inner,
d_state) with ``lax.scan``, not a Pallas kernel, and the port's scan is
plain PyTorch too: a Python loop over time that forms each step's decay
exp(Δ_t ⊙ A) and input (Δ_t ⊙ x_t) B_t, as JAX's step does, so no
(L, d_inner, d_state) tensor exists. Decode carries the SSM state plus a
(d_conv-1)-tap shift register for the causal depthwise conv.

Numerics follow the JAX package. The conv taps of the state are bf16
whatever the activation dtype (JAX allocates them bf16 and casts the
prefill's taps to bf16), so an fp32 model rounds them too; ``a_log``,
``dt_bias``, ``d_skip`` and h stay fp32 in a bf16 model. The depthwise
conv sums its taps in JAX's Python ``sum`` order, from 0. Δ's softplus is
``torch.nn.functional.softplus`` on fp32: it returns x past its threshold
of 20, where JAX computes logaddexp(x, 0), but there exp(-x) is below
half an fp32 ulp of x, so the two agree; below it they differ by at most
2 ulp (1.6e-7 relative on [-40, 40], their exp and log1p rounding apart;
writing JAX's formula in torch reads the same gap at more points).

With ``return_state`` the forward writes the given :class:`MambaState`'s
tensors in place, and :func:`mamba_decode` always does, as the KV caches
and RWKV states are written.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .layers import dense, dense_init

def mamba_dims(d_model: int, expand: int = 2, d_state: int = 16,
               d_conv: int = 4):
    d_inner = expand * d_model
    dt_rank = max(1, math.ceil(d_model / 16))
    return d_inner, dt_rank, d_state, d_conv


def mamba_init(gen, d_model: int, *, expand: int = 2, d_state: int = 16,
               d_conv: int = 4, dtype=torch.float32, lead=()):
    """Params of one Mamba mixer; ``lead`` prepends stacked-block dims."""
    d_inner, dt_rank, d_state, d_conv = mamba_dims(d_model, expand, d_state,
                                                   d_conv)
    lead, dev = tuple(lead), gen.device
    a = torch.arange(1, d_state + 1, dtype=torch.float32, device=dev)
    return {
        "in_proj": dense_init(gen, lead + (d_model, 2 * d_inner),
                              dtype=dtype),
        "conv_w": dense_init(gen, lead + (d_conv, d_inner), scale=0.1,
                             dtype=dtype),
        "conv_b": torch.zeros(lead + (d_inner,), dtype=dtype, device=dev),
        "x_proj": dense_init(gen, lead + (d_inner, dt_rank + 2 * d_state),
                             dtype=dtype),
        "dt_proj": dense_init(gen, lead + (dt_rank, d_inner), dtype=dtype),
        "dt_bias": torch.zeros(lead + (d_inner,), dtype=torch.float32,
                               device=dev),
        "a_log": torch.log(a).expand(lead + (d_inner, d_state)).clone(),
        "d_skip": torch.ones(lead + (d_inner,), dtype=torch.float32,
                             device=dev),
        "out_proj": dense_init(gen, lead + (d_inner, d_model), dtype=dtype),
    }


class MambaState(NamedTuple):
    conv: torch.Tensor   # (B, d_conv-1, d_inner) last inputs, bf16
    h: torch.Tensor      # (B, d_inner, d_state) fp32 SSM state


def mamba_state_init(batch: int, d_model: int, *, expand: int = 2,
                     d_state: int = 16, d_conv: int = 4,
                     dtype=torch.bfloat16, device=None,
                     lead=()) -> MambaState:
    """A zero state; ``lead`` prepends stacked-block dims."""
    d_inner, _, d_state, d_conv = mamba_dims(d_model, expand, d_state,
                                             d_conv)
    lead = tuple(lead)
    return MambaState(
        conv=torch.zeros(lead + (batch, d_conv - 1, d_inner), dtype=dtype,
                         device=device),
        h=torch.zeros(lead + (batch, d_inner, d_state), dtype=torch.float32,
                      device=device))


def _causal_depthwise_conv(x, w, b, init_taps=None):
    """x (B, L, C), w (K, C): causal depthwise conv along L, the taps
    summed from 0 in order."""
    k = w.shape[0]
    if init_taps is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = init_taps.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                  # (B, L+K-1, C)
    out = 0
    for i in range(k):
        out = out + xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
    return out + b[None, None, :]


def _ssm_params(p, xc, dt_rank, d_state):
    """xc (..., d_inner) -> fp32 Δ (..., d_inner), B, C (..., d_state)."""
    proj = xc @ p["x_proj"]
    dt = proj[..., :dt_rank]
    bmat = proj[..., dt_rank:dt_rank + d_state]
    cmat = proj[..., dt_rank + d_state:]
    delta = F.softplus(dt @ p["dt_proj"] + p["dt_bias"]).float()
    return delta, bmat.float(), cmat.float()


def _scan(xc, delta, bmat, cmat, a, h):
    """The selective scan from state h (B, di, ds) over L steps, one step
    at a time as JAX's ``lax.scan`` body: y (B, L, di) fp32 and the final
    state."""
    ys = []
    for t in range(xc.shape[1]):
        d_t = delta[:, t]
        h = (torch.exp(d_t[..., None] * a) * h
             + (d_t * xc[:, t].float())[..., None] * bmat[:, t, None, :])
        ys.append(torch.einsum("bds,bs->bd", h, cmat[:, t]))
    return torch.stack(ys, dim=1), h


def mamba_forward(p, x, state: MambaState = None, *, d_model: int,
                  expand: int = 2, d_state: int = 16, d_conv: int = 4,
                  return_state: bool = False):
    """x (B, L, D) -> (B, L, D) from ``state`` (None: zeros). With
    ``return_state`` the final conv taps (bf16) and SSM state are written
    into ``state`` in place (a fresh one when None) and returned beside
    the output."""
    d_inner, dt_rank, d_state, d_conv = mamba_dims(d_model, expand, d_state,
                                                   d_conv)
    b_ = x.shape[0]
    xz = dense(x, p["in_proj"])
    xc, z = xz[..., :d_inner], xz[..., d_inner:]
    init_taps = None if state is None else state.conv
    xc = F.silu(_causal_depthwise_conv(xc, p["conv_w"], p["conv_b"],
                                       init_taps))
    delta, bmat, cmat = _ssm_params(p, xc, dt_rank, d_state)
    a = -torch.exp(p["a_log"])                        # (d_inner, d_state)
    h0 = (torch.zeros((b_, d_inner, d_state), dtype=torch.float32,
                      device=x.device) if state is None else state.h)
    y, h_final = _scan(xc, delta, bmat, cmat, a, h0)
    y = y + p["d_skip"][None, None, :] * xc.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    out = dense(y, p["out_proj"])
    if not return_state:
        return out
    prev = (torch.zeros((b_, d_conv - 1, d_inner), dtype=x.dtype,
                        device=x.device)
            if init_taps is None else init_taps.to(x.dtype))
    taps = torch.cat([prev, xz[..., :d_inner]], dim=1)[:, -(d_conv - 1):]
    if state is None:
        state = mamba_state_init(b_, d_model, expand=expand, d_state=d_state,
                                 d_conv=d_conv, device=x.device)
    state.conv.copy_(taps.to(torch.bfloat16))
    state.h.copy_(h_final)
    return out, state


def mamba_decode(p, x, state: MambaState, *, d_model: int, expand: int = 2,
                 d_state: int = 16, d_conv: int = 4):
    """One-token decode. x (B, 1, D); ``state`` advanced in place."""
    d_inner, dt_rank, d_state, d_conv = mamba_dims(d_model, expand, d_state,
                                                   d_conv)
    xz = dense(x[:, 0, :], p["in_proj"])                   # (B, 2*di)
    xc_new, z = xz[..., :d_inner], xz[..., d_inner:]
    taps = torch.cat([state.conv.to(xc_new.dtype), xc_new[:, None, :]],
                     dim=1)                                # (B, d_conv, di)
    xc = torch.einsum("bkc,kc->bc", taps, p["conv_w"]) + p["conv_b"]
    xc = F.silu(xc)
    delta, bmat, cmat = _ssm_params(p, xc, dt_rank, d_state)
    y, h = _scan(xc[:, None], delta[:, None], bmat[:, None], cmat[:, None],
                 -torch.exp(p["a_log"]), state.h)
    y = y[:, 0] + p["d_skip"][None, :] * xc.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    out = dense(y, p["out_proj"])[:, None, :]
    state.conv.copy_(taps[:, 1:, :].to(state.conv.dtype))
    state.h.copy_(h)
    return out, state

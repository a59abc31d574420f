"""RWKV6 ("Finch") — attention-free token mixing with data-dependent decay
(port of ``repro/models/rwkv.py``).

Time-mix per head (size 64): state S ∈ R^{dk×dv} evolves as

    y_t = r_t · (S_{t-1} + diag(u) k_tᵀ v_t)
    S_t = diag(w_t) S_{t-1} + k_tᵀ v_t

with the data-dependent decay w_t = exp(-exp(w_base + lora(x̄_t))) and the
data-dependent token-shift lerp (ddlerp). Channel-mix is the squared-ReLU
RWKV FFN.

Where the JAX model scans the recurrence with ``lax.scan``, the port calls
``kernels.ops.rwkv6_scan`` (the CUDA kernel on the card, its plain version
on the CPU): the same function, over any L. With ``return_state`` the
forwards write the shift buffers and the WKV state into the given
:class:`RwkvState`'s tensors in place, as ``attention.kv_cache_write`` does
for the KV cache, so the shift buffers must already hold the activation
dtype (the JAX step replaces them with ``x[:, -1]`` in x's dtype).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from .layers import dense, dense_init

HEAD_SIZE = 64
DDLERP_DIM = 32
DECAY_DIM = 64


def rwkv_heads(d_model: int) -> int:
    if d_model % HEAD_SIZE:
        raise ValueError(f"d_model {d_model} is not a multiple of the RWKV "
                         f"head size {HEAD_SIZE}")
    return d_model // HEAD_SIZE


def time_mix_init(gen, d_model: int, dtype=torch.float32, lead=()):
    """Params of one time-mix; ``lead`` prepends stacked-block dims."""
    h = rwkv_heads(d_model)
    lead, dev = tuple(lead), gen.device

    def full(shape, value):
        return torch.full(lead + shape, value, dtype=torch.float32,
                          device=dev)

    def init(shape):
        return dense_init(gen, lead + shape, dtype=dtype)

    return {
        # static token-shift lerp weights for (r, k, v, g, w)
        "mu": full((5, d_model), 0.5),
        # ddlerp low-rank dynamic adjustment
        "maa_w1": init((d_model, 5 * DDLERP_DIM)),
        "maa_w2": init((5, DDLERP_DIM, d_model)),
        "wr": init((d_model, d_model)),
        "wk": init((d_model, d_model)),
        "wv": init((d_model, d_model)),
        "wg": init((d_model, d_model)),
        "wo": init((d_model, d_model)),
        # data-dependent decay: w_t = exp(-exp(base + lora))
        "decay_base": full((d_model,), -6.0),
        "decay_w1": init((d_model, DECAY_DIM)),
        "decay_w2": init((DECAY_DIM, d_model)),
        "bonus_u": full((h, HEAD_SIZE), 0.0),
        "ln_x": full((d_model,), 1.0),
    }


def channel_mix_init(gen, d_model: int, d_ff: int, dtype=torch.float32,
                     lead=()):
    lead = tuple(lead)
    return {"mu": torch.full(lead + (2, d_model), 0.5, dtype=torch.float32,
                             device=gen.device),
            "wk": dense_init(gen, lead + (d_model, d_ff), dtype=dtype),
            "wv": dense_init(gen, lead + (d_ff, d_model), dtype=dtype),
            "wr": dense_init(gen, lead + (d_model, d_model), dtype=dtype)}


class RwkvState(NamedTuple):
    shift_t: torch.Tensor   # (B, D) previous token input to time-mix
    shift_c: torch.Tensor   # (B, D) previous token input to channel-mix
    wkv: torch.Tensor       # (B, H, dk, dv) fp32 recurrent state


def rwkv_state_init(batch: int, d_model: int, dtype=torch.bfloat16,
                    device=None, lead=()) -> RwkvState:
    """A zero state; ``dtype`` is the shift buffers' (pass the activation
    dtype when the forwards will write the state), ``lead`` prepends
    stacked-block dims."""
    h, lead = rwkv_heads(d_model), tuple(lead)
    return RwkvState(
        shift_t=torch.zeros(lead + (batch, d_model), dtype=dtype,
                            device=device),
        shift_c=torch.zeros(lead + (batch, d_model), dtype=dtype,
                            device=device),
        wkv=torch.zeros(lead + (batch, h, HEAD_SIZE, HEAD_SIZE),
                        dtype=torch.float32, device=device))


def _shifted(x, prev):
    """x (B, L, D) -> x_{t-1} with ``prev`` (B, D) as the t=0 predecessor
    (dtypes promote, as ``jnp.concatenate`` does)."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _ddlerp(p, x, x_prev):
    """Data-dependent lerp producing the 5 mixed inputs (r,k,v,g,w), fp32
    (the JAX package's fp32 products against bf16 weights promote; torch's
    do not, so the weights are cast)."""
    dx = (x_prev - x).float()
    base = x.float() + dx * p["mu"][:, None, None, :]             # (5,B,L,D)
    dyn = torch.tanh((x + 0.5 * dx).float() @ p["maa_w1"].float())
    dyn = dyn.reshape(x.shape[:-1] + (5, DDLERP_DIM))
    adj = torch.einsum("blfd,fdm->fblm", dyn, p["maa_w2"].float())
    return base + dx[None] * adj                                   # (5,B,L,D)


def _group_norm_heads(x, scale, h):
    """Per-head RMS normalization of the wkv output. x (B, L, D)."""
    b, l, d = x.shape
    xh = x.reshape(b, l, h, HEAD_SIZE).float()
    var = torch.mean(xh * xh, dim=-1, keepdim=True)
    xh = xh * torch.rsqrt(var + 1e-5)
    return (xh.reshape(b, l, d) * scale).to(x.dtype)


def _write(buf: torch.Tensor, value: torch.Tensor) -> None:
    """In-place state write that refuses to round: the JAX step's state
    takes the new value's dtype."""
    if buf.dtype != value.dtype:
        raise TypeError(f"RWKV state buffer is {buf.dtype} but the step "
                        f"produces {value.dtype}: allocate the shift "
                        "buffers in the activation dtype")
    buf.copy_(value)


def time_mix_forward(p, x, state: RwkvState, d_model: int,
                     return_state: bool = False):
    """x (B, L, D), any L. The recurrence runs in ``kernels.ops.rwkv6_scan``
    from ``state.wkv``; with ``return_state`` the state's ``shift_t`` and
    ``wkv`` are written in place and returned with the output."""
    h = rwkv_heads(d_model)
    b, l, d = x.shape
    x_prev = _shifted(x, state.shift_t)
    xr, xk, xv, xg, xw = _ddlerp(p, x, x_prev)       # each (B, L, D) fp32

    r = dense(xr.to(x.dtype), p["wr"]).reshape(b, l, h, HEAD_SIZE)
    k = dense(xk.to(x.dtype), p["wk"]).reshape(b, l, h, HEAD_SIZE)
    v = dense(xv.to(x.dtype), p["wv"]).reshape(b, l, h, HEAD_SIZE)
    g = F.silu(dense(xg.to(x.dtype), p["wg"]))
    decay = p["decay_base"] + torch.tanh(xw @ p["decay_w1"].float()) \
        @ p["decay_w2"].float()
    w = torch.exp(-torch.exp(decay)).reshape(b, l, h, HEAD_SIZE)   # (0,1)

    y, s_final = kops.rwkv6_scan(r, k, v, w, p["bonus_u"], state.wkv)
    y = _group_norm_heads(y.reshape(b, l, d).to(x.dtype), p["ln_x"], h)
    out = dense(y * g.to(y.dtype), p["wo"])
    if return_state:
        _write(state.shift_t, x[:, -1, :])
        _write(state.wkv, s_final)
        return out, state
    return out


def channel_mix_forward(p, x, state: RwkvState, return_state: bool = False):
    x_prev = _shifted(x, state.shift_c)
    dx = (x_prev - x).float()
    xk = (x.float() + dx * p["mu"][0][None, None, :]).to(x.dtype)
    xr = (x.float() + dx * p["mu"][1][None, None, :]).to(x.dtype)
    k = torch.square(F.relu(dense(xk, p["wk"])))
    out = torch.sigmoid(dense(xr, p["wr"])) * dense(k, p["wv"])
    if return_state:
        _write(state.shift_c, x[:, -1, :])
        return out, state
    return out

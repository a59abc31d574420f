"""Mixture-of-Experts with sort-based capacity dispatch (port of
``repro/models/moe.py``).

Routing is softmax-then-top-k with renormalised gates. Assignments are
sorted by expert (a stable sort, as ``jnp.argsort``: ties keep token
order, so capacity drops the same tokens as the JAX package), tokens are
gathered into a dense (E, C, D) buffer, the expert GLUs run as three
batched products over the expert axis, and the outputs scatter-add back
weighted by the gates into a buffer with one sentinel row for the
dropped slots. Shared experts (DeepSeek-V2 style) run densely over every
token. The Switch-style load-balance loss comes back for the training
objective. The JAX package's sharding hints (``constrain``) have no
counterpart on one card.

On the CPU the scatter-add (``index_add``) adds a token's slots in slot
order, as XLA's scatter does; on the card its adds are atomic and their
order is not defined, so bf16 outputs may differ by an ulp run to run.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .layers import ACTS, dense_init, glu_mlp


def moe_init(gen, d_model: int, n_experts: int, d_ff: int,
             n_shared: int = 0, shared_d_ff: Optional[int] = None,
             dtype=torch.float32, lead=()):
    """Params of one MoE FFN; the router is fp32 whatever ``dtype``;
    ``lead`` prepends stacked-block dims."""
    lead = tuple(lead)
    p = {"router": dense_init(gen, lead + (d_model, n_experts),
                              dtype=torch.float32),
         "w_gate": dense_init(gen, lead + (n_experts, d_model, d_ff),
                              dtype=dtype),
         "w_up": dense_init(gen, lead + (n_experts, d_model, d_ff),
                            dtype=dtype),
         "w_down": dense_init(gen, lead + (n_experts, d_ff, d_model),
                              dtype=dtype)}
    if n_shared:
        sdff = shared_d_ff or (n_shared * d_ff)
        p["shared"] = {
            "w_gate": dense_init(gen, lead + (d_model, sdff), dtype=dtype),
            "w_up": dense_init(gen, lead + (d_model, sdff), dtype=dtype),
            "w_down": dense_init(gen, lead + (sdff, d_model), dtype=dtype)}
    return p


def capacity(n_tokens: int, n_experts: int, k: int,
             capacity_factor: float = 1.25, multiple: int = 8) -> int:
    c = int(math.ceil(n_tokens * k * capacity_factor / n_experts))
    c = max(c, k, 1)
    return int(math.ceil(c / multiple) * multiple)


def route(router_w, x, k: int):
    """x (N, D) -> gates (N, k), experts (N, k) int64, aux load-balance
    loss. The top k come from a stable descending sort, so tied
    probabilities go to the lowest expert index first, as ``lax.top_k``
    orders them."""
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)                       # (N, E)
    top_vals, top_idx = torch.sort(probs, dim=-1, descending=True,
                                   stable=True)
    top_vals, top_idx = top_vals[:, :k], top_idx[:, :k]
    gates = top_vals / (torch.sum(top_vals, dim=-1, keepdim=True) + 1e-9)
    n_experts = router_w.shape[1]
    # Switch-style aux loss: E * Σ_e f_e · p_e
    assign_frac = torch.mean(
        torch.sum(F.one_hot(top_idx, n_experts).float(), dim=1), dim=0)
    prob_frac = torch.mean(probs, dim=0)
    aux = n_experts * torch.sum(assign_frac * prob_frac)
    return gates, top_idx, aux


def dispatch_gather(x, top_idx, cap: int, n_experts: int):
    """Sort-based capacity dispatch by one gather. After a stable sort of
    the assignments by expert, expert e's tokens occupy the sorted range
    [starts[e], ends[e]), and slot c of expert e is sorted position
    starts[e] + c; slots past ends[e] (or past ``cap`` tokens: dropped)
    read the zero row N.

    x (N, D), top_idx (N, k) -> buffer (E, C, D) + bookkeeping (order, tok
    (E, C) source token with N the padding sentinel, j_safe (E, C) sorted
    position with N·k at pads, valid (E, C))."""
    n, k = top_idx.shape
    dev = x.device
    flat_expert = top_idx.reshape(-1)                    # (N*k,)
    token_id = torch.arange(n, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order].contiguous()
    sorted_token = token_id[order]
    experts = torch.arange(n_experts, device=dev, dtype=sorted_expert.dtype)
    starts = torch.searchsorted(sorted_expert, experts)
    ends = torch.searchsorted(sorted_expert, experts, right=True)
    j = starts[:, None] + torch.arange(cap, device=dev)[None, :]
    valid = j < ends[:, None]
    j_safe = torch.where(valid, j, n * k)
    tok = torch.where(valid, sorted_token[torch.where(valid, j, 0)], n)
    x_pad = torch.cat([x, torch.zeros((1, x.shape[-1]), dtype=x.dtype,
                                      device=dev)])
    buf = x_pad[tok]                                     # (E, C, D)
    return buf, (order, tok, j_safe, valid)


def combine_scatter(expert_out, bookkeeping, gates, n_tokens: int):
    """Gate-weighted scatter-add of the expert outputs (E, C, D) back to
    token rows; pads add zero into the sentinel row, which is dropped."""
    order, tok, j_safe, valid = bookkeeping
    flat_gates = gates.reshape(-1)[order]                # sorted order
    gates_pad = torch.cat([flat_gates, flat_gates.new_zeros(1)])
    gate_ec = gates_pad[j_safe]                          # (E, C), 0 at pads
    weighted = expert_out * gate_ec[..., None].to(expert_out.dtype)
    d = expert_out.shape[-1]
    out = expert_out.new_zeros((n_tokens + 1, d))
    out = torch.index_add(out, 0, tok.reshape(-1), weighted.reshape(-1, d))
    return out[:n_tokens]


def moe_forward(p, x, *, k: int, act: str = "silu",
                capacity_factor: float = 1.25):
    """x (B, L, D) -> (B, L, D), aux loss. Capacity is set by the
    N = B·L tokens of this call."""
    b, l, d = x.shape
    n = b * l
    xf = x.reshape(n, d)
    n_experts = p["router"].shape[1]
    gates, top_idx, aux = route(p["router"], xf, k)
    cap = capacity(n, n_experts, k, capacity_factor)
    buf, book = dispatch_gather(xf, top_idx, cap, n_experts)
    # Batched expert GLU: (E,C,D)@(E,D,F) -> (E,C,F)
    gate_h = ACTS[act](torch.bmm(buf, p["w_gate"]))
    up_h = torch.bmm(buf, p["w_up"])
    out_e = torch.bmm(gate_h * up_h, p["w_down"])
    out = combine_scatter(out_e, book, gates.to(out_e.dtype), n)
    if "shared" in p:
        out = out + glu_mlp(p["shared"], xf, act)
    return out.reshape(b, l, d), aux

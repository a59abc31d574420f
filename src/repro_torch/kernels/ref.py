"""Plain PyTorch versions of the port's kernels (port of
``repro/kernels/ref.py``). Kernel wrappers run these for CPU tensors, and
``chip_smoke.py`` holds each CUDA kernel against them on the card."""
from __future__ import annotations

import torch


def lowrank_linear_batched_ref(x, w, bases, rts, scales, ids, *, side):
    """Per-row heterogeneous-adapter apply (the serving batch shape).

    x (B, t, m) or (B, m); w (m, n) shared base; bases/rts/scales are
    (G, ·, ·)/(G,) adapter tables; ids (B,) selects each row's adapter:
    ``y[b] = scales[ids[b]]·(x[b]@w) + split-matmul(x[b], bases[ids[b]],
    rts[ids[b]])``. Plain gather + einsum with fp32 accumulation; the
    output dtype is ``torch.result_type(x, w)``.
    """
    squeeze_t = x.ndim == 2
    x3 = (x[:, None, :] if squeeze_t else x).float()
    ids = ids.long()
    s = scales.float()[ids][:, None, None]
    base = s * (x3 @ w.float())
    bg = bases.float()[ids]
    rg = rts.float()[ids]
    if side == "right":
        delta = torch.einsum("btr,bnr->btn",
                             torch.einsum("btm,bmr->btr", x3, rg), bg)
    else:
        delta = torch.einsum("btr,brn->btn",
                             torch.einsum("btm,bmr->btr", x3, bg), rg)
    y = (base + delta).to(torch.result_type(x, w))
    return y[:, 0, :] if squeeze_t else y

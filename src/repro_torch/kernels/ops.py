"""Public kernel entry points: CUDA tensors launch the hand-written kernel,
CPU tensors take its plain PyTorch version (port of
``repro/kernels/ops.py``).

The choice follows the tensors' device, never a failure: a kernel that
does not build or launch raises. :func:`lowrank_kernel_override` (the
counterpart of JAX's ``layers.lowrank_pallas_override``) runs the plain
version on the card too, so a caller can compare the kernel against it;
it is never the default.
"""
from __future__ import annotations

import contextlib

import torch

from . import lowrank_linear as _ll
from .ref import lowrank_linear_batched_ref

_PLAIN = [0]   # depth of open lowrank_kernel_override() contexts


@contextlib.contextmanager
def lowrank_kernel_override():
    """Run the plain version in place of the kernel, on any device."""
    _PLAIN[0] += 1
    try:
        yield
    finally:
        _PLAIN[0] -= 1


def lowrank_linear_batched(x, w, bases, rts, scales, ids, *, side=None):
    """``y[b] = scales[ids[b]]·(x[b] @ w) + split-matmul(x[b],
    bases[ids[b]], rts[ids[b]])`` — see ``kernels.lowrank_linear``.

    All operands must sit on one device. Tables and scales are taken as
    fp32 and ids as int32 (no copy when they already are).
    """
    devices = {t.device for t in (x, w, bases, rts, scales, ids)}
    if len(devices) != 1:
        raise ValueError("lowrank_linear_batched operands are on mixed "
                         f"devices: {sorted(str(d) for d in devices)}")
    side = side or _ll.infer_side(w.shape, bases.shape[1:], rts.shape[1:])
    if x.device.type != "cuda" or _PLAIN[0]:
        return lowrank_linear_batched_ref(x, w, bases, rts, scales, ids,
                                          side=side)
    return _ll.lowrank_linear_batched(
        x.contiguous(), w.contiguous(), bases.to(torch.float32).contiguous(),
        rts.to(torch.float32).contiguous(),
        scales.to(torch.float32).contiguous(),
        ids.to(torch.int32).contiguous(), side=side)

"""Causal GQA flash attention, forward only (port of
``repro/kernels/flash_attention.py``).

q (B, Lq, H, D), k/v (B, Lk, Hkv, D) with H % Hkv == 0; q head h reads kv
head h // (H / Hkv). The causal mask is suffix-aligned (query i sits at
position Lk − Lq + i), with an optional sliding window; masked scores are
the finite −1e30 of the JAX package, so a query that sees no key averages
V uniformly.

The kernel is CUDA C++ for sm_90a (``csrc/flash_attention.cu``: one block
per (64-row query tile, q head, batch row), 64-key K/V tiles streamed
through shared memory, the online softmax in fp32 registers, key tiles
wholly in the future or outside the window skipped), built with ``nvcc``
at first launch and called through ``ctypes`` on PyTorch's current
stream. It reads q, k and v through their strides, with no transposed
copies. Unlike the Pallas kernel it takes any Lq and Lk — SlotServer
admits ragged prompts. Its plain version is ``ref.flash_attention_ref``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .ref import _check_flash_args

HEAD_DIMS = (64, 128)
_SMEM_REFUSED = 9          # cudaErrorInvalidConfiguration


def _lib():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + \
            [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, causal, window):
    _check_flash_args(q, k, v, causal, window)
    d = q.shape[3]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention's kernel handles head sizes "
                         f"{HEAD_DIMS}, got D={d}")
    if q.dtype not in (torch.bfloat16, torch.float32) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype, bfloat16 or float32; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or q.device.type != "cuda":
            raise ValueError(f"{name} on {t.device}: every operand must be "
                             f"on one CUDA device (q is on {q.device})")
        if t.stride(3) != 1:
            raise ValueError(f"{name} must have unit stride along D")
    if max(q.shape[0], q.shape[2]) > 65535:
        raise ValueError(f"flash_attention's grid takes B, H <= 65535, got "
                         f"{tuple(q.shape)}")


def flash_attention(q, k, v, *, causal=True, window=0, scale=None):
    """Launch the flash attention kernel on CUDA tensors; returns o (B, Lq,
    H, D) in q's dtype, contiguous.

    q, k, v bf16 or fp32 (one dtype), any strides with unit stride along
    D; D 64 or 128; ``scale`` defaults to 1/√D. Raises for a CPU tensor, a
    bad dtype, shape or layout, or ``window`` without ``causal``.
    ``flash_attention.launches`` counts the launches."""
    _check(q, k, v, causal, window)
    b, lq, h, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    o = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    strides = (ctypes.c_longlong * 9)(
        *(t.stride(i) for t in (q, k, v) for i in range(3)))
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 ctypes.addressof(strides), b, lq, lk, h, hkv, d, scale,
                 int(bool(causal)), int(window),
                 int(q.dtype == torch.bfloat16),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err == _SMEM_REFUSED:
        raise ValueError("flash_attention: the kernel's tiles do not fit in "
                         "the device's shared memory per block")
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0

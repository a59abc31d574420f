"""The RWKV6 WKV recurrence (port of ``repro/kernels/rwkv6_scan.py``).

Per (b, h), with S a D×D fp32 state carried over the whole sequence:

    y_t = r_t · (S + diag(u) k_t v_tᵀ);   S ← diag(w_t) S + k_t v_tᵀ

The kernel is CUDA C++ for sm_90a (``csrc/rwkv6_scan.cu``: one block per
(b, h), thread j holding column j of S in registers, ``chunk`` time steps
staged in shared memory per load), built with ``nvcc`` at first launch
and called through ``ctypes`` on PyTorch's current stream. Unlike the
Pallas kernel it takes any L — decode is L = 1 and prompts are ragged.
Its plain version is ``ref.rwkv6_scan_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_HEAD_DIM = 64
_SMEM_REFUSED = 9          # cudaErrorInvalidConfiguration


def _lib():
    lib = _build.load("rwkv6_scan")
    fn = lib.rwkv6_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(r, k, v, w, u, s0, chunk):
    b, l, h, d = r.shape
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"rwkv6_scan handles head sizes 1 <= D <= "
                         f"{MAX_HEAD_DIM}, got D={d}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.shape != r.shape:
            raise ValueError(f"{name} {tuple(t.shape)} != r {tuple(r.shape)}")
    if u.shape != (h, d):
        raise ValueError(f"u {tuple(u.shape)} != (H, D) = {(h, d)}")
    if s0 is not None and s0.shape != (b, h, d, d):
        raise ValueError(f"s0 {tuple(s0.shape)} != (B, H, D, D) = "
                         f"{(b, h, d, d)}")
    if r.dtype not in (torch.bfloat16, torch.float32) or \
            k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"r, k, v must share one dtype, bfloat16 or float32; "
                        f"got {r.dtype}, {k.dtype}, {v.dtype}")
    if w.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"w must be bfloat16 or float32, got {w.dtype}")
    for name, t in (("u", u), ("s0", s0)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
                    ("s0", s0)):
        if t is None:
            continue
        if t.device != r.device or r.device.type != "cuda":
            raise ValueError(f"{name} on {t.device}: every operand must be "
                             f"on one CUDA device (r is on {r.device})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def rwkv6_scan(r, k, v, w, u, s0=None, *, chunk: int = 128):
    """Launch the WKV6 kernel on CUDA tensors; returns ``(y, s_final)``
    with y (B, L, H, D) in r's dtype and s_final (B, H, D, D) fp32.

    r, k, v (B, L, H, D) bf16 or fp32 (one dtype), w the same shape fp32
    or bf16, u (H, D) fp32, s0 (B, H, D, D) fp32 or None (zeros); all
    contiguous. Any L; ``chunk`` is the number of time steps staged in
    shared memory per load. Raises for D > 64, a CPU tensor or a bad
    dtype, shape or layout. ``rwkv6_scan.launches`` counts the
    launches."""
    _check(r, k, v, w, u, s0, chunk)
    b, l, h, d = r.shape
    y = torch.empty_like(r)
    s_final = torch.empty((b, h, d, d), dtype=torch.float32, device=r.device)
    if b * h == 0:
        return y, s_final
    err = _lib()(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), None if s0 is None else s0.data_ptr(),
                 y.data_ptr(), s_final.data_ptr(), b, l, h, d, int(chunk),
                 int(r.dtype == torch.bfloat16),
                 int(w.dtype == torch.bfloat16),
                 torch.cuda.current_stream(r.device).cuda_stream)
    if err == _SMEM_REFUSED:
        raise ValueError(f"rwkv6_scan: {chunk} staged steps do not fit in "
                         "the device's shared memory per block")
    if err != 0:
        raise RuntimeError(f"rwkv6_scan launch failed: CUDA error {err}")
    rwkv6_scan.launches += 1
    return y, s_final


rwkv6_scan.launches = 0

"""Low-rank linear applies (port of ``repro/kernels/lowrank_linear.py``).

``lowrank_linear`` is the lift-free training read of one factored block,

  right (m ≥ n; basis (n, r), rt (m, r)): y = scale·(x @ W) + (x @ rt) @ basisᵀ
  left  (m < n; basis (m, r), rt (r, n)): y = scale·(x @ W) + (x @ basis) @ rt

(``csrc/lowrank_linear.cu``), so the lifted m×n weight never exists.

``lowrank_linear_batched`` is the serving read: one decode or prefill batch where every row carries its own adapter: the
base GEMM ``x @ W`` is shared across the batch, and each row adds its own
rank-r split-matmul delta from stacked ``(G, ·, r)`` factor tables,

  right (m ≥ n; bases (G, n, r), rts (G, m, r)):
      y[b] = scales[g]·(x[b] @ W) + (x[b] @ rts[g]) @ bases[g]ᵀ
  left  (m < n; bases (G, m, r), rts (G, r, n)):
      y[b] = scales[g]·(x[b] @ W) + (x[b] @ bases[g]) @ rts[g]

with ``g = ids[b]`` (``csrc/lowrank_linear_batched.cu``). Both kernels are
CUDA C++ for sm_90a sharing ``csrc/lowrank_tiles.cuh`` (the sources say
what bounds them and how they are laid out), built with ``nvcc`` at first
launch and called through ``ctypes`` on PyTorch's current stream.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

RIGHT = "right"
LEFT = "left"

_BM, _BN, _BK = 64, 64, 16   # the GEMM tile of the .cu source
_MIN_K_TILES = 4    # K tiles each split keeps, at least


def infer_side(w_shape, basis_shape, rt_shape) -> str:
    """Recover the projection side from buffer shapes (right ⇒ basis (n, r),
    delta (m, r); left ⇒ basis (m, r), delta (r, n))."""
    mm, nn = tuple(w_shape)[-2:]
    dim, r = tuple(basis_shape)[-2:]
    if dim == nn and tuple(rt_shape)[-2:] == (mm, r):
        return RIGHT
    if dim == mm and tuple(rt_shape)[-2:] == (r, nn):
        return LEFT
    raise ValueError(f"inconsistent lowrank shapes: w {tuple(w_shape)}, "
                     f"basis {tuple(basis_shape)}, rt {tuple(rt_shape)}")


def split_k(rows: int, m: int, n: int, sms: int):
    """(ksplit, k_chunk): split K across blocks only when the output tiles
    alone leave some of the card's ``sms`` multiprocessors idle (decode,
    short prefill), aiming at two blocks per SM and keeping
    ≥ ``_MIN_K_TILES`` K tiles per split. k_chunk is a multiple of the K
    tile."""
    tiles = -(-rows // _BM) * -(-n // _BN)
    k_tiles = -(-m // _BK)
    want = -(-2 * sms // tiles) if tiles < sms else 1
    ksplit = max(1, min(want, k_tiles // _MIN_K_TILES))
    k_chunk = -(-k_tiles // ksplit) * _BK
    return -(-m // k_chunk), k_chunk


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _lib():
    lib = _build.load("lowrank_linear_batched")
    fn = lib.lowrank_linear_batched_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 11
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _lib_single():
    lib = _build.load("lowrank_linear")
    fn = lib.lowrank_linear_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


_FLOATS = (torch.float32, torch.bfloat16)


def _check_cuda(dev, **tensors):
    for name, ten in tensors.items():
        if ten.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} on {ten.device}: every operand must be "
                             f"on one CUDA device (x is on {dev})")
        if not ten.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def lowrank_linear(x, w, basis, rt, scale, *, side=None):
    """Launch the lift-free apply on CUDA tensors; see the module docstring.

    x (..., t, m) fp32 or bf16, contiguous; w (m, n) fp32 or bf16; basis
    and rt fp32 in the ``side`` layout; scale a 0-d fp32 tensor on the
    card (read there, no host sync). Returns y (..., t, n) in
    ``torch.result_type(x, w)``. Does not synchronise; raises on anything
    the kernel does not take and if the launch reports an error.
    ``lowrank_linear.launches`` counts the launches.
    """
    side = side or infer_side(w.shape, basis.shape, rt.shape)
    dev = x.device
    _check_cuda(dev, x=x, w=w, basis=basis, rt=rt, scale=scale)
    if x.dtype not in _FLOATS or w.dtype not in _FLOATS:
        raise TypeError(f"x/w must be float32 or bfloat16, got "
                        f"{x.dtype}/{w.dtype}")
    for name, ten in (("basis", basis), ("rt", rt), ("scale", scale)):
        if ten.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {ten.dtype}")
    if w.ndim != 2 or scale.numel() != 1:
        raise ValueError(f"w must be (m, n) and scale one value; got "
                         f"{tuple(w.shape)}, {tuple(scale.shape)}")
    m, n = w.shape
    r = basis.shape[-1]
    want_b, want_r = ((n, r), (m, r)) if side == RIGHT else ((m, r), (r, n))
    if x.shape[-1] != m or tuple(basis.shape) != want_b or \
            tuple(rt.shape) != want_r:
        raise ValueError(
            f"{side} side shapes: x {tuple(x.shape)}, w {tuple(w.shape)}, "
            f"basis {tuple(basis.shape)} (want {want_b}), rt "
            f"{tuple(rt.shape)} (want {want_r})")
    y = torch.empty(x.shape[:-1] + (n,), dtype=torch.result_type(x, w),
                    device=dev)
    rows = x.numel() // m if m else 0
    if rows == 0 or n == 0:
        return y
    s = torch.empty((rows, r), dtype=torch.float32, device=dev)
    ksplit, k_chunk = split_k(rows, m, n, _sm_count(dev))
    partial = (torch.empty((ksplit, rows, n), dtype=torch.float32,
                           device=dev) if ksplit > 1 else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib_single()(
        x.data_ptr(), w.data_ptr(), basis.data_ptr(), rt.data_ptr(),
        scale.data_ptr(), y.data_ptr(), s.data_ptr(),
        None if partial is None else partial.data_ptr(), rows, m, n, r,
        0 if side == RIGHT else 1, int(x.dtype == torch.bfloat16),
        int(w.dtype == torch.bfloat16), ksplit, k_chunk, stream)
    if err != 0:
        raise RuntimeError(f"lowrank_linear launch failed: CUDA error {err}")
    lowrank_linear.launches += 1
    return y


lowrank_linear.launches = 0


def lowrank_linear_batched(x, w, bases, rts, scales, ids, *, side=None):
    """Launch the CUDA kernel on CUDA tensors; see the module docstring.

    x (B, t, m) or (B, m), fp32 or bf16, contiguous; w (m, n) fp32 or
    bf16; bases/rts fp32 tables in the ``side`` layout; scales (G,) fp32;
    ids (B,) int32. Returns y in ``torch.result_type(x, w)``. Does not
    synchronise; raises on anything the kernel does not take and if the
    launch reports an error. ``lowrank_linear_batched.launches`` counts
    the launches.
    """
    side = side or infer_side(w.shape, bases.shape[1:], rts.shape[1:])
    dev = x.device
    _check_cuda(dev, x=x, w=w, bases=bases, rts=rts, scales=scales, ids=ids)
    if x.dtype not in _FLOATS or w.dtype not in _FLOATS:
        raise TypeError(f"x/w must be float32 or bfloat16, got "
                        f"{x.dtype}/{w.dtype}")
    for name, ten in (("bases", bases), ("rts", rts), ("scales", scales)):
        if ten.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {ten.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if x.ndim not in (2, 3) or w.ndim != 2:
        raise ValueError(f"x must be (B, t, m) or (B, m) and w (m, n); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    b, m = x.shape[0], x.shape[-1]
    t = x.shape[1] if x.ndim == 3 else 1
    mm, n = w.shape
    g, r = bases.shape[0], bases.shape[-1]
    want_b, want_r = ((g, n, r), (g, m, r)) if side == RIGHT else \
        ((g, m, r), (g, r, n))
    if mm != m or tuple(bases.shape) != want_b or \
            tuple(rts.shape) != want_r or tuple(scales.shape) != (g,) or \
            tuple(ids.shape) != (b,):
        raise ValueError(
            f"{side} side shapes: x {tuple(x.shape)}, w {tuple(w.shape)}, "
            f"bases {tuple(bases.shape)} (want {want_b}), rts "
            f"{tuple(rts.shape)} (want {want_r}), scales "
            f"{tuple(scales.shape)}, ids {tuple(ids.shape)}")
    y = torch.empty(x.shape[:-1] + (n,), dtype=torch.result_type(x, w),
                    device=dev)
    rows = b * t
    if rows == 0 or n == 0:
        return y
    s = torch.empty((rows, r), dtype=torch.float32, device=dev)
    ksplit, k_chunk = split_k(rows, m, n, _sm_count(dev))
    partial = (torch.empty((ksplit, rows, n), dtype=torch.float32,
                           device=dev) if ksplit > 1 else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(x.data_ptr(), w.data_ptr(), bases.data_ptr(),
                 rts.data_ptr(), scales.data_ptr(), ids.data_ptr(),
                 y.data_ptr(), s.data_ptr(),
                 None if partial is None else partial.data_ptr(),
                 rows, t, m, n, r, g, 0 if side == RIGHT else 1,
                 int(x.dtype == torch.bfloat16),
                 int(w.dtype == torch.bfloat16), ksplit, k_chunk, stream)
    if err != 0:
        raise RuntimeError(f"lowrank_linear_batched launch failed: CUDA "
                           f"error {err}")
    lowrank_linear_batched.launches += 1
    return y


lowrank_linear_batched.launches = 0

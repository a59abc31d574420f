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
CUDA C++ for sm_90a sharing ``csrc/lowrank_tiles.cuh``, built with ``nvcc``
at first launch and called through ``ctypes`` on PyTorch's current stream.

Each call takes one of three routes, chosen here from its arguments alone
(:func:`route`) before anything launches; a route that fails to build or
launch raises:

* ``tc_gemm`` — bf16 x and W, at least :data:`TC_MIN_ROWS` rows (prefill,
  training). The base GEMM's operations bound it at the bf16 tensor-core
  rate: TMA loads into a ring of up to 8 shared-memory stages, ``wgmma``
  with fp32 accumulation, the rank-r shrink in its own FP32-core pass,
  and a fused epilogue whose rank-r delta is computed while the ring
  fills. :func:`plan` picks the row tile (64 or 128) and a K split so
  that the output tiles fill the card.
* ``tc_decode`` — bf16 x and W, fewer rows (decode). The bytes of W bound
  it: W's columns are the tensor-core M side (swap-AB), W streams through
  a TMA ring in blocks of 128 columns x a K chunk, split so that the
  blocks fill the card in one wave, the shrink is folded into the same
  grid, and a reduce pass sums the fp32 partials in a fixed order and
  applies the epilogue.
* ``fp32`` — any fp32 operand, m or n not a multiple of 8, a base pointer
  of x, W or y not 16-byte aligned (TMA's rule), or r above
  :data:`MAX_TC_RANK`: exact fp32 products on the FP32 cores. No ported
  path sends such a call.

``.routes`` on each wrapper counts the launches per route beside
``.launches``. The sources say what bounds each route on this card and
how the design meets it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

RIGHT = "right"
LEFT = "left"

ROUTES = ("tc_gemm", "tc_decode", "fp32")
_ROUTE_CODE = {"fp32": 0, "tc_gemm": 1, "tc_decode": 2}
TC_MIN_ROWS = 64        # rows from which the tensor-core GEMM route runs
MAX_TC_RANK = 64        # the tc routes stage r-wide rows in shared memory
_BM, _BN, _BK = 64, 64, 16   # the fp32 route's GEMM tile
_MIN_K_TILES = 4    # K tiles each fp32 split keeps, at least
_TC_BN, _TC_BK = 128, 64     # tc_gemm: output columns a block, K a stage
_TC_MIN_SPLIT_TILES = 16     # K tiles each tc_gemm split keeps, at least
_TC_MAX_SPLIT_OUT = 1 << 17  # outputs up to which a K split pays its reduce
_TD_BN = 128                 # tc_decode: W columns a block
_TS_ROWS, _TS_KC = 32, 128   # tc_gemm shrink: rows a block, K a chunk
_MAX_PIECES = 32             # tc_gemm shrink: K pieces, at most


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
    """(ksplit, k_chunk) of the fp32 route: split K across blocks only when
    the output tiles alone leave some of the card's ``sms``
    multiprocessors idle (decode, short prefill), aiming at two blocks per
    SM and keeping ≥ ``_MIN_K_TILES`` K tiles per split. k_chunk is a
    multiple of the K tile."""
    tiles = -(-rows // _BM) * -(-n // _BN)
    k_tiles = -(-m // _BK)
    want = -(-2 * sms // tiles) if tiles < sms else 1
    ksplit = max(1, min(want, k_tiles // _MIN_K_TILES))
    k_chunk = -(-k_tiles // ksplit) * _BK
    return -(-m // k_chunk), k_chunk


def route(rows: int, m: int, n: int, r: int, x_dtype, w_dtype,
          ptrs=()) -> str:
    """The route of one call (see the module docstring): ``tc_gemm`` or
    ``tc_decode`` for bf16 x and W with m and n multiples of 8, r ≤
    :data:`MAX_TC_RANK` and every pointer in ``ptrs`` (x, W, y) 16-byte
    aligned, by rows against :data:`TC_MIN_ROWS`; else ``fp32``."""
    if (x_dtype == torch.bfloat16 and w_dtype == torch.bfloat16
            and m % 8 == 0 and n % 8 == 0 and r <= MAX_TC_RANK
            and all(p % 16 == 0 for p in ptrs)):
        return "tc_gemm" if rows >= TC_MIN_ROWS else "tc_decode"
    return "fp32"


class Plan(NamedTuple):
    """How one call is cut. ``bm``: tc_gemm's row tile (64 or 128),
    tc_decode's padded rows (16 or 64), the fp32 tile (64). K splits into
    ``ksplit`` chunks of ``k_chunk`` (a multiple of the route's K tile)
    with fp32 partials when ``ksplit > 1`` or on tc_decode. The shrink
    leaves ``pieces`` fp32 partials of s; tc_gemm's cover ``piece`` K
    values each and a further slot holds their sum; tc_decode's are one
    a block, ``pieces // ksplit`` equal parts of each K chunk."""
    route: str
    bm: int
    ksplit: int
    k_chunk: int
    pieces: int
    piece: int

    @property
    def partials(self) -> bool:
        return self.route == "tc_decode" or self.ksplit > 1

    @property
    def s_slots(self) -> int:
        return self.pieces + (self.route == "tc_gemm")


@functools.lru_cache(maxsize=4096)
def plan(route_: str, rows: int, t: int, m: int, n: int, sms: int) -> Plan:
    """Cut one call of ``rows`` rows (sequences of ``t`` rows; t = rows for
    one adapter) on ``route_`` for a card of ``sms`` multiprocessors.

    tc_gemm: row tiles of 128 when they alone give half the card output
    tiles, else 64; a K split only when the tiles fill less than half the
    card and the output is small (the reduce pass costs about as much as
    the GEMM at 2^19 outputs), keeping ≥ 16 K tiles (1024 values) a
    split; row tiles vary fastest in the grid. The shrink's 32-row blocks
    take up to 32 K pieces of whole 128-value chunks towards four blocks
    per SM.
    tc_decode: 128 W columns a block, K split in whole tiles so that the
    blocks fill the card's resident slots (two a SM at 16 rows, one at
    64) in one wave; every block computes one piece of the shrink, an
    equal part of its K chunk. fp32: :func:`split_k`.
    """
    if route_ == "tc_gemm":
        bm = 128 if -(-rows // 128) * -(-n // _TC_BN) >= sms // 2 else 64
        tiles = -(-rows // bm) * -(-n // _TC_BN)
        k_tiles = -(-m // _TC_BK)
        ksplit = 1
        if 2 * tiles < sms and rows * n <= _TC_MAX_SPLIT_OUT:
            ksplit = max(1, min(-(-sms // tiles),
                                k_tiles // _TC_MIN_SPLIT_TILES))
        k_chunk = -(-k_tiles // ksplit) * _TC_BK   # whole tiles, none empty
        ksplit = -(-m // k_chunk)
        row_blocks = (rows // t) * -(-t // _TS_ROWS)
        chunks = -(-m // _TS_KC)
        want = max(1, min(_MAX_PIECES, -(-4 * sms // row_blocks), chunks))
        piece = -(-chunks // want) * _TS_KC
        return Plan(route_, bm, ksplit, k_chunk, -(-m // piece), piece)
    if route_ == "tc_decode":
        nr = 16 if rows <= 16 else 64
        cols = -(-n // _TD_BN)
        k_tiles = -(-m // _TC_BK)
        slots = sms * (2 if nr == 16 else 1)   # blocks resident at once
        per = -(-k_tiles // max(1, slots // cols))   # K tiles a chunk
        ksplit, k_chunk = -(-k_tiles // per), per * _TC_BK
        return Plan(route_, nr, ksplit, k_chunk, ksplit * cols, 0)
    if route_ != "fp32":
        raise ValueError(f"unknown route {route_!r}: one of {ROUTES}")
    ksplit, k_chunk = split_k(rows, m, n, sms)
    return Plan(route_, _BM, ksplit, k_chunk, 1, m)


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _lib():
    lib = _build.load("lowrank_linear_batched")
    fn = lib.lowrank_linear_batched_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 15
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _lib_single():
    lib = _build.load("lowrank_linear")
    fn = lib.lowrank_linear_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 13
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _scratch(p: Plan, rows: int, n: int, r: int, dev):
    """The shrink pieces (s_slots, rows, r) and, where the plan splits K
    or streams, the GEMM partials (ksplit, rows, n), both fp32."""
    s = torch.empty((p.s_slots, rows, r), dtype=torch.float32, device=dev)
    part = (torch.empty((p.ksplit, rows, n), dtype=torch.float32, device=dev)
            if p.partials else None)
    return s, part


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
    ``lowrank_linear.launches`` counts the launches and
    ``lowrank_linear.routes`` them by route.
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
    which = route(rows, m, n, r, x.dtype, w.dtype,
                  (x.data_ptr(), w.data_ptr(), y.data_ptr()))
    p = plan(which, rows, rows, m, n, _sm_count(dev))
    s, partial = _scratch(p, rows, n, r, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib_single()(
        x.data_ptr(), w.data_ptr(), basis.data_ptr(), rt.data_ptr(),
        scale.data_ptr(), y.data_ptr(), s.data_ptr(),
        None if partial is None else partial.data_ptr(), rows, m, n, r,
        0 if side == RIGHT else 1, int(x.dtype == torch.bfloat16),
        int(w.dtype == torch.bfloat16), _ROUTE_CODE[which], p.bm, p.ksplit,
        p.k_chunk, p.pieces, p.piece, stream)
    if err != 0:
        raise RuntimeError(f"lowrank_linear launch failed on route {which}: "
                           f"CUDA error {err}")
    lowrank_linear.launches += 1
    lowrank_linear.routes[which] += 1
    return y


lowrank_linear.launches = 0
lowrank_linear.routes = dict.fromkeys(ROUTES, 0)


def lowrank_linear_batched(x, w, bases, rts, scales, ids, *, side=None):
    """Launch the CUDA kernel on CUDA tensors; see the module docstring.

    x (B, t, m) or (B, m), fp32 or bf16, contiguous; w (m, n) fp32 or
    bf16; bases/rts fp32 tables in the ``side`` layout; scales (G,) fp32;
    ids (B,) int32. Returns y in ``torch.result_type(x, w)``. Does not
    synchronise; raises on anything the kernel does not take and if the
    launch reports an error. ``lowrank_linear_batched.launches`` counts
    the launches and ``.routes`` them by route.
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
    which = route(rows, m, n, r, x.dtype, w.dtype,
                  (x.data_ptr(), w.data_ptr(), y.data_ptr()))
    p = plan(which, rows, t, m, n, _sm_count(dev))
    s, partial = _scratch(p, rows, n, r, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(x.data_ptr(), w.data_ptr(), bases.data_ptr(),
                 rts.data_ptr(), scales.data_ptr(), ids.data_ptr(),
                 y.data_ptr(), s.data_ptr(),
                 None if partial is None else partial.data_ptr(),
                 rows, t, m, n, r, g, 0 if side == RIGHT else 1,
                 int(x.dtype == torch.bfloat16),
                 int(w.dtype == torch.bfloat16), _ROUTE_CODE[which], p.bm,
                 p.ksplit, p.k_chunk, p.pieces, p.piece, stream)
    if err != 0:
        raise RuntimeError(f"lowrank_linear_batched launch failed on route "
                           f"{which}: CUDA error {err}")
    lowrank_linear_batched.launches += 1
    lowrank_linear_batched.routes[which] += 1
    return y


lowrank_linear_batched.launches = 0
lowrank_linear_batched.routes = dict.fromkeys(ROUTES, 0)

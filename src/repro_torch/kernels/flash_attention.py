"""Causal GQA flash attention, forward only (port of
``repro/kernels/flash_attention.py``).

q (B, Lq, H, D), k/v (B, Lk, Hkv, D) with H % Hkv == 0; q head h reads kv
head h // (H / Hkv). The causal mask is suffix-aligned (query i sits at
position Lk − Lq + i), with an optional sliding window; masked scores are
the finite −1e30 of the JAX package, so a query that sees no key averages
V uniformly.

The kernel is CUDA C++ for sm_90a (``csrc/flash_attention.cu``), built
with ``nvcc`` at first launch and called through ``ctypes`` on PyTorch's
current stream. It reads q, k and v through their strides, with no
transposed copies, and takes any Lq and Lk — SlotServer admits ragged
prompts. Each call takes one of two routes, chosen here from its arguments
alone (:func:`route`) before anything launches:

* ``tc`` — bf16 q, k, v that a TMA tensor map describes (base pointers
  and strides 16-byte aligned, strides nested as in (B, L, H, D)), Lk ≥ 1:
  every call of the ported paths. Warp-specialised on the tensor cores: a
  producer warp streams K/V tiles of 128 keys through a TMA ring,
  consumer warpgroups of 64 query rows run QKᵀ and PV on ``wgmma`` (P
  rounded to bf16 in registers) with the online softmax in fp32
  registers. :func:`plan`
  picks the query rows a block (64 or 128) and the block order.
* ``simt`` — fp32 inputs (TF32 ``wgmma`` cannot hold the fp32 check of
  1e-5 of scale), layouts the tensor maps do not describe (a base pointer
  or stride off 16 bytes, strides not nested as (B, L, H, D)), Lk = 0:
  the FP32 cores, one block per 64-row query tile.

Both skip key tiles wholly in the future or outside the window
(:func:`key_tiles`). ``flash_attention.routes`` counts the launches per
route beside ``.launches``. The plain version is
``ref.flash_attention_ref``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import _build
from .ref import _check_flash_args

HEAD_DIMS = (64, 128)
ROUTES = ("tc", "simt")
_ROUTE_CODE = {"simt": 0, "tc": 1}
TC_BK = 128              # tc: keys a tile
_SIMT_BQ = _SIMT_BK = 64  # simt: query rows a block, keys a tile
_SMEM_REFUSED = 9          # cudaErrorInvalidConfiguration


def _strides(t):
    """The (batch, sequence, head) element strides the kernel reads. A
    dimension of size 1 is only read at index 0: its stride is set to what
    a contiguous tensor would have there."""
    d = t.shape[3]
    sh = t.stride(2) if t.shape[2] > 1 else d
    sl = t.stride(1) if t.shape[1] > 1 else t.shape[2] * sh
    sb = t.stride(0) if t.shape[0] > 1 else t.shape[1] * sl
    return sb, sl, sh


def _tma_layout(t) -> bool:
    """A tensor map over (D, H, L, B) describes ``t``: its base pointer and
    strides are 16-byte multiples, and each stride spans the dimensions
    inside it (heads after D, sequence after heads, batch after
    sequence), the nesting the map is encoded in."""
    sb, sl, sh = _strides(t)
    esz = t.element_size()
    return (t.data_ptr() % 16 == 0
            and all(s * esz % 16 == 0 for s in (sb, sl, sh))
            and sh >= t.shape[3] and sl >= t.shape[2] * sh
            and sb >= t.shape[1] * sl)


def route(q, k, v, causal=True, window=0) -> str:
    """The route of one call (see the module docstring): ``tc`` for bf16
    q, k, v with Lk ≥ 1 that a tensor map describes (:func:`_tma_layout`:
    16-byte aligned, nested strides); else ``simt``. ``causal`` and
    ``window`` take no part: the tc kernel handles every mask, rows that
    see no key included."""
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)) or k.shape[1] == 0:
        return "simt"
    return "tc" if all(_tma_layout(t) for t in (q, k, v)) else "simt"


class Plan(NamedTuple):
    """How one call is cut: ``bq`` query rows and ``bk`` keys a tile,
    ``q_tiles`` tiles of query rows and ``blocks`` blocks, one per (query
    tile, q head, batch row)."""
    route: str
    bq: int
    bk: int
    q_tiles: int
    blocks: int


@functools.lru_cache(maxsize=4096)
def plan(route_: str, b: int, lq: int, h: int, sms: int) -> Plan:
    """Cut a call of ``b`` batch rows, ``lq`` queries and ``h`` q heads on
    ``route_`` for a card of ``sms`` multiprocessors. tc: 128 query rows a
    block (two consumer warpgroups), or 64 (one; at D = 64 two blocks then
    share an SM) where 128-row tiles would give fewer blocks than the card
    has SMs. simt: 64."""
    if route_ == "tc":
        bq = 128 if -(-lq // 128) * b * h >= sms else 64
        bk = TC_BK
    elif route_ == "simt":
        bq, bk = _SIMT_BQ, _SIMT_BK
    else:
        raise ValueError(f"unknown route {route_!r}: one of {ROUTES}")
    n_qt = -(-lq // bq)
    return Plan(route_, bq, bk, n_qt, n_qt * b * h)


def key_tiles(p: Plan, qt: int, lq: int, lk: int, causal=True, window=0):
    """[begin, end) of the key tiles query tile ``qt`` visits, as the
    kernel computes them: every tile without the causal mask or when a row
    of the tile sees no key (Lq > Lk: such a row averages every key);
    else from the tile holding the first key any row's window reaches to
    the one holding the last row's own position."""
    end = -(-lk // p.bk)
    begin = 0
    off = lk - lq
    q_lo = off + qt * p.bq
    q_hi = off + min(qt * p.bq + p.bq, lq) - 1
    if causal and q_lo >= 0:
        end = min(end, q_hi // p.bk + 1)
        lo = q_lo - window + 1
        if window > 0 and lo > 0:
            begin = lo // p.bk
    return begin, end


def block_order(p: Plan, b: int, h: int, hkv: int):
    """(query tile, batch row, q head) of each block in launch order, as
    the tc kernel decodes ``blockIdx.x``: the q heads of one kv head
    side by side, then kv heads, batch rows, and the query tiles from the
    last (the heaviest under the causal mask) to the first."""
    groups = h // hkv
    out = []
    for i in range(p.blocks):
        g, rest = i % groups, i // groups
        hk, rest = rest % hkv, rest // hkv
        bb, t = rest % b, rest // b
        out.append((p.q_tiles - 1 - t, bb, hk * groups + g))
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _lib():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + \
            [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
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
    bad dtype, shape or layout, or ``window`` without ``causal``, and if
    the launch reports an error. ``flash_attention.launches`` counts the
    launches and ``flash_attention.routes`` them by route."""
    _check(q, k, v, causal, window)
    b, lq, h, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    o = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    which = route(q, k, v, causal, window)
    p = plan(which, b, lq, h, _sm_count(q.device))
    strides = (ctypes.c_longlong * 9)(
        *(s for t in (q, k, v) for s in _strides(t)))
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 ctypes.addressof(strides), b, lq, lk, h, hkv, d, scale,
                 int(bool(causal)), int(window),
                 int(q.dtype == torch.bfloat16), _ROUTE_CODE[which], p.bq,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err == _SMEM_REFUSED:
        raise ValueError("flash_attention: the kernel's tiles do not fit in "
                         "the device's shared memory per block")
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed on route {which}: "
                           f"CUDA error {err}")
    flash_attention.launches += 1
    flash_attention.routes[which] += 1
    return o


flash_attention.launches = 0
flash_attention.routes = dict.fromkeys(ROUTES, 0)

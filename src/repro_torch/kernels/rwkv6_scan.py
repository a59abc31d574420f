"""The RWKV6 WKV recurrence (port of ``repro/kernels/rwkv6_scan.py``).

Per (b, h), with S a D×D fp32 state carried over the whole sequence:

    y_t = r_t · (S + diag(u) k_t v_tᵀ);   S ← diag(w_t) S + k_t v_tᵀ

The kernel is CUDA C++ for sm_90a (``csrc/rwkv6_scan.cu``), built with
``nvcc`` at first launch and called through ``ctypes`` on PyTorch's
current stream. Each (b, h) is spread over lanes and blocks: a column of
S over the lanes of one warp, 4 contiguous rows a lane in registers (16
when the grid would not fit one wave), and the columns over
``col_blocks`` blocks (:func:`plan`; :func:`owner` is the kernel's map
from a thread to its column and rows). y_j is the plain version's tree of
adjacent pairs — each lane's rows, then ``__shfl_xor_sync`` across the
column's lanes — so the two agree bit for bit. The time steps are staged
in shared memory with ``cp.async``. Unlike the Pallas kernel it takes any
L — decode is L = 1 and prompts are ragged. Its plain version is
``ref.rwkv6_scan_ref``.

Training adds two things (``ops.rwkv6_scan``'s autograd Function):
- the forward's checkpoint mode (``checkpoints=True``), which also writes
  the state before every ``CKPT_EVERY``-th step;
- :func:`rwkv6_scan_bwd`, the backward (``csrc/rwkv6_scan_bwd.cu``). It
  replaces no TPU kernel: the Pallas ``rwkv6_scan`` is forward only, and
  the JAX package trains RWKV6 through XLA's derivative of the
  ``lax.scan`` in ``repro/models/rwkv.py:126-136`` (``jax.vjp`` of
  ``repro/kernels/ref.py:102``). One block of 512 threads per (b, h)
  holds ∂L/∂S in registers, a thread 8 columns of one row, and walks the
  chunks between checkpoints backwards in a three-stage pipeline
  (:func:`bwd_plan`): while a chunk is walked, the one before it is
  recomputed from its checkpoint into the state slots the walk frees, and
  the one before that is loaded. A step's three row sums are one
  reduce-scatter across the row's lanes. It sums in
  ``ref.rwkv6_scan_bwd_ref``'s order, so the two agree bit for bit, and
  with no fused multiply-add. The function's bound is 16 D² fp32
  operations a step per (b, h) at the card's fp32 rate; without fused
  multiply-adds the ceiling of this arithmetic is twice that.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

MAX_HEAD_DIM = 64          # and the rows of the kernel's y tree
MAX_THREADS = 256          # a block
WARP = 32
GROUP = 8                  # steps whose y trees are reduced together
RESIDENT = 2               # blocks an SM holds (the kernel's launch bounds)
SMEM_OPTIN = 227 * 1024    # shared memory a block may take on sm_90
_SMEM_REFUSED = 9          # cudaErrorInvalidConfiguration
CKPT_EVERY = 8             # steps between the checkpoint mode's states


class Plan(NamedTuple):
    """How one call is cut. A column's 64 rows (D zero-padded, the plain
    version's ``_pairwise_sum``) are spread ``rows`` a lane over ``lanes``
    lanes; ``group`` steps are reduced together. A block holds ``cols``
    columns (``threads`` threads) and a (b, h) takes ``col_blocks`` blocks,
    ``blocks`` in all. ``staged`` time steps fill a shared-memory slot;
    ``slots`` is 2 (the next chunk is copied under this one) when the
    sequence is longer than that. ``smem`` is the bytes a block takes."""
    rows: int
    lanes: int
    group: int
    cols: int
    col_blocks: int
    blocks: int
    threads: int
    staged: int
    slots: int
    smem: int


def _cut(b, h, d, rows):
    """(lanes, cols, col_blocks, blocks) with ``rows`` rows a lane: as many
    columns a block as 256 threads hold in whole warps, no more than ``d``
    needs."""
    lanes = MAX_HEAD_DIM // rows
    per_warp = WARP // lanes
    cols = min(MAX_THREADS // lanes, -(-d // per_warp) * per_warp)
    col_blocks = -(-d // cols)
    return lanes, cols, col_blocks, b * h * col_blocks


@functools.lru_cache(maxsize=4096)
def plan(b: int, l: int, h: int, d: int, chunk: int, sms: int = 132,
         rkv_bytes: int = 2, w_bytes: int = 4, ckpt: bool = False) -> Plan:
    """Cut a call of ``b`` batch rows, ``l`` steps and ``h`` heads of size
    ``d`` with ``chunk`` steps staged per load, on a card of ``sms``
    multiprocessors, r/k/v of ``rkv_bytes`` and w of ``w_bytes`` an
    element. Four rows a lane, or
    - 16 rows a lane when four would need more than one wave of blocks
      (``RESIDENT`` an SM), as with the 8 prompts of ``generate`` or 8
      decode rows: a quarter of the blocks, each lane doing more work;
    - steps reduced one at a time when L < ``GROUP`` (decode), a kernel
      with fewer registers.
    ``min(chunk, L)`` steps a slot; where two slots of them would not fit
    in ``SMEM_OPTIN`` (fp32 operands), as many whole groups as two do. A
    ``smem`` over ``SMEM_OPTIN`` (one slot of ``chunk`` too large) is
    refused at launch. In the checkpoint mode (``ckpt``) a sequence longer
    than a slot stages a multiple of ``CKPT_EVERY`` steps, so every
    checkpoint falls on a group's first step."""
    rows, group = 4, GROUP
    lanes, cols, col_blocks, blocks = _cut(b, h, d, rows)
    if blocks > RESIDENT * sms:
        rows = 16
        lanes, cols, col_blocks, blocks = _cut(b, h, d, rows)
    if l < GROUP:
        group = 1
    step_bytes = MAX_HEAD_DIM * (3 * rkv_bytes + w_bytes)
    tile = MAX_HEAD_DIM * (cols + 1) * 4
    staged = min(chunk, max(l, 1))
    if l > staged and 2 * staged * step_bytes + tile > SMEM_OPTIN:
        fit = (SMEM_OPTIN - tile) // (2 * step_bytes)
        staged = max(fit - fit % GROUP, 1)
    if ckpt and l > staged:
        staged = max(staged - staged % CKPT_EVERY, CKPT_EVERY)
    slots = 2 if l > staged else 1
    return Plan(rows, lanes, group, cols, col_blocks, blocks, cols * lanes,
                staged, slots, slots * staged * step_bytes + tile)


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def owner(p: Plan, block: int, thread: int):
    """(b·h index, column, first row) of one thread, as the kernel decodes
    ``blockIdx.x`` and ``threadIdx.x``: lane q of column c holds rows
    [rows·q, rows·q + rows); a column or row at or past D is padding."""
    bh, cb = divmod(block, p.col_blocks)
    c, q = divmod(thread, p.lanes)
    return bh, cb * p.cols + c, p.rows * q


def _lib():
    lib = _build.load("rwkv6_scan")
    fn = lib.rwkv6_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 12 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _bwd_lib():
    lib = _build.load("rwkv6_scan_bwd")
    fn = lib.rwkv6_scan_bwd_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 10 + \
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


def rwkv6_scan(r, k, v, w, u, s0=None, *, chunk: int = 128,
               checkpoints: bool = False):
    """Launch the WKV6 kernel on CUDA tensors; returns ``(y, s_final)``
    with y (B, L, H, D) in r's dtype and s_final (B, H, D, D) fp32, and
    with ``checkpoints`` a third tensor, the states before steps 0,
    ``CKPT_EVERY``, 2·``CKPT_EVERY``, … (B, H, ⌈L / CKPT_EVERY⌉, D, D)
    fp32, what :func:`rwkv6_scan_bwd` reads.

    r, k, v (B, L, H, D) bf16 or fp32 (one dtype), w the same shape fp32
    or bf16, u (H, D) fp32, s0 (B, H, D, D) fp32 or None (zeros); all
    contiguous. Any L; ``chunk`` is the number of time steps staged in
    shared memory per load (:func:`plan`; fewer where two slots of them
    would not fit). Raises for D > 64, a CPU
    tensor or a bad dtype, shape or layout, and when ``chunk`` staged
    steps do not fit in shared memory. ``rwkv6_scan.launches`` counts the
    launches."""
    _check(r, k, v, w, u, s0, chunk)
    b, l, h, d = r.shape
    y = torch.empty_like(r)
    s_final = torch.empty((b, h, d, d), dtype=torch.float32, device=r.device)
    ck = (torch.empty((b, h, -(-l // CKPT_EVERY), d, d), dtype=torch.float32,
                      device=r.device) if checkpoints else None)
    out = (y, s_final) if ck is None else (y, s_final, ck)
    if b * h == 0:
        return out
    p = plan(b, l, h, d, int(chunk), _sm_count(r.device), r.element_size(),
             w.element_size(), ckpt=checkpoints)
    err = _lib()(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), None if s0 is None else s0.data_ptr(),
                 y.data_ptr(), s_final.data_ptr(),
                 None if ck is None else ck.data_ptr(), CKPT_EVERY, b, l, h,
                 d, p.rows, p.group, p.cols, p.col_blocks, p.staged,
                 int(r.dtype == torch.bfloat16),
                 int(w.dtype == torch.bfloat16),
                 torch.cuda.current_stream(r.device).cuda_stream)
    if err == _SMEM_REFUSED:
        raise ValueError(f"rwkv6_scan: {p.slots} x {p.staged} staged steps "
                         "do not fit in the device's shared memory per "
                         "block")
    if err != 0:
        raise RuntimeError(f"rwkv6_scan launch failed: CUDA error {err}")
    rwkv6_scan.launches += 1
    return out


rwkv6_scan.launches = 0


# ---------------------------------------------------------------- backward --

BWD_COLS = 8        # columns of ∂L/∂S a backward thread holds


class BwdPlan(NamedTuple):
    """How the backward cuts a call (``csrc/rwkv6_scan_bwd.cu``, whose
    entry point refuses a plan other than its own constants). One block a
    (b, h), ``blocks`` in all, walks ``chunks`` chunks of ``steps`` steps,
    one a checkpoint of the forward's checkpoint mode. A thread holds
    ``cols`` columns of one row of ∂L/∂S, so a row spans ``lanes`` lanes,
    a warp ``rows_per_warp`` rows and the block's ``threads`` threads
    (``warps`` warps) the 64 rows once. ``stages`` chunks are in flight
    (walked, recomputed, loaded); ``smem`` is the bytes a block takes."""
    steps: int
    chunks: int
    cols: int
    lanes: int
    rows_per_warp: int
    threads: int
    warps: int
    blocks: int
    stages: int
    smem: int


def bwd_plan(b: int, l: int, h: int) -> BwdPlan:
    """The backward's cut of a call of ``b`` batch rows, ``l`` steps and
    ``h`` heads (any D ≤ 64 is padded to 64). Shared memory, in floats, as
    the kernel lays it out: the states of one chunk, two staging buffers
    (r k w as a float4 a row, v and dy a column group of ``BWD_COLS`` + 4
    floats, v·dy's two halves), the warps' dv partials and the chunk's dr,
    dk, dw rows."""
    k, n = CKPT_EVERY, MAX_HEAD_DIM
    lanes = n // BWD_COLS
    threads = n * lanes
    buf = 4 * k * n + 2 * k * lanes * (BWD_COLS + 4) + 2 * k
    floats = k * n * n + 2 * buf + k * (threads // WARP) * n + \
        3 * (k * n + 8)
    return BwdPlan(k, -(-l // k), BWD_COLS, lanes, WARP // lanes, threads,
                   threads // WARP, b * h, 3, 4 * floats)


def _check_bwd(r, k, v, w, u, ckpt, dy, ds_final, p):
    b, l, h, d = r.shape
    if dy.shape != r.shape or dy.dtype != r.dtype:
        raise ValueError(f"dy {dy.dtype}{tuple(dy.shape)} must match r "
                         f"{r.dtype}{tuple(r.shape)}")
    want = (b, h, p.chunks, d, d)
    if ckpt.shape != want:
        raise ValueError(f"ckpt {tuple(ckpt.shape)} != {want}: the states "
                         f"the forward's checkpoint mode writes every "
                         f"{CKPT_EVERY} steps")
    if ds_final is not None and ds_final.shape != (b, h, d, d):
        raise ValueError(f"ds_final {tuple(ds_final.shape)} != (B, H, D, D)")
    _check(r, k, v, w, u, None, 1)
    for name, t in (("ckpt", ckpt), ("dy", dy), ("ds_final", ds_final)):
        if t is None:
            continue
        if name != "dy" and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != r.device:
            raise ValueError(f"{name} on {t.device}: every operand must be "
                             f"on one CUDA device (r is on {r.device})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def rwkv6_scan_bwd(r, k, v, w, u, ckpt, dy, ds_final=None):
    """Launch the WKV6 backward on CUDA tensors: the cotangents (dr, dk,
    dv in r's dtype, dw in w's dtype, du (H, D) fp32, ds0 (B, H, D, D)
    fp32) of :func:`rwkv6_scan`'s inputs, given those of y (``dy``, r's
    dtype and shape) and of the final state (``ds_final`` fp32 or None
    for zeros). ``ckpt`` is what the forward's checkpoint mode returned
    for the same inputs. All operands contiguous, on one card. Raises on
    what the kernel does not take and on a failed launch.
    ``rwkv6_scan_bwd.launches`` counts the launches."""
    b, l, h, d = r.shape
    p = bwd_plan(b, l, h)
    _check_bwd(r, k, v, w, u, ckpt, dy, ds_final, p)
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dw = torch.empty_like(w)
    du = torch.empty((b, h, d), dtype=torch.float32, device=r.device)
    ds0 = torch.empty((b, h, d, d), dtype=torch.float32, device=r.device)
    if b * h == 0:
        return dr, dk, dv, dw, du.sum(0), ds0
    err = _bwd_lib()(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        ckpt.data_ptr(), dy.data_ptr(),
        None if ds_final is None else ds_final.data_ptr(), dr.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(),
        ds0.data_ptr(), b, l, h, d, p.steps, p.cols, p.threads, p.smem,
        int(r.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16),
        torch.cuda.current_stream(r.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan_bwd launch failed: CUDA error {err}")
    rwkv6_scan_bwd.launches += 1
    return dr, dk, dv, dw, du.sum(0), ds0


rwkv6_scan_bwd.launches = 0

"""Fused GaLore preconditioner and GaLoreAdamW step (port of
``repro/kernels/galore_adamw.py``).

For a stack of projected blocks — right side: basis (…, N, r), moments
(…, M, r); left side: basis (…, M, r), moments (…, r, N) —

  g̃ = g B | Bᵀ g;  m' = β₁m + (1-β₁)g̃;  v' = β₂v + (1-β₂)g̃²;
  ũ = (m'/c₁) / (√(v'/c₂) + ε)

and then ũ itself (``project_back=False``, the factored client path),
its lift ``ũBᵀ | Bũ`` (``galore_precond_step``), or the weight update
``w ← w − lr·u − lr·λ·w`` (``galore_adamw_step``). The kernel is CUDA
C++ for sm_90a (``csrc/galore_adamw.cu``, which says what bounds it and
how its design streams g), built with ``nvcc`` at first launch and called
through ``ctypes`` on PyTorch's current stream. g is read in its own type,
fp32 or bf16; the stacked leading dims flatten into the grid.

:func:`plan` cuts a call from its arguments alone: the route (the side,
and whether rows are moved as 16-byte pieces or one value at a time), the
rank instantiation, the rows a warp (right) or columns a lane (left)
holds, the block's threads, the grid, the shared memory and where the
basis is read: staged in shared memory, or, where it does not fit there
(at rank 8 a basis of more than about 7,200 rows on the right or 5,200
on the left, as in a width-8192 model), from global memory at the same
points of the same loops.
``galore_precond_step.routes`` and ``galore_adamw_step.routes`` count the
launches by route beside ``.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

RIGHT = "right"
LEFT = "left"
MAX_RANK = 64
ROUTES = ("right_ring", "right", "right_scalar", "left_ring", "left",
          "left_scalar")
PRECOND_UT, PRECOND_U, ADAMW = 0, 1, 2     # the kernel's modes
G_DTYPES = (torch.float32, torch.bfloat16)
# The kernel's geometry (csrc/galore_adamw.cu): a lane holds NV sums (rows
# or columns times the rank instantiation); a right lane holds CHUNK
# columns of each of its rows; right blocks of RIGHT_THREADS, at least
# RIGHT_BLOCKS_PER_SM resident (its __launch_bounds__; RIGHT_GB_BLOCKS_PER_SM
# where it reads the basis from global memory); left blocks of LEFT_WARPS
# warps.
NV, CHUNK = 64, 8
RIGHT_THREADS, RIGHT_BLOCKS_PER_SM, RIGHT_GB_BLOCKS_PER_SM = 128, 3, 2
LEFT_WARPS = 8
# g of these types streams through a cp.async ring of RING_STAGES in
# shared memory where its rows are 16-byte aligned (csrc's GALORE_RING_*
# switches; on the left only where a lane holds whole 16-byte pieces, the
# ring living in the partial sums' buffer); other aligned rows load into
# registers, as measured fastest for each type (PERF.md).
RING_STAGES = 2
RING_DTYPES = (torch.bfloat16,)
MIN_TILE_ROWS = 64          # a right block's rows of one batch item, at least
SMEM_LIMIT = 232_448        # H100: opt-in shared memory a block
SMEM_PER_SM = 233_472       # a multiprocessor's, 1 KB of it kept per block
H100_SMS = 132
_SMEM_REFUSED = 9           # cudaErrorInvalidConfiguration


class Plan(NamedTuple):
    """How one call is cut. ``rmax``: the rank instantiation (8, 16, 32,
    64; B zero-padded to whole groups of 4 ranks). ``hold``: rows a warp
    holds at a time (right) or columns a lane holds (left), 64 / rmax.
    ``tile``: rows a right block walks in one batch item (at most), or
    columns a left block takes. ``grid``: (blocks per batch item, batch).
    ``vec``: every (M, N) operand moved as pieces of up to 16 bytes.
    ``smem``: dynamic shared memory in bytes. ``basis``: "shared" (staged
    once a block) or "global" (read through L1 / L2 where staging would
    not fit a block's shared memory)."""
    route: str
    rmax: int
    hold: int
    tile: int
    threads: int
    grid: tuple
    vec: bool
    smem: int
    basis: str


def rank_instance(r: int) -> int:
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"rank {r} outside [1, {MAX_RANK}]")
    return next(x for x in (8, 16, 32, 64) if r <= x)


def _piece(cols: int, itemsize: int) -> int:
    """Values a lane's ``cols`` columns move at once (as csrc's piece())."""
    return cols if cols * itemsize < 16 else 16 // itemsize


@functools.lru_cache(maxsize=4096)
def plan(side: str, M: int, N: int, r: int, g_dtype, mode: int, *,
         batch: int = 1, w_dtype=torch.float32, aligned: bool = True,
         sms: int = H100_SMS) -> Plan:
    """Cut one call: ``batch`` (M, N) blocks of rank ``r`` on ``side``,
    g in ``g_dtype``, kernel ``mode`` (:data:`PRECOND_UT`,
    :data:`PRECOND_U` or :data:`ADAMW`, whose weight is ``w_dtype``), on a
    card of ``sms`` multiprocessors. ``aligned``: every (M, N) operand
    starts on a 16-byte boundary.

    Rows are moved as pieces where every row of every (M, N) operand (g;
    u in mode 1; w in mode 2) starts on a piece's boundary: N a multiple of
    4 for fp32, of 8 for bf16, at the columns a lane holds. Such rows of a
    g in :data:`RING_DTYPES` stream through a cp.async ring (routes
    ``*_ring``; on the left where a lane's columns are whole 16-byte
    pieces), the others load into registers; unaligned rows load one value
    at a time (``*_scalar``). Right: a
    persistent grid of at most the card's resident blocks over the batch,
    at least :data:`MIN_TILE_ROWS` rows a block, each block's warps
    taking groups of ``hold`` rows in turn. Left: one block a tile of
    32·hold columns, its warps splitting M into contiguous ranges. A basis
    whose staged copy does not fit in a block's shared memory is read from
    global memory instead (``basis="global"``; the sums and their order
    are the same)."""
    if g_dtype not in G_DTYPES:
        raise TypeError(f"g must be float32 or bfloat16, got {g_dtype}")
    if side not in (RIGHT, LEFT):
        raise ValueError(f"side must be {RIGHT!r} or {LEFT!r}, got {side!r}")
    if mode not in (PRECOND_UT, PRECOND_U, ADAMW):
        raise ValueError(f"unknown mode {mode}")
    rmax = rank_instance(r)
    hold = NV // rmax
    kg = -(-r // 4)
    cols = CHUNK if side == RIGHT else hold
    sizes = [g_dtype.itemsize] + ([4] if mode == PRECOND_U else []) + \
        ([w_dtype.itemsize] if mode == ADAMW else [])
    vec = aligned and all(N % _piece(cols, s) == 0 for s in sizes)
    if side == RIGHT:
        ring = vec and g_dtype in RING_DTYPES
        threads = RIGHT_THREADS
        warps = threads // 32
        staged = 16 * kg * CHUNK * -(-N // CHUNK)
        smem = 4 * warps * NV + \
            (16 * RING_STAGES * warps * hold * 32 if ring else 0)
        basis = "shared" if staged + smem <= SMEM_LIMIT else "global"
        smem += staged if basis == "shared" else 0
        per_sm = min(RIGHT_BLOCKS_PER_SM if basis == "shared"
                     else RIGHT_GB_BLOCKS_PER_SM,
                     SMEM_PER_SM // (smem + 1024))
        groups = -(-M // hold)
        blocks = max(1, min(-(-groups // warps), (sms * per_sm) // batch,
                            -(-M // MIN_TILE_ROWS)))
        tile = min(M, -(-groups // (blocks * warps)) * warps * hold)
    else:
        ring = vec and g_dtype in RING_DTYPES and \
            hold * g_dtype.itemsize % 16 == 0
        threads = LEFT_WARPS * 32
        staged = 16 * kg * M
        smem = 4 * LEFT_WARPS * NV * 32                   # ring inside
        basis = "shared" if staged + smem <= SMEM_LIMIT else "global"
        smem += staged if basis == "shared" else 0
        tile = 32 * hold
        blocks = -(-N // tile)
    route = side + ("_ring" if ring else "" if vec else "_scalar")
    return Plan(route, rmax, hold, tile, threads, (blocks, batch), vec, smem,
                basis)


def coverage(p: Plan, M: int, N: int):
    """How often the kernel's loops visit each row and each column of one
    batch item under plan ``p``: (rows (M,), columns (N,)) int tensors. An
    element is visited by the pair of its row's and its column's visits
    (a right warp's rows and lane's columns, a left block's columns and
    warp's rows), so all ones means every element is held exactly once."""
    rows = torch.zeros(M, dtype=torch.int64)
    cols = torch.zeros(N, dtype=torch.int64)
    blocks = p.grid[0]
    if p.route.startswith(RIGHT):
        warps = p.threads // 32
        groups = -(-M // p.hold)
        for b in range(blocks):
            for w in range(warps):
                for grp in range(b * warps + w, groups, blocks * warps):
                    rows[grp * p.hold:(grp + 1) * p.hold] += 1
        nq = -(-N // CHUNK)
        for lane in range(32):
            for q in range(lane, nq, 32):
                cols[q * CHUNK:(q + 1) * CHUNK] += 1
    else:
        per = -(-M // LEFT_WARPS)
        for w in range(LEFT_WARPS):
            i0 = min(M, w * per)
            rows[i0:min(M, i0 + per)] += 1
        for b in range(blocks):
            for lane in range(32):
                c0 = (b * 32 + lane) * p.hold
                cols[c0:c0 + p.hold] += 1
    return rows, cols


def infer_side(w_shape, basis_shape, m_shape) -> str:
    """Recover the projection side from buffer shapes (right ⇒ basis (N, r),
    moments (M, r); left ⇒ basis (M, r), moments (r, N)). Square blocks with
    r == M default to right, the ``proj_type=std`` convention."""
    mm, nn = tuple(w_shape)[-2:]
    dim, r = tuple(basis_shape)[-2:]
    if dim == nn and tuple(m_shape)[-2:] == (mm, r):
        return RIGHT
    if dim == mm and tuple(m_shape)[-2:] == (r, nn):
        return LEFT
    raise ValueError(f"inconsistent galore shapes: w {tuple(w_shape)}, "
                     f"basis {tuple(basis_shape)}, m {tuple(m_shape)}")


def bias_corrections(count, b1: float, b2: float, bias_correction=True):
    """``(1 - β₁^count, 1 - β₂^count)`` in fp32, as the reference computes
    them in the kernel from its fp32 count; (1, 1) without correction."""
    if not bias_correction:
        return 1.0, 1.0
    c = torch.tensor(float(count), dtype=torch.float32)
    return (float(1 - torch.tensor(b1, dtype=torch.float32) ** c),
            float(1 - torch.tensor(b2, dtype=torch.float32) ** c))


def _lib():
    lib = _build.load("galore_adamw")
    fn = lib.galore_adamw_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 13
                       + [ctypes.c_float] * 9 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(g, basis, m, v, w, u, mode, side, *, b1, b2, eps, c1, c2, lr,
            wd, m_out, v_out):
    """Check the operands, plan and launch; returns the route taken, or
    None for an empty batch."""
    dev = g.device
    for name, ten in (("g", g), ("basis", basis), ("m", m), ("v", v),
                      ("w", w), ("u", u)):
        if ten is None:
            continue
        if ten.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} on {ten.device}: every operand must be "
                             f"on one CUDA device (g is on {dev})")
        if not ten.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name not in ("g", "w") and ten.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {ten.dtype}")
    if g.dtype not in G_DTYPES:
        raise TypeError(f"g must be float32 or bfloat16, got {g.dtype}")
    if w is not None and w.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"w must be float32 or bfloat16, got {w.dtype}")
    mm, nn = g.shape[-2:]
    r = basis.shape[-1]
    want_b, want_m = ((nn, r), (mm, r)) if side == RIGHT else \
        ((mm, r), (r, nn))
    lead = g.shape[:-2]
    if tuple(basis.shape) != lead + want_b or \
            tuple(m.shape) != lead + want_m or m.shape != v.shape or \
            (w is not None and w.shape != g.shape):
        raise ValueError(f"{side} side shapes: g {tuple(g.shape)}, basis "
                         f"{tuple(basis.shape)} (want {lead + want_b}), m "
                         f"{tuple(m.shape)}, v {tuple(v.shape)} (want "
                         f"{lead + want_m})")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"rank {r} outside [1, {MAX_RANK}]")
    batch = g.numel() // (mm * nn) if mm * nn else 0
    if batch == 0:
        return None
    rows_ops = [t for t in (g, w, u if mode == PRECOND_U else None)
                if t is not None]
    p = plan(side, mm, nn, r, g.dtype, mode, batch=batch,
             w_dtype=torch.float32 if w is None else w.dtype,
             aligned=all(t.data_ptr() % 16 == 0 for t in rows_ops),
             sms=_sm_count(dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(g.data_ptr(), basis.data_ptr(), m.data_ptr(), v.data_ptr(),
                 m_out.data_ptr(), v_out.data_ptr(),
                 None if u is None else u.data_ptr(),
                 None if w is None else w.data_ptr(),
                 int(w is not None and w.dtype == torch.bfloat16),
                 int(g.dtype == torch.bfloat16), batch, mm, nn, r,
                 0 if side == RIGHT else 1, mode, int(p.vec), p.threads,
                 p.grid[0], p.smem, int(p.basis == "global"), b1, 1.0 - b1,
                 b2, 1.0 - b2, eps, c1, c2, lr, wd, stream)
    if err == _SMEM_REFUSED:
        raise ValueError(f"galore kernel: the device refused {p.smem} bytes "
                         "of shared memory per block")
    if err != 0:
        raise RuntimeError(f"galore kernel launch failed ({p.route}): CUDA "
                           f"error {err}")
    return p.route


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def galore_precond_step(g, basis, m, v, count, *, side=None, b1=0.9,
                        b2=0.999, eps=1e-8, bias_correction=True,
                        project_back=True):
    """Launch the fused preconditioner on CUDA tensors; returns (u, m', v')
    with u (…, M, N) fp32, or ũ in the moment shape when ``project_back``
    is False. ``count`` is the post-increment step (a host number). g is
    fp32 or bf16, read as it is; basis and moments fp32; all contiguous.
    ``galore_precond_step.launches`` counts the launches and ``.routes``
    them by route."""
    side = side or infer_side(g.shape, basis.shape, m.shape)
    c1, c2 = bias_corrections(count, b1, b2, bias_correction)
    u = torch.empty(g.shape if project_back else m.shape,
                    dtype=torch.float32, device=g.device)
    m_out, v_out = torch.empty_like(m), torch.empty_like(v)
    route = _launch(g, basis, m, v, None, u,
                    PRECOND_U if project_back else PRECOND_UT, side, b1=b1,
                    b2=b2, eps=eps, c1=c1, c2=c2, lr=0.0, wd=0.0,
                    m_out=m_out, v_out=v_out)
    if route is not None:
        galore_precond_step.launches += 1
        galore_precond_step.routes[route] += 1
    return u, m_out, v_out


galore_precond_step.launches = 0
galore_precond_step.routes = dict.fromkeys(ROUTES, 0)


def galore_adamw_step(w, g, basis, m, v, count, *, side=None, b1=0.9,
                      b2=0.999, eps=1e-8, lr=1e-3, weight_decay=0.0,
                      bias_correction=True):
    """Launch the fused GaLoreAdamW step on CUDA tensors; returns
    (w', m', v'), w' in w's dtype (fp32 or bf16). g is fp32 or bf16.
    ``count`` is the post-increment step. ``galore_adamw_step.launches``
    counts the launches and ``.routes`` them by route."""
    side = side or infer_side(w.shape, basis.shape, m.shape)
    c1, c2 = bias_corrections(count, b1, b2, bias_correction)
    w_out = w.clone()
    m_out, v_out = torch.empty_like(m), torch.empty_like(v)
    route = _launch(g, basis, m, v, w_out, None, ADAMW, side, b1=b1, b2=b2,
                    eps=eps, c1=c1, c2=c2, lr=lr, wd=weight_decay,
                    m_out=m_out, v_out=v_out)
    if route is not None:
        galore_adamw_step.launches += 1
        galore_adamw_step.routes[route] += 1
    return w_out, m_out, v_out


galore_adamw_step.launches = 0
galore_adamw_step.routes = dict.fromkeys(ROUTES, 0)

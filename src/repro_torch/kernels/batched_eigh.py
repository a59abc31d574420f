"""Batched small symmetric eigensolver (port of
``repro/kernels/batched_eigh.py::jacobi_eigh``).

Parallel-order cyclic Jacobi on a (…, n, n) symmetric stack, n ≤ 64, a
fixed 12 sweeps, eigenvalues ascending with matching eigenvector columns
(the ``eigh`` convention). The kernel is CUDA C++ for sm_90a
(``csrc/batched_eigh.cu``), built with ``nvcc`` at first launch and
called through ``ctypes`` on PyTorch's current stream. Each call takes
one of two routes, chosen by :func:`plan` from n and the batch:

- ``warp`` (n ≤ ``WARP_MAX_N``), A and V in registers, 4 warps a block,
  no barrier in the sweep; what a lane needs from another arrives by
  ``__shfl_sync``. Two layouts (m = n rounded up to even):
  - ``pairs`` (m = 8, the main path's r × r Grams, up to
    ``PAIR_MAX_BATCH`` matrices): one warp a matrix, a lane for each
    (column, pair slot) holding 2 entries of A and 2 of V;
  - ``columns`` (the rest): a lane a column of A and of V, the next power
    of two ≥ m lanes a matrix, several matrices a warp below 32.
- ``block`` (larger n): one block of 4 or 8 warps owns a matrix in shared
  memory, one barrier a step.

Both follow the round-robin schedule of ``ref.round_robin_pairs``
(:func:`seat_player` is the kernel's seat arithmetic), compute (c, s)
without trigonometry (``ref.jacobi_rotation``) and keep A exactly
symmetric. ``jacobi_eigh.routes`` counts the launches by route. The plain
version is ``ref.jacobi_eigh_ref``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

MAX_JACOBI_DIM = 64
WARP_MAX_N = 16          # largest n of the warp route (PERF.md, PR 19)
PAIR_M = 8               # the pair layout's m
PAIR_MAX_BATCH = 528     # a warp a scheduler on 132 SMs; above, the
                         # column layout's 4 matrices a warp win (PERF.md)
WARPS = 4                # warp route: warps a block, one per scheduler
WARP = 32
ROUTES = ("warp", "block")
_LAYOUT_CODE = {"columns": 0, "shared": 1, "pairs": 2}   # the C entry's


class Plan(NamedTuple):
    """How one call is cut: ``route`` and its ``layout`` (``pairs`` or
    ``columns`` on the warp route, ``shared`` on the block route); ``m`` =
    n rounded up to even (odd n plays against a zero phantom column);
    ``lanes`` a matrix and ``per_warp`` matrices a warp (the block route
    spreads a matrix over all its threads); ``warps`` a block;
    ``blocks``."""
    route: str
    layout: str
    m: int
    lanes: int
    per_warp: int
    warps: int
    blocks: int


@functools.lru_cache(maxsize=1024)
def plan(n: int, batch: int) -> Plan:
    """The route and geometry of ``batch`` matrices of size ``n``."""
    if not 1 <= n <= MAX_JACOBI_DIM:
        raise ValueError(f"jacobi_eigh handles 1 <= n <= {MAX_JACOBI_DIM}, "
                         f"got n={n} (use torch.linalg.eigh)")
    m = n + (n & 1)
    if m == PAIR_M and batch <= PAIR_MAX_BATCH:
        return Plan("warp", "pairs", m, WARP, 1, WARPS, -(-batch // WARPS))
    if n <= WARP_MAX_N:
        lanes = 1 << (m - 1).bit_length()
        per_warp = WARP // lanes
        return Plan("warp", "columns", m, lanes, per_warp, WARPS,
                    -(-batch // (WARPS * per_warp)))
    warps = 4 if m <= 32 else 8
    return Plan("block", "shared", m, WARP * warps, 0, warps, batch)


def seat_player(seat: int, t: int, m: int) -> int:
    """The player in ``seat`` at step ``t`` of the circle method on ``m``
    (even) seats, as the kernel computes it (``rr_player``): seat 0 keeps
    player 0, the others turn one seat a step."""
    if seat == 0:
        return 0
    k = seat - 1 - t
    return 1 + (k + m - 1 if k < 0 else k)


def schedule(n: int):
    """The kernel's pairs, (m - 1) steps of m/2 (p, q) with p < q, phantom
    pairs (q = n for odd n) included: step t pairs seat k with seat
    m - 1 - k."""
    m = n + (n & 1)
    steps = []
    for t in range(m - 1):
        pairs = []
        for k in range(m // 2):
            a, b = seat_player(k, t, m), seat_player(m - 1 - k, t, m)
            pairs.append((min(a, b), max(a, b)))
        steps.append(pairs)
    return steps


def _pair_index(i: int, t: int, m: int) -> int:
    """The pair (seat k < m / 2) of player i at step t."""
    seat = 0 if i == 0 else 1 + (i - 1 + t) % (m - 1)
    return min(seat, m - 1 - seat)


def pair_lanes(j: int, g: int, t: int, m: int = PAIR_M):
    """The pair layout's sources for lane (column j, pair slot g) at step
    t, as the kernel packs them (``pair_sources``), lane (j, g) being
    g * m + j: where step t + 1's pivots lie once step t has updated —
    a_pp and a_qq of pair g with the lanes holding p's and q's diagonal,
    a_qp with the lane of column p holding row q, then the same for the
    pair of column j — the partner column's lane at slot g, and the
    lanes that computed the two rows of slot g at step t + 1; then
    whether j is its pair's p at t, whether each next row comes from the
    q slot of its lane, whether this lane's q slot holds its column's
    diagonal and whether it holds the row pairing with column j at
    t + 1."""
    steps = schedule(m)
    tn = (t + 1) % (m - 1)
    p, q = steps[t][g]
    k = _pair_index(j, t, m)
    pk, qk = steps[t][k]
    jp = qk if j == pk else pk
    pn, qn = steps[tn][g]
    pkn, qkn = steps[tn][_pair_index(j, tn, m)]

    def lane(col, row):                 # who holds (row, col) after step t
        return _pair_index(row, t, m) * m + col

    partner = next(b if a == j else a for a, b in steps[tn] if j in (a, b))
    return (lane(pn, pn), lane(qn, qn), lane(pn, qn), lane(pkn, pkn),
            lane(qkn, qkn), lane(pkn, qkn), g * m + jp, lane(j, pn),
            lane(j, qn), j == pk, pn != steps[t][_pair_index(pn, t, m)][0],
            qn != steps[t][_pair_index(qn, t, m)][0], j == q, partner == q)


def _lib():
    lib = _build.load("batched_eigh")
    fn = lib.jacobi_eigh_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def jacobi_eigh(a, *, sweeps: int = 12):
    """Launch the Jacobi kernel on a CUDA (…, n, n) fp32 stack; returns
    ``(lam, vec)``. Raises for n outside 1..64 or a non-square, non-CUDA or
    non-fp32 input. ``jacobi_eigh.launches`` counts the launches and
    ``.routes`` them by route."""
    n = a.shape[-1]
    if a.ndim < 2 or a.shape[-2] != n:
        raise ValueError(f"square matrices required, got {tuple(a.shape)}")
    if not 1 <= n <= MAX_JACOBI_DIM:
        raise ValueError(f"jacobi_eigh handles 1 <= n <= {MAX_JACOBI_DIM}, "
                         f"got n={n} (use torch.linalg.eigh)")
    if a.device.type != "cuda" or a.dtype != torch.float32:
        raise ValueError(f"a must be a float32 CUDA tensor, got {a.dtype} "
                         f"on {a.device}")
    lead = a.shape[:-2]
    a3 = a.reshape((-1, n, n)).contiguous()
    batch = a3.shape[0]
    lam = torch.empty((batch, n), dtype=torch.float32, device=a.device)
    vec = torch.empty((batch, n, n), dtype=torch.float32, device=a.device)
    if batch:
        p = plan(n, batch)
        err = _lib()(a3.data_ptr(), lam.data_ptr(), vec.data_ptr(), batch, n,
                     sweeps, _LAYOUT_CODE[p.layout], p.lanes, p.warps,
                     torch.cuda.current_stream(a.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"jacobi_eigh launch failed ({p.route}): "
                               f"CUDA error {err}")
        jacobi_eigh.launches += 1
        jacobi_eigh.routes[p.route] += 1
    return lam.reshape(lead + (n,)), vec.reshape(lead + (n, n))


jacobi_eigh.launches = 0
jacobi_eigh.routes = dict.fromkeys(ROUTES, 0)

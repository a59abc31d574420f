"""Port parity: ``repro_torch.kernels`` (batched heterogeneous-adapter
apply) against the JAX package's oracle and its Pallas kernel.

The same numpy inputs, made from a seed, go through the JAX reference
(``ref.lowrank_linear_batched_ref``), the JAX Pallas kernel in interpret
mode (``ops.lowrank_linear_batched``) and the port's public entry point on
CPU tensors, which runs the plain PyTorch version. Tolerances are the ones
the JAX package's own kernel tests use: 1e-5 in fp32, 5e-2 in bf16. The
CUDA kernel runs only on the card; ``chip_smoke.py`` holds it against the
plain version there.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import lowrank_linear as tll
from repro_torch.kernels import ops as tops


def _tables(rng, g, m, n, r, side):
    bdim, rshape = (n, (g, m, r)) if side == "right" else (m, (g, r, n))
    bases = (rng.standard_normal((g, bdim, r)).astype(np.float32)
             / np.sqrt(bdim))
    rts = 0.1 * rng.standard_normal(rshape).astype(np.float32)
    scales = (1.0 + 0.1 * rng.standard_normal(g)).astype(np.float32)
    return bases, rts, scales


def _both(arrays, jdtype, tdtype):
    """The same values as jax and torch arrays of one dtype (bf16 rounds
    to nearest even in both)."""
    return ([jnp.asarray(a, jdtype) for a in arrays],
            [torch.from_numpy(a).to(tdtype) for a in arrays])


def _close(t_out, j_out, tol):
    got = t_out.float().numpy()
    want = np.asarray(j_out.astype(jnp.float32))
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= tol


@pytest.mark.parametrize("side,m,n", [("right", 96, 64), ("left", 48, 96)])
@pytest.mark.parametrize("t", [1, 7, 16])   # 7: ragged row tail
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_jax_ref_and_pallas(side, m, n, t, dtype):
    b, g, r = 5, 3, 4
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, t, m)).astype(np.float32)
    w = rng.standard_normal((m, n)).astype(np.float32) / np.sqrt(m)
    bases, rts, scales = _tables(rng, g, m, n, r, side)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    (jx, jw, jb, jr), (tx, tw, tb, tr) = _both((x, w, bases, rts), jdt, tdt)
    ids = np.array([0, 2, 1, 2, 0], np.int32)
    out = tops.lowrank_linear_batched(tx, tw, tb, tr,
                                      torch.from_numpy(scales),
                                      torch.from_numpy(ids), side=side)
    assert out.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 5e-2
    _close(out, jref.lowrank_linear_batched_ref(
        jx, jw, jb, jr, jnp.asarray(scales), jnp.asarray(ids), side=side), tol)
    _close(out, jops.lowrank_linear_batched(
        jx, jw, jb, jr, jnp.asarray(scales), jnp.asarray(ids), side=side,
        block_t=8), tol)


def test_2d_x_duplicate_ids_and_inferred_side():
    b, m, n, g, r = 6, 32, 48, 2, 3
    rng = np.random.default_rng(1)
    x = rng.standard_normal((b, m)).astype(np.float32)
    w = rng.standard_normal((m, n)).astype(np.float32) / 6.0
    bases, rts, scales = _tables(rng, g, m, n, r, "left")
    ids = np.array([1, 1, 1, 0, 0, 1], np.int32)   # duplicates
    args = [torch.from_numpy(a) for a in (x, w, bases, rts, scales, ids)]
    out = tops.lowrank_linear_batched(*args)       # side inferred: left
    assert out.shape == (b, n)
    _close(out, jref.lowrank_linear_batched_ref(
        *[jnp.asarray(a) for a in (x, w, bases, rts, scales, ids)],
        side="left"), 1e-5)
    # duplicate rows with identical inputs see identical outputs
    x2 = np.broadcast_to(rng.standard_normal(m).astype(np.float32),
                         (b, m)).copy()
    out2 = tops.lowrank_linear_batched(torch.from_numpy(x2), *args[1:])
    assert torch.equal(out2[0], out2[1]) and torch.equal(out2[3], out2[4])


@pytest.mark.parametrize("side", ["right", "left"])
def test_ragged_ranks_zero_padded(side):
    """A table padded from r_g to r_max applies the same delta. The JAX
    package gets bit-equality here; the plain PyTorch version's CPU BLAS
    blocks the shrink by its output width r, so the two agree to fp32
    rounding of the O(1) outputs (the CUDA kernel sums each rank column
    alone and adds the zero columns exactly)."""
    b, t, m, n, g = 3, 4, 40, 24, 2
    r_small, r_max = 2, 5
    rng = np.random.default_rng(2)
    x = rng.standard_normal((b, t, m)).astype(np.float32)
    w = rng.standard_normal((m, n)).astype(np.float32) / 6.0
    bases, rts, scales = _tables(rng, g, m, n, r_small, side)
    pad_r = [(0, 0)] * 3
    pad_r[2 if side == "right" else 1] = (0, r_max - r_small)
    bases_p = np.pad(bases, [(0, 0), (0, 0), (0, r_max - r_small)])
    rts_p = np.pad(rts, pad_r)
    ids = torch.tensor([0, 1, 0], dtype=torch.int32)
    to = torch.from_numpy
    small = tops.lowrank_linear_batched(to(x), to(w), to(bases), to(rts),
                                        to(scales), ids, side=side)
    padded = tops.lowrank_linear_batched(to(x), to(w), to(bases_p),
                                         to(rts_p), to(scales), ids,
                                         side=side)
    assert torch.max(torch.abs(small - padded)) <= 1e-6


def test_infer_side_matches_jax():
    from repro.kernels.lowrank_linear import infer_side as jax_infer
    for shapes in (((96, 64), (64, 4), (96, 4)),
                   ((48, 96), (48, 4), (4, 96))):
        assert tll.infer_side(*shapes) == jax_infer(*shapes)
    with pytest.raises(ValueError, match="inconsistent lowrank shapes"):
        tll.infer_side((48, 96), (64, 4), (4, 96))


@pytest.mark.parametrize("rows,m,n", [(8, 1024, 1024), (8, 1024, 2816),
                                      (8, 2816, 1024), (128, 1024, 1024),
                                      (1024, 2816, 1024), (3, 40, 24),
                                      (17, 1032, 520), (100, 40, 24),
                                      (1, 7, 5), (64, 1024, 8)])
def test_split_k_covers_k_in_whole_tiles(rows, m, n):
    """The fp32 route's K split: chunks are whole K tiles, cover K exactly
    once, and only small row counts split."""
    ksplit, k_chunk = tll.split_k(rows, m, n, sms=132)
    assert k_chunk % 16 == 0 and ksplit >= 1
    assert (ksplit - 1) * k_chunk < m <= ksplit * k_chunk
    if rows >= 1024:
        assert ksplit == 1
    p = tll.plan("fp32", rows, rows, m, n, sms=132)
    assert (p.ksplit, p.k_chunk, p.pieces) == (ksplit, k_chunk, 1)


# (m, n) of every adapted projection on the ported paths
_PATH_MN = [(1024, 1024), (1024, 2816), (2816, 1024),      # qwen1.5-0.5b
            (2048, 2048), (2048, 7168), (7168, 2048),      # rwkv6-1.6b
            (4608, 4608), (4608, 512), (4608, 18432),      # starcoder2-7b
            (18432, 4608)]
# (B, t) of every launch: serving decode, generate prefill, SlotServer's
# admission prefill (full and ragged), the training forward
_PATH_BT = [(8, 1), (8, 128), (1, 128), (1, 100), (4, 128)]
# the edges of each route: rows 1, 8, 16, 17, TC_MIN_ROWS - 1, TC_MIN_ROWS,
# TC_MIN_ROWS + 1, t = 100 tiles spanning two sequences, 1024 rows; n not a
# multiple of the N tile, m not a multiple of the K tile, a short last K
# chunk
_EDGE = [(1, 1, 1024, 1024), (8, 1, 1032, 520), (16, 1, 4608, 4608),
         (17, 1, 1024, 2816), (1, 63, 2816, 1024), (1, 64, 1024, 1024),
         (1, 65, 1032, 520), (8, 100, 1024, 1024), (8, 128, 2816, 1024),
         (2, 17, 1032, 520), (65, 1, 1024, 1024), (8, 128, 4104, 136)]


def _chunk_ranges(m, ksplit, k_chunk):
    """K ranges of the kernel's blocks z: [z k_chunk, min(m, (z+1) k_chunk))."""
    return [(z * k_chunk, min(m, (z + 1) * k_chunk)) for z in range(ksplit)]


def _assert_partition(ranges, lo, hi):
    """The ranges, in order, cover [lo, hi) once (empty ones allowed)."""
    pos = lo
    for a, b in ranges:
        if b > a:
            assert a == pos, (ranges, lo, hi)
            pos = b
    assert pos == hi, (ranges, lo, hi)


@pytest.mark.parametrize("b,t,m,n", [(b, t, m, n) for (m, n) in _PATH_MN
                                     for (b, t) in _PATH_BT] + _EDGE)
def test_plan_covers_rows_n_and_k_in_whole_tiles(b, t, m, n):
    """The tile and split plan of the call's route covers rows, n and K
    once, in whole tiles: K chunks are whole 64-wide TMA tiles (only the
    last may run past m, where TMA reads zeros), none is empty, the
    shrink's K pieces and row blocks partition K and each sequence's rows,
    and the output tiles fill the card where the shape allows."""
    rows, sms = b * t, 132
    which = tll.route(rows, m, n, 16, torch.bfloat16, torch.bfloat16)
    p = tll.plan(which, rows, t, m, n, sms)
    assert p.route == which
    assert p.k_chunk % 64 == 0 and p.ksplit >= 1
    chunks = _chunk_ranges(m, p.ksplit, p.k_chunk)
    assert all(b_ > a for a, b_ in chunks)
    _assert_partition(chunks, 0, m)
    if which == "tc_decode":
        assert rows < tll.TC_MIN_ROWS and rows <= p.bm and p.bm in (16, 64)
        cols = -(-n // 128)
        assert p.pieces == p.ksplit * cols   # a shrink piece a block
        sub = cols
        for kb, ke in chunks:            # each chunk's sub-pieces
            step = -(-(ke - kb) // sub)
            _assert_partition([(kb + i * step, min(ke, kb + (i + 1) * step))
                               for i in range(sub)], kb, ke)
        k_tiles = -(-m // 64)
        slots = sms * (2 if p.bm == 16 else 1)   # one wave of blocks
        if cols < slots:
            assert cols * p.ksplit <= slots
            assert 2 * cols * p.ksplit >= slots or p.ksplit == k_tiles
        else:
            assert p.ksplit == 1
        assert p.partials
    else:
        assert which == "tc_gemm" and rows >= tll.TC_MIN_ROWS
        assert p.bm in (64, 128)
        tiles = -(-rows // p.bm) * -(-n // 128)
        if rows * n <= tll._TC_MAX_SPLIT_OUT:
            assert tiles * p.ksplit >= min(sms // 2, tiles * max(
                1, -(-m // 64) // 16))
        if p.ksplit > 1:
            assert p.k_chunk >= 16 * 64 and 2 * tiles < sms
            assert rows * n <= tll._TC_MAX_SPLIT_OUT
        assert p.partials == (p.ksplit > 1)
        assert p.s_slots == p.pieces + 1     # the pieces and their sum
        assert p.piece % 128 == 0            # whole shrink chunks
        _assert_partition([(f * p.piece, min(m, (f + 1) * p.piece))
                           for f in range(p.pieces)], 0, m)
        per_seq = -(-t // 32)            # shrink row blocks of one sequence
        for q in range(b):
            _assert_partition([(q * t + i * 32, min((q + 1) * t,
                                                    q * t + (i + 1) * 32))
                               for i in range(per_seq)], q * t, (q + 1) * t)


@pytest.mark.parametrize("b,t", _PATH_BT)
@pytest.mark.parametrize("m,n", _PATH_MN)
def test_route_of_every_path_call_is_a_tensor_core_route(b, t, m, n):
    """Every (rows, m, n) the ported paths launch is bf16 with m, n
    multiples of 8 and rank 8 or 16: decode (8 rows) takes tc_decode,
    every prefill and the training forward (100-1024 rows) tc_gemm."""
    rows = b * t
    ptrs = (0x7f0000000000, 0x7f0000100000, 0x7f0000200000)
    for r in (8, 16):
        which = tll.route(rows, m, n, r, torch.bfloat16, torch.bfloat16,
                          ptrs)
        assert which == ("tc_decode" if rows < tll.TC_MIN_ROWS
                         else "tc_gemm")


@pytest.mark.parametrize("case,want", [
    (dict(), "tc_gemm"),
    (dict(rows=63), "tc_decode"),
    (dict(rows=1), "tc_decode"),
    (dict(x_dtype=torch.float32), "fp32"),
    (dict(w_dtype=torch.float32), "fp32"),
    (dict(m=1028), "fp32"),                   # m not a multiple of 8
    (dict(n=517), "fp32"),                    # n not a multiple of 8
    (dict(r=65), "fp32"),                     # rank above MAX_TC_RANK
    (dict(ptrs=(0x1002, 0x2000, 0x3000)), "fp32"),   # x view 2 B off
    (dict(ptrs=(0x1000, 0x2008, 0x3000)), "fp32"),   # W 8 B off
    (dict(ptrs=(0x1000, 0x2000, 0x3004)), "fp32"),   # y 4 B off
    (dict(rows=8, ptrs=(0x1010, 0x2020, 0x3030)), "tc_decode"),
])
def test_route_rules(case, want):
    """The route follows dtype, m and n divisibility by 8, the rank limit
    and 16-byte alignment of x, W and y (TMA's rule), then rows."""
    args = dict(rows=128, m=1024, n=1024, r=16, x_dtype=torch.bfloat16,
                w_dtype=torch.bfloat16, ptrs=(0x1000, 0x2000, 0x3000))
    args.update(case)
    assert tll.route(**args) == want


def test_device_rules():
    """CPU tensors take the plain version; the kernel is never a CPU
    fallback, and mixed devices raise."""
    rng = np.random.default_rng(3)
    x, w = torch.randn(2, 8), torch.randn(8, 4)
    bases, rts, scales = (torch.from_numpy(a)
                          for a in _tables(rng, 2, 8, 4, 2, "right"))
    ids = torch.tensor([0, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="one CUDA device"):
        tll.lowrank_linear_batched(x, w, bases, rts, scales, ids,
                                   side="right")
    with pytest.raises(ValueError, match="mixed devices"):
        tops.lowrank_linear_batched(x, w, bases, rts, scales,
                                    ids.to("meta"))
    with tops.plain_kernels():
        plain = tops.lowrank_linear_batched(x, w, bases, rts, scales, ids)
    assert torch.equal(plain, tops.lowrank_linear_batched(
        x, w, bases, rts, scales, ids))
    assert tll.lowrank_linear_batched.launches == 0
    assert sum(tll.lowrank_linear_batched.routes.values()) == 0

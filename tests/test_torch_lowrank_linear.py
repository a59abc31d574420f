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
                                      (1024, 2816, 1024), (3, 40, 24)])
def test_split_k_covers_k_in_whole_tiles(rows, m, n):
    """The K split handed to the kernel: chunks are whole K tiles, cover
    K exactly once, and only small row counts split."""
    ksplit, k_chunk = tll.split_k(rows, m, n, sms=132)
    assert k_chunk % 16 == 0 and ksplit >= 1
    assert (ksplit - 1) * k_chunk < m <= ksplit * k_chunk
    if rows >= 1024:
        assert ksplit == 1


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

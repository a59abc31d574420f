"""Rank-r gradient projectors (port of ``repro/core/projector.py``).

* ``proj_type=std`` side rule: for a block ``W ∈ R^{m×n}`` a RIGHT basis
  ``B ∈ R^{n×r}`` when ``m >= n`` (``g̃ = g B``), else a LEFT basis
  ``B ∈ R^{m×r}`` (``g̃ = Bᵀ g``).
* Data-driven bases (exact SVD, randomized SVD) and seeded random
  orthonormal bases, fully determined by an integer seed through the
  port's threefry (``utils.prng``), so a basis rebuilt from the broadcast
  seed is JAX's basis.
* The r×r change of basis ``X ← X (B_oldᵀ B_new)`` for projected buffers.

Every function takes leading batch dims (stacked scan blocks, stacked
buckets) where JAX vmaps: torch's linalg is batched, and a key tensor
``(..., 2)`` draws one Gaussian sketch per batch entry.

SVD signs are implementation-defined, and the round-0 RSVD bases reach a
sign-sensitive clamp (the synced ṽ install, ``galore.with_projected_v``).
For CPU tensors the small SVD therefore runs LAPACK ``gesdd`` through
SciPy, the routine JAX's CPU backend calls, so the port takes the same
signs as the reference there; CUDA tensors use ``torch.linalg.svd``, a
stack of larger matrices several at once (:func:`_svd_card`).
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from ..utils import prng

RIGHT = "right"
LEFT = "left"


def proj_side(shape) -> str:
    """GaLore ``proj_type=std``: right basis iff m >= n (square ⇒ right).

    Shapes may carry leading batch dims (stacked scan blocks) — only the
    trailing two matter.
    """
    if len(shape) < 2:
        raise ValueError(f"projector requires a ≥2-D block, got {shape}")
    m, n = shape[-2:]
    return RIGHT if m >= n else LEFT


def basis_dim(shape) -> int:
    """The ambient dimension the basis lives in (n for right, m for left)."""
    m, n = shape[-2:]
    return n if proj_side(shape) == RIGHT else m


def project(g, basis, side: str):
    """g (..., m, n), basis (..., dim, r) -> (..., m, r) or (..., r, n)."""
    if side == RIGHT:
        return torch.einsum("...mn,...nr->...mr", g, basis)
    return torch.einsum("...mr,...mn->...rn", basis, g)


def project_back(u, basis, side: str):
    """Projected update back to ambient shape."""
    if side == RIGHT:
        return torch.einsum("...mr,...nr->...mn", u, basis)
    return torch.einsum("...mr,...rn->...mn", basis, u)


def reproject(buf, old_basis, new_basis, side: str):
    """Change of basis for projected optimizer buffers (Appendix A.1):
    right ``buf (m,r) ← buf @ (B_oldᵀ B_new)``; left ``buf (r,n) ←
    (B_newᵀ B_old) buf``."""
    transfer = torch.einsum("...dr,...ds->...rs", old_basis, new_basis)
    if side == RIGHT:
        return torch.einsum("...mr,...rs->...ms", buf, transfer)
    return torch.einsum("...rs,...rn->...sn", transfer, buf)


# ---------------------------------------------------------------- bases ----

SVD_STREAMS = 8          # cuSOLVER SVDs in flight at once on the card


def _svd_card(x):
    """``torch.linalg.svd`` of each matrix of a CUDA stack, up to
    :data:`SVD_STREAMS` at once: a host thread and a side stream per share
    of the stack, each matrix the same call as alone. One cuSOLVER SVD of
    a large matrix leaves most of the card idle and waits on the host for
    its convergence flag, so matrices in flight together finish sooner.
    Stacks of small matrices (≤ 32, which torch solves in one batched
    Jacobi call), single matrices and tensors that need a gradient take
    the plain batched call."""
    flat = x.reshape((-1,) + x.shape[-2:])
    n = min(SVD_STREAMS, flat.shape[0])
    if n < 2 or max(x.shape[-2:]) <= 32 or x.requires_grad:
        return torch.linalg.svd(x, full_matrices=False)
    mm, nn = x.shape[-2:]
    k = min(mm, nn)
    u = flat.new_empty((flat.shape[0], mm, k))
    s = flat.new_empty((flat.shape[0], k))
    vt = flat.new_empty((flat.shape[0], k, nn))
    main = torch.cuda.current_stream(x.device)
    streams = [torch.cuda.Stream(x.device) for _ in range(n)]
    for st in streams:
        st.wait_stream(main)          # x is ready before any share reads it

    def share(j):
        with torch.cuda.stream(streams[j]):
            for i in range(j, flat.shape[0], n):
                ui, si, vti = torch.linalg.svd(flat[i], full_matrices=False)
                u[i].copy_(ui)
                s[i].copy_(si)
                vt[i].copy_(vti)

    with ThreadPoolExecutor(n) as pool:
        list(pool.map(share, range(n)))          # re-raises a share's error
    for st in streams:
        main.wait_stream(st)
    lead = x.shape[:-2]
    return (u.reshape(lead + (mm, k)), s.reshape(lead + (k,)),
            vt.reshape(lead + (k, nn)))


def _svd(x):
    """Batched economy SVD ``(u, s, vt)``: LAPACK ``gesdd`` through SciPy
    for CPU tensors (the signs JAX's CPU backend gives), torch.linalg.svd
    on the card (:func:`_svd_card`)."""
    if x.device.type != "cpu":
        return _svd_card(x)
    import scipy.linalg
    a = x.detach().numpy()
    flat = a.reshape((-1,) + a.shape[-2:])
    outs = [scipy.linalg.svd(mat, full_matrices=False,
                             lapack_driver="gesdd") for mat in flat]
    u, s, vt = (np.stack([o[i] for o in outs]).reshape(
        a.shape[:-2] + outs[0][i].shape) for i in range(3))
    return (torch.from_numpy(u.astype(np.float32)),
            torch.from_numpy(s.astype(np.float32)),
            torch.from_numpy(vt.astype(np.float32)))


def svd_basis(g, rank: int, side: str):
    """Exact top-r singular basis of the gradient (GaLore's SVD refresh);
    leading dims batch."""
    u, _, vt = _svd(g.float())
    if side == RIGHT:
        return vt[..., :rank, :].mT          # (n, r) right singular vectors
    return u[..., :rank]                     # (m, r) left singular vectors


def rsvd_basis(g, rank: int, side: str, key, oversample: int = 8,
               power_iters: int = 1):
    """Randomized SVD basis: a Gaussian sketch from ``key`` (one key per
    batch entry of ``g``), one power iteration, QR, and a small SVD."""
    g32 = g.float()
    m, n = g32.shape[-2:]
    k = min(rank + oversample, min(m, n))
    if side == LEFT:
        g32 = g32.mT                 # reduce to the right-basis problem on gᵀ
        m, n = n, m
    omega = prng.normal(key, (m, k))
    y = g32.mT @ omega                                   # (n, k)
    for _ in range(power_iters):
        y = g32.mT @ (g32 @ y)
    q, _ = torch.linalg.qr(y)                            # (n, k)
    b = g32 @ q                                          # (m, k)
    _, _, vt = _svd(b)                                   # (k, k)
    return q @ vt[..., :rank, :].mT                      # (n, r)


def random_basis(key, dim: int, rank: int):
    """Seeded random orthonormal basis (..., dim, r): QR of a Gaussian
    sketch with the signs fixed by diag(R). ``key`` is an int seed or a
    ``(..., 2)`` key tensor."""
    if not torch.is_tensor(key):
        key = prng.PRNGKey(key)
    gauss = prng.normal(key, (dim, rank))
    q, r = torch.linalg.qr(gauss)
    signs = torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))
    signs = torch.where(signs == 0, 1.0, signs)
    return q * signs[..., None, :]


def seeded_block_key(seed, refresh_idx, block_id, device=None):
    """Per-(round seed, refresh, block) key so blocks decorrelate but every
    client reconstructs the identical basis from the broadcast seed.
    ``block_id`` may be an int tensor (one key per id)."""
    key = prng.PRNGKey(int(seed) & 0xFFFFFFFF, device=device)
    key = prng.fold_in(key, int(refresh_idx) & 0xFFFFFFFF)
    return prng.fold_in(key, block_id)


def stacked_keys(base_key, n: int):
    """Per-layer keys ``fold_in(base_key, i)``, i < n: (..., 2) ->
    (..., n, 2)."""
    idx = torch.arange(n, dtype=torch.int64, device=base_key.device)
    return prng.fold_in(base_key[..., None, :], idx)


# The stacked (scan-block) variants of the JAX package are the functions
# above: leading dims batch throughout.
svd_basis_nd = svd_basis
rsvd_basis_nd = rsvd_basis
random_basis_nd = random_basis


class ProjectorSchedule(NamedTuple):
    """SVD->random schedule (Appendix D): data-driven bases for the first
    ``adaptive_steps`` refreshes, seeded random thereafter."""
    refresh_every: int            # tau
    adaptive_steps: int           # S: number of data-driven refreshes
    rank: int
    oversample: int = 8
    use_exact_svd: bool = False   # exact SVD vs RSVD in the adaptive phase

    def is_adaptive(self, refresh_idx) -> bool:
        return int(refresh_idx) < self.adaptive_steps

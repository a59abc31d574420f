"""Port parity: ``repro_torch.core.projector`` against
``repro.core.projector`` on the same numpy inputs.

Projections are held to 1e-6. Data-driven bases are compared as
subspaces (‖PPᵀ − QQᵀ‖_max) on gradients with a clear spectral gap at the
rank, because SVD signs are implementation-defined and a top-r subspace
is only as stable as its gap; the randomized SVD with the same key is held
to 1e-5.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.core import projector as jproj
from repro_torch.core import projector as tproj


def _graded(rng, lead, m, n, rank):
    """A matrix stack with singular values 1, .8, .6, .4 down to rank, then
    a floor far below: a clear gap at ``rank``."""
    out = []
    for _ in range(int(np.prod(lead, dtype=int))):
        u, _ = np.linalg.qr(rng.standard_normal((m, m)))
        v, _ = np.linalg.qr(rng.standard_normal((n, n)))
        k = min(m, n)
        s = np.concatenate([np.linspace(1.0, 0.4, rank),
                            0.02 * rng.random(k - rank)])
        out.append((u[:, :k] * s) @ v[:, :k].T)
    return np.stack(out).reshape(tuple(lead) + (m, n)).astype(np.float32)


def _subspace_err(p, q):
    p, q = np.asarray(p), np.asarray(q)
    return np.max(np.abs(p @ np.swapaxes(p, -1, -2)
                         - q @ np.swapaxes(q, -1, -2)))


@pytest.mark.parametrize("side,m,n", [("right", 40, 24), ("left", 24, 40)])
def test_project_back_reproject(side, m, n):
    rng = np.random.default_rng(0)
    r, dim = 4, (n if side == "right" else m)
    g = rng.standard_normal((2, m, n)).astype(np.float32)
    b_old = np.linalg.qr(rng.standard_normal((2, dim, r)))[0].astype(
        np.float32)
    b_new = np.linalg.qr(rng.standard_normal((2, dim, r)))[0].astype(
        np.float32)
    u = rng.standard_normal((2,) + ((m, r) if side == "right"
                                    else (r, n))).astype(np.float32)
    pairs = [
        (jproj.project(jnp.asarray(g), jnp.asarray(b_old), side),
         tproj.project(torch.from_numpy(g), torch.from_numpy(b_old), side)),
        (jproj.project_back(jnp.asarray(u), jnp.asarray(b_old), side),
         tproj.project_back(torch.from_numpy(u), torch.from_numpy(b_old),
                            side)),
        (jproj.reproject(jnp.asarray(u), jnp.asarray(b_old),
                         jnp.asarray(b_new), side),
         tproj.reproject(torch.from_numpy(u), torch.from_numpy(b_old),
                         torch.from_numpy(b_new), side)),
    ]
    for want, got in pairs:
        assert np.max(np.abs(np.asarray(want) - got.numpy())) <= 1e-6


def test_side_rule():
    assert tproj.proj_side((4, 3)) == jproj.proj_side((4, 3)) == "right"
    assert tproj.proj_side((2, 3, 5)) == jproj.proj_side((2, 3, 5)) == "left"
    assert tproj.basis_dim((3, 5)) == jproj.basis_dim((3, 5)) == 3
    with pytest.raises(ValueError):
        tproj.proj_side((4,))


@pytest.mark.parametrize("side,m,n", [("right", 64, 40), ("left", 40, 64)])
def test_rsvd_basis_same_key(side, m, n):
    rng = np.random.default_rng(1)
    g = _graded(rng, (3,), m, n, 4)
    jkeys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(5),
                                                  i))(jnp.arange(3))
    want = jproj.rsvd_basis_nd(jnp.asarray(g), 4, side, jkeys)
    got = tproj.rsvd_basis(torch.from_numpy(g), 4, side,
                           torch.from_numpy(np.asarray(jkeys).astype(
                               np.int64)))
    assert got.shape == want.shape
    assert _subspace_err(want, got.numpy()) <= 1e-5


@pytest.mark.parametrize("side,m,n", [("right", 48, 32), ("left", 32, 48)])
def test_svd_basis_subspace(side, m, n):
    g = _graded(np.random.default_rng(2), (2,), m, n, 4)
    want = jproj.svd_basis_nd(jnp.asarray(g), 4, side)
    got = tproj.svd_basis(torch.from_numpy(g), 4, side)
    assert got.shape == want.shape
    assert _subspace_err(want, got.numpy()) <= 1e-5


def test_cpu_svd_takes_lapack_gesdd_signs():
    """On CPU tensors the small SVD is LAPACK gesdd through SciPy — the
    routine behind jnp.linalg.svd on the CPU — so even the signs agree."""
    rng = np.random.default_rng(3)
    b = rng.standard_normal((5, 30, 12)).astype(np.float32)
    _, _, want = jnp.linalg.svd(jnp.asarray(b), full_matrices=False)
    _, _, got = tproj._svd(torch.from_numpy(b))
    assert np.max(np.abs(np.asarray(want) - got.numpy())) <= 1e-5

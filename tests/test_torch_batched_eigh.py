"""Port parity: ``kernels.ref.jacobi_eigh_ref`` (the plain version of the
CUDA ``jacobi_eigh``) against the JAX package's Pallas Jacobi kernel in
interpret mode, and the ``ops.batched_small_eigh`` routing and mask
semantics against the JAX wrapper's.

Eigenvalues are held to 1e-5 of the spectrum's scale. Eigenvectors are
compared as subspaces: the projector onto each cluster of equal
eigenvalues (a repeated eigenvalue has no canonical basis, and signs are
arbitrary), to 1e-4. Repeated spectra are held to 2e-3: with triple
eigenvalues one unit apart in a 64×64 matrix (relative gap 1/22), the
fixed 12 fp32 sweeps leave the cluster projectors 3e-5 to 3.5e-4 (JAX's
kernel) and 1e-4 to 9e-4 (the port's plain version) away from float64
LAPACK over five seeds, so the two differ by up to ~1e-3 while each is
as far from the truth as the algorithm allows.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import ops as jops
from repro.kernels.batched_eigh import jacobi_eigh as jjacobi
from repro_torch.kernels import batched_eigh as teigh
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The smoke-size tensors gain nothing from torch's intra-op pool, and
    beside the JAX compiles of parallel test workers its idle threads only
    compete for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spectrum_case(rng, kind, n, batch=3):
    out = []
    for _ in range(batch):
        q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        if kind == "random":
            lam = rng.random(n) * 4.0
        elif kind == "rank_deficient":
            lam = np.concatenate([rng.random(n - n // 2) + 0.5,
                                  np.zeros(n // 2)])
        else:                                   # repeated eigenvalues
            lam = np.repeat(np.arange(1, n // 3 + 2, dtype=float), 3)[:n]
        out.append((q * lam) @ q.T)
    a = np.stack(out).astype(np.float32)
    return 0.5 * (a + np.swapaxes(a, -1, -2))


def _cluster_projector_err(lam, v1, v2, rel=1e-2):
    """Max projector difference over clusters of (near-)equal eigenvalues
    of the first solution."""
    scale = max(np.max(np.abs(lam)), 1e-30)
    worst, i, n = 0.0, 0, len(lam)
    while i < n:
        j = i + 1
        while j < n and lam[j] - lam[j - 1] <= rel * scale:
            j += 1
        p1 = v1[:, i:j] @ v1[:, i:j].T
        p2 = v2[:, i:j] @ v2[:, i:j].T
        worst = max(worst, float(np.max(np.abs(p1 - p2))))
        i = j
    return worst


@pytest.mark.parametrize("n", [3, 8, 17, 64])
@pytest.mark.parametrize("kind", ["random", "rank_deficient", "repeated"])
def test_ref_matches_pallas_jacobi(n, kind):
    rng = np.random.default_rng(n)
    a = _spectrum_case(rng, kind, n)
    lam_j, vec_j = (np.asarray(x) for x in jjacobi(jnp.asarray(a),
                                                    interpret=True))
    lam_t, vec_t = (x.numpy() for x in tref.jacobi_eigh_ref(
        torch.from_numpy(a)))
    for b in range(a.shape[0]):
        scale = np.max(np.abs(lam_j[b]))
        assert np.max(np.abs(lam_t[b] - lam_j[b])) <= 1e-5 * scale
        tol = 2e-3 if kind == "repeated" else 1e-4
        assert _cluster_projector_err(lam_j[b], vec_j[b], vec_t[b]) <= tol
        assert np.all(np.diff(lam_t[b]) >= 0)          # ascending
        recon = (vec_t[b] * lam_t[b]) @ vec_t[b].T
        assert np.max(np.abs(recon - a[b])) <= 1e-5 * scale * n


def test_exact_zero_off_diagonals_rotate_by_zero():
    """Diagonal input: θ pinned to 0 everywhere, so V stays the identity
    up to the ascending sort (no π/2 swaps)."""
    d = np.array([[3.0, 1.0, 2.0, 0.5]], np.float32)
    a = torch.diag_embed(torch.from_numpy(d))
    lam, vec = tref.jacobi_eigh_ref(a)
    order = np.argsort(d[0], kind="stable")
    assert np.array_equal(lam.numpy()[0], d[0][order])
    assert np.array_equal(np.abs(vec.numpy()[0]), np.eye(4)[:, order])


def test_batched_small_eigh_mask_semantics():
    rng = np.random.default_rng(7)
    a = _spectrum_case(rng, "random", 6, batch=4).reshape(2, 2, 6, 6)
    a[0, 1, 0, 0] = np.nan                    # a quarantined payload
    mask = np.array([[True, False], [True, True]])
    lam_j, vec_j = jops.batched_small_eigh(jnp.asarray(a), mask=mask)
    for force in (None, "lapack", "jacobi"):
        lam_t, vec_t = tops.batched_small_eigh(torch.from_numpy(a),
                                               mask=torch.from_numpy(mask),
                                               force=force)
        lam_t, vec_t = lam_t.numpy(), vec_t.numpy()
        assert np.all(lam_t[0, 1] == 0.0)
        assert np.array_equal(np.abs(vec_t[0, 1]), np.eye(6))
        assert np.all(np.isfinite(lam_t)) and np.all(np.isfinite(vec_t))
        assert np.max(np.abs(lam_t - np.asarray(lam_j))) <= 1e-5 * np.max(
            np.abs(lam_j))
    full_t = tops.batched_small_eigh(torch.from_numpy(a[1]),
                                     mask=np.ones(2, bool))
    plain_t = tops.batched_small_eigh(torch.from_numpy(a[1]))
    assert all(torch.equal(x, y) for x, y in zip(full_t, plain_t))


def test_routing_on_cpu():
    """CPU tensors take LAPACK unless the Jacobi route is forced, which
    then runs the plain version; the kernel never launches here."""
    a = torch.from_numpy(_spectrum_case(np.random.default_rng(8), "random",
                                        5))
    lam, _ = tops.batched_small_eigh(a)
    assert torch.equal(lam, torch.linalg.eigh(a)[0])
    lam_j, _ = tops.batched_small_eigh(a, force="jacobi")
    assert torch.equal(lam_j, tref.jacobi_eigh_ref(a)[0])
    with pytest.raises(ValueError, match="CUDA"):
        teigh.jacobi_eigh(a)
    with pytest.raises(ValueError, match="n <= 64"):
        teigh.jacobi_eigh(torch.zeros(2, 65, 65))
    assert teigh.jacobi_eigh.launches == 0

"""Port parity: ``kernels.ref.jacobi_eigh_ref`` (the plain version of the
CUDA ``jacobi_eigh``) against the JAX package's Pallas Jacobi kernel in
interpret mode, and the ``ops.batched_small_eigh`` routing and mask
semantics against the JAX wrapper's. The CUDA kernel cannot run here, so
its host side is checked instead: ``plan``, its schedule against JAX's,
its (c, s) formula against ½·atan2, the pair layout's lane sources, and
an emulation of its order of operations against the card's gates.

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
from repro.kernels.batched_eigh import _round_robin_pairs as jpairs
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
    assert sum(teigh.jacobi_eigh.routes.values()) == 0


# ----------------------------------------------- the kernel's host side --

@pytest.mark.parametrize("batch", [1, 7, 101, 384, 528, 529, 6144])
def test_plan_route_and_geometry(batch):
    """Warp route up to WARP_MAX_N: m = 8 (n = 7, 8) in the pair layout, one
    warp a matrix, up to PAIR_MAX_BATCH matrices; otherwise the column
    layout, a power-of-two lane group >= m (n rounded up to even) a
    matrix, whole matrices a warp. 4 warps a block, and the blocks cover
    the batch with less than one block spare (101 fills no whole block).
    Block route above: one block a matrix."""
    for n in range(1, 65):
        p = teigh.plan(n, batch)
        assert p.m == n + n % 2
        if n <= teigh.WARP_MAX_N:
            assert p.route == "warp" and p.warps == teigh.WARPS == 4
            pairs = p.m == 8 and batch <= teigh.PAIR_MAX_BATCH
            assert p.layout == ("pairs" if pairs else "columns")
            if pairs:
                assert (p.lanes, p.per_warp) == (32, 1)
            else:
                assert p.lanes & (p.lanes - 1) == 0
                assert p.m <= p.lanes <= 32 and p.lanes < 2 * p.m
                assert p.per_warp * p.lanes == 32
            per_block = p.warps * p.per_warp
            assert (p.blocks - 1) * per_block < batch <= p.blocks * per_block
        else:
            assert (p.route, p.layout, p.blocks) == ("block", "shared", batch)
            assert p.warps == (4 if p.m <= 32 else 8)
    with pytest.raises(ValueError, match="n <= 64"):
        teigh.plan(65, batch)


def test_main_path_plans():
    """The 𝒮 buckets of the main path (384, 96 and 192 Grams of 8 x 8) and
    rank 16 take the warp route; the 64-client cohort's 6,144 Grams the
    column layout, 4 matrices a warp."""
    for batch in (384, 96, 192):
        assert teigh.plan(8, batch)[:6] == ("warp", "pairs", 8, 32, 1, 4)
    assert teigh.plan(16, 384)[:6] == ("warp", "columns", 16, 16, 2, 4)
    assert teigh.plan(8, 6144)[:6] == ("warp", "columns", 8, 8, 4, 4)


def test_pair_layout_sources_deliver():
    """Follow labels through two sweeps of the pair layout: lane (j, g)
    holds entries (p_g, j) and (q_g, j) of step t and updates them in
    place; the sources the kernel packs bring it, from the updated
    lanes, a_pp, a_qq, a_qp of step t + 1's row pair and of its column's
    pair, the partner column's lane, and the rows of slot g at step
    t + 1; step 0's pivots come from the lanes the kernel's prologue
    names; after a sweep the lanes hold step 0's entries, where the sort
    reads the diagonal."""
    m = teigh.PAIR_M
    steps = teigh.schedule(m)
    lanes = [(j, g) for g in range(m // 2) for j in range(m)]
    held = {g * m + j: (steps[0][g], j) for j, g in lanes}   # ((p, q), j)

    def slot(lane, s):
        (p, q), col = held[lane]
        return ((p, q)[s], col)                              # (row, col)

    for j, g in lanes:                   # the prologue's step-0 pivots
        p, q = steps[0][g]
        k = min(j, m - 1 - j)
        assert (slot(g * m + g, 0), slot(g * m + q, 1),
                slot(g * m + g, 1)) == ((p, p), (q, q), (q, p))
        assert (slot(k * m + k, 0), slot(k * m + m - 1 - k, 1),
                slot(k * m + k, 1)) == ((k, k), (m - 1 - k, m - 1 - k),
                                        (m - 1 - k, k))
        assert j in steps[0][k]
    for t in list(range(m - 1)) * 2:
        tn = (t + 1) % (m - 1)
        moved = {}
        for j, g in lanes:
            src = teigh.pair_lanes(j, g, t, m)
            p, q = steps[t][g]
            assert held[g * m + j] == ((p, q), j)

            def diag(lane):
                return slot(lane, int(teigh.pair_lanes(
                    *divmod(lane, m)[::-1], t, m)[12]))

            def pair(lane):
                return slot(lane, int(teigh.pair_lanes(
                    *divmod(lane, m)[::-1], t, m)[13]))

            pn, qn = steps[tn][g]
            assert (diag(src[0]), diag(src[1]), pair(src[2])) == (
                (pn, pn), (qn, qn), (qn, pn))
            pk, qk = next(pq for pq in steps[tn] if j in pq)
            assert (diag(src[3]), diag(src[4]), pair(src[5])) == (
                (pk, pk), (qk, qk), (qk, pk))
            k = next(i for i, pq in enumerate(steps[t]) if j in pq)
            jp = sum(steps[t][k]) - j
            assert src[6] == g * m + jp and src[9] == (j == steps[t][k][0])
            assert slot(src[7], int(src[10])) == (pn, j)
            assert slot(src[8], int(src[11])) == (qn, j)
            moved[g * m + j] = ((pn, qn), j)
        held = moved
    assert held == {g * m + j: (steps[0][g], j) for j, g in lanes}


@pytest.mark.parametrize("n", range(1, 65))
def test_kernel_schedule_matches_jax(n):
    """The kernel's seat arithmetic, phantom pairs dropped, is JAX's
    round-robin schedule step for step (and the plain version's); each
    step pairs every seat once, and each sweep every unordered pair
    once."""
    steps = teigh.schedule(n)
    m = n + n % 2
    jp, jq = (x.tolist() for x in jpairs(n))
    assert len(steps) == m - 1 == len(jp)
    seen = []
    for pairs, ps, qs in zip(steps, jp, jq):
        assert sorted(i for pq in pairs for i in pq) == list(range(m))
        real = [(p, q) for p, q in pairs if q < n]
        assert real == list(zip(ps, qs))
        seen += real
    assert sorted(seen) == [(p, q) for p in range(n) for q in range(p + 1, n)]
    rp, rq = tref.round_robin_pairs(n)
    assert (rp, rq) == (jp, jq)


def test_rotation_matches_half_atan2():
    """The kernel's (c, s) (``ref.jacobi_rotation``) against cos and sin of
    θ = ½·atan2(y, x) in float64 from the kernel's own fp32 x = a_qq − a_pp
    and y = 2a_pq, to 2e-7 absolute; the branch exact: c ≥ 0, s with θ's
    sign (a signed zero where it underflows), (1, 0) where a_pq = 0. The
    grid holds a_pq = 0, a_qq < a_pp, |a_pq| = 1e-30 and equal
    diagonals."""
    rng = np.random.default_rng(3)
    vals = np.concatenate([
        np.array([0.0, 1e-30, -1e-30, 1e-20, 1e-7, -1e-7, 0.1, -0.3, 1.0,
                  -1.0, 2.0, -3.7, 1e3, -1e5, 1e20, 3e37]),
        rng.standard_normal(40) * 10.0 ** rng.uniform(-8, 8, 40),
    ]).astype(np.float32)
    app, aqq, apq = (x.ravel() for x in np.meshgrid(vals, vals, vals,
                                                    indexing="ij"))
    c, s = (t.numpy().astype(np.float64)
            for t in tref.jacobi_rotation(app, aqq, apq))
    x = (aqq - app).astype(np.float64)             # fp32 differences
    y = 2.0 * apq.astype(np.float64)
    theta = np.where(apq == 0, 0.0, 0.5 * np.arctan2(y, x))
    assert np.max(np.abs(c - np.cos(theta))) <= 2e-7
    assert np.max(np.abs(s - np.sin(theta))) <= 2e-7
    assert np.all(c >= 0)
    assert np.all(np.signbit(s) == (theta < 0))
    zero = apq == 0
    assert np.all(c[zero] == 1.0) and np.all(s[zero] == 0.0)
    assert np.any(zero & (aqq < app)) and np.any(zero & (aqq == app))
    assert np.any((np.abs(apq) == np.float32(1e-30)) & (aqq < app))


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def _emulate_warp_route(a, sweeps=12):
    """The warp route's arithmetic in its order, its lanes vectorised: a
    lane owns column j of A and V; each step pairs by the kernel's
    schedule, takes (c, s) from the pair's pivots (``jacobi_rotation``)
    and writes each entry as RN(RN(P1 X + P4 W) + RN(RN(P2 Y) + RN(P3 Z)))
    (the fused multiply-add emulated in float64). Returns (lam, vec) and
    whether A stayed exactly symmetric after every step."""
    b, n, _ = a.shape
    m = n + n % 2
    A = torch.zeros(b, m, m)
    A[:, :n, :n] = 0.5 * (a + a.mT)
    V = torch.eye(m).repeat(b, 1, 1)
    symmetric = True
    for _ in range(sweeps):
        for pairs in teigh.schedule(n):
            p = torch.tensor([pq[0] for pq in pairs])
            q = torch.tensor([pq[1] for pq in pairs])
            c, s = tref.jacobi_rotation(A[:, p, p], A[:, q, q], A[:, p, q])
            partner = torch.empty(m, dtype=torch.long)
            partner[p], partner[q] = q, p
            alpha, beta = torch.empty(b, m), torch.empty(b, m)
            alpha[:, p], alpha[:, q] = c, c
            beta[:, p], beta[:, q] = -s, s
            ar, br = alpha[:, :, None], beta[:, :, None]      # rows
            ac, bc = alpha[:, None, :], beta[:, None, :]      # columns
            x, y = A, A[:, :, partner]
            z, w = A[:, partner, :], A[:, partner][:, :, partner]
            A = _fma(ar * ac, x, (br * bc) * w) + ((ar * bc) * y
                                                   + (br * ac) * z)
            V = _fma(ac.expand_as(V), V, bc * V[:, :, partner])
            symmetric &= torch.equal(A, A.mT)
    lam, order = torch.sort(torch.diagonal(A, dim1=-2, dim2=-1)[:, :n],
                            stable=True)
    vec = torch.gather(V[:, :n, :], 2, order[:, None, :].expand(-1, n, -1))
    return lam, vec, symmetric


@pytest.mark.parametrize("n", [3, 8, 16])
def test_warp_route_arithmetic_meets_the_card_gates(n):
    """An emulation of the warp route's order of operations keeps A exactly
    symmetric by construction (no re-pin) and meets the gates the card
    holds the kernel to against the plain version (``chip_smoke.py``):
    eigenvalues within 1e-5·max(n, 8) of the scale, reconstruction and
    orthogonality within 1e-5·max(n, 8); a diagonal input comes back
    exactly as the plain version returns it."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((4, n, n + 3)).astype(np.float32)
    a = torch.from_numpy(x @ np.swapaxes(x, -1, -2))
    lam, vec, symmetric = _emulate_warp_route(a)
    assert symmetric
    lam_p, _ = tref.jacobi_eigh_ref(a)
    tol = 1e-5 * max(n, 8)
    scale = lam_p.abs().max().item()
    assert (lam - lam_p).abs().max().item() <= tol * scale
    recon = (vec * lam[:, None, :]) @ vec.mT
    assert (recon - a).abs().max().item() <= tol * scale
    assert (vec.mT @ vec - torch.eye(n)).abs().max().item() <= tol
    d = torch.diag_embed(torch.tensor([[3.0, 1.0, 2.0, 0.5]] * 2))
    got, want = _emulate_warp_route(d)[:2], tref.jacobi_eigh_ref(d)
    assert all(torch.equal(g, w) for g, w in zip(got, want))

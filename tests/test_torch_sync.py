"""Port parity: 𝒮 and 𝒜 — ``core.ajive`` (factored: shared and
heterogeneous bases, both sides, stacked, all three joint-basis routes;
dense: ``ajive`` with a fixed and an estimated joint rank, ``ajive_sync``),
``core.state_sync`` (avg, avg_svd, ajive: factored per leaf and bucketed,
and the dense protocols on lifted views) and ``core.aggregation`` —
against the JAX package on seeded random stacks, ≤1e-5 relative.

The stacks carry a shared low-rank component plus small client noise, as
the projected second moments of a federated round do, so AJIVE's joint
basis is well separated from the noise (a joint basis of unrelated views
is degenerate in every implementation). Heterogeneous bases are nearby
orthonormal bases, as clients that refreshed on similar data hold.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.core import aggregation as jagg
from repro.core import ajive as jajive
from repro.core import state_sync as jsync
from repro_torch.core import aggregation as tagg
from repro_torch.core import ajive as tajive
from repro_torch.core import state_sync as tsync
from repro_torch.utils import prng

R = 4


def _rel(got, want):
    want = np.asarray(want)
    return float(np.max(np.abs(np.asarray(got) - want))
                 / max(np.max(np.abs(want)), 1e-30))


def _stack(rng, c, lead, side, dim_free, noise=0.05):
    """(C, *lead, m, r) right | (C, *lead, r, n) left: shared factor times
    per-client coefficients plus noise. The coefficients have singular
    values in [1, 2], so no view is near rank-deficient: Phase 1 scales its
    scores by Λ^{-1/2} of the view's Gram, which would amplify round-off
    in both implementations alike."""
    shared = rng.standard_normal(lead + (dim_free, R))
    out = []
    for _ in range(c):
        q1 = np.linalg.qr(rng.standard_normal(lead + (R, R)))[0]
        q2 = np.linalg.qr(rng.standard_normal(lead + (R, R)))[0]
        coef = (q1 * np.linspace(1.0, 2.0, R)) @ q2
        v = shared @ coef + noise * rng.standard_normal(lead + (dim_free, R))
        out.append(v if side == "right" else np.swapaxes(v, -1, -2))
    return np.stack(out).astype(np.float32)


def _bases(rng, c, lead, dim):
    base = rng.standard_normal(lead + (dim, R))
    return np.stack([np.linalg.qr(base + 0.2 * rng.standard_normal(
        base.shape))[0] for _ in range(c)]).astype(np.float32)


def _weights(c):
    return np.linspace(1.0, 2.0, c).astype(np.float32)


CASES = [("right", 4, (), 48), ("left", 4, (), 40), ("right", 4, (2,), 48),
         ("left", 4, (3,), 40),
         ("right", 20, (), 96)]       # C·k = 80 > 64, d = 96: the sketch


@pytest.mark.parametrize("side,c,lead,dim_free", CASES)
def test_ajive_sync_factored(side, c, lead, dim_free):
    rng = np.random.default_rng(0)
    v = _stack(rng, c, lead, side, dim_free)
    w = _weights(c)
    want = jajive.ajive_sync_factored(jnp.asarray(v), R, jnp.asarray(w),
                                      side)
    got = tajive.ajive_sync_factored(torch.from_numpy(v), R,
                                     torch.from_numpy(w), side)
    assert tuple(got.shape) == tuple(want.shape)
    assert _rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("side,c,lead,dim_free", CASES[:4])
def test_ajive_sync_hetero_factored(side, c, lead, dim_free):
    rng = np.random.default_rng(1)
    v = _stack(rng, c, lead, side, dim_free)
    b = _bases(rng, c, lead, 32)
    w = _weights(c)
    want = jajive.ajive_sync_hetero_factored(jnp.asarray(v), jnp.asarray(b),
                                             R, jnp.asarray(w), side)
    got = tajive.ajive_sync_hetero_factored(torch.from_numpy(v),
                                            torch.from_numpy(b), R,
                                            torch.from_numpy(w), side)
    assert _rel(got.numpy(), want) <= 1e-5


def test_exclude_zero_weights_masks_joint_basis():
    """A zero-weight client's moments shape neither the joint basis nor the
    result when ``exclude_zero_weights`` is set."""
    rng = np.random.default_rng(2)
    v = _stack(rng, 5, (), "right", 48)
    w = np.array([1, 1, 1, 0, 1], np.float32)
    outs = []
    for garbage in (0.0, 50.0):
        v[3] = garbage * rng.standard_normal(v[3].shape)
        want = jajive.ajive_sync_factored(jnp.asarray(v), R, jnp.asarray(w),
                                          "right", exclude_zero_weights=True)
        got = tajive.ajive_sync_factored(torch.from_numpy(v), R,
                                         torch.from_numpy(w), "right",
                                         exclude_zero_weights=True)
        assert _rel(got.numpy(), want) <= 1e-5
        outs.append(got.numpy())
    assert _rel(outs[1], outs[0]) <= 1e-5


@pytest.mark.parametrize("protocol", ["avg", "avg_svd", "ajive"])
@pytest.mark.parametrize("side", ["right", "left"])
def test_sync_blocks(protocol, side):
    rng = np.random.default_rng(3)
    v = _stack(rng, 4, (2,), side, 48 if side == "right" else 40)
    b = _bases(rng, 4, (2,), 32)
    w = _weights(4)
    want = jsync.sync_block_synced_factored(protocol, jnp.asarray(v), side,
                                            jnp.asarray(w), R)
    got = tsync.sync_block_synced_factored(protocol, torch.from_numpy(v),
                                           side, torch.from_numpy(w), R)
    assert _rel(got.numpy(), want) <= 1e-5
    want = jsync.sync_block_hetero_factored(protocol, jnp.asarray(v),
                                            jnp.asarray(b), side,
                                            jnp.asarray(w), R)
    got = tsync.sync_block_hetero_factored(protocol, torch.from_numpy(v),
                                           torch.from_numpy(b), side,
                                           torch.from_numpy(w), R)
    assert _rel(got.numpy(), want) <= 1e-5
    assert tsync.sync_block_synced_factored("none", torch.from_numpy(v),
                                            side) is None


def test_transfer_grams_and_gram_orth():
    rng = np.random.default_rng(4)
    b = _bases(rng, 3, (), 24)
    want = jsync.transfer_grams(jnp.asarray(b))
    assert _rel(tsync.transfer_grams(torch.from_numpy(b)).numpy(), want) \
        <= 1e-6
    x = rng.standard_normal((30, 6)).astype(np.float32)
    x[:, 5] = x[:, 0]                            # rank-deficient factor
    coeff, rfac = tsync._gram_orth(torch.from_numpy(x.T @ x))
    q = x @ coeff.numpy()
    assert np.allclose(q @ rfac.numpy(), x, atol=1e-4)
    gram = q.T @ q
    assert np.allclose(gram[:5, :5], np.eye(5), atol=1e-4)


@pytest.mark.parametrize("protocol", ["avg", "ajive"])
@pytest.mark.parametrize("hetero", [False, True])
def test_map_sync_leaves_bucketed_matches_jax(protocol, hetero):
    rng = np.random.default_rng(5)
    shapes = [("right", 48), ("right", 48), ("left", 40), ("right", 48),
              ("left", 40)]
    vs = [_stack(rng, 4, (2,), s, d) for s, d in shapes]
    bs = [_bases(rng, 4, (2,), 32) for _ in shapes]
    vs.insert(2, None)
    bs.insert(2, None)
    w = _weights(4)

    def leaf_fn(sync_lib, wt):
        def fn(v, b, n_batch=0):
            side = "right" if v.shape[-1] == b.shape[-1] else "left"
            if hetero:
                return sync_lib.sync_block_hetero_factored(protocol, v, b,
                                                           side, wt, R)
            return sync_lib.sync_block_synced_factored(protocol, v, side, wt,
                                                       R)
        return fn

    want = jsync.map_sync_leaves(
        leaf_fn(jsync, jnp.asarray(w)),
        [None if v is None else jnp.asarray(v) for v in vs],
        [None if b is None else jnp.asarray(b) for b in bs])
    tv = [None if v is None else torch.from_numpy(v) for v in vs]
    tb = [None if b is None else torch.from_numpy(b) for b in bs]
    got = tsync.map_sync_leaves(leaf_fn(tsync, torch.from_numpy(w)), tv, tb)
    for a, g in zip(want, got):
        if a is None:
            assert g is None
            continue
        assert _rel(g.numpy(), a) <= 1e-5


@pytest.mark.parametrize("side", ["right", "left"])
def test_factored_lift_averages(side):
    rng = np.random.default_rng(6)
    d = _stack(rng, 4, (2,), side, 24)
    b = _bases(rng, 4, (2,), 16)
    w = _weights(4)
    want = jagg.factored_lift_average(jnp.asarray(d), jnp.asarray(b[0]),
                                      side, jnp.asarray(w))
    got = tagg.factored_lift_average(torch.from_numpy(d),
                                     torch.from_numpy(b[0]), side,
                                     torch.from_numpy(w))
    assert _rel(got.numpy(), want) <= 1e-5
    want = jagg.factored_lift_average_hetero(jnp.asarray(d), jnp.asarray(b),
                                             side, jnp.asarray(w))
    got = tagg.factored_lift_average_hetero(torch.from_numpy(d),
                                            torch.from_numpy(b), side,
                                            torch.from_numpy(w))
    assert _rel(got.numpy(), want) <= 1e-5
    for hetero in (False, True):
        want = jagg.robust_factored_lift(jnp.asarray(d), jnp.asarray(b), side,
                                         jnp.asarray(w), hetero=hetero)
        got = tagg.robust_factored_lift(torch.from_numpy(d),
                                        torch.from_numpy(b), side,
                                        torch.from_numpy(w), hetero=hetero)
        assert _rel(got.numpy(), want) <= 1e-5
    for hetero in (False, True):
        want = jagg.robust_factored_lift(jnp.asarray(d), jnp.asarray(b), side,
                                         jnp.asarray(w), "geomedian",
                                         hetero=hetero)
        got = tagg.robust_factored_lift(torch.from_numpy(d),
                                        torch.from_numpy(b), side,
                                        torch.from_numpy(w), "geomedian",
                                        hetero=hetero)
        assert _rel(got.numpy(), want) <= 1e-5


def test_weighted_average():
    rng = np.random.default_rng(7)
    x = {"a": rng.standard_normal((3, 4, 5)).astype(np.float32), "b": None}
    w = np.array([1.0, 2.0, 3.0], np.float32)
    want = jagg.weighted_average({"a": jnp.asarray(x["a"]), "b": None},
                                 jnp.asarray(w))
    got = tagg.weighted_average({"a": torch.from_numpy(x["a"]), "b": None},
                                torch.from_numpy(w))
    assert got["b"] is None
    assert _rel(got["a"].numpy(), want["a"]) <= 1e-6


# --------------------------------------------------- dense (lifted) views --

def _views(rng, k, n, m, joint=3, indiv=2, noise=1e-3):
    """(k, n, m) views: a shared rank-``joint`` column space with
    per-view loadings (singular values 3..2), a rank-``indiv`` individual
    part per view (1..0.5) and small noise — well separated spectra, so
    every SVD of the pipeline has a gap at its rank."""
    u = np.linalg.qr(rng.standard_normal((n, joint)))[0]
    out = []
    for _ in range(k):
        vj = np.linalg.qr(rng.standard_normal((m, joint)))[0]
        ui = np.linalg.qr(rng.standard_normal((n, indiv)))[0]
        vi = np.linalg.qr(rng.standard_normal((m, indiv)))[0]
        x = (u * np.linspace(3.0, 2.0, joint)) @ vj.T \
            + (ui * np.linspace(1.0, 0.5, indiv)) @ vi.T \
            + noise * rng.standard_normal((n, m))
        out.append(x)
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("joint_rank", [3, None])
@pytest.mark.parametrize("center", [False, True])
def test_dense_ajive_matches_jax(joint_rank, center):
    """Phases 1-3 on dense views; with ``joint_rank=None`` the Wedin and
    random-direction bounds draw through the threefry keys and must pick
    the same rank."""
    v = _views(np.random.default_rng(8), 4, 40, 30)
    want, jrank = jajive.ajive(jnp.asarray(v), signal_ranks=5,
                               joint_rank=joint_rank, center=center,
                               key=jax.random.PRNGKey(3),
                               return_rank_diag=True)
    got, trank = tajive.ajive(torch.from_numpy(v), signal_ranks=5,
                              joint_rank=joint_rank, center=center,
                              key=prng.PRNGKey(3), return_rank_diag=True)
    assert int(trank) == int(jrank)
    if joint_rank is None and not center:
        assert int(trank) == 3
    for name in ("joint", "individual", "joint_mean", "sv_joint"):
        assert _rel(getattr(got, name).numpy(), getattr(want, name)) <= 1e-5
    assert np.max(np.abs(got.noise.numpy() - np.asarray(want.noise))) \
        <= 1e-5 * np.max(np.abs(v))
    jb, tb = np.asarray(want.joint_basis), got.joint_basis.numpy()
    assert _rel(tb @ tb.T, jb @ jb.T) <= 1e-5


def test_dense_bounds_match_jax():
    rng = np.random.default_rng(9)
    x = _views(rng, 1, 24, 18)[0]
    u, s, vt = np.linalg.svd(x, full_matrices=False)
    args = [u[:, :3], s[:3], vt[:3]]
    want = jajive.wedin_bound(jnp.asarray(x), *map(jnp.asarray, args),
                              jax.random.PRNGKey(4))
    got = tajive.wedin_bound(torch.from_numpy(x),
                             *(torch.from_numpy(a.copy()) for a in args),
                             prng.PRNGKey(4))
    assert _rel(got.numpy(), want) <= 1e-5
    want = jajive.random_direction_bound([(24, 18)] * 3, [3, 4, 5],
                                         jax.random.PRNGKey(6))
    got = tajive.random_direction_bound([(24, 18)] * 3, [3, 4, 5],
                                        prng.PRNGKey(6))
    assert _rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("protocol", ["none", "avg", "avg_svd", "ajive"])
@pytest.mark.parametrize("side", ["right", "left"])
def test_dense_protocols_match_jax(protocol, side):
    """``SYNC_PROTOCOLS`` on lifted views, ``sync_block`` onto a new basis
    and ``sync_block_factored``, against JAX; on a shared basis the dense
    and the factored round trips agree."""
    rng = np.random.default_rng(10)
    v = _stack(rng, 4, (), side, 48 if side == "right" else 40)
    b_old, b_new = _bases(rng, 2, (), 32)
    w = _weights(4)
    jargs = (jnp.asarray(v), jnp.asarray(b_old), side, jnp.asarray(w), R)
    targs = (torch.from_numpy(v), torch.from_numpy(b_old), side,
             torch.from_numpy(w), R)
    want = jsync.SYNC_PROTOCOLS[protocol](*jargs)
    got = tsync.SYNC_PROTOCOLS[protocol](*targs)
    if protocol == "none":
        assert got is None and want is None
        return
    assert _rel(got.numpy(), want) <= 1e-5
    views = jsync.lift_views(jnp.asarray(v), jnp.asarray(b_old), side)
    tviews = tsync.lift_views(torch.from_numpy(v), torch.from_numpy(b_old),
                              side)
    assert _rel(tviews.numpy(), views) <= 1e-6
    lifted = tsync.sync_lifted_views(protocol, tviews, torch.from_numpy(w),
                                     R)
    assert _rel(lifted.numpy(), jsync.sync_lifted_views(
        protocol, views, jnp.asarray(w), R)) <= 1e-5
    assert _rel(tsync.project_state(lifted, torch.from_numpy(b_new),
                                    side).numpy(),
                jsync.project_state(jnp.asarray(lifted.numpy()),
                                    jnp.asarray(b_new), side)) <= 1e-6
    dense = tsync.sync_block(protocol, torch.from_numpy(v),
                             torch.from_numpy(b_old), torch.from_numpy(b_new),
                             side, torch.from_numpy(w), R)
    assert _rel(dense.numpy(), jsync.sync_block(
        protocol, jnp.asarray(v), jnp.asarray(b_old), jnp.asarray(b_new),
        side, jnp.asarray(w), R)) <= 1e-5
    fact = tsync.sync_block_factored(protocol, torch.from_numpy(v),
                                     torch.from_numpy(b_old),
                                     torch.from_numpy(b_new), side,
                                     torch.from_numpy(w), R)
    assert _rel(fact.numpy(), jsync.sync_block_factored(
        protocol, jnp.asarray(v), jnp.asarray(b_old), jnp.asarray(b_new),
        side, jnp.asarray(w), R)) <= 1e-5
    assert _rel(fact.numpy(), dense.numpy()) <= 1e-4


@pytest.mark.parametrize("protocol", ["avg", "avg_svd", "ajive"])
def test_dense_sync_of_stacked_blocks_matches_jax_vmap(protocol):
    """Lifted views with a stacked-block axis (k, nb, n, m) sync each block
    on its own, as the reference's eager 𝒮 does under ``jax.vmap``, and
    re-project onto per-block bases."""
    rng = np.random.default_rng(11)
    v = np.stack([_views(rng, 4, 40, 30) for _ in range(3)], axis=1)
    basis = np.stack([_bases(rng, 1, (), 30)[0] for _ in range(3)])
    w = _weights(4)
    want = jax.vmap(lambda x: jsync.sync_lifted_views(
        protocol, x, jnp.asarray(w), R), in_axes=1)(jnp.asarray(v))
    got = tsync.sync_lifted_views(protocol, torch.from_numpy(v),
                                  torch.from_numpy(w), R)
    assert got.shape == (3, 40, 30)
    assert _rel(got.numpy(), want) <= 1e-5
    jproj = jax.vmap(lambda x, b: jsync.project_state(x, b, "right"))(
        jnp.asarray(got.numpy()), jnp.asarray(basis))
    assert _rel(tsync.project_state(got, torch.from_numpy(basis),
                                    "right").numpy(), jproj) <= 1e-6
    jproj = jax.vmap(lambda x, b: jsync.project_state(x, b, "left"))(
        jnp.asarray(got.numpy().transpose(0, 2, 1)), jnp.asarray(basis))
    assert _rel(tsync.project_state(got.mT, torch.from_numpy(basis),
                                    "left").numpy(), jproj) <= 1e-6

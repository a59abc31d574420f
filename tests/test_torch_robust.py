"""Port parity: the robust section of 𝒜 and 𝒮 and the masked and guarded
round — ``repro_torch.core.aggregation`` / ``state_sync`` / ``ajive`` /
``fed`` against ``repro.core``'s.

* Every robust operator against JAX's on the same numpy stacks, within
  1e-6 of the output's scale (``geomedian`` 1e-5: its Weiszfeld loop
  divides by distances, which amplifies the ulp-level differences of the
  two packages' reductions), ties through ``trimmed_mean`` included: the
  port sorts stably, as ``jnp.argsort`` does.
* The robust 𝒮 on stacked (C, nb, ·, r) scan-block stacks, shared and
  heterogeneous bases, with a zero-weight client excluded from the AJIVE
  joint basis (1e-6, AJIVE and ``geomedian`` 1e-5), and through
  ``map_sync_leaves``' shape buckets (1e-5: measured 1.1e-6 for
  ``trimmed_mean``, whose window ``min(cum, 1-t) − max(cum − w, t)``
  cancels the two packages' differently rounded cumulative weights).
* Engine rounds on JAX's ``_problem`` of ``tests/test_fed_methods.py``
  (C = 4, T = 5, rank 4): each ``robust_agg`` mode with quarantine over
  two rounds — the adaptive round 0 on per-client bases, round 1 on the
  shared one — attacked by NaN shards, sign flips and 100× scales, and
  the masked round in its three forms. Per-step losses ≤1e-5,
  global leaves ≤1e-5 of their scale, synced ṽ ≤3e-4 of its scale (the
  RSVD-basis bound of ``test_torch_fed.py``, ROADMAP Queue 3 e).
* The port's own identities, bitwise: an honest cohort through the
  guard, a full mask and an all-ones attack are the plain round;
  ``run_rounds(masks=)`` is a loop of masked rounds. A quarantined
  attacker ≈ the same client masked out (1e-5, JAX's own test's bound).

No bit identity across packages is claimed: ROADMAP Queue 3 b lists the
reference's own permutation-invariance property test as failing.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from threadpoolctl import threadpool_limits

from repro.core import aggregation as jagg
from repro.core import fed as jfed
from repro.core import state_sync as jsync
from repro_torch.core import aggregation as tagg
from repro_torch.core import fed as tfed
from repro_torch.core import state_sync as tsync
from repro_torch.utils import tree
from test_fed_methods import _problem

MODES = ("none", "norm_clip", "trimmed_mean", "geomedian")
ROBUST = ("norm_clip", "trimmed_mean", "geomedian")
LOSS_TOL, PARAM_TOL, SYNC_TOL = 1e-5, 1e-5, 3e-4
# the uplink multipliers of rounds 0 and 1: a NaN shard, a sign flip and
# a 100x scale
ATTACKS = np.array([[1.0, np.nan, -1.0, 100.0],
                    [100.0, 1.0, 1.0, -1.0]], np.float32)


def _rel(got, want):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want))
                 / max(np.max(np.abs(want)), 1e-30))


def _tol(mode):
    return 1e-5 if mode == "geomedian" else 1e-6


def _tloss(p, batch):
    x, y = batch
    h = torch.tanh(x @ p["l1"]["w"] + p["l1"]["b"])
    out = h @ p["l2"]["w"] + p["l2"]["b"]
    return torch.mean((out - y) ** 2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread and one BLAS thread beside the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


# ---------------------------------------------------------- operators ------

def _stack(rng, shape, c=5):
    return rng.standard_normal((c,) + shape).astype(np.float32)


def _weights(rng, c=5, zero=None):
    w = rng.uniform(0.5, 2.0, c).astype(np.float32)
    if zero is not None:
        w[zero] = 0.0
    return w


def _bases(rng, c, dim, r, hetero, lead=()):
    b0 = np.linalg.qr(rng.standard_normal(lead + (dim, r)))[0]
    out = []
    for _ in range(c):
        q = np.linalg.qr(rng.standard_normal(lead + (r, r)))[0]
        out.append(b0 @ q if hetero else b0)
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("shape", [(6, 3), (2, 6, 3)], ids=["leaf", "scan"])
@pytest.mark.parametrize("mode", MODES)
def test_robust_reduce_matches_jax(mode, shape):
    """With one outlier client and one zero-weight client: the zero weight
    vanishes from every mode, a stacked (nb, ·, r) leaf reduces as one
    client vector."""
    rng = np.random.default_rng(1)
    s = _stack(rng, shape)
    s[3] *= 40.0
    w = _weights(rng, zero=1)
    kw = dict(trim=0.2, iters=8, tol=1e-6)
    want = jagg.robust_factored_reduce(jnp.asarray(s), jnp.asarray(w), mode,
                                       **kw)
    got = tagg.robust_factored_reduce(torch.from_numpy(s),
                                      torch.from_numpy(w), mode, **kw)
    assert got.shape == tuple(want.shape)
    assert _rel(got, want) <= _tol(mode)
    s[1] = 1e6                        # the zero-weight client, far away
    got2 = tagg.robust_factored_reduce(torch.from_numpy(s),
                                       torch.from_numpy(w), mode, **kw)
    assert _rel(got2, want) <= _tol(mode)


@pytest.mark.parametrize("side", ["right", "left"])
@pytest.mark.parametrize("hetero", [False, True], ids=["shared", "hetero"])
@pytest.mark.parametrize("mode", MODES)
def test_robust_lift_matches_jax(mode, hetero, side):
    rng = np.random.default_rng(2)
    c, dim, other, r = 5, 7, 6, 3
    d = _stack(rng, (other, r) if side == "right" else (r, other), c)
    d[4] *= 30.0
    b = _bases(rng, c, dim, r, hetero)
    w = _weights(rng, c)
    want = jagg.robust_factored_lift(jnp.asarray(d), jnp.asarray(b), side,
                                     jnp.asarray(w), mode, hetero=hetero,
                                     trim=0.25, iters=12, tol=1e-6)
    got = tagg.robust_factored_lift(torch.from_numpy(d), torch.from_numpy(b),
                                    side, torch.from_numpy(w), mode,
                                    hetero=hetero, trim=0.25, iters=12,
                                    tol=1e-6)
    assert _rel(got, want) <= _tol(mode)


def test_norms_quantile_and_clip_match_jax():
    rng = np.random.default_rng(3)
    s = _stack(rng, (4, 3), 6)
    s[2, 0, 0] = np.nan
    s[4, 1, 1] = np.inf
    w = _weights(rng, 6, zero=5)
    got = tagg.client_sq_norms(torch.from_numpy(s)).numpy()
    want = np.asarray(jagg.client_sq_norms(jnp.asarray(s)))
    assert np.isfinite(got).all() and _rel(got, want) <= 1e-6
    for q in (0.1, 0.5, 0.9):
        assert float(tagg.weighted_quantile(
            torch.tensor(want), torch.from_numpy(w), q)) == float(
            jagg.weighted_quantile(jnp.asarray(want), jnp.asarray(w), q))
    s = np.nan_to_num(s, posinf=0.0)
    got = tagg.median_norm_clip_factors(torch.from_numpy(s),
                                        torch.from_numpy(w))
    want = jagg.median_norm_clip_factors(jnp.asarray(s), jnp.asarray(w))
    assert _rel(got, want) <= 1e-6
    assert float(got.max()) == 1.0       # inliers pass exactly


def test_trimmed_mean_ties_match_jax():
    """Tied coordinates under unequal weights: which tied client the trim
    window cuts depends on the sort's tie order — stable in both."""
    vals = np.array([[1.0, 2.0], [1.0, 2.0], [3.0, 2.0], [1.0, 0.0],
                     [3.0, 2.0]], np.float32)[:, :, None]
    w = np.array([0.1, 0.4, 0.2, 0.25, 0.05], np.float32)
    for trim in (0.1, 0.2, 0.35):
        want = jagg.robust_factored_reduce(jnp.asarray(vals), jnp.asarray(w),
                                           "trimmed_mean", trim=trim)
        got = tagg.robust_factored_reduce(torch.from_numpy(vals),
                                          torch.from_numpy(w),
                                          "trimmed_mean", trim=trim)
        assert _rel(got, want) <= 1e-6


def test_screen_quarantine_and_masks_match_jax():
    rng = np.random.default_rng(4)
    d = {"a": _stack(rng, (5, 2), 5), "b": _stack(rng, (2, 3), 5)}
    v = {"a": np.abs(_stack(rng, (5, 2), 5)), "skip": None}
    d["a"][1, 0, 0] = np.nan                    # non-finite shard
    d["b"][3] *= 50.0                           # norm outlier
    v["a"][4, 0, 1] = np.inf                    # non-finite moment
    scales = np.ones(5, np.float32)
    w = _weights(rng, 5, zero=2)
    jt = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    tt = lambda t: tree.tree_map(torch.from_numpy, t)      # noqa: E731
    want = np.asarray(jagg.screen_factored_clients(
        jt(d), jt(v), jnp.asarray(scales), jnp.asarray(w), zmax=6.0))
    keep = tagg.screen_factored_clients(tt(d), tt(v),
                                        torch.from_numpy(scales),
                                        torch.from_numpy(w), zmax=6.0)
    assert keep.numpy().tolist() == want.tolist() == [True, False, True,
                                                      False, False]
    wq = tagg.quarantine_weights(torch.from_numpy(w), keep)
    assert _rel(wq, jagg.quarantine_weights(jnp.asarray(w),
                                            jnp.asarray(want))) <= 1e-7
    masked = tagg.mask_client_rows(tt(d), keep)
    assert bool(torch.isfinite(masked["a"]).all())
    assert not masked["b"][3].any() and torch.equal(masked["b"][0],
                                                    tt(d)["b"][0])
    everyone = torch.ones(5, dtype=torch.bool)
    wt = torch.from_numpy(w)
    assert tagg.quarantine_weights(wt, everyone) is not wt
    assert torch.equal(tagg.quarantine_weights(wt, everyone), wt)
    same = tagg.mask_client_rows(tt(d), everyone)
    assert all(torch.equal(a, b) for a, b in zip(
        tree.tree_leaves(same), tree.tree_leaves(tt(d)))
        if bool(torch.isfinite(b).all()))


def test_rebase_matches_jax():
    rng = np.random.default_rng(5)
    for side, shape in (("right", (6, 3)), ("left", (3, 6))):
        s = _stack(rng, shape, 4)
        b = _bases(rng, 4, 7, 3, True)
        want = jagg.rebase_factored_stack(jnp.asarray(s), jnp.asarray(b),
                                          side)
        got = tagg.rebase_factored_stack(torch.from_numpy(s),
                                         torch.from_numpy(b), side)
        assert _rel(got, want) <= 1e-6


# ---------------------------------------------------------- robust 𝒮 -------

@pytest.mark.parametrize("hetero", [False, True], ids=["shared", "hetero"])
@pytest.mark.parametrize("robust", ROBUST)
@pytest.mark.parametrize("protocol", ["avg", "avg_svd", "ajive"])
def test_robust_sync_matches_jax(protocol, robust, hetero):
    """Stacked (C, nb, m, r) moments, one client poisoned ×50, one with
    zero weight excluded from the AJIVE joint basis."""
    rng = np.random.default_rng(6)
    c, nb, m, n, r = 5, 2, 9, 7, 3
    v = np.abs(_stack(rng, (nb, m, r), c))
    v[2] *= 50.0
    b = _bases(rng, c, n, r, hetero, lead=(nb,))
    w = _weights(rng, c, zero=4)
    kw = dict(exclude_zero_weights=True, robust=robust, trim=0.2, iters=8,
              tol=1e-6)
    if hetero:
        want = jsync.sync_block_hetero_factored(
            protocol, jnp.asarray(v), jnp.asarray(b), "right",
            jnp.asarray(w), r, **kw)
        got = tsync.sync_block_hetero_factored(
            protocol, torch.from_numpy(v), torch.from_numpy(b), "right",
            torch.from_numpy(w), r, **kw)
    else:
        want = jsync.sync_block_synced_factored(
            protocol, jnp.asarray(v), "right", jnp.asarray(w), r, **kw)
        got = tsync.sync_block_synced_factored(
            protocol, torch.from_numpy(v), "right", torch.from_numpy(w), r,
            **kw)
    assert got.shape == tuple(want.shape)
    assert _rel(got, want) <= (1e-5 if robust == "geomedian"
                               or protocol == "ajive" else 1e-6)


@pytest.mark.parametrize("robust", ROBUST)
def test_robust_sync_bucketed_matches_jax(robust):
    """Three leaves, two of one shape: the port stacks the pair into one
    bucket, where JAX vmaps over it — each leaf is still reduced as its
    own client vector (the scan-block leaf jointly over its nb axis)."""
    rng = np.random.default_rng(7)
    c, r = 4, 3
    shapes = [(8, r), (8, r), (2, 5, r)]
    vs = [np.abs(_stack(rng, s, c)) for s in shapes]
    vs[1][3] *= 30.0
    bs = [_bases(rng, c, 6, r, False, lead=s[:-2]) for s in shapes]
    w = _weights(rng, c)

    def fn(sync, wt):
        def leaf(v, b, n_batch=0):
            kw = dict(robust=robust, trim=0.2, iters=8, tol=1e-6)
            if sync is tsync:
                kw["batch_dims"] = n_batch
            return sync.sync_block_synced_factored("avg", v, "right", wt, r,
                                                   **kw)
        return leaf

    want = jsync.map_sync_leaves(fn(jsync, jnp.asarray(w)),
                                 [jnp.asarray(x) for x in vs],
                                 [jnp.asarray(x) for x in bs])
    got = tsync.map_sync_leaves(fn(tsync, torch.from_numpy(w)),
                                [torch.from_numpy(x) for x in vs],
                                [torch.from_numpy(x) for x in bs])
    for g, wv in zip(got, want):
        assert _rel(g, wv) <= 1e-5


# ------------------------------------------------------- engine rounds -----

@pytest.fixture(scope="module")
def problem():
    jparams, jloss, batches = _problem()
    tparams = tree.tree_map(lambda x: torch.from_numpy(np.array(x)),
                            jax.tree_util.tree_map(np.asarray, jparams))
    return jparams, jloss, batches, tparams


def _kw(**over):
    kw = dict(method="fedgalore", rank=4, lr=3e-2, local_steps=5,
              clip_norm=10.0, weight_decay=0.01)
    kw.update(over)
    return kw


def _engines(problem, **over):
    """The JAX engine starts from a zero synced ṽ — the same round 0 as
    none (fresh moments are zero and the install clamps at zero, as the
    reference's own scan over rounds relies on), so its jitted round
    compiles once rather than once per synced-state structure."""
    jparams, jloss, _, tparams = problem
    je = jfed.FedEngine(jfed.FedConfig(**_kw(**over)), jloss, jparams)
    je.synced_v = je._zero_synced_template()
    return je, tfed.FedEngine(tfed.FedConfig(**_kw(**over)), _tloss,
                              tparams)


def _port(problem, **over):
    _, _, _, tparams = problem
    return tfed.FedEngine(tfed.FedConfig(**_kw(**over)), _tloss, tparams)


def _assert_round_close(je, te, jm, tm):
    assert np.max(np.abs(tm["local_loss"].numpy()
                         - np.asarray(jm["local_loss"]))) <= LOSS_TOL
    for a, b in zip(jax.tree_util.tree_leaves(je.global_trainable),
                    tree.tree_leaves(te.global_trainable)):
        assert _rel(b, a) <= PARAM_TOL
    if je.synced_v is not None:
        for a, b in zip(jax.tree_util.tree_leaves(je.synced_v),
                        tree.tree_leaves(te.synced_v)):
            assert _rel(b, a) <= SYNC_TOL


@pytest.mark.parametrize("robust", MODES)
def test_guarded_rounds_match_jax(problem, robust):
    """Quarantine plus each robust_agg mode: the NaN and scale clients are
    quarantined, the sign flips pass the screen and meet the robust
    reductions."""
    batches = problem[2]
    je, te = _engines(problem, quarantine=True, robust_agg=robust)
    for attack in ATTACKS:
        jm = je.run_round(batches, attack=attack)
        tm = te.run_round(batches, attack=attack)
        _assert_round_close(je, te, jm, tm)
        want = (np.isnan(attack) | (attack > 1.0)).tolist()
        assert te.quarantined.tolist() == want
    for x in tree.tree_leaves(te.global_trainable):
        assert bool(torch.isfinite(x).all())


MASKS = np.array([[True, False, True, True], [True, True, False, False]])


@pytest.mark.parametrize("form", [
    {}, {"factored_clients": False}, {"fused_round": False,
                                      "factored_sync": False}],
    ids=["factored", "dense_clients", "eager"])
def test_masked_rounds_match_jax(problem, form):
    batches = problem[2]
    je, te = _engines(problem, **form)
    for mask in MASKS:
        jm = je.run_round(batches, mask=mask)
        tm = te.run_round(batches, mask=mask)
        _assert_round_close(je, te, jm, tm)


# ---------------------------------------------------- port identities ------

def _leaves_equal(a, b):
    la, lb = tree.tree_leaves(a), tree.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y), float((x - y).abs().max())


@pytest.mark.parametrize("robust", ["none", "trimmed_mean"])
def test_honest_guarded_round_is_bitwise_plain(problem, robust):
    """An honest cohort through the guard (screen, weight fold, moment
    reinstall, exclusion-aware 𝒮) is the unguarded round bit for bit;
    with robust_agg the 𝒜 and 𝒮 reductions differ, so only the screen's
    identity holds there (quarantine adds nothing to it)."""
    batches = problem[2]
    a = _port(problem, quarantine=True, robust_agg=robust)
    b = _port(problem, robust_agg=robust)
    for _ in range(3):
        ma, mb = a.run_round(batches), b.run_round(batches)
        assert torch.equal(ma["local_loss"], mb["local_loss"])
        assert not a.quarantined.any()
    _leaves_equal(a.global_trainable, b.global_trainable)
    _leaves_equal(a.synced_v, b.synced_v)


def test_full_mask_and_all_ones_attack_are_the_plain_round(problem):
    batches = problem[2]
    m, a, p = _port(problem), _port(problem), _port(problem)
    for _ in range(2):
        mm = m.run_round(batches, mask=np.ones(4, bool))
        ma = a.run_round(batches, attack=np.ones(4, np.float32))
        mp = p.run_round(batches)
        assert torch.equal(mm["local_loss"], mp["local_loss"])
        assert torch.equal(ma["local_loss"], mp["local_loss"])
        assert a.quarantined is None
    for e in (m, a):
        _leaves_equal(e.global_trainable, p.global_trainable)
        _leaves_equal(e.synced_v, p.synced_v)


@pytest.mark.parametrize("attack_val", [np.nan, 100.0], ids=["nan", "scale"])
def test_quarantine_matches_masked_round(problem, attack_val):
    batches = problem[2]
    q, m = _port(problem, quarantine=True), _port(problem)
    attack = np.ones(4, np.float32)
    attack[1] = attack_val
    mask = np.array([True, False, True, True])
    for _ in range(2):
        q.run_round(batches, attack=attack)
        m.run_round(batches, mask=mask)
    for x, y in zip(tree.tree_leaves(q.global_trainable),
                    tree.tree_leaves(m.global_trainable)):
        assert bool(torch.isfinite(x).all())
        assert float((x - y).abs().max()) <= 1e-5


def test_run_rounds_masks_is_a_loop_of_masked_rounds(problem):
    x, y = problem[2]
    rb = (np.stack([np.asarray(x)] * 3), np.stack([np.asarray(y)] * 3))
    masks = np.array([[True] * 4, [True, False, True, True],
                      [True, True, False, False]])
    a, b = _port(problem), _port(problem)
    out = a.run_rounds(rb, masks=masks)
    want = torch.stack([b.run_round((rb[0][r], rb[1][r]),
                                    mask=masks[r])["local_loss"]
                        for r in range(3)])
    assert torch.equal(out["local_loss"], want)
    _leaves_equal(a.global_trainable, b.global_trainable)
    _leaves_equal(a.synced_v, b.synced_v)
    with pytest.raises(ValueError, match="masks shape"):
        a.run_rounds(rb, masks=masks[:2])


def test_refusals(problem):
    batches = problem[2]
    with pytest.raises(ValueError, match="factored"):
        _port(problem, quarantine=True, factored_clients=False)
    with pytest.raises(ValueError, match="robust_agg"):
        _port(problem, robust_agg="median")
    dense = _port(problem, factored_clients=False)
    with pytest.raises(ValueError, match="factored"):
        dense.run_round(batches, attack=ATTACKS[1])
    eager = _port(problem, fused_round=False)
    with pytest.raises(ValueError, match="fused"):
        eager.run_round(batches, attack=ATTACKS[1])
    eng = _port(problem)
    with pytest.raises(ValueError, match="participant"):
        eng.run_round(batches, mask=np.zeros(4, bool))
    with pytest.raises(ValueError, match="mask shape"):
        eng.run_round(batches, mask=np.ones(3, bool))
    with pytest.raises(ValueError, match="attack shape"):
        eng.run_round(batches, attack=np.ones(5, np.float32))

"""Port parity: the population layer — ``repro_torch.core.population``
against ``repro.core.population``.

* Plans: ``sample_cohort``, ``corruption_multipliers`` and
  ``corruption_schedule`` equal JAX's exactly over a grid of configs ×
  rounds (the port keeps its own copy of the numpy draws).
* The client-state store: spill round trip through the LRU window, a
  truncated spill reading back cold (never NaN), and spill files read by
  the other package's store, both ways. The staleness buffer. The drift
  metrics against JAX's in float64.
* ``PopulationRunner`` against JAX's on ``_problem`` of
  ``tests/test_fed_methods.py`` (C = 4 of a population of 12, drops,
  stragglers merging stale, corrupted clients quarantined, spills): the
  integer fields of every record exact, losses ≤1e-5, the leaves as
  ``test_torch_fed.py`` holds them (≤1e-4 of their scale, synced ṽ
  ≤3e-4: the round-0 RSVD bases, ROADMAP Queue 3 e), drift and stale
  errors ≤1e-3 relative (ratios of the same differences).
* The port's runner on its own: snapshot kill and resume (losses rtol
  1e-6, drift 1e-5, the reference test's tolerances), the tripwire's
  rollback and replay, its degrade and its no-op, and ``max_staleness=0``
  ≡ synchronous, bitwise.
"""
import os
import warnings

import numpy as np
import pytest

import jax
import torch
from threadpoolctl import threadpool_limits

from repro.core import fed as jfed
from repro.core import population as jpop
from repro_torch.core import fed as tfed
from repro_torch.core import population as tpop
from repro_torch.utils import tree
from test_fed_methods import _problem

LOSS_TOL, PARAM_TOL, SYNC_TOL = 1e-5, 1e-4, 3e-4
ROUNDS = 5


def _rel(got, want):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want))
                 / max(np.max(np.abs(want)), 1e-30))


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


# ---------------------------------------------------------------- plans ----

PLAN_CONFIGS = {
    "faults": dict(population=64, dropout_rate=0.3, straggler_rate=0.4,
                   max_staleness=3, seed=7),
    "no_staleness": dict(population=32, dropout_rate=0.25,
                         straggler_rate=0.6, max_staleness=0, seed=3),
    "adversaries": dict(population=32, dropout_rate=0.2, straggler_rate=0.3,
                        max_staleness=2, corrupt_rate=0.4, seed=11,
                        attack_scale=50.0),
    "pardon": dict(corrupt_rate=0.999, seed=0),
    "one_mode": dict(population=16, corrupt_rate=0.5, seed=3,
                     corrupt_modes=("scale",), attack_scale=37.0),
    "smoke_phase": dict(population=32, dropout_rate=0.25,
                        straggler_rate=0.25, max_staleness=2,
                        staleness_decay=0.5, seed=3, corrupt_rate=0.25),
}


@pytest.mark.parametrize("name", sorted(PLAN_CONFIGS))
def test_plans_match_jax(name):
    kw = PLAN_CONFIGS[name]
    jc, tc = jpop.ParticipationConfig(**kw), tpop.ParticipationConfig(**kw)
    for cohort in (4, 8):
        for r in range(8):
            a, b = jpop.sample_cohort(jc, cohort, r), \
                tpop.sample_cohort(tc, cohort, r)
            assert a.round_idx == b.round_idx
            for f in ("clients", "mask", "delays", "corrupt"):
                x, y = getattr(a, f), getattr(b, f)
                assert x.dtype == y.dtype and np.array_equal(x, y), f
            ma = jpop.corruption_multipliers(a, jc)
            mb = tpop.corruption_multipliers(b, tc)
            assert (ma is None) == (mb is None)
            if ma is not None:
                np.testing.assert_array_equal(ma, mb)
        for start in (0, 3):
            sa = jpop.corruption_schedule(jc, cohort, 5, start_round=start)
            sb = tpop.corruption_schedule(tc, cohort, 5, start_round=start)
            for x, y in zip(sa, sb):
                assert (x is None) == (y is None)
                if x is not None:
                    np.testing.assert_array_equal(x, y)


def test_plan_invariants_and_refusals():
    """The reference's guarantees: ≥ 1 honest on-time client, corruption
    on-time only, draws invariant in downstream knobs."""
    base = dict(population=32, dropout_rate=0.25, straggler_rate=0.3,
                max_staleness=3, seed=4)
    for r in range(6):
        a = tpop.sample_cohort(tpop.ParticipationConfig(**base), 8, r)
        b = tpop.sample_cohort(tpop.ParticipationConfig(
            corrupt_rate=0.5, **base), 8, r)
        assert np.array_equal(a.delays, b.delays)
        assert not b.corrupt[~b.mask].any()
        assert (b.mask & (b.corrupt == 0)).any()
    with pytest.raises(ValueError, match="population"):
        tpop.sample_cohort(tpop.ParticipationConfig(population=3), 4, 0)
    with pytest.raises(ValueError, match="honest"):
        tpop.sample_cohort(tpop.ParticipationConfig(corrupt_rate=1.0), 4, 0)
    with pytest.raises(ValueError, match="corrupt mode"):
        tpop.sample_cohort(tpop.ParticipationConfig(
            corrupt_rate=0.5, corrupt_modes=("bitflip",)), 4, 0)


# ---------------------------------------------------- client-state store ---

def _store_template():
    return {"delta": np.zeros((3, 2), np.float32),
            "v": {"a": np.zeros((5,), np.float32), "skip": None}}


def _rows(rng, n):
    return {"delta": rng.normal(size=(n, 3, 2)).astype(np.float32),
            "v": {"a": rng.normal(size=(n, 5)).astype(np.float32),
                  "skip": None}}


def test_store_spill_roundtrip(tmp_path):
    n = 5000
    rng = np.random.default_rng(0)
    store = tpop.ClientStateStore(n, _store_template(), str(tmp_path),
                                  shard_size=256, max_resident_shards=4)
    ids = np.sort(rng.choice(n, size=200, replace=False))
    rows = _rows(rng, 200)
    store.scatter(ids, rows, round_idx=3)
    assert store.spills > 0
    got = store.gather(ids)
    np.testing.assert_array_equal(got["delta"], rows["delta"])
    np.testing.assert_array_equal(got["v"]["a"], rows["v"]["a"])
    assert got["v"]["skip"] is None and store.loads > 0
    cold = store.gather(np.setdiff1d(np.arange(300), ids)[:50])
    assert not cold["delta"].any() and not cold["v"]["a"].any()
    assert (store.last_round[ids] == 3).all()
    assert store.resident_bytes() <= 4 * 256 * 11 * 4
    store.flush()
    again = tpop.ClientStateStore(n, _store_template(), str(tmp_path),
                                  shard_size=256, max_resident_shards=4)
    np.testing.assert_array_equal(again.gather(ids)["delta"], rows["delta"])
    with pytest.raises(ValueError, match="spill"):
        tpop.ClientStateStore(64, _store_template(), directory=None,
                              shard_size=16, max_resident_shards=2)
    with pytest.raises(ValueError, match="structure"):
        store.scatter(ids[:1], {"delta": rows["delta"][:1]})


@pytest.mark.parametrize("poison", ["truncated", "nonfinite"])
def test_store_bad_spill_reads_cold(tmp_path, poison):
    """A spill cut short mid-write, or one carrying non-finite rows, reads
    back as cold zeros — never NaN — while the other shards are intact."""
    store = tpop.ClientStateStore(64, _store_template(), str(tmp_path),
                                  shard_size=16, max_resident_shards=8)
    ids = np.arange(64)
    rows = tree.tree_map(lambda x: np.ones_like(x), _rows(
        np.random.default_rng(1), 64))
    if poison == "nonfinite":
        rows["delta"][20, 0, 0] = np.nan
    store.scatter(ids, rows)
    store.flush()
    victim = os.path.join(str(tmp_path), "clients_00000001.npz")
    if poison == "truncated":
        with open(victim, "r+b") as f:
            f.truncate(os.path.getsize(victim) // 2)
    again = tpop.ClientStateStore(64, _store_template(), str(tmp_path),
                                  shard_size=16, max_resident_shards=8)
    got = again.gather(ids)
    assert not got["delta"][16:32].any()
    assert got["delta"][:16].all() and got["delta"][32:].all()
    assert np.isfinite(got["delta"]).all()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_spill_files_read_across_packages(tmp_path, writer):
    rng = np.random.default_rng(2)
    ids = np.array([0, 5, 17, 40, 63])
    rows = _rows(rng, len(ids))
    make = {"jax": jpop.ClientStateStore, "torch": tpop.ClientStateStore}
    reader = "torch" if writer == "jax" else "jax"
    w = make[writer](64, _store_template(), str(tmp_path), shard_size=16,
                     max_resident_shards=2)
    w.scatter(ids, rows)
    w.flush()
    r = make[reader](64, _store_template(), str(tmp_path), shard_size=16,
                     max_resident_shards=2)
    got = r.gather(ids)
    np.testing.assert_array_equal(np.asarray(got["delta"]), rows["delta"])
    np.testing.assert_array_equal(np.asarray(got["v"]["a"]),
                                  rows["v"]["a"])
    assert r.loads > 0


# ----------------------------------------------------- staleness buffer ----

def _entry(cid, due):
    return tpop.StaleEntry(client_id=cid, birth_round=0, due_round=due,
                           weight=0.25, decay=0.5, base_scale=1.0,
                           deltas={"a": np.ones(2, np.float32)}, bases=None,
                           v_rows=None)


def test_staleness_buffer():
    buf = tpop.StalenessBuffer()
    for cid, due in ((1, 2), (2, 1), (3, 3)):
        buf.push(_entry(cid, due))
    assert len(buf) == 3 and buf.pending_rounds == [1, 2, 3]
    assert sorted(e.client_id for e in buf.pop_due(2)) == [1, 2]
    assert len(buf) == 1 and buf.pending_rounds == [3]
    cap = tpop.StalenessBuffer(capacity=2)
    assert cap.push(_entry(0, due=5)) is None
    assert cap.push(_entry(1, due=3)) is None
    assert cap.push(_entry(2, due=4)).client_id == 1   # earliest due
    assert cap.push(_entry(3, due=4)).client_id == 2   # FIFO among ties
    assert cap.evictions == 2 and len(cap) == 2
    with pytest.raises(ValueError, match="capacity"):
        tpop.StalenessBuffer(capacity=0)


# ----------------------------------------------------- drift observatory ---

def test_drift_metrics_match_jax():
    rng = np.random.default_rng(3)
    rows = {"w": rng.random((5, 3, 4)), "skip": None,
            "s": rng.random((5, 2, 6, 2))}
    bar = {"w": rng.random((3, 4)), "skip": None, "s": rng.random((2, 6, 2))}
    w = rng.uniform(0.1, 1.0, 5)
    for weights in (None, w):
        want = jpop.moment_divergence(rows, bar, weights)
        assert tpop.moment_divergence(rows, bar, weights) == pytest.approx(
            want, rel=1e-12)
        trows = tree.tree_map(torch.from_numpy, rows)
        assert tpop.moment_divergence(
            trows, tree.tree_map(torch.from_numpy, bar),
            weights) == pytest.approx(want, rel=1e-12)
    assert tpop.tree_rel_err(rows, rows) == 0.0
    assert tpop.tree_rel_err(tree.tree_map(torch.from_numpy, rows),
                             rows) == 0.0
    a = tree.tree_map(lambda x: x * 1.1, rows)
    assert tpop.tree_rel_err(a, rows) == pytest.approx(
        jpop.tree_rel_err(a, rows), rel=1e-12)
    assert tpop.tree_rel_err(a, rows) == pytest.approx(0.1, rel=1e-9)


# --------------------------------------------------------------- runner ----

def _kw(**over):
    kw = dict(method="fedgalore", rank=4, lr=3e-2, local_steps=5,
              clip_norm=10.0, weight_decay=0.01)
    kw.update(over)
    return kw


@pytest.fixture(scope="module")
def problem():
    jparams, jloss, batches = _problem()
    tparams = tree.tree_map(lambda x: torch.from_numpy(np.array(x)),
                            jax.tree_util.tree_map(np.asarray, jparams))
    return jparams, jloss, batches, tparams


def _port(problem, **over):
    return tfed.FedEngine(tfed.FedConfig(**_kw(**over)), _tloss, problem[3])


def _batches_for(problem):
    x, y = problem[2]
    # a different draw per round: the cohort's rows rolled by the round
    return lambda ids, r: (np.roll(np.asarray(x), r, axis=2),
                           np.roll(np.asarray(y), r, axis=2))


RUNNER_PCFG = dict(population=12, dropout_rate=0.25, straggler_rate=0.35,
                   max_staleness=2, staleness_decay=0.5, seed=11,
                   corrupt_rate=0.3)


@pytest.fixture(scope="module")
def runner_pair(problem, tmp_path_factory):
    """JAX's runner and the port's through ROUNDS faulted rounds, the
    store spilling (3 shards, 1 resident)."""
    jparams, jloss, _, _ = problem
    je = jfed.FedEngine(jfed.FedConfig(**_kw(quarantine=True)), jloss,
                        jparams)
    je.synced_v = je._zero_synced_template()     # one compile, same round 0
    te = _port(problem, quarantine=True)
    out = {}
    for name, pop_mod, eng in (("jax", jpop, je), ("torch", tpop, te)):
        d = tmp_path_factory.mktemp(name)
        run = pop_mod.PopulationRunner(
            eng, _batches_for(problem), cohort=4,
            pcfg=pop_mod.ParticipationConfig(**RUNNER_PCFG),
            store_dir=str(d), shard_size=4, max_resident_shards=1)
        recs = [run.run_round() for _ in range(ROUNDS)]
        run.store.flush()
        out[name] = (run, recs)
    return out


INT_FIELDS = ("round", "participants", "dropped", "straggling", "buffered",
              "corrupted", "stale_evicted", "stale_merged")


def test_runner_records_match_jax(runner_pair):
    (jr, jrecs), (tr, trecs) = runner_pair["jax"], runner_pair["torch"]
    assert sum(r["stale_merged"] for r in trecs) > 0
    assert sum(r["corrupted"] for r in trecs) > 0
    assert sum(r["dropped"] for r in trecs) > 0
    for a, b in zip(jr.history, tr.history):
        assert set(a) == set(b)
        assert {k: a[k] for k in INT_FIELDS} == {k: b[k] for k in INT_FIELDS}
        assert abs(a["mean_final_loss"] - b["mean_final_loss"]) <= LOSS_TOL
        for k in ("moment_divergence", "stale_weight_err",
                  "stale_moment_div"):
            assert b[k] == pytest.approx(a[k], rel=1e-3, abs=1e-7), k
    for a, b in zip(jrecs, trecs):
        assert np.max(np.abs(b["local_loss"].numpy()
                             - np.asarray(a["local_loss"]))) <= LOSS_TOL
        corrupt = a["plan"].corrupt
        attack = tpop.corruption_multipliers(b["plan"], tr.pcfg)
        if attack is None:
            continue
        bad = (np.isnan(attack) | (attack > 1.0)) & b["plan"].mask
        assert (b["quarantined"][bad]).all()
        assert (corrupt != 0).sum() >= bad.sum()


def test_runner_state_matches_jax(runner_pair):
    (jr, _), (tr, _) = runner_pair["jax"], runner_pair["torch"]
    for a, b in zip(jax.tree_util.tree_leaves(jr.engine.global_trainable),
                    tree.tree_leaves(tr.engine.global_trainable)):
        assert _rel(b, a) <= PARAM_TOL
        assert bool(torch.isfinite(b).all())
    for a, b in zip(jax.tree_util.tree_leaves(jr.engine.synced_v),
                    tree.tree_leaves(tr.engine.synced_v)):
        assert _rel(b, a) <= SYNC_TOL
    np.testing.assert_array_equal(jr.store.last_round, tr.store.last_round)
    assert tr.store.spills > 0 and tr.store.loads > 0
    ids = np.arange(12)
    ga, gb = jr.store.gather(ids), tr.store.gather(ids)
    for a, b in zip(jax.tree_util.tree_leaves(ga), tree.tree_leaves(gb)):
        assert np.isfinite(b).all()
        assert _rel(b, a) <= SYNC_TOL
    assert ([e.client_id for e in jr.buffer._entries]
            == [e.client_id for e in tr.buffer._entries])


def _runner(eng, pcfg=None, batches_for=None, problem=None, **kw):
    return tpop.PopulationRunner(
        eng, batches_for or _batches_for(problem), cohort=4,
        pcfg=tpop.ParticipationConfig(**(pcfg or {})), **kw)


def test_snapshot_kill_resume(problem, tmp_path):
    snap = str(tmp_path / "snaps")
    pc = dict(dropout_rate=0.2, straggler_rate=0.3, max_staleness=2, seed=9)
    ra = _runner(_port(problem), pc, problem=problem, snapshot_dir=snap,
                 snapshot_every=1, snapshot_keep=2)
    ra.run_rounds(3)
    assert len(ra.buffer) > 0                  # something in flight
    rb = _runner(_port(problem), pc, problem=problem, snapshot_dir=snap)
    assert rb.restore() == 3 and rb.engine.round_idx == 3
    assert len(rb.history) == 3 and len(rb.buffer) == len(ra.buffer)
    ra.run_rounds(3)
    rb.run_rounds(3)
    assert ([r["stale_merged"] for r in ra.history]
            == [r["stale_merged"] for r in rb.history])
    np.testing.assert_allclose([r["mean_final_loss"] for r in rb.history[3:]],
                               [r["mean_final_loss"] for r in ra.history[3:]],
                               rtol=1e-6)
    np.testing.assert_allclose(
        [r["moment_divergence"] for r in rb.history[3:]],
        [r["moment_divergence"] for r in ra.history[3:]], rtol=1e-5,
        atol=1e-8)
    assert len([f for f in os.listdir(snap) if f.endswith(".npz")]) == 2
    with pytest.raises(FileNotFoundError):
        _runner(_port(problem), problem=problem,
                snapshot_dir=str(tmp_path / "empty")).restore()
    with pytest.raises(ValueError, match="snapshot_dir"):
        _runner(_port(problem), problem=problem).snapshot()


NAN_PC = dict(corrupt_rate=0.5, corrupt_modes=("nan",), seed=5)


def test_tripwire_rolls_back_and_replays(problem):
    """Quarantine off: the drift tripwire sees the poisoned round, rolls it
    back, screens the harvest on the host and replays without the
    offenders — no warning, finite state, one record per round."""
    run = _runner(_port(problem), NAN_PC, problem=problem,
                  drift_tripwire=1e6, tripwire_retries=2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        recs = [run.run_round() for _ in range(3)]
    assert any(r["tripwire_replays"] > 0 for r in recs)
    for rec in recs:
        assert np.isfinite(rec["mean_final_loss"])
        assert rec["tripwire_quarantined"] >= rec["tripwire_replays"]
    for x in tree.tree_leaves(run.engine.global_trainable):
        assert bool(torch.isfinite(x).all())
    assert len(run.history) == 3


def test_tripwire_degrades_with_warning(problem):
    run = _runner(_port(problem), NAN_PC, problem=problem,
                  drift_tripwire=1e6, tripwire_retries=0)
    with pytest.warns(UserWarning, match="tripwire"):
        rec = run.run_round()
    assert rec["tripwire_replays"] == 0


def test_tripwire_noop_on_honest_rounds(problem):
    pc = dict(dropout_rate=0.2, seed=3)
    ra = _runner(_port(problem), pc, problem=problem, drift_tripwire=1e6,
                 loss_tripwire=1e6)
    rb = _runner(_port(problem), pc, problem=problem)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for _ in range(3):
            ra.run_round()
            rb.run_round()
    assert all(r["tripwire_replays"] == 0 for r in ra.history)
    for x, y in zip(tree.tree_leaves(ra.engine.global_trainable),
                    tree.tree_leaves(rb.engine.global_trainable)):
        assert torch.equal(x, y)


def test_staleness_zero_is_synchronous(problem):
    """max_staleness=0: no straggler, no buffer — the runner's rounds are
    the bare engine's, bit for bit."""
    bf = _batches_for(problem)
    run = _runner(_port(problem), dict(straggler_rate=0.9, max_staleness=0,
                                       seed=5), batches_for=bf)
    eng = _port(problem)
    for r in range(3):
        rec = run.run_round()
        assert rec["participants"] == 4
        assert rec["buffered"] == 0 and rec["stale_merged"] == 0
        mp = eng.run_round(bf(None, r))
        assert torch.equal(rec["local_loss"], mp["local_loss"])
    for a, b in ((run.engine.global_trainable, eng.global_trainable),
                 (run.engine.synced_v, eng.synced_v)):
        for x, y in zip(tree.tree_leaves(a), tree.tree_leaves(b)):
            assert torch.equal(x, y)


def test_dense_client_runner_and_refusals(problem, tmp_path):
    """Dense-client engines (GaLore without factored clients and without
    𝒮, and a LoRA method) run faulted population rounds: stale dense
    deltas merge, rows persist. A syncing dense-client GaLore engine has
    no birth bases for its stale moments (ROADMAP Queue 3 s: the
    reference fails there too), and the eager round is refused."""
    pc = dict(population=8, dropout_rate=0.25, straggler_rate=0.5,
              max_staleness=1, seed=11)
    for over in (dict(method="fedgalore_minus", factored_clients=False),
                 dict(method="fedit")):
        run = _runner(_port(problem, **over), pc, problem=problem,
                      store_dir=str(tmp_path / over["method"]),
                      shard_size=4, max_resident_shards=1)
        out = run.run_rounds(4)
        assert sum(h["stale_merged"] for h in out["history"]) > 0
        assert all(np.isfinite(h["mean_final_loss"])
                   for h in out["history"])
        assert (run.store.last_round >= 0).any()
        for x in tree.tree_leaves(run.engine.global_trainable):
            assert bool(torch.isfinite(x).all())
    run = _runner(_port(problem, factored_clients=False), pc,
                  problem=problem)
    with pytest.raises(ValueError, match="Queue 3 s"):
        run.run_rounds(4)
    with pytest.raises(ValueError, match="fused"):
        _runner(_port(problem, fused_round=False), problem=problem)


@pytest.mark.parametrize("method", ["fedgalore_minus", "fedavg_full"])
def test_dense_round_retains_only_for_a_harvester(problem, method):
    """A dense-client round keeps its stacked trainables (and GaLore
    states) only once a PopulationRunner has asked for them; alone it
    holds nothing past the round."""
    eng = _port(problem, method=method, factored_clients=False)
    eng.run_round(_batches_for(problem)(None, 0))
    assert eng._client_state is None and eng._client_opt is None
    run = _runner(eng, problem=problem)
    run.run_round()
    assert tree.tree_leaves(eng._client_state)[0].shape[0] == 4
    assert (eng._client_opt is not None) == (method == "fedgalore_minus")

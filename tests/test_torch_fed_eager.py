"""Port parity: the eager oracle round and the dense-client GaLore round of
``repro_torch.core.fed.FedEngine``.

* ``fedgalore`` with ``fused_round=False`` and with ``factored_sync=False``
  against JAX's eager stage-by-stage round on the qwen1.5 smoke model, set
  up as ``test_torch_fed.py`` sets it up (C = 4, T = 2, rank 4, batch
  8 × 16). Clients train dense copies of the target leaves through
  ``galore_adamw``'s update (the fused preconditioner with the update
  projected back); round 0's 𝒮 lifts each client's ṽ with its own RSVD
  basis and runs the dense AJIVE, round 1's takes the factored
  shared-basis AJIVE (``fused_round=False``) or the dense lift again
  (``factored_sync=False``). Bounds as ``test_torch_fed.py``'s, for its
  reasons (round 0's RSVD bases carry fp32 round-off amplified by the
  spectral gap at the rank, ROADMAP Queue 3 e): losses ≤1e-5, global
  leaves ≤1e-4 and synced ṽ ≤3e-4 of their scale. The synced ṽ of a
  dense-lift round is expressed on client 0's end-of-round basis in both
  packages and is compared as it stands.
* The port's own rounds against each other on JAX's ``_problem`` (every
  method, weight decay 0.01, three rounds, the adaptive round 0 in the
  window), as JAX's ``test_fused_round_matches_eager_reference`` and
  ``test_factored_clients_match_dense_fused_round`` do: the default round
  (factored clients for the GaLore methods) against the eager oracle and
  against the dense-client round, leaves and synced ṽ within 1e-5
  absolute. The two run the same mathematics in different orders, so no
  bit-identity is claimed (ROADMAP Queue 3 b).
* ``lift_free=False`` against the default lift-free round and against
  JAX's ``lift_free=False`` round, per GaLore method, as JAX's
  ``test_liftfree_matches_transient_lift_all_galore_methods`` does (three
  rounds on ``_problem``, an active clip 0.5, weight decay 0.01): every
  round reads the transient lift under ``lift_free=False``, and rounds 1-2
  read lift-free by default; losses, leaves and synced ṽ within 1e-5
  absolute.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from threadpoolctl import threadpool_limits

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.core.fed import FedConfig as JFedConfig
from repro.core.fed import FedEngine as JFedEngine
from repro.core.fed import METHODS as JMETHODS
from repro.data import FederatedBatcher as JBatcher
from repro.data import seq_classification as jseq
from repro.launch.steps import galore_target_fn as jtarget
from repro.models import model as jmodel
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.fed import METHODS, FedConfig, FedEngine
from repro_torch.data import FederatedBatcher, seq_classification
from repro_torch.launch.steps import galore_target_fn
from repro_torch.models import model as tmodel
from repro_torch.models.convert import params_from_jax
from repro_torch.utils import tree
from test_fed_round_fused import _problem, _round_batches

C, T, BATCH, SEQ = 4, 2, 8, 16
LOSS_TOL, PARAM_TOL, SYNC_TOL = 1e-5, 1e-4, 3e-4
EAGER = {"fused_round": dict(fused_round=False),
         "factored_sync": dict(factored_sync=False)}


def _rel(got, want):
    want = np.asarray(want)
    return float(np.max(np.abs(np.asarray(got) - want))
                 / max(np.max(np.abs(want)), 1e-30))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread and one BLAS thread (the LAPACK behind SciPy's and
    JAX's CPU SVDs): beside the other test workers, idle threads of a
    multi-threaded pool only compete for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def eager_runs():
    """Both engines, two eager rounds each way, on identical batches."""
    jcfg = jsmoke(jget_config("qwen1.5-0.5b"))
    tcfg = smoke_variant(get_config("qwen1.5-0.5b"))
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              "cpu")
    out = {}
    for name, kw in EAGER.items():
        fkw = dict(method="fedgalore", rank=4, lr=3e-3, local_steps=T, **kw)
        je = JFedEngine(JFedConfig(**fkw),
                        loss_fn=lambda p, b: jmodel.loss_fn(p, jcfg, b),
                        params=jparams, target_fn=jtarget(jcfg))
        te = FedEngine(FedConfig(**fkw),
                       loss_fn=lambda p, b: tmodel.loss_fn(p, tcfg, b),
                       params=tparams, target_fn=galore_target_fn(tcfg))
        jb = JBatcher(jseq(256, 4, SEQ, jcfg.vocab_size), C, BATCH,
                      alpha=0.5)
        tb = FederatedBatcher(seq_classification(256, 4, SEQ,
                                                 tcfg.vocab_size),
                              C, BATCH, alpha=0.5)
        recs = []
        for _ in range(2):
            jbatch, tbatch = jb.round_batches(T), tb.round_batches(T)
            jm = je.run_round({k: jnp.asarray(v) for k, v in jbatch.items()})
            tm = te.run_round(tbatch)
            recs.append(dict(
                jloss=np.asarray(jm["local_loss"]),
                tloss=tm["local_loss"].numpy(),
                jglobal=[np.asarray(x) for x in jax.tree_util.tree_leaves(
                    je.global_trainable)],
                tglobal=[x.numpy() for x in tree.tree_leaves(
                    te.global_trainable)],
                jsync=[np.asarray(x) for x in jax.tree_util.tree_leaves(
                    je.synced_v)],
                tsync=[x.numpy() for x in tree.tree_leaves(te.synced_v)]))
        out[name] = recs
    return out


@pytest.mark.parametrize("rnd", [0, 1])
@pytest.mark.parametrize("which", sorted(EAGER))
def test_eager_round_matches_jax(eager_runs, which, rnd):
    rec = eager_runs[which][rnd]
    assert rec["tloss"].shape == rec["jloss"].shape == (C, T)
    assert np.max(np.abs(rec["tloss"] - rec["jloss"])) <= LOSS_TOL
    assert len(rec["tglobal"]) == len(rec["jglobal"]) == 7
    for got, want in zip(rec["tglobal"], rec["jglobal"]):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert _rel(got, want) <= PARAM_TOL
    assert len(rec["tsync"]) == len(rec["jsync"]) == 7
    for got, want in zip(rec["tsync"], rec["jsync"]):
        assert got.shape == want.shape
        assert _rel(got, want) <= SYNC_TOL


def test_eager_round_launches_the_lifted_preconditioner(monkeypatch):
    """The dense-client GaLore step runs ``galore_precond_step`` with the
    update projected back, once per shape bucket per client per step;
    𝒮 of the adaptive round 0 lifts densely (no small eigensolve), of
    round 1 on the shared basis through the batched eigensolve, once per
    target leaf."""
    from repro_torch.kernels import ops as kops
    calls = []
    seen = {"eigh": 0}
    precond, eigh = kops.galore_precond_step, kops.batched_small_eigh

    def counted_precond(*a, **k):
        calls.append(k.get("project_back", True))
        return precond(*a, **k)

    def counted_eigh(*a, **k):
        seen["eigh"] += 1
        return eigh(*a, **k)

    monkeypatch.setattr(kops, "galore_precond_step", counted_precond)
    monkeypatch.setattr(kops, "batched_small_eigh", counted_eigh)
    cfg = smoke_variant(get_config("qwen1.5-0.5b"))
    params = tmodel.init_params(cfg, seed=0, device="cpu")
    eng = FedEngine(FedConfig(method="fedgalore", rank=4, lr=3e-3,
                              local_steps=T, fused_round=False),
                    loss_fn=lambda p, b: tmodel.loss_fn(p, cfg, b),
                    params=params, target_fn=galore_target_fn(cfg))
    tb = FederatedBatcher(seq_classification(64, 4, 8, cfg.vocab_size), C,
                          2, alpha=0.5)
    n_buckets = len({tuple(x.shape)
                     for x in tree.tree_leaves(eng.global_trainable)})
    per_round = []
    for _ in range(2):
        calls.clear()
        seen["eigh"] = 0
        eng.run_round(tb.round_batches(T))
        per_round.append((list(calls), seen["eigh"]))
    for pb, _ in per_round:
        assert pb == [True] * (C * T * n_buckets)
    assert per_round[0][1] == 0
    assert per_round[1][1] == 7


@pytest.mark.parametrize("method", sorted(METHODS))
def test_default_round_matches_eager_oracle(method):
    """Three rounds of the default round against the eager oracle
    (``fused_round=False, factored_sync=False``) and, for the GaLore
    methods, against the dense-client round (``factored_clients=False``),
    all in the port."""
    jparams, _ = _problem()
    params = tree.tree_map(lambda x: torch.from_numpy(np.array(x)),
                           jax.tree_util.tree_map(np.asarray, jparams))

    def loss(p, batch):
        x, y = batch
        h = torch.tanh(x @ p["l1"]["w"] + p["l1"]["b"])
        return torch.mean((h @ p["l2"]["w"] + p["l2"]["b"] - y) ** 2)

    variants = {"default": {},
                "eager": dict(fused_round=False, factored_sync=False)}
    if METHODS[method].optimizer == "galore_adamw":
        variants["dense_clients"] = dict(factored_clients=False)
    engines = {}
    for name, kw in variants.items():
        eng = FedEngine(FedConfig(method=method, rank=4, lr=3e-2,
                                  local_steps=5, clip_norm=10.0,
                                  weight_decay=0.01, **kw), loss, params)
        assert eng._factored == (name != "dense_clients" and METHODS[
            method].optimizer == "galore_adamw")
        for r in range(3):
            m = eng.run_round(_round_batches(r))
            assert bool(torch.isfinite(m["local_loss"]).all())
        engines[name] = eng
    ref = engines["default"]
    for name, eng in engines.items():
        for attr in ("global_trainable", "frozen", "synced_v"):
            a, b = getattr(ref, attr), getattr(eng, attr)
            assert (a is None) == (b is None), (name, attr)
            for x, y in zip(tree.tree_leaves(a), tree.tree_leaves(b)):
                assert float((x - y).abs().max()) <= 1e-5, (name, attr)


@pytest.mark.parametrize("method", sorted(
    m for m, s in METHODS.items() if s.optimizer == "galore_adamw"))
def test_lift_free_off_matches_lift_free_and_jax(method):
    """Three rounds under ``lift_free=False`` (the transient-lift read in
    every round) against the default lift-free round in the port and
    against JAX's ``lift_free=False`` round, with an active clip."""
    assert JMETHODS[method].optimizer == "galore_adamw"
    jparams, jloss = _problem()
    params = tree.tree_map(lambda x: torch.from_numpy(np.array(x)),
                           jax.tree_util.tree_map(np.asarray, jparams))

    def loss(p, batch):
        x, y = batch
        h = torch.tanh(x @ p["l1"]["w"] + p["l1"]["b"])
        return torch.mean((h @ p["l2"]["w"] + p["l2"]["b"] - y) ** 2)

    kw = dict(method=method, rank=4, lr=3e-2, local_steps=5, clip_norm=0.5,
              weight_decay=0.01)
    je = JFedEngine(JFedConfig(lift_free=False, **kw), jloss, jparams)
    engines, reads = {}, {}
    for lf in (True, False):
        eng = FedEngine(FedConfig(lift_free=lf, **kw), loss, params)
        assert eng._lift_free is lf
        seen = reads[lf] = []
        inner = eng._local_train

        def spy(st, batches, transient, inner=inner, seen=seen):
            seen.append(transient)
            return inner(st, batches, transient)

        eng._local_train = spy
        engines[lf] = eng
    for r in range(3):
        batch = _round_batches(r)
        jm = je.run_round(batch)
        ms = {lf: eng.run_round(batch) for lf, eng in engines.items()}
        for m in ms.values():
            assert bool(torch.isfinite(m["local_loss"]).all())
        assert np.max(np.abs(ms[False]["local_loss"].numpy()
                             - np.asarray(jm["local_loss"]))) <= 1e-5
        assert float((ms[False]["local_loss"]
                      - ms[True]["local_loss"]).abs().max()) <= 1e-5
    assert reads[False] == [True] * (3 * C)
    assert reads[True] == [True] * C + [False] * (2 * C)
    off, on = engines[False], engines[True]
    for attr in ("global_trainable", "synced_v"):
        want = getattr(je, attr)
        assert (want is None) == (getattr(off, attr) is None)
        assert (getattr(on, attr) is None) == (want is None)
        jl = [np.asarray(x) for x in jax.tree_util.tree_leaves(want)]
        for x, y, z in zip(tree.tree_leaves(getattr(off, attr)),
                           tree.tree_leaves(getattr(on, attr)), jl):
            assert float((x - y).abs().max()) <= 1e-5, attr
            assert np.max(np.abs(x.numpy() - z)) <= 1e-5, attr
